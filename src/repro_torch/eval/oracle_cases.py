"""Seeded overloaded streams on which engines are held to the oracle.

``chip_smoke.py`` and the card tests run the port's engines against
``eval.oracle.run_oracle`` on these, with the literal sort-based
Algorithm 2 pinned (``shed_plan="sort"``).  ``overload_case`` is the
overload fixture of the reference's oracle tests (tests/test_oracle.py),
built from the port's modules; ``layout_case`` is a stock stream whose
PM-BL fires drop a strict subset of several live PMs, so that its
result depends on the threefry layout.
"""
from __future__ import annotations

from repro_torch.cep import engine, patterns as pat, runner
from repro_torch.configs import pspice_paper as pp
from repro_torch.data import streams

# The paper's costs with the sort plan's per-PM shed constant.
COST = dict(pp.COST, c_shed_pm=1.5e-6)
OVERLOAD_LEVELS = (1.2, 1.4, 1.6)


def overload_case(shedder: str, mult: float, device, seed: int = 0):
    """``(cfg, model, events)``: Q1 (window 400, 4 symbols), N = 48, a
    1 ms bound and 300 spawn-heavy events at ``mult`` × 3 times the rate
    the costs allow, so that Algorithm 2 fires many times."""
    specs = [pat.make_q1(window_size=400, num_symbols=4)]
    cp = pat.compile_patterns(specs)
    cfg = runner.default_config(
        cp, max_pms=48, latency_bound=0.001, shedder=shedder,
        emit_matches=True, shed_plan="sort", **COST)
    model = engine.make_model(cp, cfg, device=device)
    rate = mult * 3.0 / (cfg.c_base + cfg.c_match * 0.3 * cfg.max_pms)
    raw = streams.gen_stock(300, num_symbols=50, pattern_symbols=4,
                            p_class=0.5, seed=100 + seed)
    ev = streams.classify(specs, raw, rate=rate, seed=seed, device=device)
    return cfg, model, ev


def layout_case(shedder: str, device):
    """``(cfg, model, events)``: the stock scenario's three Q1 patterns,
    N = 64, a 5 ms bound and 600 events at three times the rate the
    costs allow (seed 1)."""
    sc = streams.get_scenario("stock")
    specs = sc.specs()
    cp = pat.compile_patterns(specs)
    cfg = runner.default_config(
        cp, max_pms=64, latency_bound=0.005, shedder=shedder,
        emit_matches=True, shed_plan="sort", **COST)
    model = engine.make_model(cp, cfg, device=device)
    rate = 3.0 / (cfg.c_base + cfg.c_match * 30)
    ev = streams.classify(specs, sc.raw(n=600), rate=rate, seed=1,
                          device=device)
    return cfg, model, ev
