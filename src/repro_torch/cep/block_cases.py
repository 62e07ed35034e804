"""Seeded event blocks on which the block kernel fires Algorithm 2.

The card tests and ``chip_smoke.py`` hold ``kernels.block_step`` against
``block_step_plain`` on these blocks: an overloaded run of a registered
scenario, its carry just before the run's first shed decision, and the
next W events.  The carry comes from the per-event engine (backend
"torch"), so the block kernel starts from a state it did not make.
"""
from __future__ import annotations

import dataclasses

from repro_torch.cep import engine, patterns as pat, runner
from repro_torch.data import streams

# (scenario, N, shedder): SEQ/at-open at the stock main path's shape and
# at N=2048, ANY/in-windows (bus) and ANY/at-open with E-BL (soccer) —
# all with the store in shared memory — and soccer's 8 ANY patterns at
# N=2048 under PM-BL, whose store (about 1 MB) takes the kernel's
# device-memory instantiation.
CASES = (("stock", 256, "pspice"), ("stock", 256, "pmbl"),
         ("stock", 2048, "pspice"), ("bus", 128, "pmbl"),
         ("soccer", 256, "ebl"), ("soccer", 2048, "pmbl"))


def case_config(name: str, N: int, shedder: str, *, W: int = 32, **costs):
    """``(compiled patterns, cfg)`` of a case: scenario ``name`` with an
    N-slot store, matches and stats on, the block backend at W events per
    launch and a latency bound of 2 ms."""
    cp = pat.compile_patterns(streams.get_scenario(name).specs())
    return cp, runner.default_config(
        cp, max_pms=N, latency_bound=0.002, shedder=shedder,
        emit_matches=True, gather_stats=True, backend="cuda_block",
        block_events=W, **costs)


def firing_block(name: str, N: int, shedder: str, device, *, W: int = 32,
                 n: int = 600, **costs):
    """``(cfg, model, carry, blk, i0)`` for scenario ``name`` with an
    N-slot store: the carry after the first ``i0`` events of a run at ten
    times the rate the costs allow, and the W-event block that follows,
    placed so that it holds the run's first shed decision (the last W
    events when the run never sheds).  ``costs`` are the
    ``default_config`` cost keywords."""
    sc = streams.get_scenario(name)
    specs = sc.specs()
    cp, cfg = case_config(name, N, shedder, W=W, **costs)
    rate = 10.0 / (cfg.c_base + cfg.c_match * 30)
    ev = streams.classify(specs, sc.raw(n=n), rate=rate, seed=1,
                          device=device)
    model = engine.make_model(cp, cfg, device=device)
    ref = dataclasses.replace(cfg, backend="torch")
    carry = engine.init_carry(cfg, seed=1, device=device)
    _, outs = engine.run_engine(ref, model, ev, carry, device=device)
    fires = outs.shed.nonzero().flatten().tolist()
    warm = max(fires[0] - W // 2, 0) if fires else n - W
    if warm:
        carry, _ = engine.run_engine(
            ref, model, engine.EventBatch(*(x[:warm] for x in ev)), carry,
            device=device)
    blk = engine.EventBatch(*(x[warm:warm + W].contiguous() for x in ev))
    return cfg, model, carry, blk, warm
