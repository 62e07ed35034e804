"""The port's engine against the reference engine, BITWISE.

The axes of tests/test_backend.py: the reference's ``xla`` and
``pallas`` backends against the port's ``torch`` and ``cuda`` backends
(on the CPU the ``cuda`` backend's kernel wrappers compute their plain
versions), all four shedders, q1 (SEQ / at-open) and q4 (ANY /
in-windows), monolithic and chunked with a ragged tail, with match
emission and statistics gathering on.  Inputs reach both packages
through ``repro_torch.cep.convert``; the whole carry and every StepOut
must be equal bit for bit.
"""
import dataclasses
import functools

import pytest

from repro.cep import engine as eng
from repro.cep import patterns as pat
from repro.cep import runner
from repro.data import streams
from repro_torch.cep import engine as teng
from repro_torch.cep import runner as trunner

from _torch_bridge import (COST, SHEDDERS, assert_trees_equal, port_config,
                           to_port)


def _spec(name):
    if name == "q1":  # SEQ / SPAWN_AT_OPEN
        return pat.make_q1(window_size=400, num_symbols=4)
    return pat.make_q4(any_n=3, window_size=120, slide=40)


def _setup(name, shedder, max_pms=32, n=400):
    specs = [_spec(name)]
    cp = pat.compile_patterns(specs)
    cfg = runner.default_config(cp, max_pms=max_pms, latency_bound=0.005,
                                gather_stats=True, emit_matches=True,
                                shedder=shedder, **COST)
    model = eng.make_model(cp, cfg)
    rate = 2.0 * 3.0 / (cfg.c_base + cfg.c_match * 0.3 * max_pms)
    raw = streams.gen_stock(n, num_symbols=50, pattern_symbols=4,
                            p_class=0.05, seed=100)
    ev = streams.classify(specs, raw, rate=rate, seed=0)
    return cfg, model, ev


@functools.lru_cache(maxsize=None)
def _reference(name, shedder, backend):
    cfg, model, ev = _setup(name, shedder)
    cfg = dataclasses.replace(cfg, backend=backend)
    carry0 = eng.init_carry(cfg)
    carry, outs = eng.run_engine(cfg, model, ev, carry0)
    return cfg, model, ev, carry0, carry, outs


@pytest.mark.parametrize("ref_backend,port_backend",
                         [("xla", "torch"), ("pallas", "cuda")])
@pytest.mark.parametrize("name", ["q1", "q4"])
@pytest.mark.parametrize("shedder", SHEDDERS)
def test_run_engine_bitwise(name, shedder, ref_backend, port_backend):
    cfg, model, ev, carry0, carry, outs = _reference(name, shedder,
                                                     ref_backend)
    if shedder in ("pspice", "pmbl"):
        assert float(carry.shed_calls) > 0, "fixture must fire Alg. 2"
    if shedder == "ebl":
        assert float(carry.ebl_dropped) > 0, "fixture must drop events"
    tcfg = port_config(cfg, port_backend)
    t_carry, t_outs = teng.run_engine(tcfg, *to_port(model, ev, carry0),
                                      device="cpu")
    assert_trees_equal(carry, t_carry, f"{name}/{shedder} carry")
    assert_trees_equal(outs, t_outs, f"{name}/{shedder} outs")
    assert eng.match_sets(outs) == teng.match_sets(t_outs)


def test_legacy_paths_bitwise():
    """spawn_alloc="argsort" and shed_plan="sort" (the oracles the O(N)
    paths are held to) on both sides."""
    cfg, model, ev = _setup("q1", "pspice")
    cfg = dataclasses.replace(cfg, spawn_alloc="argsort", shed_plan="sort")
    carry0 = eng.init_carry(cfg)
    carry, outs = eng.run_engine(cfg, model, ev, carry0)
    assert float(carry.shed_calls) > 0
    for backend in ("torch", "cuda"):
        t_carry, t_outs = teng.run_engine(port_config(cfg, backend),
                                          *to_port(model, ev, carry0),
                                          device="cpu")
        assert_trees_equal(carry, t_carry, f"legacy {backend} carry")
        assert_trees_equal(outs, t_outs, f"legacy {backend} outs")


def test_wrap_event_index_matches_reference():
    for start in (0, 5, 2 ** 31 - 1, 2 ** 31, 2 ** 32 + 7, 3 * 2 ** 31):
        assert teng.wrap_event_index(start) == int(
            eng.wrap_event_index(start))


@pytest.mark.parametrize("bad", [
    dict(backend="xla"), dict(backend="pallas"), dict(max_pms=0),
    dict(latency_bound=0.0), dict(safety_buffer=-1.0), dict(shedder="x"),
    dict(c_base=-1.0), dict(ebl_floor=2.0), dict(spawn_alloc="x"),
    dict(shed_plan="x"), dict(kinds="x"), dict(spawn_modes="x")])
def test_config_validation(bad):
    """The port validates its config as the reference does; its backends
    are "torch" and "cuda" and any other name raises."""
    cp = pat.compile_patterns([_spec("q1")])
    with pytest.raises(ValueError):
        trunner.default_config(cp, **bad)
    assert trunner.default_config(cp).backend == "torch"


