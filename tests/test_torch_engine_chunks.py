"""The port's engine against the reference engine, BITWISE, part 2:
chunked runs with a ragged tail against the reference's monolithic run,
the quality sweep's multi-pattern scenarios, and the run summary
(part 1, the backend × shedder × pattern grid, is test_torch_engine.py).
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

from repro.cep import engine as eng
from repro.cep import patterns as pat
from repro.cep import runner
from repro.data import streams
from repro_torch.cep import engine as teng

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


@pytest.mark.parametrize("port_backend", ["torch", "cuda"])
@pytest.mark.parametrize("name", ["q1", "q4"])
@pytest.mark.parametrize("shedder", SHEDDERS)
def test_chunked_ragged_tail_equals_monolithic(name, shedder, port_backend):
    """Chunks of 64 events over a 400-event stream (ragged 16-event tail),
    with global indices, replay the reference's monolithic xla run."""
    cfg, model, ev, carry0, carry, outs = _reference(name, shedder, "xla")
    tcfg = port_config(cfg, port_backend)
    t_model, t_ev, t_carry = to_port(model, ev, carry0)
    n = t_ev.ev_class.shape[0]
    pieces = []
    for start in range(0, n, 64):
        piece = teng.EventBatch(*(x[start:start + 64] for x in t_ev))
        t_carry, o = teng.run_engine_chunk(tcfg, t_model, piece, t_carry,
                                           start, device="cpu")
        pieces.append(o)
    t_outs = teng.StepOut(*(torch.cat(xs) for xs in zip(*pieces)))
    assert n % 64, "fixture must have a ragged tail"
    assert_trees_equal(carry, t_carry, f"{name}/{shedder} chunked carry")
    assert_trees_equal(outs, t_outs, f"{name}/{shedder} chunked outs")


@pytest.mark.parametrize("scenario,max_pms",
                         [("stock", 37), ("soccer", 53), ("bus", 61)])
@pytest.mark.parametrize("shedder", ["pspice", "ebl"])
def test_scenario_bitwise(scenario, max_pms, shedder):
    """The quality sweep's scenarios (3 SEQ, 8 bound ANY, 1 in-window ANY
    patterns) at odd store sizes: the per-pattern cost sum rounds as the
    reference's for P = 1, 3 and 8."""
    sc = streams.get_scenario(scenario)
    specs = sc.specs()
    cp = pat.compile_patterns(specs)
    cfg = runner.default_config(cp, max_pms=max_pms, latency_bound=0.005,
                                shedder=shedder, emit_matches=True, **COST)
    model = eng.make_model(cp, cfg)
    rate = 3.0 / (cfg.c_base + cfg.c_match * 0.3 * max_pms)
    ev = streams.classify(specs, sc.raw(n=500), rate=rate, seed=0)
    carry0 = eng.init_carry(cfg)
    carry, outs = eng.run_engine(cfg, model, ev, carry0)
    t_carry, t_outs = teng.run_engine(port_config(cfg, "cuda"),
                                      *to_port(model, ev, carry0),
                                      device="cpu")
    assert_trees_equal(carry, t_carry, f"{scenario} carry")
    assert_trees_equal(outs, t_outs, f"{scenario} outs")


def test_summary_matches_reference():
    cfg, model, ev, carry0, carry, outs = _reference("q1", "pspice", "xla")
    t_carry, t_outs = teng.run_engine(port_config(cfg, "torch"),
                                      *to_port(model, ev, carry0),
                                      device="cpu")
    a, b = eng.summarize(carry, outs), teng.summarize(t_carry, t_outs)
    for f in ("complex_count", "pms_created", "l_e", "n_pm"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    for f in ("pms_shed", "shed_calls", "overflow", "ebl_dropped"):
        assert getattr(a, f) == getattr(b, f)
    assert a.matches == b.matches
    np.testing.assert_array_equal(a.match_probability, b.match_probability)
