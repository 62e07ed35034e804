"""The port's tenant lanes against the reference's, BITWISE.

L = 3 lanes with distinct arrival rates, seeds and per-lane models run
through the port's ``runtime.run_chunk_lanes`` — per event on "torch"
and "cuda" (the lockstep loop over the L·P pattern rows; here the
kernels' plain versions), and per W-event block on "cuda_block" (the
block kernel's lane instance; on CPU tensors its plain version lane by
lane), fused and replay — and every carry and StepOut leaf of every lane
must equal the reference's ``run_chunk_lanes`` with ``backend="xla"``
bit for bit.  (The reference's ``pallas_block`` is not the truth: under
jax 0.9.0 its Pallas lacks ``pl.load``.)  Each lane also equals its own
single-lane ``run_engine``; ``merge_carries`` equals the reference's,
L = 0 included.
"""
import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.cep import engine as eng
from repro.cep import patterns as pat
from repro.cep import runner
from repro.core import overload as rovl
from repro.data import streams
from repro import runtime as RT
from repro_torch import runtime as TRT
from repro_torch.cep import convert
from repro_torch.cep import engine as teng
from repro_torch.kernels import block_step as kb

from _torch_bridge import COST, SHEDDERS, assert_trees_equal, port_config

L, N_EV, W = 3, 240, 16


def _spec(name):
    if name == "q1":  # SEQ / SPAWN_AT_OPEN
        return pat.make_q1(window_size=400, num_symbols=4)
    return pat.make_q4(any_n=3, window_size=120, slide=40)  # ANY/in-windows


@functools.lru_cache(maxsize=None)
def _inputs(name, shedder):
    """Reference config and lane-stacked (model, events): lane i runs at
    1 + 0.4·i times the base rate on stream seed 100 + i, with its own
    utility tables and latency fit.  Carries come from ``_carry0``."""
    specs = [_spec(name)]
    cp = pat.compile_patterns(specs)
    cfg = runner.default_config(cp, max_pms=32, latency_bound=0.005,
                                gather_stats=True, emit_matches=True,
                                shedder=shedder, block_events=W, **COST)
    rate = 3.0 / (cfg.c_base + cfg.c_match * 0.3 * cfg.max_pms)
    rng = np.random.default_rng(7)
    models, evs = [], []
    for i in range(L):
        tables = rng.uniform(0.1, 1.0, (1, 4, cfg.max_states))
        models.append(eng.make_model(
            cp, cfg, ut_tables=jnp.asarray(tables, jnp.float32),
            ut_bins=jnp.array([64], jnp.int32),
            f_model=rovl.LatencyModel(
                a=jnp.float32(cfg.c_match * (1.0 + 0.25 * i)),
                b=jnp.float32(cfg.c_base), kind=jnp.int32(rovl.LINEAR))))
        raw = streams.gen_stock(N_EV, num_symbols=50, pattern_symbols=4,
                                p_class=0.05, seed=100 + i)
        evs.append(streams.classify(specs, raw, rate=rate * (1 + 0.4 * i),
                                    seed=i))
    return cfg, RT.stack(models), RT.stack(evs)


def _carry0(cfg):
    return RT.init_lane_carries(cfg, L, seed=5)


@functools.lru_cache(maxsize=None)
def _reference(name, shedder):
    cfg, mL, evL = _inputs(name, shedder)
    return RT.run_chunk_lanes(cfg, mL, evL, _carry0(cfg), jnp.int32(0))


def _port(name, shedder):
    cfg, mL, evL = _inputs(name, shedder)
    n = convert.tree_to_numpy
    return cfg, (convert.model_from_numpy(n(mL), "cpu"),
                 convert.events_from_numpy(n(evL), "cpu"),
                 convert.carry_from_numpy(n(_carry0(cfg)), "cpu"))


VARIANTS = [(n, s, v) for n in ("q1", "q4") for s in SHEDDERS
            for v in ("torch", "cuda", "cuda_block", "cuda_block_replay")
            if v != "cuda_block_replay" or s in ("pspice", "pmbl")]


@pytest.mark.parametrize("name,shedder,variant", VARIANTS)
def test_lanes_equal_reference_xla_lanes(name, shedder, variant):
    """Bar: bit for bit in every carry and StepOut leaf of every lane."""
    ref_c, ref_o = _reference(name, shedder)
    cfg, (mL, evL, cL0) = _port(name, shedder)
    backend = variant.removesuffix("_replay")
    tcfg = port_config(cfg, backend)
    if variant.endswith("_replay"):
        tcfg = dataclasses.replace(tcfg, block_shed="replay")
    saved = convert.tree_to_numpy(cL0)
    c, o = TRT.run_chunk_lanes(tcfg, mL, evL, cL0, 0, device="cpu")
    if shedder in ("pspice", "pmbl"):
        assert float(c.pms_shed.sum()) > 0, "fixture must shed"
        assert (c.shed_calls > 0).sum() >= 2, "two lanes must shed"
    assert_trees_equal(ref_c, c, f"{name}/{shedder}/{variant} carry")
    assert_trees_equal(ref_o, o, f"{name}/{shedder}/{variant} outs")
    # run_chunk_lanes leaves the caller's carry as it was.
    assert_trees_equal(saved, cL0, "caller's carry")


@pytest.mark.parametrize("backend", ["torch", "cuda_block"])
def test_each_lane_equals_its_single_lane_run(backend):
    """Bar: bit for bit — lane i of the lane run is lane i's own
    ``run_engine`` (its model, events and carry alone)."""
    cfg, (mL, evL, cL0) = _port("q1", "pspice")
    tcfg = port_config(cfg, backend)
    c, o = TRT.run_chunk_lanes_donated(
        tcfg, mL, evL, teng.tree_map(torch.clone, cL0), 0, device="cpu")
    for i in range(L):
        ci, oi = teng.run_engine(tcfg, *(TRT.unstack_lane(t, i) for t in (
            mL, evL, cL0)), device="cpu")
        assert_trees_equal(ci, TRT.unstack_lane(c, i), f"lane {i} carry")
        assert_trees_equal(oi, TRT.unstack_lane(o, i), f"lane {i} outs")


def test_donated_run_updates_the_carry_in_place():
    """run_chunk_lanes_donated hands the carry over: on "cuda_block" the
    kernel writes the caller's (contiguous) tensors themselves."""
    cfg, (mL, evL, cL0) = _port("q1", "pspice")
    tcfg = port_config(cfg, "cuda_block")
    c, _ = TRT.run_chunk_lanes_donated(tcfg, mL, evL, cL0, 0, device="cpu")
    assert c.pms.active.data_ptr() == cL0.pms.active.data_ptr()
    assert c.sim_time.data_ptr() == cL0.sim_time.data_ptr()


@pytest.mark.parametrize("lanes", [3, 0])
def test_merge_carries_equals_reference(lanes):
    """Bar: bit for bit, L = 0 (every fold its reduction's identity)
    included."""
    ref_c, _ = _reference("q1", "pspice")
    cfg, (mL, evL, cL0) = _port("q1", "pspice")
    c, _ = TRT.run_chunk_lanes(port_config(cfg, "torch"), mL, evL, cL0, 0,
                               device="cpu")
    import jax
    ref_c = jax.tree.map(lambda x: x[:lanes], ref_c)
    c = teng.tree_map(lambda x: x[:lanes], c)
    assert_trees_equal(eng.merge_carries(ref_c), teng.merge_carries(c),
                       f"merge_carries L={lanes}")


def test_lane_kernel_plain_per_lane_starts():
    """The lane instance on CPU tensors (its plain version lane by lane),
    with a different start per lane and one finished lane, equals
    ``block_step_plain`` on each lane alone: bit for bit; the finished
    lane is left exactly as it was, with status [0, W]."""
    cfg, (mL, evL, cL0) = _port("q1", "pmbl")
    tcfg = port_config(cfg, "cuda_block")
    blk = teng.EventBatch(*(x[:, 64:64 + W].contiguous() for x in evL))
    starts = [0, 5, W]
    c = teng.tree_map(torch.clone, cL0)
    rows = kb.new_rows(tcfg, W, "cpu", lanes=L)
    _, rows, status = kb.block_step_lanes(tcfg, mL, c, blk, 64, starts, W,
                                          rows)
    for i in range(L):
        ci = teng.tree_map(torch.clone, TRT.unstack_lane(cL0, i))
        ri = kb.new_rows(tcfg, W, "cpu")
        _, ri, si = kb.block_step_plain(tcfg, TRT.unstack_lane(mL, i), ci,
                                        TRT.unstack_lane(blk, i), 64,
                                        starts[i], W, ri)
        assert_trees_equal(ci, TRT.unstack_lane(c, i), f"lane {i} carry")
        assert_trees_equal(ri, {k: v[i] for k, v in rows.items()},
                           f"lane {i} rows")
        assert status[i].tolist() == si.tolist()
    assert status[2].tolist() == [0, W]
    assert_trees_equal(TRT.unstack_lane(cL0, 2), TRT.unstack_lane(c, 2),
                       "finished lane")


def test_lane_kernel_operand_checks():
    """The lane instance's argument block refuses an operand without the
    lane axis, and per-lane starts of the wrong length or out of range."""
    cfg, (mL, evL, cL0) = _port("q1", "pspice")
    tcfg = port_config(cfg, "cuda_block")
    blk = teng.EventBatch(*(x[:, :W].contiguous() for x in evL))
    rows = kb.new_rows(tcfg, W, "cpu", lanes=L)
    one = TRT.unstack_lane(mL, 0)
    with pytest.raises(ValueError, match="trans"):
        kb.BlockScan(tcfg, one, cL0, blk, rows, lanes=L)
    scan = kb.BlockScan(tcfg, mL, cL0, blk, rows, lanes=L)
    with pytest.raises(ValueError, match="per-lane starts"):
        scan.set_block(0, 0, [0, 0], W)
    with pytest.raises(ValueError, match="per-lane starts"):
        scan.set_block(0, 0, [0, 0, W + 1], W)
    a = scan.set_block(0, 0, [0, 1, 2], W)
    assert a.lanes == L and a.n_rows == W and a.lane_s
    assert scan.starts.tolist() == [0, 1, 2]
    assert scan.set_block(0, 0, 3, W).lane_s is None
