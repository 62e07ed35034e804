"""The port's block backend (``backend="cuda_block"``) against the
reference, BITWISE.

On the CPU the block backend runs ``kernels.block_step.block_step_plain``,
the plain version of the event-block megakernel.  The reference's own
block backend (``pallas_block``) cannot run here: its kernel calls
``pl.load``, which the installed jax's Pallas no longer has.  So the
ground truth is the reference's ``xla`` backend, which ``pallas_block``
claims to equal bit for bit.  Inputs reach both packages through
``repro_torch.cep.convert``; the whole carry and every StepOut must be
equal.  The axes are those of tests/test_block_backend.py: W ∈ {1, 8,
32, 128} × 4 shedders on Q1 (SEQ / at-open) and Q4 (ANY / in-windows),
ragged chunked runs (one across the int32 wrap), a spawn overflow, the
overload sweep and the replay protocol (the three scenarios are in
test_torch_block_scenarios.py).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.cep import engine as eng
from repro.cep import patterns as pat
from repro.cep import runner
from repro.core import overload as ovl
from repro.data import streams
from repro_torch.cep import convert
from repro_torch.cep import engine as teng
from repro_torch.cep import patterns as tpat
from repro_torch.cep import runner as trunner
from repro_torch.core import overload as tovl
from repro_torch.data import streams as tstreams
from repro_torch.kernels import block_step as kblock

from _torch_bridge import (COST, SHEDDERS, assert_trees_equal, port_config,
                           to_port)

W_GRID = (1, 8, 32, 128)


def _setup(name, shedder, max_pms=None, n=300, rate_mult=2.0, lb=0.005,
           p_class=0.05):
    """The overloaded fixture of tests/test_block_backend.py at a
    non-tile-multiple store size."""
    specs = [pat.make_q1(window_size=400, num_symbols=4) if name == "q1"
             else pat.make_q4(any_n=3, window_size=120, slide=40)]
    max_pms = max_pms or (37 if name == "q1" else 53)
    cp = pat.compile_patterns(specs)
    cfg = runner.default_config(cp, max_pms=max_pms, latency_bound=lb,
                                gather_stats=True, emit_matches=True,
                                shedder=shedder, **COST)
    model = eng.make_model(cp, cfg)
    rate = rate_mult * 3.0 / (cfg.c_base + cfg.c_match * 0.3 * max_pms)
    raw = streams.gen_stock(n, num_symbols=50, pattern_symbols=4,
                            p_class=p_class, seed=100)
    ev = streams.classify(specs, raw, rate=rate, seed=0)
    return cfg, model, ev


@functools.lru_cache(maxsize=None)
def _reference(name, shedder, **kw):
    """The reference xla run of a fixture: (cfg, model, events, carry0,
    carry, outs)."""
    shed_plan = kw.pop("shed_plan", "threshold")
    cfg, model, ev = _setup(name, shedder, **kw)
    cfg = dataclasses.replace(cfg, shed_plan=shed_plan)
    carry0 = eng.init_carry(cfg)
    carry, outs = eng.run_engine(cfg, model, ev, carry0)
    return cfg, model, ev, carry0, carry, outs


def _block_cfg(cfg, w, **kw):
    return dataclasses.replace(port_config(cfg, "cuda_block"),
                               block_events=w, **kw)


def _run_block(cfg, model, ev, carry0, w, **kw):
    return teng.run_engine(_block_cfg(cfg, w, **kw),
                           *to_port(model, ev, carry0), device="cpu")


@pytest.mark.parametrize("w", W_GRID)
@pytest.mark.parametrize("name", ["q1", "q4"])
@pytest.mark.parametrize("shedder", SHEDDERS)
def test_w_sweep_bitwise(name, shedder, w):
    cfg, model, ev, carry0, carry, outs = _reference(name, shedder)
    if shedder in ("pspice", "pmbl"):
        assert float(carry.shed_calls) > 0, "fixture must fire Alg. 2"
    if shedder == "ebl":
        assert float(carry.ebl_dropped) > 0, "fixture must drop events"
    t_carry, t_outs = _run_block(cfg, model, ev, carry0, w)
    assert_trees_equal(carry, t_carry, f"{name}/{shedder}/W={w} carry")
    assert_trees_equal(outs, t_outs, f"{name}/{shedder}/W={w} outs")
    assert eng.match_sets(outs) == teng.match_sets(t_outs)


@pytest.mark.parametrize("w,origin", [(1, 0), (32, 0), (128, 0),
                                      (32, 2 ** 31 - 150)])
def test_ragged_chunks_equal_monolithic(w, origin):
    """Chunks of 100 over 320 events (ragged tail; W > chunk included)
    replay the reference's monolithic run; with ``origin`` near 2^31 the
    global indices wrap inside the run."""
    cfg, model, ev, carry0, _, _ = _reference("q1", "pspice", n=320)
    # run_engine_chunk donates its buffers: hand it copies.
    ref_c, ref_o = eng.run_engine_chunk(
        cfg, model, *jax.tree.map(jnp.copy, (ev, carry0)),
        eng.wrap_event_index(origin))
    assert float(ref_c.shed_calls) > 0
    tcfg = _block_cfg(cfg, w)
    t_model, t_ev, t_carry = to_port(model, ev, carry0)
    pieces = []
    for start in range(0, 320, 100):
        piece = teng.EventBatch(*(x[start:start + 100] for x in t_ev))
        t_carry, o = teng.run_engine_chunk(tcfg, t_model, piece, t_carry,
                                           origin + start, device="cpu")
        pieces.append(o)
    t_outs = teng.StepOut(*(torch.cat(xs) for xs in zip(*pieces)))
    assert_trees_equal(ref_c, t_carry, f"W={w} origin={origin} carry")
    assert_trees_equal(ref_o, t_outs, f"W={w} origin={origin} outs")


def test_spawn_overflow():
    """A tiny store: the kernel's rank and overflow bookkeeping matches
    the engine's free-list compaction when candidates exceed slots."""
    cfg, model, ev, carry0, carry, outs = _reference(
        "q4", "none", max_pms=4, n=600, rate_mult=1.0)
    assert float(carry.overflow) > 0, "fixture must overflow"
    t_carry, t_outs = _run_block(cfg, model, ev, carry0, 32)
    assert_trees_equal(carry, t_carry, "overflow carry")
    assert_trees_equal(outs, t_outs, "overflow outs")


@pytest.mark.parametrize("mult", (1.2, 1.4, 1.6))
@pytest.mark.parametrize("shedder", ("pspice", "pmbl"))
def test_overload_sweep_bitwise(shedder, mult):
    """Sustained overload: Algorithm 2 fires many times per block, so the
    in-kernel select, key splits and shed cost run end to end."""
    cfg, model, ev, carry0, carry, outs = _reference(
        "q1", shedder, n=240, rate_mult=mult, lb=0.001, p_class=0.5)
    assert float(carry.shed_calls) >= 8, float(carry.shed_calls)
    for w in (8, 128):
        t_carry, t_outs = _run_block(cfg, model, ev, carry0, w)
        assert_trees_equal(carry, t_carry, f"{shedder}/x{mult}/W={w} carry")
        assert_trees_equal(outs, t_outs, f"{shedder}/x{mult}/W={w} outs")


def test_original_threefry_layout_bitwise():
    """jax's original (non-partitionable) threefry layout, in which the
    committed quality results were made: with both packages set to it,
    the block path's fused PM-BL fires (in-kernel key splits and
    uniforms) equal the reference's xla run bit for bit.  On this stock
    stream the fires drop a strict subset of the live PMs, so the draws
    decide: the port's partitionable run completes other matches."""
    from repro_torch import prng
    sc = streams.get_scenario("stock")
    specs = sc.specs()
    cp = pat.compile_patterns(specs)
    cfg = runner.default_config(cp, max_pms=97, latency_bound=0.005,
                                shedder="pmbl", emit_matches=True,
                                gather_stats=True, **COST)
    ev = streams.classify(specs, sc.raw(n=600), seed=1,
                          rate=3.0 / (cfg.c_base + cfg.c_match * 30))
    model = eng.make_model(cp, cfg)
    carry0 = eng.init_carry(cfg)
    old = (jax.config.jax_threefry_partitionable, prng.PARTITIONABLE)
    try:
        jax.config.update("jax_threefry_partitionable", False)
        prng.PARTITIONABLE = False
        carry, outs = eng.run_engine(cfg, model, ev, carry0)
        t_carry, t_outs = _run_block(cfg, model, ev, carry0, 32)
        prng.PARTITIONABLE = True
        _, p_outs = _run_block(cfg, model, ev, carry0, 32)
    finally:
        jax.config.update("jax_threefry_partitionable", old[0])
        prng.PARTITIONABLE = old[1]
    assert float(carry.shed_calls) >= 2
    assert_trees_equal(carry, t_carry, "original layout carry")
    assert_trees_equal(outs, t_outs, "original layout outs")
    assert teng.match_sets(p_outs) != teng.match_sets(t_outs)


@pytest.mark.parametrize("shed_plan,block_shed,w", [
    ("threshold", "replay", 1), ("threshold", "replay", 8),
    ("threshold", "replay", 32), ("sort", "fused", 32)])
@pytest.mark.parametrize("shedder", ("pspice", "pmbl"))
def test_replay_protocol_bitwise(shedder, shed_plan, block_shed, w):
    """The kernel stops at each fire and the per-event step replays it
    (``block_shed="replay"``, and forced by ``shed_plan="sort"``).  W=1
    makes every fire the last valid event of its block."""
    cfg, model, ev, carry0, carry, outs = _reference(
        "q1", shedder, shed_plan=shed_plan)
    assert float(carry.shed_calls) > 0
    bcfg = _block_cfg(cfg, w, block_shed=block_shed)
    assert not kblock.fused_shed(bcfg)
    t_carry, t_outs = teng.run_engine(bcfg, *to_port(model, ev, carry0),
                                      device="cpu")
    assert_trees_equal(carry, t_carry, f"replay {shed_plan} W={w} carry")
    assert_trees_equal(outs, t_outs, f"replay {shed_plan} W={w} outs")


@pytest.mark.parametrize("shedder", SHEDDERS)
def test_block_plain_equals_port_per_event_engine(shedder):
    """The plain block version against the port's per-event ``torch``
    backend (two independent implementations of the operator) on the
    stock patterns, P = 3, with gathered stats and emitted matches."""
    sc = tstreams.get_scenario("stock")
    specs = sc.specs()
    cp = tpat.compile_patterns(specs)
    cfg = trunner.default_config(cp, max_pms=97, latency_bound=0.002,
                                 shedder=shedder, emit_matches=True,
                                 gather_stats=True, **COST)
    raw = sc.raw(n=300)
    rate = 10.0 / (cfg.c_base + cfg.c_match * 30)
    got = {}
    for backend in ("torch", "cuda_block"):
        c = dataclasses.replace(cfg, backend=backend, block_events=32)
        ev = tstreams.classify(specs, raw, rate=rate, seed=1, device="cpu")
        model = teng.make_model(cp, c, device="cpu")
        got[backend] = teng.run_engine(
            c, model, ev, teng.init_carry(c, seed=1, device="cpu"),
            device="cpu")
    ref_c = got["torch"][0]
    if shedder != "none":
        assert float(ref_c.shed_calls) + float(ref_c.ebl_dropped) > 0
    assert_trees_equal(got["torch"], got["cuda_block"], shedder)


def test_run_engine_leaves_the_callers_carry():
    """The kernel updates its carry in place; the engine hands it a
    copy, so the caller's carry is unchanged."""
    cfg, model, ev, carry0, _, _ = _reference("q1", "pspice")
    t_model, t_ev, t_carry = to_port(model, ev, carry0)
    before = convert.tree_to_numpy(t_carry)
    teng.run_engine(_block_cfg(cfg, 32), t_model, t_ev, t_carry,
                    device="cpu")
    assert_trees_equal(before, t_carry, "caller's carry")


# ---------------------------------------------------------------------------
# Algorithm 1 with the lazy inverse
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", [tovl.LINEAR, tovl.NLOGN])
def test_detect_overload_lazy_matches_reference(kind):
    """The port's Algorithm 1 against the reference's with the lazy
    inverse (its block kernel's): bitwise on LINEAR; equal decisions and ρ
    on NLOGN (log2 is not the same function on every platform)."""
    rng = np.random.default_rng(kind)
    a = np.float32(5e-5 if kind == tovl.LINEAR else 5e-6)
    b, ga, gb = np.float32(2e-4), np.float32(1e-6), np.float32(5e-5)
    fm = ovl.LatencyModel(a=jnp.float32(a), b=jnp.float32(b),
                          kind=jnp.int32(kind))
    gm = ovl.LatencyModel(a=jnp.float32(ga), b=jnp.float32(gb),
                          kind=jnp.int32(0))
    tf = tovl.latency_model(float(a), float(b), kind)
    tg = tovl.latency_model(float(ga), float(gb), tovl.LINEAR)
    # Jitted, as the engine runs it: XLA fuses a·basis + b into one FMA.
    ref_fn = jax.jit(lambda lq, n: ovl.detect_overload(fm, gm, lq, n, 0.05,
                                                       lazy=True))
    for _ in range(40):
        l_q = np.float32(rng.random() * 0.05)
        n_pm = int(rng.integers(0, 6000))
        ref = ref_fn(jnp.float32(l_q), jnp.int32(n_pm))
        got = tovl.detect_overload(tf, tg, torch.tensor(l_q),
                                   torch.tensor(n_pm, dtype=torch.int32),
                                   0.05)
        assert bool(got.shed) == bool(ref.shed)
        assert int(got.rho) == int(ref.rho)
        if kind == tovl.LINEAR:
            assert np.float32(got.l_e) == np.asarray(ref.l_e)


@pytest.mark.parametrize("kind", [tovl.LINEAR, tovl.NLOGN])
def test_invert_latency_lazy_equals_eager(kind):
    m = tovl.latency_model(3.7e-5, 1.1e-4, kind)
    t = torch.linspace(0.0, 2.0, 257)
    assert torch.equal(tovl.invert_latency_lazy(m, t),
                       tovl.invert_latency(m, t))


# ---------------------------------------------------------------------------
# Configuration and the wrapper's contract
# ---------------------------------------------------------------------------

def test_config_names_the_block_backend():
    cp = tpat.compile_patterns([pat.make_q1(window_size=400,
                                            num_symbols=4)])
    cfg = trunner.default_config(cp, backend="cuda_block", block_events=8)
    assert cfg.backend == teng.BACKEND_CUDA_BLOCK in teng.BACKENDS
    for bad in (dict(block_events=0), dict(block_shed="x"),
                dict(backend="pallas_block")):
        with pytest.raises(ValueError):
            trunner.default_config(cp, **{"backend": "cuda_block", **bad})
    fused = {(sh, plan, mode): kblock.fused_shed(dataclasses.replace(
        cfg, shedder=sh, shed_plan=plan, block_shed=mode))
        for sh in SHEDDERS for plan in ("threshold", "sort")
        for mode in ("fused", "replay")}
    assert {k for k, v in fused.items() if v} == {
        ("pspice", "threshold", "fused"), ("pmbl", "threshold", "fused")}


def test_block_step_rejects_a_bad_span():
    cfg, model, ev, carry0, _, _ = _reference("q1", "none")
    tcfg = _block_cfg(cfg, 8)
    t_model, t_ev, t_carry = to_port(model, ev, carry0)
    blk = teng.EventBatch(*(x[:8] for x in t_ev))
    with pytest.raises(ValueError, match="n_valid"):
        kblock.block_step(tcfg, t_model, t_carry, blk, 0, 0, 9)
    launches = kblock.block_step.launches
    _, rows, status = kblock.block_step(tcfg, t_model, t_carry, blk, 0, 0, 8)
    assert kblock.block_step.launches == launches, \
        "CPU tensors run the plain version and launch nothing"
    assert status.tolist() == [0, 8] and rows["l_e"].shape == (8,)
