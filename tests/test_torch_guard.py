"""The port's carry guard and the ladder's PM trim (repro_torch.runtime
.guard) against the reference's (repro.runtime.guard).

Bars, all BITWISE:
* the check vectors (one operator and per lane) on a healthy state and
  under each poison, and ``CarryGuard.check``'s violations;
* ``trim_store`` — the port's "torch" backend against the reference's
  ``xla`` trim, "cuda" and "cuda_block" (their kernels' plain versions
  here) against ``pallas_block`` (its kernels in interpret mode) — on
  random stores and tables, pSPICE and PM-BL in both threefry layouts;
  the simulated shed cost over every n_before of a store;
* ``trim_store_lanes`` against each lane's ``trim_store`` and against the
  reference's ``trim_store_lanes``;
* a checkpoint survives the block kernel's in-place chunks, and a
  per-lane restore leaves the other lanes as they were.
"""
import contextlib
import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.cep import engine as eng
from repro.cep import patterns as pat
from repro.cep import runner
from repro.runtime import guard as RGD
from repro.runtime import lanes as RLN
from repro_torch import prng
from repro_torch.cep import convert
from repro_torch.cep import engine as teng
from repro_torch.runtime import guard as TGD
from repro_torch.runtime import lanes as TLN

from _torch_bridge import COST, assert_trees_equal, port_config

@functools.lru_cache(maxsize=None)
def _setup(shedder="pspice", backend="xla", N=64):
    specs = [pat.make_q1(window_size=400, num_symbols=4),
             pat.make_q1(window_size=300, num_symbols=4)]
    cp = pat.compile_patterns(specs)
    cfg = runner.default_config(cp, max_pms=N, shedder=shedder,
                                backend=backend, gather_stats=True, **COST)
    rng = np.random.default_rng(0)
    P, M = cfg.num_patterns, cfg.max_states
    model = eng.make_model(
        cp, cfg, ut_tables=jnp.asarray(rng.random((P, 7, M)).astype(
            np.float32)), ut_bins=jnp.full((P,), 50, jnp.int32))
    return cfg, model


def _store(cfg, rng, seed, fill=None):
    """A carry with a random store (active share ``fill``, states, window
    opens) and clock."""
    P, N, M = cfg.num_patterns, cfg.max_pms, cfg.max_states
    c = eng.init_carry(cfg, seed=seed)
    act = rng.random((P, N)) < (rng.random() if fill is None else fill)
    return c._replace(
        pms=c.pms._replace(
            active=jnp.asarray(act),
            state=jnp.asarray(rng.integers(1, M, (P, N)).astype(np.int32)),
            open_idx=jnp.asarray(rng.integers(0, 900, (P, N)).astype(
                np.int32))),
        sim_time=jnp.float32(rng.random() * 10))


def _port_tree(t):
    f = convert.carry_from_numpy if isinstance(t, eng.Carry) else \
        convert.model_from_numpy
    return f(convert.tree_to_numpy(t), "cpu")


@contextlib.contextmanager
def _layout(partitionable: bool):
    """Both packages' threefry in one layout."""
    old = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", partitionable)
    try:
        with prng.layout(partitionable):
            yield
    finally:
        jax.config.update("jax_threefry_partitionable", old)


# ---------------------------------------------------------------------------
# The PM trim
# ---------------------------------------------------------------------------

# (shedder, reference backend, port backend, threefry layout); pSPICE
# draws nothing, so one layout covers it.
CASES = [("pspice", "xla", "torch", True),
         ("pspice", "pallas_block", "cuda", True),
         ("pspice", "pallas_block", "cuda_block", True)] + [
    ("pmbl", rb, b, part) for rb, b in (("xla", "torch"),
                                        ("pallas_block", "cuda_block"))
    for part in (True, False)]


@pytest.mark.parametrize("shedder,ref_backend,backend,partitionable", CASES)
def test_trim_store_equals_reference(shedder, ref_backend, backend,
                                     partitionable):
    """Random stores and fractions: the whole trimmed carry (mask, key,
    clock, counters) equals the reference's trim on its backend."""
    cfg, model = _setup(shedder, ref_backend)
    tcfg, tm = port_config(cfg, backend), _port_tree(model)
    rng = np.random.default_rng(1)
    with _layout(partitionable):
        for trial in range(6):
            c = _store(cfg, rng, trial)
            frac = float(rng.choice([0.1, 0.25, 0.33, 0.5]))
            want = RGD.trim_store(cfg, model, c, jnp.int32(1000),
                                  jnp.float32(frac))
            got = TGD.trim_store(tcfg, tm, _port_tree(c), 1000, frac)
            assert_trees_equal(want, got,
                               f"{shedder}/{backend} trial {trial}")
            assert float(got.shed_calls) == 1.0


def test_trim_cost_term_equals_reference():
    """The shed cost ``c_shed_base + c_shed_pm · n_before`` (hazard: XLA
    may fuse it) over every n_before of the store, at a zero clock and at
    a random one: a trim of 0 PMs still pays it."""
    cfg, model = _setup()
    tcfg, tm = port_config(cfg, "torch"), _port_tree(model)
    rng = np.random.default_rng(2)
    P, N = cfg.num_patterns, cfg.max_pms
    got, want = [], []
    for n in range(0, P * N + 1, 3):
        flat = np.zeros(P * N, bool)
        flat[rng.permutation(P * N)[:n]] = True
        c = _store(cfg, rng, 0)
        c = c._replace(pms=c.pms._replace(active=jnp.asarray(
            flat.reshape(P, N))), sim_time=jnp.float32(
                0.0 if n % 2 else rng.random()))
        want.append(float(RGD.trim_store(cfg, model, c, jnp.int32(0),
                                         jnp.float32(0.0)).sim_time))
        got.append(float(TGD.trim_store(tcfg, tm, _port_tree(c), 0,
                                        0.0).sim_time))
    assert got == want


@pytest.mark.parametrize("shedder,backend", [("pspice", "cuda_block"),
                                             ("pspice", "torch"),
                                             ("pmbl", "cuda")])
def test_trim_store_lanes_equals_each_lane_and_reference(shedder, backend):
    """Four lanes, each its own store, table, clock and key: the lane
    trim equals each lane's single trim and the reference's vmapped
    trim_store_lanes."""
    ref_backend = "xla" if backend == "torch" else "pallas_block"
    cfg, model = _setup(shedder, ref_backend)
    tcfg = port_config(cfg, backend)
    rng = np.random.default_rng(3)
    L = 4
    carries = [_store(cfg, rng, k, fill=0.2 + 0.2 * k) for k in range(L)]
    models = [model._replace(ut_tables=jnp.asarray(rng.random(
        model.ut_tables.shape).astype(np.float32))) for _ in range(L)]
    rc, rm = RLN.stack(carries), RLN.stack(models)
    want = RGD.trim_store_lanes(cfg, rm, rc, jnp.int32(700),
                                jnp.float32(0.3))
    got = TGD.trim_store_lanes(tcfg, _port_tree(rm), _port_tree(rc), 700,
                               0.3)
    assert_trees_equal(want, got, f"lanes {shedder}/{backend}")
    for k in range(L):
        one = TGD.trim_store(tcfg, _port_tree(models[k]),
                             _port_tree(carries[k]), 700, 0.3)
        assert_trees_equal(one, TLN.unstack_lane(got, k), f"lane {k}")


# ---------------------------------------------------------------------------
# Checks
# ---------------------------------------------------------------------------

def _poisons():
    """(name, carry poison, model poison) — each trips one check."""
    f32 = jnp.float32
    return [
        ("healthy", lambda c: c, lambda m: m),
        ("nan_time", lambda c: c._replace(sim_time=f32(jnp.nan)), None),
        ("zero_gap", lambda c: c._replace(ema_gap=f32(0.0)), None),
        ("inf_ring", lambda c: c._replace(
            lat_samples_l=c.lat_samples_l.at[5].set(jnp.inf)), None),
        ("bad_state", lambda c: c._replace(pms=c.pms._replace(
            state=jnp.where(c.pms.active, 0, c.pms.state))), None),
        ("bad_ptr", lambda c: c._replace(
            ring_ptr=c.ring_ptr.at[0].set(99)), None),
        ("neg_counter", lambda c: c._replace(pms_shed=f32(-1.0)), None),
        ("ebl_frac", lambda c: c._replace(ebl_frac=f32(1.5)), None),
        ("nan_obs", lambda c: c._replace(
            obs_counts=c.obs_counts.at[0, 1, 1].set(jnp.nan)), None),
        ("nan_table", None, lambda m: m._replace(
            ut_tables=m.ut_tables.at[0, 0, 0].set(jnp.nan))),
        ("zero_bins", None, lambda m: m._replace(
            ut_bins=m.ut_bins.at[1].set(0))),
        ("nan_f", None, lambda m: m._replace(f_model=type(m.f_model)(
            a=f32(jnp.nan), b=m.f_model.b, kind=m.f_model.kind))),
        ("inf_proc", None, lambda m: m._replace(
            proc_cost=m.proc_cost.at[0].set(jnp.inf))),
    ]


@pytest.mark.parametrize("name,cp,mp", _poisons(),
                         ids=[p[0] for p in _poisons()])
def test_check_vectors_equal_reference(name, cp, mp):
    cfg, model = _setup()
    c = _store(cfg, np.random.default_rng(4), 0, fill=0.5)
    c, m = (cp or (lambda x: x))(c), (mp or (lambda x: x))(model)
    tc, tm = _port_tree(c), _port_tree(m)
    cv, mv = np.asarray(RGD.carry_check_vec(c)), \
        np.asarray(RGD.model_check_vec(m))
    np.testing.assert_array_equal(TGD.carry_check_vec(tc).numpy(), cv)
    np.testing.assert_array_equal(TGD.model_check_vec(tm).numpy(), mv)
    assert cv.all() and mv.all() if name == "healthy" else \
        not (cv.all() and mv.all())
    # Lane-stacked: the poison in lane 1 of 3 only.
    healthy = _store(cfg, np.random.default_rng(4), 0, fill=0.5)
    rc = RLN.stack([healthy, c, healthy])
    rm = RLN.stack([model, m, model])
    np.testing.assert_array_equal(
        TGD.carry_check_lanes(_port_tree(rc)).numpy(),
        np.asarray(RGD.carry_check_lanes(rc)))
    np.testing.assert_array_equal(
        TGD.model_check_lanes(_port_tree(rm)).numpy(),
        np.asarray(RGD.model_check_lanes(rm)))
    rg, tg = RGD.CarryGuard(RGD.GuardConfig(), lanes=3), \
        TGD.CarryGuard(TGD.GuardConfig(), lanes=3)
    assert [v.to_row() for v in tg.check(_port_tree(rc), _port_tree(rm))] \
        == [v.to_row() for v in rg.check(rc, rm)]


# ---------------------------------------------------------------------------
# Checkpoints
# ---------------------------------------------------------------------------

def _events(cfg, n, seed):
    from repro.data import streams
    specs = [pat.make_q1(window_size=400, num_symbols=4),
             pat.make_q1(window_size=300, num_symbols=4)]
    raw = streams.gen_stock(n, num_symbols=50, pattern_symbols=4,
                            p_class=0.05, seed=seed)
    ev = streams.classify(specs, raw, rate=3.0 / (cfg.c_base + cfg.c_match
                                                  * 0.3 * cfg.max_pms),
                          seed=seed)
    return convert.events_from_numpy(convert.tree_to_numpy(ev), "cpu")


def test_checkpoint_survives_in_place_chunks():
    """The block kernel path updates the runtime's carry in place (the
    port's donation); a checkpoint taken before two such chunks still
    holds the state it saved, bit for bit, and restores it."""
    cfg, model = _setup()
    tcfg = port_config(cfg, "cuda_block")
    tm = _port_tree(model)
    carry = teng.init_carry(tcfg, device="cpu")
    ev = _events(cfg, 256, 5)
    carry, _ = teng._scan_events_backend(
        tcfg, tm, teng.EventBatch(*(x[:128] for x in ev)), carry, 0,
        own=True)
    # A host copy (a CPU tensor's .numpy() would share its storage).
    saved = copy.deepcopy(convert.tree_to_numpy(carry))
    guard = TGD.CarryGuard(TGD.GuardConfig())
    guard.save(carry, tm, chunk_i=1)
    live_active = carry.pms.active
    carry2, _ = teng._scan_events_backend(
        tcfg, tm, teng.EventBatch(*(x[128:] for x in ev)), carry, 128,
        own=True)
    assert carry2.pms.active.data_ptr() == live_active.data_ptr(), \
        "the chunk is expected to write the carry in place"
    assert not np.array_equal(carry2.sim_time.numpy(), saved["sim_time"])
    assert_trees_equal(saved, guard.checkpoint[0], "checkpoint")
    back, _ = guard.restore(carry2, tm)
    assert_trees_equal(saved, back, "restored")


def test_lane_restore_leaves_neighbors_bitwise():
    """Restoring lanes 0 and 2 of 4 rewinds exactly those lanes (carry
    and model) to the checkpoint; lanes 1 and 3 keep their live state."""
    cfg, model = _setup()
    tcfg = port_config(cfg, "torch")
    L = 4
    tm = TLN.broadcast_model(_port_tree(model), L)
    carry = TLN.init_lane_carries(tcfg, L, device="cpu")
    guard = TGD.CarryGuard(TGD.GuardConfig(), lanes=L)
    guard.save(carry, tm, chunk_i=0)
    ev = TLN.stack([_events(cfg, 200, 10 + k) for k in range(L)])
    live, _ = teng._scan_events_lanes(tcfg, tm, ev, carry, 0)
    live_np = copy.deepcopy(convert.tree_to_numpy(live))
    bad_m = tm._replace(ut_tables=tm.ut_tables.clone().fill_(float("nan")))
    c, m = guard.restore(live, bad_m, lanes=[0, 2])
    ck = convert.tree_to_numpy(guard.checkpoint[0])
    for k in range(L):
        want = ck if k in (0, 2) else live_np
        assert_trees_equal(
            {name: np.asarray(v)[k] for name, v in _flat_items(want)},
            {name: np.asarray(v)[k] for name, v in
             _flat_items(convert.tree_to_numpy(c))}, f"lane {k}")
    assert torch.isfinite(m.ut_tables[[0, 2]]).all()
    assert torch.isnan(m.ut_tables[[1, 3]]).all()
    assert torch.isnan(bad_m.ut_tables).all(), "the caller's model is kept"


def _flat_items(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat_items(v, f"{path}.{k}")
    else:
        yield path, tree


def test_guard_config_validation_equals_reference():
    for kw in (dict(check_every_chunks=0), dict(checkpoint_every_chunks=0),
               dict(quarantine_offers=-1)):
        with pytest.raises(ValueError) as want:
            RGD.GuardConfig(**kw)
        with pytest.raises(ValueError) as got:
            TGD.GuardConfig(**kw)
        assert str(got.value) == str(want.value)
