"""The port's streaming runtime against the reference's (repro.runtime):
chunking, telemetry, refresh and the two runtimes, on a small shedding
stream (Q1 over 4 symbols, N = 48, a 5 ms bound), inputs made by the
reference and handed to both through NumPy.

Bars, per test: BITWISE where the computation is the engine's or a
copy (chunked and grouped runs vs the monolithic scan, lanes, stats
vectors, ChunkStats rows but their walls, the latency refit, the
refresh gates' decisions); the model builder's tolerance of
tests/test_torch_core.py (rtol 1e-5, atol 1e-7) for refreshed utility
tables, whose matrix powers sum in another order.
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
from repro.data import streams
from repro import runtime as RT
from repro.runtime import telemetry as RTM
from repro_torch import runtime as TRT
from repro_torch.cep import convert
from repro_torch.cep import engine as teng
from repro_torch.runtime import chunker as tchunker
from repro_torch.runtime import telemetry as TTM

from _torch_bridge import COST, assert_trees_equal, port_config, to_port

N_EVENTS = 1000
RTOL, ATOL = 1e-5, 1e-7
WALLS = ("wall_s", "events_per_s", "refresh_wall_s")


@functools.lru_cache(maxsize=None)
def _setup():
    specs = [pat.make_q1(window_size=400, num_symbols=4)]
    cp = pat.compile_patterns(specs)
    cfg = runner.default_config(cp, max_pms=48, latency_bound=0.005,
                                gather_stats=True, shedder=eng.SHED_PSPICE,
                                **COST)
    model = eng.make_model(cp, cfg)
    return specs, cfg, model


@functools.lru_cache(maxsize=None)
def _events(seed=0, rate_mult=1.0, n=N_EVENTS):
    specs, cfg, _ = _setup()
    rate = 3.0 / (cfg.c_base + cfg.c_match * 0.3 * cfg.max_pms)
    raw = streams.gen_stock(n, num_symbols=50, pattern_symbols=4,
                            p_class=0.05, seed=100 + seed)
    return streams.classify(specs, raw, rate=rate * rate_mult, seed=seed)


@functools.lru_cache(maxsize=None)
def _mono(seed=0, n=N_EVENTS):
    """The reference's monolithic run (carry, outs) as NumPy trees."""
    _, cfg, model = _setup()
    c, o = eng.run_engine(cfg, model, _events(seed, n=n),
                          eng.init_carry(cfg))
    return convert.tree_to_numpy(c), convert.tree_to_numpy(o)


def _port(backend="torch", seed=0, n=N_EVENTS):
    """(cfg, model, events, carry0) of the port on the CPU."""
    _, cfg, model = _setup()
    m, e, c = to_port(model, _events(seed, n=n), eng.init_carry(cfg))
    return port_config(cfg, backend), m, e, c


def _rows(log):
    return [{k: v for k, v in r.items() if k not in WALLS}
            for r in log.rows()]


# ---------------------------------------------------------------------------
# Chunked and grouped execution
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("chunk", [64, 100, 256, N_EVENTS])
def test_chunked_bitwise_equals_reference_monolithic(chunk):
    """Bar: bit for bit — chunks (non-divisors included) through
    ``run_engine_chunk`` with global starts replay the reference's
    monolithic scan."""
    ref_c, ref_o = _mono()
    assert float(ref_c["pms_shed"]) > 0, "fixture must actually shed"
    cfg, m, ev, carry = _port()
    outs = []
    for start, piece in TRT.iter_chunks(ev, chunk):
        carry, o = teng.run_engine_chunk(cfg, m, piece, carry, start,
                                         device="cpu")
        outs.append(o)
    o_cat = teng.StepOut(*(torch.cat(xs) for xs in zip(*outs)))
    assert_trees_equal(ref_c, carry, f"carry, chunk={chunk}")
    assert_trees_equal(ref_o, o_cat, f"outs, chunk={chunk}")


@pytest.mark.parametrize("backend", ["torch", "cuda_block"])
def test_stream_runtime_ragged_pushes(backend):
    """Bar: bit for bit — pushes of 700 re-chunk at 256 (groups of 3);
    flush drains the tail; the carry is the reference's monolithic one."""
    ref_c, _ = _mono()
    cfg, m, ev, _ = _port(backend)
    srt = TRT.StreamRuntime(cfg, m, rt=TRT.RuntimeConfig(chunk_size=256,
                                                         group_chunks=3),
                            device="cpu")
    for s in range(0, N_EVENTS, 700):
        srt.push(TRT.slice_events(ev, s, min(s + 700, N_EVENTS)))
    srt.flush()
    assert_trees_equal(ref_c, srt.carry, f"ragged pushes ({backend})")
    assert srt.events_processed == N_EVENTS


def test_stream_runtime_stats_rows_equal_reference():
    """Bar: every ChunkStats field but the walls equals the reference's
    StreamRuntime on the same stream, grouped (chunk 128, groups of 3)
    with a ragged tail."""
    _, cfg, model = _setup()
    rt = dict(chunk_size=128, group_chunks=3)
    ref = RT.StreamRuntime(cfg, model, rt=RT.RuntimeConfig(**rt))
    ref.push(_events(), flush=True)
    tcfg, m, ev, _ = _port()
    srt = TRT.StreamRuntime(tcfg, m, rt=TRT.RuntimeConfig(**rt),
                            device="cpu")
    stats = srt.push(ev, flush=True)
    assert [s.n_events for s in stats] == [128] * 7 + [104]
    assert _rows(srt.telemetry) == _rows(ref.telemetry)
    assert srt.telemetry.aggregate()["pms_shed"] == \
        ref.telemetry.aggregate()["pms_shed"] > 0


def _lanes_ref(L=3):
    _, cfg, model = _setup()
    evs = [_events(i, 1.0 + 0.2 * i) for i in range(L)]
    return cfg, RT.stack(evs), RT.broadcast_model(model, L)


@pytest.mark.parametrize("backend", ["torch", "cuda_block"])
def test_multitenant_runtime_equals_reference(backend):
    """Bar: bit for bit — the port's MultiTenantRuntime (chunk 256,
    groups of 2) equals the reference's lane scan in every carry leaf,
    and its ChunkStats rows equal the reference's MultiTenantRuntime's but
    for the walls."""
    cfg, evL, mL = _lanes_ref()
    rt = dict(chunk_size=256, group_chunks=2)
    ref = RT.MultiTenantRuntime(cfg, mL, num_lanes=3,
                                rt=RT.RuntimeConfig(**rt))
    ref.push(evL, flush=True)
    tm, te, _ = to_port(mL, evL, eng.init_carry(cfg))
    mt = TRT.MultiTenantRuntime(port_config(cfg, backend), tm, 3,
                                rt=TRT.RuntimeConfig(**rt), device="cpu")
    mt.push(te, flush=True)
    assert_trees_equal(ref.carry, mt.carry, f"runtime carry ({backend})")
    assert _rows(mt.telemetry) == _rows(ref.telemetry)
    assert mt.events_processed == 3 * N_EVENTS
    assert_trees_equal(eng.merge_carries(ref.carry), mt.merged_carry(),
                       "merged carry")


def test_multitenant_refresh_equals_per_lane_stream_runtime():
    """Bar: bit for bit — with per-lane refresh every 2 chunks, lane i of
    the MultiTenantRuntime equals the port's StreamRuntime run on lane
    i's stream alone (carry, model and refresh counters)."""
    specs, cfg, model = _setup()
    L = 3
    tcfg = port_config(cfg, "torch")
    tm = to_port(model, _events(), eng.init_carry(cfg))[0]
    evs = [to_port(model, _events(i, 1.0 + 0.3 * i), eng.init_carry(cfg))[1]
           for i in range(L)]
    rt = TRT.RuntimeConfig(chunk_size=200, group_chunks=3,
                           refresh=TRT.RefreshConfig(every_chunks=2,
                                                     min_observations=64.0,
                                                     decay=0.5))
    mt = TRT.MultiTenantRuntime(tcfg, TRT.broadcast_model(tm, L), L, rt=rt,
                                specs=specs, device="cpu")
    for s in range(0, N_EVENTS, 333):
        mt.push(TRT.stack([TRT.slice_events(e, s, min(s + 333, N_EVENTS))
                           for e in evs]))
    mt.flush()
    assert sum(s.refresh_count for s in mt.refresh_state) >= L
    for i in range(L):
        srt = TRT.StreamRuntime(tcfg, tm, rt=rt, specs=specs, seed=i,
                                device="cpu")
        srt.push(evs[i], flush=True)
        assert_trees_equal(srt.carry, TRT.unstack_lane(mt.carry, i),
                           f"lane {i} carry")
        assert_trees_equal(srt.model, TRT.unstack_lane(mt.model, i),
                           f"lane {i} model")
        assert dataclasses.astuple(srt.refresh_state)[1:] == \
            dataclasses.astuple(mt.refresh_state[i])[1:]


# ---------------------------------------------------------------------------
# ChunkBuffer
# ---------------------------------------------------------------------------

def _ev(n, tag=0):
    return teng.EventBatch(
        ev_class=torch.full((n, 1), tag, dtype=torch.int32),
        ev_bind=torch.zeros((n, 1), dtype=torch.int32),
        ev_open=torch.zeros((n, 1), dtype=torch.bool),
        ev_id=torch.arange(n, dtype=torch.int32),
        ev_rand=torch.zeros((n,)), ebl_raw=torch.zeros((n,)),
        arrival=torch.arange(n, dtype=torch.float32))


def test_ragged_pushes_rechunk():
    buf = TRT.ChunkBuffer(64)
    got = buf.push(_ev(100))
    assert [(s, TRT.num_events(e)) for s, e in got] == [(0, 64)]
    assert buf.pending == 36
    got = buf.push(_ev(100))
    assert [(s, TRT.num_events(e)) for s, e in got] == [(64, 64), (128, 64)]
    assert got[1][1].ev_id.tolist() == list(range(28, 92))
    got = buf.drain()
    assert [(s, TRT.num_events(e)) for s, e in got] == [(192, 8)]
    assert buf.pending == 0 and buf.drain() == []


def test_lane_stacked_axis():
    buf = TRT.ChunkBuffer(32, axis=1)
    evL = TRT.stack([_ev(50), _ev(50, tag=1)])
    (start, piece), = buf.push(evL)
    assert start == 0 and piece.ev_class.shape == (2, 32, 1)
    assert piece.ev_class[1].unique().tolist() == [1]
    (start, piece), = buf.drain()
    assert start == 32 and piece.ev_class.shape == (2, 18, 1)


def _shares(a, b):
    """True when tensors a and b share storage."""
    return a.untyped_storage().data_ptr() == b.untyped_storage().data_ptr()


def test_outputs_never_alias_pushed_batch():
    """A PyTorch slice is a view: the buffer must copy, so nothing it hands
    out (a chunk-multiple region, a drained tail, a pushed chunk) shares
    storage with the caller's batch."""
    ev = _ev(64)
    _, region, n = TRT.ChunkBuffer(64).push_region(ev)
    assert n == 1
    assert not any(_shares(a, b) for a, b in zip(region, ev))
    buf = TRT.ChunkBuffer(64)
    tail_in = _ev(10)
    assert buf.push_region(tail_in)[2] == 0
    (_, tail), = buf.drain()
    assert not any(_shares(a, b) for a, b in zip(tail, tail_in))
    (_, piece), = TRT.ChunkBuffer(64).push(ev)
    assert not any(_shares(a, b) for a, b in zip(piece, ev))
    assert not any(_shares(a, b) for a, b in
                   zip(TRT.slice_events(ev, 0, 64), ev))


def test_zero_length_push():
    """An empty push is a no-op at every buffer state."""
    buf = TRT.ChunkBuffer(64)
    start, region, n = buf.push_region(_ev(0))
    assert (start, region, n) == (0, None, 0) and buf.pending == 0
    assert buf.push(_ev(0)) == [] and buf.drain() == []
    buf.push(_ev(50))
    assert buf.push(_ev(0)) == [] and buf.pending == 50
    got = buf.push(_ev(30))
    assert [(s, TRT.num_events(e)) for s, e in got] == [(0, 64)]
    assert buf.pending == 16


def test_zero_length_push_through_runtime():
    """Bar: bit for bit — empty pushes return no stats and do not perturb
    the stream."""
    ref_c, _ = _mono()
    cfg, m, ev, _ = _port()
    srt = TRT.StreamRuntime(cfg, m, rt=TRT.RuntimeConfig(chunk_size=256),
                            device="cpu")
    assert srt.push(TRT.slice_events(ev, 0, 0)) == []
    srt.push(ev)
    assert srt.push(TRT.slice_events(ev, 0, 0)) == []
    srt.flush()
    assert_trees_equal(ref_c, srt.carry, "empty pushes interleaved")


def test_push_larger_than_one_group():
    """Bar: bit for bit — one push of 8 chunks at group_chunks=3 runs as
    groups of 3/3/2 and equals the monolithic scan."""
    ref_c, _ = _mono()
    cfg, m, ev, _ = _port()
    srt = TRT.StreamRuntime(cfg, m, rt=TRT.RuntimeConfig(
        chunk_size=125, group_chunks=3), device="cpu")
    stats = srt.push(ev, flush=True)
    assert len(stats) == 8
    assert_trees_equal(ref_c, srt.carry, "one push, many groups")


def test_ragged_pushes_interleaved_with_refresh_boundaries():
    """Bar: bit for bit — grouped dispatch with ragged pushes truncates
    groups at refresh boundaries, so it refreshes on the same chunks and
    ends in the same state as chunk-at-a-time execution."""
    specs, cfg, model = _setup()
    tcfg, m, ev, _ = _port()
    rcfg = TRT.RefreshConfig(every_chunks=3, min_observations=64.0)

    def run(group_chunks, sizes):
        srt = TRT.StreamRuntime(
            tcfg, m, specs=specs, device="cpu",
            rt=TRT.RuntimeConfig(chunk_size=100, refresh=rcfg,
                                 group_chunks=group_chunks))
        s = 0
        for sz in sizes:
            srt.push(TRT.slice_events(ev, s, min(s + sz, N_EVENTS)))
            s += sz
        srt.flush()
        return srt

    grouped = run(4, [130, 270, 400, 57, 143])
    serial = run(1, [N_EVENTS])
    assert_trees_equal(serial.carry, grouped.carry, "grouped vs serial")
    assert [c.refreshed for c in grouped.telemetry.chunks] \
        == [c.refreshed for c in serial.telemetry.chunks]
    assert grouped.refresh_state.refresh_count \
        == serial.refresh_state.refresh_count > 0


@pytest.mark.parametrize("chunk,expect", [
    (256, 32), (512, 16), (513, 15), (767, 10), (1023, 8), (1024, 16),
    (4096, 16)])
def test_group_budget_boundary_sizes(chunk, expect):
    assert tchunker.suggested_group_chunks(chunk) == expect


def test_group_budget_is_a_cap_and_equals_reference():
    budget = tchunker.GROUP_EVENT_BUDGET
    assert budget == RT.chunker.GROUP_EVENT_BUDGET == 8192
    for chunk in range(1, 4100):
        g = tchunker.suggested_group_chunks(chunk)
        assert g == RT.chunker.suggested_group_chunks(chunk)
        assert g >= 1 and (chunk >= 1024 or chunk * g <= budget)
    with pytest.raises(ValueError):
        tchunker.suggested_group_chunks(0)


# ---------------------------------------------------------------------------
# Telemetry
# ---------------------------------------------------------------------------

def _stats_pair(outs, carry):
    ref = np.asarray(RTM.device_chunk_stats(outs, carry))
    port = TTM.device_chunk_stats(
        teng.StepOut(*(torch.from_numpy(np.array(x)) for x in outs)),
        convert.carry_from_numpy(convert.tree_to_numpy(carry), "cpu"))
    return ref, port.numpy()


@pytest.mark.parametrize("k", [0, 1, 2, 3, 17, N_EVENTS])
def test_stats_vector_equals_reference(k):
    """Bar: bit for bit, every slot of the (11,) vector on the first k
    events of a run (k = 0: the empty chunk's zeros)."""
    _, cfg, model = _setup()
    carry, outs = eng.run_engine(cfg, model, _events(), eng.init_carry(cfg))
    ref, port = _stats_pair(jax.tree.map(lambda x: x[:k], outs), carry)
    assert port.dtype == np.float32 and port.shape == (11,)
    np.testing.assert_array_equal(port, ref)


def test_stats_vector_equals_reference_on_lanes():
    """Bar: bit for bit on a lane-stacked StepOut and carry (quantiles
    over every lane's events, counters summed over lanes)."""
    cfg, evL, mL = _lanes_ref()
    cL, oL = RT.run_chunk_lanes(cfg, mL, evL, RT.init_lane_carries(cfg, 3),
                                jnp.int32(0))
    ref, port = _stats_pair(jax.tree.map(lambda x: x[:, :300], oL), cL)
    np.testing.assert_array_equal(port, ref)


def test_quantiles_bitwise_jnp_and_torch_quantile_is_not():
    """Bar: bit for bit with jnp.quantile (jitted, linear) on 280 random
    vectors of 1 to 2999 elements; torch.quantile, which interpolates
    with torch.lerp, differs from it on some of them (why the port does
    not use it)."""
    rng = np.random.default_rng(0)
    jq = jax.jit(lambda x: jnp.quantile(x, jnp.array([0.5, 0.99],
                                                     x.dtype)))
    lerp_differs = 0
    for n in [1, 2, 3, 7, 100, 1024, 2999] * 40:
        x = (rng.random(n) *
             rng.choice([1e-4, 1e-2, 1.0, 30.0])).astype(np.float32)
        want = np.asarray(jq(x))
        t = torch.from_numpy(x)
        np.testing.assert_array_equal(TTM.quantiles(t).numpy(), want)
        lerp_differs += not np.array_equal(
            torch.quantile(t, torch.tensor([0.5, 0.99])).numpy(), want)
    assert lerp_differs > 0
    nan = torch.tensor([1.0, float("nan"), 2.0])
    assert torch.isnan(TTM.quantiles(nan)).all()


def test_chunk_stats_consistent():
    cfg, m, ev, _ = _port()
    srt = TRT.StreamRuntime(cfg, m, rt=TRT.RuntimeConfig(chunk_size=256),
                            device="cpu")
    stats = srt.push(ev, flush=True)
    assert [s.n_events for s in stats] == [256, 256, 256, 232]
    assert [s.start for s in stats] == [0, 256, 512, 768]
    for s in stats:
        assert s.events_per_s > 0 and s.l_e_p99 >= s.l_e_p50
    agg = srt.telemetry.aggregate()
    assert agg["n_events"] == N_EVENTS
    assert agg["pms_shed"] == float(srt.carry.pms_shed)
    assert agg["completions"] == float(srt.carry.complex_count.sum())


def test_grouped_dispatch_and_ragged_tail_quantiles():
    """Grouped chunks and a 2-event tail: each chunk's p50/p99 equals
    NumPy's percentiles over exactly its events (rtol 1e-6, NumPy's
    interpolation rounds in float64)."""
    n = 4 * 128 + 2
    ev = _port(n=n)[2]
    cfg, m, _, _ = _port()
    _, o_mono = _mono(n=n)
    l_e = np.asarray(o_mono["l_e"])
    srt = TRT.StreamRuntime(cfg, m, rt=TRT.RuntimeConfig(
        chunk_size=128, group_chunks=4), device="cpu")
    stats = srt.push(ev, flush=True)
    assert [s.n_events for s in stats] == [128] * 4 + [2]
    for s in stats:
        span = l_e[s.start:s.start + s.n_events]
        np.testing.assert_allclose(s.l_e_p50, np.percentile(span, 50),
                                   rtol=1e-6)
        np.testing.assert_allclose(s.l_e_p99, np.percentile(span, 99),
                                   rtol=1e-6)


def test_telemetry_log_json_round_trip():
    cfg, m, ev, _ = _port()
    srt = TRT.StreamRuntime(cfg, m, rt=TRT.RuntimeConfig(chunk_size=300),
                            device="cpu")
    srt.push(ev, flush=True)
    log = srt.telemetry
    log.record_event("note", 1, {"x": 1})
    back = TTM.TelemetryLog.from_json(log.to_json())
    assert back.rows() == log.rows() and back.event_rows() == \
        log.event_rows()
    assert back.aggregate() == log.aggregate()
    assert TTM.TelemetryLog().aggregate() == {"n_chunks": 0, "n_events": 0,
                                              "events_per_s": 0.0}
    assert list(TTM._VEC_FIELDS) == list(RTM._VEC_FIELDS)
    assert [f.name for f in dataclasses.fields(TTM.ChunkStats)] == \
        [f.name for f in dataclasses.fields(RTM.ChunkStats)]


# ---------------------------------------------------------------------------
# Refresh
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _gathered(seed=0):
    """A carry that gathered observations (reference run, NumPy tree) on
    a refresh-widened model."""
    specs, cfg, model = _setup()
    rcfg = RT.RefreshConfig(every_chunks=2, min_observations=64.0)
    model_w = RT.prepare_model(specs, model, rcfg)
    carry, _ = eng.run_engine(cfg, model_w, _events(seed),
                              eng.init_carry(cfg))
    return model_w, convert.tree_to_numpy(carry)


def _both_refresh(rcfg_kw, carry_np=None, twice=False):
    specs, cfg, _ = _setup()
    model_w, c_np = _gathered()
    c_np = c_np if carry_np is None else carry_np
    out = []
    for pkg, conv in ((RT, None), (TRT, "cpu")):
        rcfg, state = pkg.RefreshConfig(**rcfg_kw), pkg.RefreshState()
        if conv is None:
            m = model_w
            c = jax.tree.map(jnp.asarray, _ref_carry(c_np))
            c_cfg = cfg
        else:
            m = convert.model_from_numpy(convert.tree_to_numpy(model_w), conv)
            c = convert.carry_from_numpy(c_np, conv)
            c_cfg = port_config(cfg, "torch")
        res = [pkg.refresh_model(specs, c_cfg, m, c, rcfg, state)]
        if twice:
            res.append(pkg.refresh_model(specs, c_cfg, m, c, rcfg, state))
        out.append((res, state))
    return out


def _ref_carry(c_np):
    pms = eng.PMStore(**{k: c_np["pms"][k] for k in eng.PMStore._fields})
    return eng.Carry(pms=pms, **{k: c_np[k] for k in eng.Carry._fields
                                 if k != "pms"})


def _counters(state):
    return (state.refresh_count, state.skipped_drift, state.skipped_obs,
            state.skipped_nonfinite)


def test_refresh_tables_and_latency_refit_equal_reference():
    """Bars: the same decision; the refitted f bit for bit (its sums go
    through overload.xla_sum); the utility tables within the model
    builder's tolerance; shapes unchanged; obs decayed bit for bit."""
    (ref, rs), (port, ps) = _both_refresh(dict(min_observations=64.0,
                                               decay=0.5))
    (rm, rc, rdid), = ref
    (pm, pc, pdid), = port
    assert rdid and pdid and _counters(rs) == _counters(ps) == (1, 0, 0, 0)
    for f in ("a", "b", "kind"):
        np.testing.assert_array_equal(getattr(pm.f_model, f).numpy(),
                                      np.asarray(getattr(rm.f_model, f)))
    assert tuple(pm.ut_tables.shape) == rm.ut_tables.shape
    np.testing.assert_allclose(pm.ut_tables.numpy(),
                               np.asarray(rm.ut_tables), RTOL, ATOL)
    np.testing.assert_array_equal(pm.ut_bins.numpy(), np.asarray(rm.ut_bins))
    np.testing.assert_array_equal(pc.obs_counts.numpy(),
                                  np.asarray(rc.obs_counts))
    np.testing.assert_array_equal(pc.obs_rewards.numpy(),
                                  np.asarray(rc.obs_rewards))
    np.testing.assert_allclose(ps.last_T, rs.last_T, RTOL, ATOL)


@pytest.mark.parametrize("gate", ["obs", "drift", "nonfinite"])
def test_refresh_gates_decide_as_reference(gate):
    """Bar: the same decisions and skip counters as the reference's, for
    the NaN gate (checked first), the min-observation gate and the drift
    gate."""
    _, c_np = _gathered()
    if gate == "obs":
        kw, twice, c = dict(min_observations=1e12), False, None
    elif gate == "drift":
        kw, twice, c = dict(min_observations=64.0, drift_threshold=1e9), \
            True, None
    else:
        c = dict(c_np, obs_counts=np.where(
            np.arange(c_np["obs_counts"].size).reshape(
                c_np["obs_counts"].shape) == 5, np.nan,
            c_np["obs_counts"]).astype(np.float32))
        # NaN and too few observations: the NaN gate must decide.
        kw, twice = dict(min_observations=1e12), False
    (ref, rs), (port, ps) = _both_refresh(kw, c, twice)
    assert [r[2] for r in ref] == [p[2] for p in port]
    assert _counters(rs) == _counters(ps)
    want = {"obs": (0, 0, 1, 0), "drift": (1, 1, 0, 0),
            "nonfinite": (0, 0, 0, 1)}[gate]
    assert _counters(ps) == want


def test_prepare_model_equals_reference():
    """Bar: bit for bit (edge-replicated bins), single and lane-stacked;
    a model already wide enough is returned as it is."""
    specs, cfg, model = _setup()
    rcfg = RT.RefreshConfig()
    tm = to_port(model, _events(), eng.init_carry(cfg))[0]
    for ref_m, port_m in ((model, tm),
                          (RT.broadcast_model(model, 2),
                           TRT.broadcast_model(tm, 2))):
        want = RT.prepare_model(specs, ref_m, rcfg).ut_tables
        got = TRT.prepare_model(specs, port_m, TRT.RefreshConfig())
        np.testing.assert_array_equal(got.ut_tables.numpy(),
                                      np.asarray(want))
        assert TRT.prepare_model(specs, got, TRT.RefreshConfig()) is got
    assert TRT.table_width(specs, 64) == RT.table_width(specs, 64) == 7


def test_refit_handles_wrapped_lat_ptr():
    """Bar: bit for bit with the reference's refit on a ring whose pointer
    wrapped negative (every slot valid)."""
    _, cfg, _ = _setup()
    kw = dict(lat_ptr=np.int32(-100),
              lat_samples_n=np.arange(64, dtype=np.float32),
              lat_samples_l=np.arange(64, dtype=np.float32) * 1e-4)
    ref = RT.refit_latency_model(eng.init_carry(cfg, lat_capacity=64)
                                 ._replace(**{k: jnp.asarray(v)
                                              for k, v in kw.items()}))
    c = teng.init_carry(port_config(cfg, "torch"), lat_capacity=64,
                        device="cpu")
    got = TRT.refit_latency_model(c._replace(
        **{k: torch.tensor(v) for k, v in kw.items()}))
    assert np.isfinite(float(got.a)) and float(got.a) > 0
    for f in ("a", "b", "kind"):
        assert getattr(got, f).item() == np.asarray(getattr(ref, f)).item()


def test_runtime_refreshes_on_cadence_and_state_round_trips():
    specs, cfg, model = _setup()
    tcfg, m, ev, _ = _port()
    srt = TRT.StreamRuntime(tcfg, m, specs=specs, device="cpu",
                            rt=TRT.RuntimeConfig(chunk_size=250,
                                                 refresh=TRT.RefreshConfig(
                                                     every_chunks=2,
                                                     min_observations=64.0)))
    srt.push(ev, flush=True)
    st = srt.refresh_state
    assert st.refresh_count >= 1
    assert srt.telemetry.aggregate()["refreshes"] == st.refresh_count
    back = TRT.RefreshState.from_control(st.to_control())
    np.testing.assert_array_equal(back.last_T, st.last_T)
    assert _counters(back) == _counters(st)


def test_refresh_requires_gather_stats_and_specs():
    specs, cfg, _ = _setup()
    tcfg, m, _, _ = _port()
    rt = TRT.RuntimeConfig(refresh=TRT.RefreshConfig())
    with pytest.raises(ValueError, match="gather_stats"):
        TRT.StreamRuntime(dataclasses.replace(tcfg, gather_stats=False), m,
                          specs=specs, rt=rt, device="cpu")
    with pytest.raises(ValueError, match="PatternSpec"):
        TRT.StreamRuntime(tcfg, m, rt=rt, device="cpu")


# ---------------------------------------------------------------------------
# What the runtime refuses, and devices
# ---------------------------------------------------------------------------

_BAD_KNOB = {
    "ingest": ("IngestConfig", dict(max_queue_events=8, high_watermark=16)),
    "ladder": ("LadderConfig", dict(trim_frac=1.5)),
    "guard": ("GuardConfig", dict(check_every_chunks=0)),
    "persist": ("PersistConfig", dict(dir="")),
}


@pytest.mark.parametrize("knob", ["ingest", "ladder", "guard", "persist"])
def test_resilience_and_persistence_knobs_are_refused(knob):
    """An invalid setting of each resilience/persistence knob is refused
    with the reference's message; a ladder that needs admission without
    an ingest front-end is refused by RuntimeConfig, as in the
    reference."""
    cls, kw = _BAD_KNOB[knob]
    with pytest.raises(ValueError) as want:
        getattr(RT, cls)(**kw)
    with pytest.raises(ValueError) as got:
        getattr(TRT, cls)(**kw)
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="ingest front-end"):
        TRT.RuntimeConfig(ladder=TRT.LadderConfig())


def test_mesh_is_refused():
    cfg, m, _, _ = _port()
    with pytest.raises(NotImplementedError, match="item 4"):
        TRT.MultiTenantRuntime(cfg, TRT.broadcast_model(m, 2), 2,
                               mesh=object(), device="cpu")


def test_runtimes_run_on_cuda_unless_asked_for_the_cpu():
    """No silent CPU fallback: without a card the default device raises,
    and a model on another device than the runtime's is refused."""
    if torch.cuda.is_available():
        pytest.skip("the no-card behaviour needs a machine without CUDA")
    cfg, m, _, _ = _port()
    with pytest.raises(RuntimeError, match="CUDA"):
        TRT.StreamRuntime(cfg, m)
    with pytest.raises(RuntimeError, match="CUDA"):
        TRT.init_lane_carries(cfg, 2)
