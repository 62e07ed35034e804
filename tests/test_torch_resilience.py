"""The port's resilient runtimes (ingest, degradation ladder, carry guard
in repro_torch.runtime.service) against the reference's (repro.runtime),
under the same seeded fault schedule, on a small shedding stream (Q1
over 4 symbols, N = 48, a 5 ms bound, chunk 128, pushes of 512).

Bars, per test:
* BITWISE — telemetry rows but their walls, the runtime events
  (admission, ladder, guard violations and restores), the ladder's
  transitions, the guard's and the admission's counters and the final
  carry equal the reference's ``xla`` runtime (the port on "torch");
  refreshed utility tables within the model builder's tolerance
  (rtol 1e-5, atol 1e-7, as tests/test_torch_runtime.py), every other
  model leaf bit for bit;
* BITWISE — resilience that is off, or configured and never triggered,
  leaves the chunked runtime equal to one monolithic ``run_engine`` on
  every backend ("torch", "cuda", "cuda_block": their kernels' plain
  versions here);
* the ladder's state machine makes the reference's transitions.
"""
import functools

import numpy as np
import pytest

from repro import runtime as RT
from repro.cep import engine as eng
from repro.cep import patterns as pat
from repro.cep import runner
from repro.data import streams
from repro_torch import runtime as TRT
from repro_torch.cep import convert
from repro_torch.cep import engine as teng

from _torch_bridge import COST, assert_trees_equal, port_config, to_port

N_EVENTS, CHUNK, PUSH = 2048, 128, 512
RTOL, ATOL = 1e-5, 1e-7
WALLS = ("wall_s", "events_per_s", "refresh_wall_s")


@functools.lru_cache(maxsize=None)
def _setup(max_pms=48):
    specs = [pat.make_q1(window_size=400, num_symbols=4)]
    cp = pat.compile_patterns(specs)
    cfg = runner.default_config(cp, max_pms=max_pms, latency_bound=0.005,
                                gather_stats=True, shedder=eng.SHED_PSPICE,
                                **COST)
    return specs, cfg, eng.make_model(cp, cfg)


@functools.lru_cache(maxsize=None)
def _events(seed=0, rate_mult=1.0, n=N_EVENTS):
    specs, cfg, _ = _setup()
    # At about the sustainable rate: the clean cell stays mostly under
    # the ladder's bound, so escalation in fault cells comes from faults.
    rate = rate_mult / (cfg.c_base + cfg.c_match * 0.3 * cfg.max_pms)
    raw = streams.gen_stock(n, num_symbols=50, pattern_symbols=4,
                            p_class=0.05, seed=101 + seed)
    return streams.classify(specs, raw, rate=rate, seed=7 + seed)


def _rt(pkg, refresh=True, ladder=None, **kw):
    """The resilience configuration of the reference's chaos benchmark
    (bench_faults.resilience_rt) in package ``pkg``."""
    return pkg.RuntimeConfig(
        chunk_size=CHUNK,
        refresh=pkg.RefreshConfig(every_chunks=4, min_observations=64.0)
        if refresh else None,
        ingest=pkg.IngestConfig(max_queue_events=1 << 15,
                                high_watermark=1 << 13,
                                low_watermark=1 << 11, seed=5),
        ladder=ladder or pkg.LadderConfig(escalate_streak=2,
                                          deescalate_streak=2,
                                          latency_bound=0.01),
        guard=pkg.GuardConfig(check_every_chunks=1,
                              checkpoint_every_chunks=4), **kw)


def _rows(log):
    """Telemetry rows but their walls, NaN as a string (a poisoned clock
    makes NaN latencies, which must match too)."""
    nan = lambda v: "nan" if isinstance(v, float) and v != v else v  # noqa
    return [{k: nan(v) for k, v in r.items() if k not in WALLS}
            for r in log.rows()]


def _port_ev(ev):
    return convert.events_from_numpy(convert.tree_to_numpy(ev), "cpu")


def _assert_runtimes_equal(ref, port, what):
    assert _rows(port.telemetry) == _rows(ref.telemetry), what
    assert port.telemetry.event_rows() == ref.telemetry.event_rows(), what
    assert port.ladder.transitions == ref.ladder.transitions, what
    assert port.guard.counters() == ref.guard.counters(), what
    assert port.quarantine_dropped == ref.quarantine_dropped, what
    assert port.events_processed == ref.events_processed, what
    assert_trees_equal(ref.carry, port.carry, f"{what}: carry")
    rm, pm = convert.tree_to_numpy(ref.model), convert.tree_to_numpy(
        port.model)
    np.testing.assert_allclose(pm.pop("ut_tables"), rm.pop("ut_tables"),
                               RTOL, ATOL)
    assert_trees_equal(rm, pm, f"{what}: model but its tables")


# The fault cells: clean, a stream fault, two state faults, all at once.
CELLS = {"clean": (), "stall": ("stall",),
         "lane_poison": ("lane_poison",),
         "table_corrupt": ("table_corrupt",),
         "all_faults": RT.STREAM_FAULTS + RT.STATE_FAULTS}


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_stream_runtime_under_faults_equals_reference(cell):
    """The fault matrix cell by cell: state faults strike between pushes,
    stream faults rewrite each push — through both runtimes from two
    injectors with one seed; then the end-of-run guard sweep."""
    specs, cfg, model = _setup()
    ev = _events()
    kinds = CELLS[cell]
    mk = lambda pkg: pkg.FaultInjector(pkg.FaultConfig(  # noqa: E731
        kinds=kinds, seed=3, p_fault=0.35)) if kinds else None
    ri, ti = mk(RT), mk(TRT)
    ref = RT.StreamRuntime(cfg, model, _rt(RT), specs=specs)
    tm = to_port(model, ev, eng.init_carry(cfg))[0]
    port = TRT.StreamRuntime(port_config(cfg, "torch"), tm, _rt(TRT),
                             specs=specs, device="cpu")
    for s in range(0, N_EVENTS, PUSH):
        b = RT.slice_events(ev, s, min(s + PUSH, N_EVENTS))
        tb = _port_ev(b)
        if kinds:
            ref.carry = ri.corrupt_carry(ref.carry)
            ref.model = ri.corrupt_model(ref.model)
            b = ri.corrupt_events(b)
            port.carry = ti.corrupt_carry(port.carry)
            port.model = ti.corrupt_model(port.model)
            tb = ti.corrupt_events(tb)
        ref.push(b)
        port.push(tb)
    ref.flush()
    port.flush()
    rv, pv = ref.guard_now(), port.guard_now()
    assert [v.to_row() for v in pv] == [v.to_row() for v in rv]
    _assert_runtimes_equal(ref, port, cell)
    if kinds:
        assert ti.log == ri.log and ti.log
    assert port.guard.check(port.carry, port.model) == []
    agg = port.telemetry.aggregate()
    assert agg["ladder_transitions"] == len(port.ladder.transitions)
    if cell == "all_faults":
        assert port.guard.restores > 0 and agg["max_rung"] > 0


def test_multitenant_runtime_under_lane_faults_equals_reference():
    """Three lanes, per-lane queues, lane-targeted state faults: the
    guard restores only the poisoned lanes (and quarantines them at
    admission) exactly as the reference does; the ladder trims all lanes
    at once."""
    specs, cfg, model = _setup()
    L = 3
    evL = RT.stack([_events(k, 1.0 + 0.3 * k) for k in range(L)])
    mL = RT.broadcast_model(model, L)
    kw = dict(kinds=("lane_poison", "table_corrupt", "nan_refresh"),
              seed=11, p_fault=0.4)
    ri, ti = RT.FaultInjector(RT.FaultConfig(**kw)), \
        TRT.FaultInjector(TRT.FaultConfig(**kw))
    ref = RT.MultiTenantRuntime(cfg, mL, L, rt=_rt(RT), specs=specs)
    tmL, tevL, _ = to_port(mL, evL, eng.init_carry(cfg))
    port = TRT.MultiTenantRuntime(port_config(cfg, "torch"), tmL, L,
                                  rt=_rt(TRT), specs=specs, device="cpu")
    for k, s in enumerate(range(0, N_EVENTS, PUSH)):
        lane = k % L
        ref.carry = ri.corrupt_carry(ref.carry, lane=lane)
        ref.model = ri.corrupt_model(ref.model, lane=lane)
        port.carry = ti.corrupt_carry(port.carry, lane=lane)
        port.model = ti.corrupt_model(port.model, lane=lane)
        ref.push(RT.slice_events(evL, s, s + PUSH, axis=1))
        port.push(TRT.slice_events(tevL, s, s + PUSH, axis=1))
    ref.flush()
    port.flush()
    assert ti.log == ri.log
    _assert_runtimes_equal(ref, port, "lanes")
    restores = port.telemetry.events_of("guard_restore")
    assert restores and all(e.detail["lanes"] for e in restores)
    assert port.ingest.control_state() == ref.ingest.control_state()


def test_pm_trim_rung_over_lanes_equals_reference():
    """A ladder whose bound every chunk violates climbs to the PM-trim
    rung and trims every lane between chunks: equal to the reference's
    runtime (refresh off, so the tables stay bit for bit)."""
    specs, cfg, model = _setup()
    L = 3
    evL = RT.stack([_events(k, 2.0) for k in range(L)])
    mL = RT.broadcast_model(model, L)

    def rt(pkg):   # chunk by chunk: the ladder acts after every chunk
        return _rt(pkg, refresh=False, group_chunks=1,
                   ladder=pkg.LadderConfig(
                       escalate_streak=1, deescalate_streak=50,
                       latency_bound=1e-4, max_rung=pkg.RUNG_PM_TRIM,
                       trim_frac=0.3))

    ref = RT.MultiTenantRuntime(cfg, mL, L, rt=rt(RT), specs=specs)
    tmL, tevL, _ = to_port(mL, evL, eng.init_carry(cfg))
    port = TRT.MultiTenantRuntime(port_config(cfg, "torch"), tmL, L,
                                  rt=rt(TRT), specs=specs, device="cpu")
    ref.push(evL, flush=True)
    port.push(tevL, flush=True)
    _assert_runtimes_equal(ref, port, "trim rung")
    assert port.ladder.rung == TRT.RUNG_PM_TRIM
    # One trim per lane after each of the 16 chunks (the last one's
    # lands after the final stats), plus the in-scan sheds.
    assert float(port.carry.shed_calls.sum()) >= L * 16


@pytest.mark.parametrize("backend", ["torch", "cuda", "cuda_block"])
def test_resilience_off_and_inert_cost_nothing(backend):
    """Off: the chunked runtime equals one monolithic run_engine.  Inert
    (ingest that never sheds, a ladder whose bound is never hit, a guard
    that never fires): it equals resilience off, bit for bit."""
    specs, cfg, model = _setup()
    ev = _events(rate_mult=3.0, n=1024)
    tcfg = port_config(cfg, backend)
    tm, tev, tc = to_port(model, ev, eng.init_carry(cfg))
    mono, _ = teng.run_engine(tcfg, tm, tev, tc, device="cpu")
    off = TRT.StreamRuntime(tcfg, tm, TRT.RuntimeConfig(chunk_size=CHUNK),
                            device="cpu")
    off.push(tev, flush=True)
    assert_trees_equal(mono, off.carry, f"off ({backend})")
    inert = TRT.StreamRuntime(tcfg, tm, _rt(TRT, refresh=False, ladder=(
        TRT.LadderConfig(latency_bound=1e6))), device="cpu")
    for s in range(0, 1024, PUSH):
        inert.push(TRT.slice_events(tev, s, s + PUSH))
    inert.flush()
    assert_trees_equal(off.carry, inert.carry, f"inert ({backend})")
    assert inert.guard.checks_run > 0 and inert.guard.violations == 0
    assert not inert.ladder.transitions and not inert.backpressure
    assert float(off.carry.pms_shed) > 0, "the stream must shed"


def test_ladder_state_machine_equals_reference():
    rng = np.random.default_rng(0)
    kw = dict(escalate_streak=2, deescalate_streak=3)
    ref, port = RT.DegradationLadder(RT.LadderConfig(**kw)), \
        TRT.DegradationLadder(TRT.LadderConfig(**kw))
    for k in range(200):
        if ref.rung == RT.RUNG_QUARANTINE and rng.random() < 0.7:
            a, b = ref.quarantine_tick(k), port.quarantine_tick(k)
        else:
            v = bool(rng.random() < 0.55)
            a, b = ref.observe(v, k), port.observe(v, k)
        assert a == b and ref.control_state() == port.control_state()
    assert len(port.transitions) > 10 and max(
        t["to"] for t in port.transitions) == TRT.RUNG_QUARANTINE


@pytest.mark.parametrize("kw", [dict(escalate_streak=0),
                                dict(input_shed_frac=-0.1),
                                dict(max_rung=7), dict(latency_bound=0.0)])
def test_ladder_config_validation_equals_reference(kw):
    with pytest.raises(ValueError) as want:
        RT.LadderConfig(**kw)
    with pytest.raises(ValueError) as got:
        TRT.LadderConfig(**kw)
    assert str(got.value) == str(want.value)


def test_quarantine_refuses_pushes_and_recovers_by_ticks():
    """A ladder forced to quarantine refuses whole pushes and comes back
    down one rung per deescalate_streak refused pushes, as the
    reference's."""
    specs, cfg, model = _setup()
    ev = _events(rate_mult=3.0)

    def rt(pkg):
        return _rt(pkg, refresh=False, ladder=pkg.LadderConfig(
            escalate_streak=1, deescalate_streak=2, latency_bound=1e-4))

    ref = RT.StreamRuntime(cfg, model, rt(RT), specs=specs)
    tm, tev, _ = to_port(model, ev, eng.init_carry(cfg))
    port = TRT.StreamRuntime(port_config(cfg, "torch"), tm, rt(TRT),
                             specs=specs, device="cpu")
    for s in range(0, N_EVENTS, 256):
        ref.push(RT.slice_events(ev, s, s + 256))
        port.push(TRT.slice_events(tev, s, s + 256))
    ref.flush()
    port.flush()
    assert port.quarantine_dropped > 0
    assert any(t["why"] == "quarantine_timeout"
               for t in port.ladder.transitions)
    _assert_runtimes_equal(ref, port, "quarantine")
