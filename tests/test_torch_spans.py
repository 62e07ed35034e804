"""The port's spans (``repro_torch.spans``): what a record holds, when
spans are recorded, the buffer's cap, the profiler's clock, and the tree
of spans one push of the streaming runtime emits, whose ``runtime.run``
and ``runtime.refresh`` spans are its ``ChunkStats`` walls."""
from __future__ import annotations

import threading

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from repro_torch import runtime as RT, spans
from repro_torch.cep import engine, patterns as pat, runner
from repro_torch.data import streams

COST = dict(c_base=3e-4, c_match=6e-5, c_shed_base=1.5e-4, c_shed_pm=1.5e-6,
            c_ebl=6e-5)


@pytest.fixture(autouse=True)
def _empty():
    spans.clear()
    yield
    spans.clear()


def _tree(recs, parent=-1):
    """The records as nested (name, [children]) in the order they
    began."""
    return [(r[0], _tree(recs, k)) for k, r in enumerate(recs)
            if r[3] == parent]


def test_parents_counts_and_seconds():
    with spans.recording():
        with spans.span("a", n=3) as a:
            with spans.span("b") as b:
                b.n = 7
            with spans.span("c"):
                pass
        with spans.span("d"):
            pass
    recs = spans.records()
    assert [(r[0], r[3], r[4]) for r in recs] == [
        ("a", -1, 3), ("b", 0, 7), ("c", 0, 0), ("d", -1, 0)]
    assert all(0 < r[1] <= r[2] for r in recs)
    assert recs[0][1] <= recs[1][1] <= recs[1][2] <= recs[2][1] \
        <= recs[2][2] <= recs[0][2] <= recs[3][1]
    assert a.seconds == (recs[0][2] - recs[0][1]) * 1e-9
    assert b.seconds == (recs[1][2] - recs[1][1]) * 1e-9


def test_parents_are_per_thread():
    got = []

    def other():
        with spans.span("t") as s:
            got.append(s)

    with spans.recording():
        with spans.span("main"):
            th = threading.Thread(target=other)
            th.start()
            th.join(timeout=30)
    assert not th.is_alive() and got
    assert sorted((r[0], r[3]) for r in spans.records()) == [
        ("main", -1), ("t", -1)]


def test_recorded_only_under_the_profiler_or_recording():
    assert not torch._C._autograd._profiler_enabled()
    with spans.span("off") as s:
        pass
    assert s.seconds >= 0 and spans.records() == []
    with profile(activities=[ProfilerActivity.CPU]):
        with spans.span("profiled"):
            pass
    with spans.span("off again"):
        pass
    with spans.recording():
        with spans.recording():
            with spans.span("forced"):
                pass
        with spans.span("still forced"):
            pass
    with spans.span("off at last"):
        pass
    assert [r[0] for r in spans.records()] == ["profiled", "forced",
                                               "still forced"]


def test_an_open_span_reads_minus_one_and_clear_lets_it_go():
    with spans.recording():
        with spans.span("outer"):
            assert spans.records()[0][2] == -1
            spans.clear()
            with spans.span("after"):
                pass
        assert [(r[0], r[3]) for r in spans.records()] == [("after", -1)]


def test_cap_and_dropped(monkeypatch):
    monkeypatch.setattr(spans, "CAP", 3)
    with spans.recording():
        with spans.span("p"):
            for _ in range(4):
                with spans.span("q"):
                    with spans.span("r"):
                        pass
    recs = spans.records()
    assert [(r[0], r[3]) for r in recs] == [("p", -1), ("q", 0), ("r", 1)]
    assert all(r[2] >= r[1] for r in recs)
    assert spans.dropped() == 6
    spans.clear()
    assert spans.dropped() == 0 and spans.records() == []


def test_records_lie_on_the_profilers_clock():
    """A profiler range around a span contains the span's record in the
    profiler's own times."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("around"):
            with spans.span("inside"):
                torch.ones(64).sum()
    (name, a, b, _, _), = spans.records()
    ev, = [e for e in prof.profiler.kineto_results.events()
           if e.name() == "around"]
    lo = ev.start_ns()
    assert lo <= a <= b <= lo + ev.duration_ns()


def _runtime(L=2, n=128, chunk=64, group=1, cls=RT.MultiTenantRuntime):
    specs = [pat.make_q1(window_size=400, num_symbols=4)]
    cp = pat.compile_patterns(specs)
    cfg = runner.default_config(cp, max_pms=64, latency_bound=0.005,
                                gather_stats=True, shedder="pspice",
                                backend="cuda_block", block_events=32,
                                **COST)
    rate = 3.0 / (cfg.c_base + cfg.c_match * 20)
    evs = [streams.classify(specs, streams.gen_stock(
        n, num_symbols=50, pattern_symbols=4, p_class=0.05, seed=100 + k),
        rate=rate * (1 + 0.3 * k), seed=k, device="cpu") for k in range(L)]
    model = engine.make_model(cp, cfg, device="cpu")
    rt = RT.RuntimeConfig(chunk_size=chunk, group_chunks=group,
                          refresh=RT.RefreshConfig(every_chunks=2,
                                                   min_observations=1.0))
    if cls is RT.StreamRuntime:
        return cls(cfg, model, rt=rt, specs=specs, device="cpu"), evs[0]
    return (cls(cfg, RT.broadcast_model(model, L), L, rt=rt, specs=specs,
                device="cpu"), RT.stack(evs))


STATS = ("runtime.chunk_stats", [("runtime.to_device", [])] * 2)
RUN = ("runtime.run", [("driver.prepare", []), ("driver.launches", []),
                       STATS, ("runtime.to_host", [])])
CHUNK = [RUN, ("runtime.refresh", []), ("runtime.summarize", [])]
FIRST = [("runtime.to_host", [])] + CHUNK      # the counter snapshot first


@pytest.mark.parametrize("cls", [RT.MultiTenantRuntime, RT.StreamRuntime])
def test_a_push_emits_the_tree_and_its_walls(cls):
    """Two pushes of one chunk each on the block kernel's plain path; the
    first reads the counter snapshot, the second is on the refresh
    cadence."""
    with spans.recording():
        mt, ev = _runtime(cls=cls)
        stats = [mt.push(engine.EventBatch(*(x.narrow(mt._axis, a, 64)
                                             for x in ev)))
                 for a in (0, 64)]
    recs = spans.records()
    lanes = 2 if cls is RT.MultiTenantRuntime else 1
    assert _tree(recs) == [
        ("runtime.construct", [("runtime.init_carry", [])]),
        ("runtime.push", [("runtime.buffer", []), ("runtime.chunk", FIRST)]),
        ("runtime.push", [("runtime.buffer", []), ("runtime.chunk", CHUNK)])]
    by = {}
    for r in recs:
        by.setdefault(r[0], []).append(r)
    assert [r[4] for r in by["runtime.init_carry"]] == [lanes]
    assert [r[4] for r in by["runtime.buffer"]] == [64, 64]
    assert [r[4] for r in by["runtime.chunk"]] == [64 * lanes] * 2
    assert [r[4] for r in by["driver.launches"]] == [2, 2]
    assert [r[4] for r in by["runtime.to_host"]] == [5 * 4 * lanes, 44, 44]
    assert [r[4] for r in by["runtime.to_device"]] == [4, 8] * 2
    sec = lambda r: (r[2] - r[1]) * 1e-9  # noqa: E731
    (s0,), (s1,) = stats
    assert [s0.wall_s, s1.wall_s] == [sec(r) for r in by["runtime.run"]]
    assert [s0.refresh_wall_s, s1.refresh_wall_s] == [
        sec(r) for r in by["runtime.refresh"]]


def test_a_group_is_one_chunk_span_with_one_read():
    """A group of 2 chunks: both scans under one ``runtime.run``, one
    read of both stats vectors, each ChunkStats half its wall."""
    with spans.recording():
        mt, ev = _runtime(group=2)
        stats = mt.push(engine.EventBatch(*(x[:, :128] for x in ev)))
    recs = spans.records()
    scan = [("driver.prepare", []), ("driver.launches", []), STATS]
    chunk = [("runtime.to_host", []),
             ("runtime.run", scan + scan + [("runtime.to_host", [])]),
             ("runtime.refresh", []), ("runtime.summarize", [])]
    assert _tree(recs)[1] == ("runtime.push", [("runtime.buffer", []),
                                               ("runtime.chunk", chunk)])
    run, = [r for r in recs if r[0] == "runtime.run"]
    refresh, = [r for r in recs if r[0] == "runtime.refresh"]
    assert [s.wall_s for s in stats] == [(run[2] - run[1]) * 1e-9 / 2] * 2
    assert [s.refresh_wall_s for s in stats] == [
        0.0, (refresh[2] - refresh[1]) * 1e-9]
    assert [s.chunk_index for s in stats] == [0, 1]
    assert [s.refreshed for s in stats] == [False, True]


def test_engine_reads_are_spans_beside_host_syncs():
    """The per-event loop's reads: one ``engine.read`` span each, as many
    as ``engine.host_syncs`` counts."""
    specs = [pat.make_q1(window_size=400, num_symbols=4)]
    cp = pat.compile_patterns(specs)
    cfg = runner.default_config(cp, max_pms=32, latency_bound=0.005,
                                backend="torch", **COST)
    ev = streams.classify(specs, streams.gen_stock(
        24, num_symbols=50, pattern_symbols=4, p_class=0.05, seed=3),
        rate=2000.0, seed=0, device="cpu")
    model = engine.make_model(cp, cfg, device="cpu")
    syncs = engine.host_syncs
    with spans.recording():
        engine.run_engine(cfg, model, ev, engine.init_carry(cfg,
                                                            device="cpu"),
                          device="cpu")
    reads = [r for r in spans.records() if r[0] == "engine.read"]
    assert len(reads) == engine.host_syncs - syncs > 0
    assert all(r[4] > 0 for r in reads)
