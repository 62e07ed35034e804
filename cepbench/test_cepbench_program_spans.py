"""The per-layer metrics that read the program's spans
(``program_spans``): their arithmetic on synthetic records, the window's
clip, nothing read without such spans, without a device operation or
without the span module, and every one read from a tiny traced run."""
from __future__ import annotations

import dataclasses
import json
import pathlib
import sys

import numpy as np
import pytest

from cepbench import _tiny, harness, program_spans, tracing

ROOT = pathlib.Path(__file__).resolve().parent.parent
MAN = json.loads((ROOT / "BENCHMARK.json").read_text())
US = 1000                  # ns
T0 = 1_792_000_000_000_000_000     # a window on the Unix-epoch clock


def _trace(dev=(("block_step_kernel", 10, 20),), pushes=2):
    """A window from T0 to T0 + 1 000 us with device ops (name, start,
    end in us) and ``pushes`` pushes."""
    col = lambda k: np.array([T0 + d[k] * US for d in dev],  # noqa: E731
                             np.int64)
    z = np.zeros(0, np.int64)
    return tracing.Trace(
        t0=T0, t1=T0 + 1000 * US, dev_name=[d[0] for d in dev],
        dev_start=col(1), dev_end=col(2), spans={}, host_name=[],
        host_start=z, host_end=z, counts={"pushes": pushes}, config={},
        cell={})


# (name, start us, end us, n), parents left out: the metrics read none.
RECS = [("runtime.construct", -5, 80, 2),       # begins before the window
        ("runtime.construct", 100, 190, 2),
        ("runtime.construct", 200, 310, 2),
        ("runtime.buffer", 395, 400, 64),
        ("driver.prepare", 400, 403, 0),
        ("driver.launches", 403, 467, 32),
        ("runtime.chunk_stats", 467, 470, 0),
        ("runtime.to_device", 468, 469, 4),
        ("runtime.to_device", 469, 470, 12),
        ("runtime.to_host", 470, 480, 40),
        ("runtime.summarize", 480, 482, 0),
        ("runtime.buffer", 495, 500, 64),
        ("driver.prepare", 500, 504, 0),
        ("driver.launches", 504, 600, 32),
        ("engine.read", 550, 551, 8),
        ("runtime.chunk_stats", 600, 610, 0),
        ("runtime.to_device", 601, 608, 4),
        ("runtime.to_device", 608, 609, 12),
        ("runtime.to_host", 610, 614, 44),
        ("runtime.summarize", 614, 617, 0),
        ("driver.launches", 990, 1010, 32),     # ends after the window
        ("runtime.to_host", 2000, 2100, 44)]    # a later window's


@pytest.fixture
def recs(monkeypatch):
    from repro_torch import spans
    got = [(k, T0 + a * US, T0 + b * US, -1, n) for k, a, b, n in RECS]
    monkeypatch.setattr(spans, "records", lambda: list(got))
    return got


NEW = {"runtime.construct_ms": (90 + 110) / 2 * 1e-3,
       "driver.prepare_ms_per_push": (3 + 4) / 2 * 1e-3,
       "driver.enqueue_us_per_launch": (64 + 96) / 64,
       "runtime.to_host_ms_per_push": (10 + 4) / 2 * 1e-3,
       "runtime.summarize_ms_per_push": (2 + 3) / 2 * 1e-3,
       "runtime.syncs_per_push": 7 / 2,
       "runtime.chunk_stats_ms_per_push": (3 + 10) / 2 * 1e-3,
       "runtime.buffer_ms_per_push": (5 + 5) / 2 * 1e-3}


@pytest.mark.parametrize("name", sorted(NEW))
def test_metric(recs, name):
    assert harness.metric_reader(name)(_trace()) == pytest.approx(NEW[name])


def test_within_clips_to_the_window(recs):
    got = program_spans.within(_trace(), "runtime.construct")
    assert got == [(T0 + 100 * US, T0 + 190 * US, 2),
                   (T0 + 200 * US, T0 + 310 * US, 2)]
    assert program_spans.within(_trace(), "runtime.to_host")[-1][0] \
        == T0 + 610 * US


def test_an_open_span_is_not_read(monkeypatch):
    from repro_torch import spans
    monkeypatch.setattr(spans, "records", lambda: [
        ("runtime.construct", T0 + 100 * US, -1, -1, 0)])
    assert harness.metric_reader("runtime.construct_ms")(_trace()) is None


@pytest.mark.parametrize("name", sorted(NEW))
def test_none_without_such_spans(monkeypatch, name):
    from repro_torch import spans
    monkeypatch.setattr(spans, "records", lambda: [
        ("runtime.push", T0 + 100 * US, T0 + 200 * US, -1, 0)])
    assert harness.metric_reader(name)(_trace()) is None


@pytest.mark.parametrize("name", sorted(NEW))
def test_none_without_a_device_operation(recs, name):
    assert harness.metric_reader(name)(_trace(dev=())) is None


@pytest.mark.parametrize("name", sorted(NEW))
def test_none_without_pushes_or_the_span_module(recs, monkeypatch, name):
    if name.endswith("_per_push"):
        assert harness.metric_reader(name)(_trace(pushes=0)) is None
    monkeypatch.delitem(sys.modules, "repro_torch.spans")
    assert harness.metric_reader(name)(_trace()) is None


def test_every_new_metric_is_a_program_span_of_every_cell():
    got = {m["name"] for m in MAN["per_layer"]
           if m["source"] == "program_span"}
    assert got == set(NEW)
    for w in MAN["workloads"]:
        per_layer = harness.load_cell(w["name"])[4]
        assert got <= {m["name"] for m in per_layer}


@pytest.mark.parametrize("name", ["stock-q1.lanes128", "soccer-q3.lanes128"])
def test_a_tiny_traced_run_reads_every_span_metric(monkeypatch, name):
    """The readers on the window of a real traced run on the CPU: one
    device operation is laid into it, as a run on the card has, to pass
    the reader's gate; every span metric then reads a value.  Each push
    of 32 events is one chunk, so the stream is waited for three times a
    push (two copies to the device, one read), plus a session's first
    counter snapshot."""
    got = []
    real = tracing.from_profiler

    def keep(*a):
        got.append(real(*a))
        return got[-1]

    monkeypatch.setattr(tracing, "from_profiler", keep)
    out, log = _tiny.run(name, trace=True)
    assert out["correct"], log[-8:]
    tr, = got
    assert not len(tr.dev_start)
    tr = dataclasses.replace(
        tr, dev_name=["block_step_kernel"],
        dev_start=np.array([tr.t0], np.int64),
        dev_end=np.array([tr.t0 + 1], np.int64))
    values = {k: harness.metric_reader(k)(tr) for k in NEW}
    assert all(v is not None and v > 0 for v in values.values()), values
    assert 3 < values["runtime.syncs_per_push"] < 4
