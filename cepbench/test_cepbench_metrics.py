"""Each per-layer metric's arithmetic on a synthetic trace, and the trace
reductions they share."""
from __future__ import annotations

import json
import pathlib

import numpy as np
import pytest

from cepbench import harness, roofline, tracing

ROOT = pathlib.Path(__file__).resolve().parent.parent
CFG = json.loads((ROOT / "cepbench/configs/stock-q1.json").read_text())
CELL = json.loads((ROOT / "cepbench/cells/stock-q1.lanes128.json")
                  .read_text())
US = 1000                  # ns


def _trace(dev, pushes, counts=None, sessions=(), host=()):
    """Device ops (name, start, end) and push spans in microseconds over a
    window from 0 to 1 000 us."""
    spans = {"session.start": [(a * US, b * US) for a, b in sessions],
             "push": [(a * US, b * US) for a, b in pushes],
             "harness": [(0, 0), (1000 * US, 1000 * US)]}
    col = lambda xs, k: np.array([x[k] * US for x in xs], np.int64)  # noqa
    return tracing.Trace(
        t0=0, t1=1000 * US, dev_name=[d[0] for d in dev],
        dev_start=col(dev, 1), dev_end=col(dev, 2), spans=spans,
        host_name=[h[0] for h in host], host_start=col(host, 1),
        host_end=col(host, 2), counts=counts or {}, config=CFG, cell=CELL)


DEV = [("block_step_kernel<true>", 100, 180), ("block_step_kernel<true>",
                                               150, 250),
       ("fill", 600, 610), ("block_step_kernel<true>", 900, 1100)]


def test_union_and_busy():
    tr = _trace(DEV, [(0, 500)])
    assert tracing.union(tr.dev_start, tr.dev_end, 0, 1000 * US) == [
        (100 * US, 250 * US), (600 * US, 610 * US), (900 * US, 1000 * US)]
    assert tracing.busy_ns(tr) == 260 * US
    assert list(tracing.busy_within(tr, [(0, 500 * US), (120 * US, 605 * US),
                                         (950 * US, 2000 * US),
                                         (260 * US, 590 * US)])) == [
        150 * US, 135 * US, 50 * US, 0]
    assert tracing.idle_gaps(tr) == [(0, 100 * US), (250 * US, 600 * US),
                                     (610 * US, 900 * US)]


@pytest.mark.parametrize("name,want", [
    ("device.idle_pct", 74.0),
    ("runtime.host_ms_per_push", ((500 - 150) + (500 - 110)) / 2 * 1e-3),
    ("block_kernel.us_per_launch", (80 + 100 + 200) / 3),
    ("driver.launches_per_push", 32.0)])
def test_metric(name, want):
    tr = _trace(DEV, [(0, 500), (500, 1000)],
                counts={"pushes": 2, "launches": 64})
    assert harness.metric_reader(name)(tr) == pytest.approx(want)


def test_roofline_share():
    counts = {"pushes": 2, "launches": 64, "mean_live_pms": 128 * 30.0}
    tr = _trace(DEV, [(0, 500)], counts=counts)
    nbytes = roofline.block_bytes(tr)
    P, N, W = len(CFG["patterns"]), CFG["max_pms"], 32
    per_lane = roofline.lane_bytes(P, N, 11, W, 30.0, seq=True,
                                   binds=False)
    assert nbytes == 128 * per_lane
    # Q1: the active flags, two words of each live PM, the rows, the
    # model columns and scalars in; the store, rows, scalars out.
    scalars = 2 * P * 4 + 12 * 4 + 2 * 4
    assert per_lane == (P * N + 30 * 8 + W * (P * 9 + 16) + P * 22 + scalars
                        + P * N * 13 + scalars + W * 10 + W * 8)
    want = 100 * nbytes / roofline.HBM_BYTES_PER_S / (380 / 3 * 1e-6)
    assert harness.metric_reader("block_step_roofline")(tr) == \
        pytest.approx(want)
    assert want < 100


@pytest.mark.parametrize("name", ["device.idle_pct",
                                  "block_kernel.us_per_launch",
                                  "block_step_roofline",
                                  "driver.launches_per_push",
                                  "runtime.host_ms_per_push"])
def test_nothing_to_read_gives_none(name):
    tr = _trace([], [], counts={})
    assert harness.metric_reader(name)(tr) is None


def test_breakdown_names_gaps_by_span():
    host = [("aten::zeros", 20, 60), ("aten::empty", 30, 40)]
    tr = _trace(DEV, [(90, 1000)], sessions=[(0, 90)], host=host)
    b = tracing.breakdown(tr)
    assert b["device_ops"][0][0] == "block_step_kernel<true>"
    assert b["device_ops"][0][1] == pytest.approx(280e-6)   # clipped
    names = dict(b["idle_gaps"])
    assert names["idle in session.start"] == pytest.approx(100e-6)
    assert names["idle in push"] == pytest.approx(640e-6)
    assert names["session.start: aten::zeros"] == pytest.approx(100e-6)
    assert len(b["idle_gaps"]) <= 10
