"""The harness end to end on the CPU at a tiny size: the generator,
session rotation, the push loop, the traced reductions, and ``correct``
from the plain reference against the port's plain path."""
from __future__ import annotations

import numpy as np
import pytest

from cepbench import _tiny, harness, traffic

CELLS = ["stock-q1.lanes128", "soccer-q3.lanes128"]


@pytest.mark.parametrize("name", CELLS)
def test_run_is_correct(name):
    out, log = _tiny.run(name)
    assert out["correct"], log[-8:]
    assert out["failed"] == 0 and out["attempted"] >= 2
    assert set(out["metrics"]) == {"events_per_s", "push_ms_p95",
                                   "setup_s"}
    assert all(v["value"] > 0 for v in out["metrics"].values())
    assert list(out)[-1] == "check"
    assert {k: v[0] for k, v in out["check"].items()} == {
        "carry_leaves_differing": 0.0, "push_stats_differing": 0.0,
        "events_unprocessed": 0.0, "model_values_differing": 0.0,
        "ut_table_gap": pytest.approx(0.0, abs=1e-9)}
    assert log[-1].startswith("check ")


def test_sessions_rotate_on_fresh_runtimes():
    """Sessions take the sets in turn, each on a runtime of its own that
    processes every event pushed; the checked push's start is kept."""
    _, cfg, cell, _, _ = _tiny.cell(CELLS[0])
    prog = harness.Program(cfg, cell, "cpu")
    sets = traffic.session_sets(cfg, cell, 9)
    warm = traffic.warm_stream(cfg, cell["session_events"])
    rates = traffic.lane_rates(cell, prog.build(warm, 0.5))
    for s in sets:
        s["arrival"] = np.stack([traffic.arrivals(
            cell["session_events"], r) for r in rates])
    loop = harness.Loop(prog, cell, [prog.batch(s) for s in sets], 1)
    seen = []
    real = prog.runtime
    prog.runtime = lambda: seen.append(real()) or seen[-1]
    span = harness._span_fn(False)
    for k in range(3):
        assert loop.session(k, span, None)
    pushes = -(-cell["session_events"] // cell["push_events"])
    assert len(loop.push_ms) == 3 * pushes and len(set(map(id, seen))) == 3
    assert loop.sessions == [(2 * 96, 2 * 96, True)] * 3
    assert loop.events == 3 * 2 * 96
    assert loop.checked["set"] == 0 and loop.checked["start"] == 32


def test_traced_run_reads_the_host_side():
    out, _ = _tiny.run(CELLS[0], trace=True)
    assert out["correct"]
    # No device here: the device metrics find nothing and are left out.
    assert set(out["metrics"]) == {"runtime.host_ms_per_push",
                                   "driver.launches_per_push"}
    assert out["device"]["busy_s"] == 0.0
    assert out["device"]["window_s"] > 0
    assert out["breakdown"]["idle_gaps"]


@pytest.mark.parametrize("where,key", [("cell", "loop"),
                                       ("config", "refresh_every")])
def test_a_key_the_harness_does_not_run_is_refused(tmp_path, where, key):
    """A cell or configuration asking for something the harness does not
    do (here an open loop or a model refresh) is refused, not run as if
    the key were not there."""
    import json
    import shutil
    root = tmp_path
    shutil.copy(harness.ROOT / "BENCHMARK.json", root)
    (root / "cepbench" / "configs").mkdir(parents=True)
    for f in (harness.ROOT / "cepbench" / "configs").glob("*.json"):
        shutil.copy(f, root / "cepbench" / "configs")
    name = CELLS[0]
    assert harness.load_cell(name, root)
    if where == "config":
        f = root / "cepbench" / "configs" / "stock-q1.json"
        f.write_text(json.dumps(dict(json.loads(f.read_text()),
                                     **{key: 4})))
        with pytest.raises(ValueError, match=key):
            harness.load_cell(name, root)
    else:
        cell = dict(json.loads((harness.HERE / "cells" /
                                f"{name}.json").read_text()), loop="open")
        with pytest.raises(ValueError, match=key):
            harness._keys_run(name, cell, harness.CELL_KEYS)


def test_checked_push_spans_the_session():
    """The checked push is drawn over the whole session (any push but
    the first) and the sampled lanes are distinct, from the seed."""
    _, _, cell, _, _ = harness.load_cell(CELLS[0])
    n_push = -(-cell["session_events"] // cell["push_events"])
    draws = [harness.draw_checked(s, cell) for s in range(400)]
    pushes = {p for p, _ in draws}
    assert min(pushes) == 1 and max(pushes) == n_push - 1
    assert all(len(set(ln)) == cell["check_lanes"] for _, ln in draws)
    assert harness.draw_checked(2 ** 31 + 5, cell)[0] == \
        harness.draw_checked(2 ** 31 + 5, cell)[0]
