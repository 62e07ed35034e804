"""``correct`` comes out false when the timed path is broken underneath
(a step that leaves its state as it was, half the lanes left out, an
answer altered where it is produced) and for the control: the plain
reference in the program's place in bfloat16."""
from __future__ import annotations

import pytest

from cepbench import _tiny, control, harness
from repro_torch.runtime import service, telemetry

NAME = "stock-q1.lanes128"


def _scan_then(fix):
    run = service.MultiTenantRuntime._scan

    def scan(cfg, model, events, carry, start, own):
        before = [x.clone() for x in harness._leaves(carry)]
        c, outs = run(cfg, model, events, carry, start, own)
        fix(before, list(harness._leaves(c)))
        return c, outs
    return staticmethod(scan)


def _unchanged(before, after):
    for b, a in zip(before, after):
        a.copy_(b)


def _half(before, after):
    for b, a in zip(before, after):
        if a.dim() and a.shape[0] > 1:
            a[a.shape[0] // 2:] = b[a.shape[0] // 2:]


STATS = telemetry.device_chunk_stats


def _altered_stats(outs, carry):
    """The chunk's telemetry with one more PM at its end than it had."""
    vec = STATS(outs, carry).clone()
    vec[telemetry._VEC["n_pm_end"]] += 1
    return vec


@pytest.mark.parametrize("fault", ["unchanged", "half", "answer"])
def test_fault_is_not_correct(monkeypatch, fault):
    if fault == "answer":
        monkeypatch.setattr(telemetry, "device_chunk_stats",
                            _altered_stats)
        monkeypatch.setattr(service.TM, "device_chunk_stats",
                            _altered_stats)
    else:
        monkeypatch.setattr(service.MultiTenantRuntime, "_scan", _scan_then(
            _unchanged if fault == "unchanged" else _half))
    out, _ = _tiny.run(NAME)
    assert not out["correct"]
    assert any(v > lim for v, lim in out["check"].values())


@pytest.mark.parametrize("precision,correct", [("bfloat16", False),
                                               ("float32", True)])
def test_control(precision, correct):
    """bfloat16 in the program's place fails every comparison; the
    float32 reference in its place passes them (the comparison itself
    is sound)."""
    _, cfg, cell, _, _ = _tiny.cell(NAME)
    sets, warm, built, ck, lanes = control.low_outputs(cfg, cell, 5,
                                                       precision)
    got = harness.compare(cfg, cell, sets, warm, built, ck, lanes)
    over = {k: v[0] > cfg["limits"][k] for k, v in got.items()}
    assert (not any(over.values())) == correct
    if not correct:
        assert all(over.values()), got
