"""Cells cut to a size a CPU test run can hold: the plain PyTorch
version of every kernel runs where the card would."""
from __future__ import annotations

import time

from cepbench import harness


def cell(name: str) -> tuple:
    """``harness.load_cell(name)`` with 2 lanes, sessions of 96 events,
    pushes and chunks of 32, both lanes checked."""
    wl, cfg, cell, e2e, per_layer = harness.load_cell(name)
    cell = dict(cell, lanes=2, session_events=96, push_events=32,
                check_lanes=2)
    cfg = dict(cfg, chunk_events=32)
    return wl, cfg, cell, e2e, per_layer


def run(name: str, seed: int = 2 ** 31 + 11, seconds: float = 1.0,
        trace: bool = False) -> tuple[dict, list[str]]:
    """(the result line's object, the lines for standard error)."""
    lines: list[str] = []
    out = harness.run(name, seed, seconds, trace, time.perf_counter(),
                      device="cpu", loaded=cell(name), log=lines.append)
    return out, lines
