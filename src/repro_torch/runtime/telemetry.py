"""Per-chunk runtime telemetry (DESIGN.md §7, §8).

Port of ``repro.runtime.telemetry``.  Every per-chunk reduction runs on
the device in one function (``device_chunk_stats``) and crosses to the
host as a single (11,) float32 vector per chunk — one vector per chunk
of a group, stacked, in ONE transfer per group; that transfer doubles as
the synchronization point the wall-clock measurement needs.  The log
aggregates into the throughput headline (events/sec, p50/p99 event
latency, shed/overflow counters).

The quantiles interpolate linearly as ``jnp.quantile`` does, with the
rounding the reference's jitted reduction has on the CPU: ``lo·(1 − w)``
fused into ``hi·w`` (``fp.fma(lo, 1 − w, hi·w)``), found by test;
``torch.quantile`` (``torch.lerp``) rounds otherwise, in about one case
in seven (``tests/test_torch_runtime.py``).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import fp
from repro_torch.cep.engine import Carry, StepOut

# Carry accumulator scalars differenced per chunk.
_COUNTERS = ("pms_shed", "shed_calls", "overflow", "ebl_dropped")

# The device_chunk_stats vector layout — the SINGLE place that names the
# slots.  summarize_chunk and counters_from_vec read by name through _VEC.
_VEC_FIELDS = ("l_e_p50", "l_e_p99", "l_e_max", "n_pm_end", "shed_events",
               "dropped_events") + _COUNTERS + ("complex_count",)
_VEC = {name: i for i, name in enumerate(_VEC_FIELDS)}
_QUANTILES = (0.5, 0.99)


def counter_snapshot(carry: Carry) -> dict[str, float]:
    """Host copies of the carry's scalar counters (+ total completions),
    summed over lanes.  Used once per stream for the first chunk's
    baseline; steady-state chunks reuse the counter tail of the previous
    ``device_chunk_stats`` vector instead."""
    snap = {k: float(getattr(carry, k).cpu().numpy().sum())
            for k in _COUNTERS}
    snap["complex_count"] = float(carry.complex_count.cpu().numpy().sum())
    return snap


def quantiles(x: torch.Tensor, qs=_QUANTILES) -> torch.Tensor:
    """``jnp.quantile(x, qs)`` (linear) of a 1-D float32 tensor, bit for
    bit; NaN when x holds a NaN."""
    a = torch.sort(x).values
    n1 = torch.tensor(float(x.shape[0] - 1), dtype=torch.float32,
                      device=x.device)
    q = torch.tensor(qs, dtype=torch.float32, device=x.device) * n1
    low, high = torch.floor(q), torch.ceil(q)
    hw = q - low
    lw = 1.0 - hw
    lo = a[low.clamp(0, x.shape[0] - 1).long()]
    hi = a[high.clamp(0, x.shape[0] - 1).long()]
    out = fp.fma(lo, lw, hi * hw)
    return torch.where(torch.isnan(x).any(), torch.nan, out)


def device_chunk_stats(outs: StepOut, carry: Carry) -> torch.Tensor:
    """Every per-chunk reduction in one device computation: l_e
    p50/p99/max, end-of-chunk PM count, shed/dropped event counts (over
    every lane), and the carry's cumulative counters.  Returns a (11,)
    float32 vector on the carry's device — one device→host transfer."""
    dev = carry.sim_time.device
    l_e = outs.l_e.reshape(-1)
    f32 = torch.float32
    if l_e.shape[0] == 0:
        # Zero-length chunk (an empty push/drain): the latency/count slots
        # are zero; the cumulative counter tail still reads the carry so
        # the next chunk's baseline stays correct.
        head = torch.zeros((6,), dtype=f32, device=dev)
    else:
        head = torch.cat([
            quantiles(l_e), l_e.max()[None],
            torch.stack([outs.n_pm[..., -1].sum(),
                         outs.shed.sum().to(f32),
                         outs.dropped.sum().to(f32)]).to(f32)])
    tail = torch.stack([getattr(carry, k).sum() for k in _COUNTERS] +
                       [carry.complex_count.sum()]).to(f32)
    return torch.cat([head, tail])


def counters_from_vec(vec: np.ndarray) -> dict[str, float]:
    """The cumulative-counter tail of a ``device_chunk_stats`` vector, in
    ``counter_snapshot``'s format (the next chunk's 'before')."""
    return {k: float(vec[_VEC[k]]) for k in _COUNTERS + ("complex_count",)}


@dataclasses.dataclass
class ChunkStats:
    chunk_index: int
    start: int                  # global index of the chunk's first event
    n_events: int               # events processed (all lanes)
    n_lanes: int
    wall_s: float
    events_per_s: float
    l_e_p50: float
    l_e_p99: float
    l_e_max: float
    n_pm_end: float             # active PMs after the chunk (all lanes)
    shed_events: int            # events at which a shed triggered
    dropped_events: int         # E-BL input drops
    pms_shed: float             # counter deltas over the chunk
    shed_calls: float
    overflow: float
    ebl_dropped: float
    completions: float
    refreshed: bool = False     # model refresh ran after this chunk
    refresh_wall_s: float = 0.0  # host time spent in/gating the refresh
    rung: int = 0               # degradation-ladder rung after this chunk

    def to_row(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class RuntimeEvent:
    """A discrete runtime occurrence (ladder transition, guard violation,
    guard restore, admission backpressure)."""
    kind: str
    chunk_index: int
    detail: dict = dataclasses.field(default_factory=dict)

    def to_row(self) -> dict:
        return dataclasses.asdict(self)


def summarize_chunk(chunk_index: int, start: int, n_events: int,
                    n_lanes: int, vec: np.ndarray,
                    before: dict[str, float], wall_s: float,
                    refreshed: bool = False,
                    refresh_wall_s: float = 0.0) -> ChunkStats:
    """Stats for one chunk from its ``device_chunk_stats`` vector + the
    previous chunk's cumulative counters."""
    after = counters_from_vec(vec)
    d = {k: after[k] - before[k] for k in before}
    v = lambda k: float(vec[_VEC[k]])  # noqa: E731
    return ChunkStats(
        chunk_index=chunk_index, start=start, n_events=n_events,
        n_lanes=n_lanes, wall_s=wall_s,
        events_per_s=n_events / max(wall_s, 1e-12),
        l_e_p50=v("l_e_p50"), l_e_p99=v("l_e_p99"), l_e_max=v("l_e_max"),
        n_pm_end=v("n_pm_end"),
        shed_events=int(v("shed_events")),
        dropped_events=int(v("dropped_events")),
        pms_shed=d["pms_shed"], shed_calls=d["shed_calls"],
        overflow=d["overflow"], ebl_dropped=d["ebl_dropped"],
        completions=d["complex_count"], refreshed=refreshed,
        refresh_wall_s=refresh_wall_s,
    )


class TelemetryLog:
    """Append-only chunk log with run-level aggregation."""

    def __init__(self):
        self.chunks: list[ChunkStats] = []
        self.events: list[RuntimeEvent] = []

    def append(self, stats: ChunkStats) -> None:
        self.chunks.append(stats)

    def record_event(self, kind: str, chunk_index: int,
                     detail: dict | None = None) -> RuntimeEvent:
        ev = RuntimeEvent(kind, chunk_index, detail or {})
        self.events.append(ev)
        return ev

    def events_of(self, kind: str) -> list[RuntimeEvent]:
        return [e for e in self.events if e.kind == kind]

    def rows(self) -> list[dict]:
        return [c.to_row() for c in self.chunks]

    def event_rows(self) -> list[dict]:
        return [e.to_row() for e in self.events]

    def to_json(self) -> dict:
        """JSON-able dump: chunk rows + runtime events + the aggregate."""
        return {"chunks": self.rows(), "events": self.event_rows(),
                "aggregate": self.aggregate()}

    @classmethod
    def from_json(cls, d: dict) -> "TelemetryLog":
        """Rebuild a log from ``to_json`` output (the aggregate is
        recomputed from the rows, never trusted)."""
        log = cls()
        log.chunks = [ChunkStats(**row) for row in d.get("chunks", [])]
        log.events = [RuntimeEvent(**row) for row in d.get("events", [])]
        return log

    def aggregate(self) -> dict:
        if not self.chunks:
            return {"n_chunks": 0, "n_events": 0, "events_per_s": 0.0}
        n_events = sum(c.n_events for c in self.chunks)
        # Aggregate throughput charges the host-side refresh time too —
        # per-chunk events_per_s is processing-only.
        wall = sum(c.wall_s + c.refresh_wall_s for c in self.chunks)
        return {
            "n_chunks": len(self.chunks),
            "n_events": n_events,
            "wall_s": wall,
            "refresh_wall_s": sum(c.refresh_wall_s for c in self.chunks),
            "events_per_s": n_events / max(wall, 1e-12),
            "l_e_p50_max": max(c.l_e_p50 for c in self.chunks),
            "l_e_p99_max": max(c.l_e_p99 for c in self.chunks),
            "l_e_max": max(c.l_e_max for c in self.chunks),
            "pms_shed": sum(c.pms_shed for c in self.chunks),
            "shed_calls": sum(c.shed_calls for c in self.chunks),
            "overflow": sum(c.overflow for c in self.chunks),
            "ebl_dropped": sum(c.ebl_dropped for c in self.chunks),
            "completions": sum(c.completions for c in self.chunks),
            "refreshes": sum(1 for c in self.chunks if c.refreshed),
            "max_rung": max(c.rung for c in self.chunks),
            "ladder_transitions": len(self.events_of("ladder")),
            "guard_violations": len(self.events_of("guard_violation")),
            "guard_restores": len(self.events_of("guard_restore")),
        }
