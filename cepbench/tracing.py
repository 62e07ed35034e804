"""What a traced run reads: the profiler's device operations and the
harness's spans, cut to the measured window, and the reductions every
per-layer metric shares (busy time, idle gaps, time by operation).

Times are in nanoseconds on the profiler's clock, which the device's
operations and the host's spans share.
"""
from __future__ import annotations

import dataclasses

import numpy as np

SPANS = ("session.start", "push", "harness")


@dataclasses.dataclass
class Trace:
    """One traced window: ``t0``, ``t1`` its ends; device operations as
    parallel arrays; the harness's spans by name; the host's operations
    (for naming idle gaps); ``counts`` the harness's and the program's
    counters over the window; ``config`` and ``cell`` the files run."""
    t0: int
    t1: int
    dev_name: list
    dev_start: np.ndarray
    dev_end: np.ndarray
    spans: dict
    host_name: list
    host_start: np.ndarray
    host_end: np.ndarray
    counts: dict
    config: dict
    cell: dict

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) * 1e-9


def _time(ev, what: str) -> int:
    f = getattr(ev, what + "_ns", None)
    if f is not None:
        return int(f())
    return int(getattr(ev, what + "_us")() * 1000)


def from_profiler(prof, counts: dict, config: dict, cell: dict) -> Trace:
    """The window's trace from a finished ``torch.profiler.profile``: the
    window runs from the first span's start to the last span's end."""
    dev, host, spans = [], [], {k: [] for k in SPANS}
    for ev in prof.profiler.kineto_results.events():
        start = _time(ev, "start")
        end = start + _time(ev, "duration")
        name = ev.name()
        if name in spans:
            # A span shows on the host and, as an annotation, on the
            # device's timeline: the host's is the span.
            if ev.device_type().name != "CUDA":
                spans[name].append((start, end))
        elif ev.device_type().name == "CUDA":
            dev.append((name, start, end))
        else:
            host.append((name, start, end))
    marks = [t for v in spans.values() for s in v for t in s]
    if not marks:
        raise RuntimeError("the profiler recorded none of the harness's "
                           "spans")
    t0, t1 = min(marks), max(marks)
    dev = [d for d in dev if d[2] > t0 and d[1] < t1]
    host = [h for h in host if h[2] > t0 and h[1] < t1]
    col = lambda xs, k: np.array([x[k] for x in xs], np.int64)  # noqa: E731
    return Trace(t0=t0, t1=t1, dev_name=[d[0] for d in dev],
                 dev_start=col(dev, 1), dev_end=col(dev, 2),
                 spans={k: sorted(v) for k, v in spans.items()},
                 host_name=[h[0] for h in host], host_start=col(host, 1),
                 host_end=col(host, 2), counts=dict(counts), config=config,
                 cell=cell)


def union(start: np.ndarray, end: np.ndarray, lo: int, hi: int
          ) -> list[tuple[int, int]]:
    """The union of intervals [start, end) clipped to [lo, hi), sorted."""
    s, e = np.clip(start, lo, hi), np.clip(end, lo, hi)
    keep = e > s
    order = np.argsort(s[keep], kind="stable")
    out: list[list[int]] = []
    for a, b in zip(s[keep][order].tolist(), e[keep][order].tolist()):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def busy_ns(tr: Trace, lo: int | None = None, hi: int | None = None) -> int:
    """Device time in [lo, hi) (the window by default) in which some
    device operation ran."""
    return int(busy_within(tr, [(tr.t0 if lo is None else lo,
                                 tr.t1 if hi is None else hi)])[0])


def busy_within(tr: Trace, spans: list) -> np.ndarray:
    """``busy_ns`` of each (lo, hi) of ``spans`` at once."""
    u = np.array(union(tr.dev_start, tr.dev_end, tr.t0, tr.t1),
                 np.int64).reshape(-1, 2)
    cum = np.concatenate([[0], np.cumsum(u[:, 1] - u[:, 0])])
    out = np.zeros(len(spans), np.int64)
    for k, (lo, hi) in enumerate(spans):
        i0 = np.searchsorted(u[:, 1], lo, side="right")
        i1 = np.searchsorted(u[:, 0], hi, side="left")
        if i1 <= i0:
            continue
        tot = cum[i1] - cum[i0]
        tot -= max(0, lo - u[i0, 0])
        tot -= max(0, u[i1 - 1, 1] - hi)
        out[k] = tot
    return out


def idle_gaps(tr: Trace) -> list[tuple[int, int]]:
    """The window's stretches with no device operation running."""
    busy = union(tr.dev_start, tr.dev_end, tr.t0, tr.t1)
    gaps, at = [], tr.t0
    for a, b in busy:
        if a > at:
            gaps.append((at, a))
        at = max(at, b)
    if at < tr.t1:
        gaps.append((at, tr.t1))
    return gaps


def _host_at(tr: Trace, t: int) -> str:
    """The harness span and the innermost host operation running at t."""
    span = next((k for k, v in tr.spans.items() for a, b in v if a <= t < b),
                "outside the spans")
    inside = (tr.host_start <= t) & (tr.host_end > t)
    if not inside.any():
        return span
    idx = np.nonzero(inside)[0]
    k = idx[np.argmin(tr.host_end[idx] - tr.host_start[idx])]
    return f"{span}: {tr.host_name[k]}"


def idle_by_span(tr: Trace) -> dict:
    """Idle device time (ns) by the harness span the host was in."""
    gaps = np.array(idle_gaps(tr), np.int64).reshape(-1, 2)
    mid = (gaps[:, 0] + gaps[:, 1]) // 2
    out = {}
    left = np.ones(len(mid), bool)
    for name, v in tr.spans.items():
        if not v:
            continue
        a = np.array(v, np.int64)
        k = np.searchsorted(a[:, 0], mid, side="right") - 1
        inside = (k >= 0) & (mid < a[np.maximum(k, 0), 1]) & left
        out[name] = int((gaps[inside, 1] - gaps[inside, 0]).sum())
        left &= ~inside
    out["outside the spans"] = int((gaps[left, 1] - gaps[left, 0]).sum())
    return out


def breakdown(tr: Trace, top: int = 10) -> dict:
    """The device operations that took most time; the idle time by the
    harness span the host was in (``idle in <span>``), then the longest
    single idle gaps named by the span and the innermost host operation
    at their middle; in seconds."""
    tot: dict[str, int] = {}
    for n, a, b in zip(tr.dev_name, tr.dev_start.tolist(),
                       tr.dev_end.tolist()):
        tot[n] = tot.get(n, 0) + (min(b, tr.t1) - max(a, tr.t0))
    ops = sorted(tot.items(), key=lambda kv: -kv[1])[:top]
    by_span = sorted(((f"idle in {k}", v) for k, v in
                      idle_by_span(tr).items() if v),
                     key=lambda kv: -kv[1])
    gaps = sorted(idle_gaps(tr), key=lambda g: g[0] - g[1])
    longest = [(_host_at(tr, (a + b) // 2), b - a)
               for a, b in gaps[:max(0, top - len(by_span))]]
    return {"device_ops": [[n, v * 1e-9] for n, v in ops],
            "idle_gaps": [[n, v * 1e-9] for n, v in by_span + longest]}
