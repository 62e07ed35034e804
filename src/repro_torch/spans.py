"""Spans: the program's own timeline of its host work.

``span(name, n=0)`` brackets one step of the host's work::

    with spans.span("driver.launches") as s:
        ...
        s.n = launches          # a count the site sets
    wall = s.seconds

Every span reads ``time.time_ns()`` at its entry and exit, always, so a
caller may take its duration (``seconds``) as its own timing.  A span is
RECORDED only while recording is on: while a torch profiler records
(``torch.profiler.profile``, any activities) or inside ``recording()``.
A record is the tuple ``(name, start_ns, end_ns, parent, n)``: ``parent``
is the index in ``records()`` of the span that was open on the same
thread when this one began (-1 for none), ``n`` the site's count
(launches, lanes, bytes).

The times are Unix-epoch nanoseconds, the clock the profiler's own
events are given on, so records line up with a profiler trace.  It is a
wall clock, not a monotonic one: where the system's time is stepped (by
NTP or by hand) while a span is open, its ``seconds``, and the
``ChunkStats.wall_s`` and ``refresh_wall_s`` taken from them, read short,
long or negative by the step.  Spans
are not ``torch.profiler.record_function`` ranges: the profiler draws
such a range on the device's timeline too, where a reader of the trace
would take it for device work.

The buffer holds at most ``CAP`` records; spans past it are counted in
``dropped()`` and not recorded.  ``clear()`` empties it.
"""
from __future__ import annotations

import contextlib
import threading
import time

import torch

CAP = 1 << 18

_profiling = torch._C._autograd._profiler_enabled
_clock = time.time_ns
_buf: list = []
_dropped = 0
_gen = 0                # bumped by clear(): older open spans are let go
_forced = 0
_lock = threading.Lock()
_local = threading.local()


def _open(name: str, start: int, n: int) -> tuple[int, int]:
    """Reserve the record of a span that begins: (the buffer's
    generation, the record's index, or -1 when the buffer is full)."""
    global _dropped
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    with _lock:
        g = _gen
        parent = stack[-1][1] if stack and stack[-1][0] == g else -1
        if len(_buf) >= CAP:
            _dropped += 1
            k = -1
        else:
            k = len(_buf)
            _buf.append((name, start, -1, parent, n))
    stack.append((g, k))
    return g, k


class span:
    """One span (see the module docstring); ``start_ns``, ``end_ns`` and
    ``seconds`` are set on exit of the ``with`` block."""

    __slots__ = ("name", "n", "start_ns", "end_ns", "_k")

    def __init__(self, name: str, n: int = 0):
        self.name = name
        self.n = n
        self._k = None

    def __enter__(self) -> "span":
        self.start_ns = t = _clock()
        if _forced or _profiling():
            self._k = _open(self.name, t, self.n)
        return self

    def __exit__(self, et, ev, tb) -> bool:
        self.end_ns = t = _clock()
        if self._k is not None:
            g, k = self._k
            self._k = None
            _local.stack.pop()
            with _lock:
                if k >= 0 and g == _gen:
                    _buf[k] = (self.name, self.start_ns, t, _buf[k][3],
                               self.n)
        return False

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-9


@contextlib.contextmanager
def recording():
    """Record spans inside the ``with`` block, profiler or not."""
    global _forced
    with _lock:
        _forced += 1
    try:
        yield
    finally:
        with _lock:
            _forced -= 1


def records() -> list[tuple]:
    """The recorded spans in the order they began; a span still open has
    ``end_ns`` -1."""
    with _lock:
        return list(_buf)


def dropped() -> int:
    """Spans not recorded since the last ``clear()``: the buffer was
    full."""
    return _dropped


def clear() -> None:
    """Empty the buffer and zero ``dropped()``.  Spans open across a
    ``clear`` are not recorded."""
    global _dropped, _gen
    with _lock:
        _buf.clear()
        _dropped = 0
        _gen += 1
