"""Chunked ingestion: fixed-size micro-batches over unbounded streams
(DESIGN.md §7).

Port of ``repro.runtime.chunker``.  The chunker turns any sequence of
``EventBatch`` pushes into fixed-size chunks: full chunks stream through
the engine with their global start index, the remainder is buffered
until the next push, and ``drain`` flushes it as one smaller tail chunk.
Because event indices are global, chunked execution is bitwise-identical
to the monolithic scan.

``axis`` selects the event axis: 0 for plain event batches, 1 for
lane-stacked ones (leading ``(L,)`` lane axis, repro_torch.runtime.lanes).
A PyTorch slice is a view, so every slice here is a copy: nothing the
chunker hands out aliases a pushed batch.
"""
from __future__ import annotations

from typing import Iterator

import torch

from repro_torch.cep.engine import EventBatch


def num_events(events: EventBatch, axis: int = 0) -> int:
    return events.ev_class.shape[axis]


# Per-dispatch event budget the auto-grouping policy targets: small chunks
# group until one dispatch covers ~this many events (the reference's
# BENCH_engine.json chunk sweep, made on the CPU: chunk=256 went from 12.6%
# over the monolithic scan at a fixed group of 16 to parity at 32).
GROUP_EVENT_BUDGET = 8192


def suggested_group_chunks(chunk_size: int) -> int:
    """Default macro-batch size (chunks per dispatch) for a chunk size.

    Chunks below 1024 events group until a dispatch covers at most
    ``GROUP_EVENT_BUDGET`` events — the budget is a CAP, not a floor.
    Larger chunks keep the group of 16 (budget-exempt)."""
    if chunk_size <= 0:
        raise ValueError(f"chunk_size must be positive: {chunk_size}")
    if chunk_size >= 1024:
        return 16
    return max(1, GROUP_EVENT_BUDGET // chunk_size)


def slice_events(events: EventBatch, start: int, stop: int,
                 axis: int = 0) -> EventBatch:
    """Events ``[start, stop)`` along ``axis``, as new tensors."""
    return EventBatch(*(x.narrow(axis, start, stop - start).clone(
        memory_format=torch.contiguous_format) for x in events))


def concat_events(a: EventBatch | None, b: EventBatch,
                  axis: int = 0) -> EventBatch:
    if a is None or num_events(a, axis) == 0:
        return b
    return EventBatch(*(torch.cat([x, y], dim=axis) for x, y in zip(a, b)))


def iter_chunks(events: EventBatch, chunk_size: int, start: int = 0,
                axis: int = 0) -> Iterator[tuple[int, EventBatch]]:
    """Yield ``(global_start, chunk)`` pairs covering ``events``; the last
    chunk may be shorter (non-divisor streams are first-class)."""
    n = num_events(events, axis)
    for s in range(0, n, chunk_size):
        yield start + s, slice_events(events, s, min(s + chunk_size, n),
                                      axis)


class ChunkBuffer:
    """Reorders arbitrary-size pushes into fixed-size chunks.

    ``push`` returns the full chunks now available (each tagged with its
    global start index); a trailing remainder stays buffered.  ``drain``
    returns the remainder as one final short chunk.
    """

    def __init__(self, chunk_size: int, axis: int = 0):
        if chunk_size <= 0:
            raise ValueError(f"chunk_size must be positive: {chunk_size}")
        self.chunk_size = chunk_size
        self.axis = axis
        self._pending: EventBatch | None = None
        self._next_start = 0  # global index of the first buffered event

    @property
    def pending(self) -> int:
        return 0 if self._pending is None \
            else num_events(self._pending, self.axis)

    @property
    def next_start(self) -> int:
        return self._next_start

    def buffered(self) -> EventBatch | None:
        """A copy of the sub-chunk remainder (None when empty) — what a
        durable snapshot must carry so a recovered buffer resumes
        mid-chunk."""
        if self._pending is None:
            return None
        return slice_events(self._pending, 0,
                            num_events(self._pending, self.axis), self.axis)

    def restore(self, pending: EventBatch | None, next_start: int) -> None:
        """Reset buffer state from a snapshot (repro_torch.runtime.persist);
        the buffer keeps a copy of ``pending``."""
        self._pending = None if pending is None else slice_events(
            pending, 0, num_events(pending, self.axis), self.axis)
        self._next_start = int(next_start)

    def push(self, events: EventBatch) -> list[tuple[int, EventBatch]]:
        start, region, n_chunks = self.push_region(events)
        if n_chunks == 0:
            return []
        return list(iter_chunks(region, self.chunk_size, start=start,
                                axis=self.axis))

    def push_region(self, events: EventBatch) \
            -> tuple[int, EventBatch | None, int]:
        """Like ``push`` but returns the full-chunk region unsliced:
        ``(global_start, region, n_full_chunks)`` with ``region`` holding
        ``n_full_chunks · chunk_size`` events (None when no full chunk is
        available).  The runtime runs the region in chunk groups.  The
        tail stays buffered exactly as with ``push``.  The region (and
        everything ``drain`` later returns) never aliases the pushed
        batch."""
        buf = concat_events(self._pending, events, self.axis)
        n = num_events(buf, self.axis)
        n_full = (n // self.chunk_size) * self.chunk_size
        start = self._next_start
        region = slice_events(buf, 0, n_full, self.axis) if n_full else None
        self._pending = slice_events(buf, n_full, n, self.axis) \
            if n > n_full else None
        self._next_start += n_full
        return start, region, n_full // self.chunk_size

    def drain(self) -> list[tuple[int, EventBatch]]:
        if self._pending is None:
            return []
        out = [(self._next_start, self._pending)]
        self._next_start += num_events(self._pending, self.axis)
        self._pending = None
        return out
