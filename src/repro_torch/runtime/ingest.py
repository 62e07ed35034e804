"""Bounded ingestion front-end with admission control (DESIGN.md §12).

Port of ``repro.runtime.ingest``.  The engine's own shedding (pSPICE PM
shedding, E-BL input drops) assumes events have already been ADMITTED
into the stream.  A serving front-end faces an earlier failure mode: the
producer outruns the service and the un-ingested backlog grows without
bound.  ``IngestQueue`` sits between ``push`` and the ``ChunkBuffer``
and applies, in order:

1. a token-bucket admission controller clocked by EVENT ARRIVAL TIME (not
   wall clock, so chaos runs replay bit-for-bit): sustained input above
   ``admit_rate`` events/sec sheds the excess uniformly;
2. watermark-based uniform input shedding with hysteresis — above
   ``high_watermark`` queued events a drop probability ramps toward
   ``shed_max`` (eSPICE-style input-level shedding, the ladder rung BELOW
   pSPICE PM shedding), and stays engaged until depth falls back under
   ``low_watermark``;
3. a hard bound: events that would push the queue past
   ``max_queue_events`` are rejected outright and the ``AdmitReport``
   raises its backpressure flag so the caller can slow the producer.

The bucket, the watermarks and the drop probability are host floats
(Python float64, as in the reference); the one random draw per shedding
offer comes from a threefry key split on the host
(``repro_torch.prng``, in the layout ``prng.PARTITIONABLE`` picks), and
its float32 uniforms compare against ``float32(p)`` — the reference's
``jax.random.uniform(sub, (n,)) >= p`` — so two queues with the same seed
and the same offer sequence admit the reference's event sets.

``IngestFrontEnd`` runs one queue per tenant lane and re-aligns the
per-lane admitted streams into the lockstep lane-stacked batches
``MultiTenantRuntime`` consumes, substituting NEUTRAL events (class 0,
no window-open: they advance sim-time but can never spawn or complete a
match) for quarantined lanes and ragged tails.  Queued events are the
queue's own copies, so a caller may reuse the tensors it offered.
"""
from __future__ import annotations

import collections
import dataclasses

import numpy as np
import torch

from repro_torch import prng
from repro_torch.cep.engine import EventBatch
from repro_torch.runtime import chunker


@dataclasses.dataclass(frozen=True)
class IngestConfig:
    """Static front-end knobs (validated at construction)."""
    max_queue_events: int = 1 << 16   # hard bound; beyond it offers reject
    high_watermark: int = 1 << 14     # shedding engages above this depth
    low_watermark: int = 1 << 12      # ... and disengages below this one
    shed_max: float = 0.9             # watermark shed probability ceiling
    admit_rate: float = 0.0           # events/sec token refill; <= 0 = off
    admit_burst: float = 4096.0       # bucket capacity (events)
    pump_chunks: int = 0              # chunks drained per push; <= 0 = all
    seed: int = 0

    def __post_init__(self):
        if self.max_queue_events < 1:
            raise ValueError("ingest.max_queue_events must be >= 1: "
                             f"{self.max_queue_events}")
        if not (0 <= self.low_watermark <= self.high_watermark
                <= self.max_queue_events):
            raise ValueError(
                "ingest watermarks must satisfy 0 <= low_watermark <= "
                "high_watermark <= max_queue_events: got "
                f"low={self.low_watermark}, high={self.high_watermark}, "
                f"max={self.max_queue_events}")
        if not 0.0 <= self.shed_max <= 1.0:
            raise ValueError("ingest.shed_max is a drop probability and "
                             f"must be in [0, 1]: {self.shed_max}")
        if self.admit_rate > 0 and self.admit_burst < 1.0:
            raise ValueError("ingest.admit_burst must be >= 1 event when "
                             f"admit_rate is on: {self.admit_burst}")


@dataclasses.dataclass
class AdmitReport:
    """One offer's admission outcome (host-side, appended per offer)."""
    offered: int
    admitted: int
    shed: int            # dropped by bucket/watermark/forced shedding
    rejected: int        # dropped by the hard queue bound
    depth: int           # queue depth after the offer
    drop_p: float        # combined drop probability applied
    backpressure: bool   # caller should slow the producer
    quarantined: bool = False


def take_rows(events: EventBatch, idx, axis: int = 0) -> EventBatch:
    """Row-gather every tensor along the event axis (new tensors)."""
    dev = events.arrival.device
    i = torch.from_numpy(np.asarray(idx, np.int64)).to(dev)
    return EventBatch(*(x.index_select(axis, i) for x in events))


def neutral_like(events: EventBatch) -> EventBatch:
    """Same-shape events that are inert to every pattern: class 0
    (irrelevant), no window-open, no binding/id.  They still advance
    sim-time by c_base each — a quarantined lane keeps its clock moving
    without matching anything.  Arrival times are preserved."""
    return events._replace(
        ev_class=torch.zeros_like(events.ev_class),
        ev_bind=torch.full_like(events.ev_bind, -1),
        ev_open=torch.zeros_like(events.ev_open),
        ev_id=torch.full_like(events.ev_id, -1),
        ev_rand=torch.ones_like(events.ev_rand),   # never E-BL sampled
        ebl_raw=torch.zeros_like(events.ebl_raw))


def _copy(events: EventBatch, axis: int) -> EventBatch:
    return chunker.slice_events(events, 0, chunker.num_events(events, axis),
                                axis)


class IngestQueue:
    """Bounded FIFO of event batches with seeded admission control."""

    def __init__(self, cfg: IngestConfig, axis: int = 0):
        self.cfg = cfg
        self.axis = axis
        self._queue: collections.deque[EventBatch] = collections.deque()
        self._depth = 0
        self._key = prng.PRNGKey(cfg.seed, device="cpu")
        self._tokens = float(cfg.admit_burst)
        self._clock: float | None = None   # last arrival seen (stream time)
        self._shedding = False             # watermark hysteresis latch
        # The degradation ladder's input-shed rung sets this directly.
        self.forced_drop = 0.0
        self.reports: list[AdmitReport] = []
        self.total_offered = 0
        self.total_admitted = 0
        self.total_shed = 0
        self.total_rejected = 0

    @property
    def depth(self) -> int:
        return self._depth

    # -- admission ---------------------------------------------------------
    def _watermark_p(self) -> float:
        c = self.cfg
        if self._shedding:
            if self._depth < c.low_watermark:
                self._shedding = False
        elif self._depth > c.high_watermark:
            self._shedding = True
        if not self._shedding:
            return 0.0
        span = max(c.max_queue_events - c.low_watermark, 1)
        frac = (self._depth - c.low_watermark) / span
        return min(c.shed_max, c.shed_max * frac)

    def _bucket_p(self, n: int, t_now: float) -> float:
        c = self.cfg
        if c.admit_rate <= 0 or n == 0:
            return 0.0
        if self._clock is not None:
            dt = max(0.0, t_now - self._clock)
            self._tokens = min(float(c.admit_burst),
                               self._tokens + dt * c.admit_rate)
        self._clock = t_now
        avail = self._tokens
        return 0.0 if n <= avail else 1.0 - avail / n

    def offer(self, events: EventBatch, t_now: float | None = None,
              owned: bool = False) -> AdmitReport:
        """Admit (a uniform subset of) ``events`` into the queue.
        ``t_now`` is the batch's largest arrival (float32, widened) when
        the caller already read it; ``owned`` says the queue may keep the
        tensors as they are (else it keeps a copy)."""
        n = chunker.num_events(events, self.axis)
        if t_now is None:
            t_now = float(events.arrival.max()) if n else 0.0
        p = max(self._watermark_p(), self._bucket_p(n, t_now),
                float(self.forced_drop))
        if n == 0:
            rep = AdmitReport(0, 0, 0, 0, self._depth, p,
                              self._depth > self.cfg.high_watermark)
            self.reports.append(rep)
            return rep
        if p >= 1.0:
            kept = 0
            events = None
        elif p > 0.0:
            keys = prng.split(self._key)
            self._key, sub = keys[0], keys[1]
            keep = prng.uniform(sub, (n,)) >= torch.tensor(np.float32(p))
            idx = np.nonzero(keep.numpy())[0]
            kept = int(idx.size)
            events = take_rows(events, idx, self.axis) if kept else None
        else:
            kept = n
            if not owned:
                events = _copy(events, self.axis)
        shed = n - kept
        # Hard bound: reject what does not fit (drop-from-tail).
        room = self.cfg.max_queue_events - self._depth
        rejected = max(0, kept - room)
        if rejected:
            keep_n = kept - rejected
            events = chunker.slice_events(events, 0, keep_n, self.axis) \
                if keep_n else None
            kept = keep_n
        if kept:
            self._queue.append(events)
            self._depth += kept
            self._tokens = max(0.0, self._tokens - kept)
        rep = AdmitReport(
            offered=n, admitted=kept, shed=shed, rejected=rejected,
            depth=self._depth, drop_p=float(p),
            backpressure=rejected > 0
            or self._depth > self.cfg.high_watermark)
        self.reports.append(rep)
        self.total_offered += n
        self.total_admitted += kept
        self.total_shed += shed
        self.total_rejected += rejected
        return rep

    # -- drain -------------------------------------------------------------
    def take(self, max_events: int | None = None,
             drain: bool = False) -> EventBatch | None:
        """Dequeue up to ``max_events`` admitted events in arrival order.
        ``drain`` is accepted for signature parity with
        ``IngestFrontEnd.take`` (a single queue has no lane raggedness)."""
        k = self._depth if max_events is None \
            else min(self._depth, max_events)
        if k <= 0:
            return None
        pieces, got = [], 0
        while got < k:
            batch = self._queue[0]
            n = chunker.num_events(batch, self.axis)
            if n <= k - got:
                pieces.append(batch)
                self._queue.popleft()
                got += n
            else:
                cut = k - got
                pieces.append(chunker.slice_events(batch, 0, cut, self.axis))
                self._queue[0] = chunker.slice_events(batch, cut, n,
                                                      self.axis)
                got += cut
        self._depth -= k
        out = pieces[0]
        for p in pieces[1:]:
            out = chunker.concat_events(out, p, self.axis)
        return out

    def purge(self) -> int:
        """Drop everything queued (lane quarantine); returns the count."""
        n = self._depth
        self._queue.clear()
        self._depth = 0
        return n

    # -- durable state (repro_torch.runtime.persist) -----------------------
    def control_state(self) -> dict:
        """JSON control state: everything a bitwise-identical replay of
        future offers needs — bucket tokens + arrival clock, watermark
        latch, forced drop, the PRNG key (as the reference's two uint32
        words), and the counters.  (Queued EVENTS travel separately as a
        snapshot section; the ``reports`` list is in-memory forensics and
        is not restored.)"""
        return {"tokens": self._tokens, "clock": self._clock,
                "shedding": self._shedding,
                "forced_drop": float(self.forced_drop),
                "key": self._key.numpy().view(np.uint32).tolist(),
                "totals": [self.total_offered, self.total_admitted,
                           self.total_shed, self.total_rejected]}

    def restore_control_state(self, d: dict) -> None:
        self._tokens = float(d["tokens"])
        self._clock = None if d["clock"] is None else float(d["clock"])
        self._shedding = bool(d["shedding"])
        self.forced_drop = float(d["forced_drop"])
        self._key = torch.from_numpy(
            np.asarray(d["key"], dtype=np.uint32).view(np.int32).copy())
        (self.total_offered, self.total_admitted, self.total_shed,
         self.total_rejected) = (int(x) for x in d["totals"])

    def queued_events(self) -> EventBatch | None:
        """Everything queued as ONE batch (arrival order), or None."""
        if self._depth == 0:
            return None
        batches = list(self._queue)
        out = batches[0]
        for b in batches[1:]:
            out = chunker.concat_events(out, b, self.axis)
        return out

    def restore_queued(self, events: EventBatch | None) -> None:
        """Reset the queue contents from a snapshot section.  A single
        concatenated batch dequeues identically to the original deque
        (``take`` slices across batch boundaries anyway)."""
        self._queue.clear()
        self._depth = 0
        if events is not None:
            n = chunker.num_events(events, self.axis)
            if n:
                self._queue.append(events)
                self._depth = n


class IngestFrontEnd:
    """Per-lane ``IngestQueue`` set for ``MultiTenantRuntime``.

    Offers accept lane-stacked batches (leading ``(L,)`` axis) and fan out
    per lane; ``take`` re-aligns the admitted streams into a lockstep
    lane-stacked batch.  Because per-lane shedding is independent, lane
    depths diverge — ``take`` dequeues the aligned minimum and leaves the
    rest queued; ``drain=True`` (end of stream) pads short lanes with
    neutral events instead so nothing stays stranded.  Quarantined lanes
    contribute neutral substitutes until their tick count expires.
    """

    def __init__(self, cfg: IngestConfig, num_lanes: int):
        self.cfg = cfg
        self.num_lanes = num_lanes
        self.queues = [
            IngestQueue(dataclasses.replace(cfg, seed=cfg.seed + lane))
            for lane in range(num_lanes)]
        self._quarantine: dict[int, int] = {}   # lane -> remaining offers

    @property
    def depth(self) -> int:
        """Aligned depth: events dequeuable NOW in lockstep."""
        ds = [q.depth for lane, q in enumerate(self.queues)
              if lane not in self._quarantine]
        return min(ds) if ds else 0

    @property
    def max_depth(self) -> int:
        return max((q.depth for lane, q in enumerate(self.queues)
                    if lane not in self._quarantine), default=0)

    @property
    def forced_drop(self) -> float:
        return self.queues[0].forced_drop if self.queues else 0.0

    @forced_drop.setter
    def forced_drop(self, p: float) -> None:
        for q in self.queues:
            q.forced_drop = p

    @property
    def reports(self) -> list[AdmitReport]:
        return [r for q in self.queues for r in q.reports]

    def quarantined_lanes(self) -> list[int]:
        return sorted(self._quarantine)

    def quarantine_lane(self, lane: int, offers: int) -> int:
        """Quarantine ``lane`` for the next ``offers`` offer cycles; its
        queued events are purged and new offers dropped meanwhile."""
        self._quarantine[lane] = max(1, offers)
        return self.queues[lane].purge()

    def offer(self, events_lanes: EventBatch) -> list[AdmitReport]:
        """Offer a lane-stacked batch: one copy of it and one read of every
        lane's largest arrival, then each lane's admission."""
        n = chunker.num_events(events_lanes, 1)
        own = _copy(events_lanes, 1)
        t_now = own.arrival.amax(dim=1).cpu().tolist() if n \
            else [0.0] * self.num_lanes
        return [self.offer_lane(lane, EventBatch(*(x[lane] for x in own)),
                                t_now=t_now[lane], owned=True)
                for lane in range(self.num_lanes)]

    def offer_lane(self, lane: int, events: EventBatch,
                   t_now: float | None = None,
                   owned: bool = False) -> AdmitReport:
        if lane in self._quarantine:
            n = chunker.num_events(events, 0)
            q = self.queues[lane]
            q.total_offered += n
            q.total_shed += n
            rep = AdmitReport(offered=n, admitted=0, shed=n, rejected=0,
                              depth=0, drop_p=1.0, backpressure=False,
                              quarantined=True)
            q.reports.append(rep)
            self._quarantine[lane] -= 1
            if self._quarantine[lane] <= 0:
                del self._quarantine[lane]
            return rep
        return self.queues[lane].offer(events, t_now=t_now, owned=owned)

    def take(self, max_events: int | None = None,
             drain: bool = False) -> EventBatch | None:
        active = [lane for lane in range(self.num_lanes)
                  if lane not in self._quarantine]
        if not active:
            return None
        depths = [self.queues[lane].depth for lane in active]
        k = max(depths) if drain else min(depths)
        if max_events is not None:
            k = min(k, max_events)
        if k <= 0:
            return None
        batches: list[EventBatch | None] = [None] * self.num_lanes
        ref = None
        for lane in active:
            b = self.queues[lane].take(k)
            batches[lane] = self._pad_neutral(b, k) if b is not None \
                else None
            if batches[lane] is not None and ref is None:
                ref = batches[lane]
        if ref is None:
            return None
        for lane in range(self.num_lanes):
            if batches[lane] is None:
                batches[lane] = neutral_like(ref)
        return EventBatch(*(torch.stack(xs) for xs in zip(*batches)))

    # -- durable state (repro_torch.runtime.persist) -----------------------
    def control_state(self) -> dict:
        """Per-lane queue control + the quarantine map; queued events per
        lane travel as separate snapshot sections keyed by lane index."""
        return {"lanes": [q.control_state() for q in self.queues],
                "quarantine": {str(k): int(v)
                               for k, v in self._quarantine.items()}}

    def restore_control_state(self, d: dict) -> None:
        for q, qd in zip(self.queues, d["lanes"]):
            q.restore_control_state(qd)
        self._quarantine = {int(k): int(v)
                            for k, v in d["quarantine"].items()}

    @staticmethod
    def _pad_neutral(events: EventBatch, k: int) -> EventBatch:
        n = chunker.num_events(events, 0)
        if n >= k:
            return events
        # Repeat the last row (keeps arrival monotone), neutralized.
        tail = neutral_like(take_rows(events, np.full(k - n, n - 1)))
        return chunker.concat_events(events, tail)
