"""The streaming runtime: chunk lifecycle orchestration (DESIGN.md §7).

Port of ``repro.runtime.service``.  ``StreamRuntime`` (one tenant) and
``MultiTenantRuntime`` (L tenant lanes in lockstep) drive the engine
chunk-by-chunk over unbounded streams:

    push(events) ─→ ChunkBuffer ─→ [engine scan / lane scan], per chunk
         ▲                              │ owned carry, global start
         │ host-side control            ▼
         └── telemetry ◄── refresh? ◄── stats vector

Between chunks the host reads telemetry, and — on the refresh cadence —
re-estimates the Markov/utility model and the latency regression from the
carry's accumulated observations (``repro_torch.runtime.refresh``), so
the shedder tracks drifting stream statistics.  The runtime owns its
carry: the block kernel updates it in place chunk after chunk, so
steady-state memory is constant however long the stream runs.

The reference's resilience layer and durable persistence (ingest
admission, the degradation ladder, the carry guard, snapshots and the
write-ahead log) and its sharded lanes are not ported yet: their
configuration knobs raise ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Sequence

import torch

from repro_torch.cep import engine as eng
from repro_torch.cep import patterns as pat
from repro_torch.device import check_on, resolve_device
from repro_torch.runtime import chunker, lanes as LN, refresh as RF, \
    telemetry as TM

_LATER = ("belongs to the port's resilience and persistence slice "
          "(ROADMAP.md queue 1, item 3b), not ported yet")


@dataclasses.dataclass(frozen=True)
class RuntimeConfig:
    chunk_size: int = 1024
    refresh: RF.RefreshConfig | None = None
    # Macro-batching (DESIGN.md §8): up to this many consecutive full
    # chunks run per group, whose per-chunk telemetry vectors cross to the
    # host in ONE transfer.  Groups never cross a refresh boundary, so the
    # host keeps its control cadence.  None (the default) sizes the group
    # from the chunk size (``chunker.suggested_group_chunks``); 1 disables
    # grouping.
    group_chunks: int | None = None
    # The reference's resilience layer and persistence: must stay None.
    ingest: object | None = None
    ladder: object | None = None
    guard: object | None = None
    persist: object | None = None

    def __post_init__(self):
        if self.chunk_size < 1:
            raise ValueError("runtime chunk_size must be >= 1 event: "
                             f"{self.chunk_size}")
        if self.group_chunks is not None and self.group_chunks < 1:
            raise ValueError(
                "runtime group_chunks must be >= 1 chunk per dispatch, or "
                f"None for the auto policy: {self.group_chunks}")
        for name in ("ingest", "ladder", "guard", "persist"):
            if getattr(self, name) is not None:
                raise NotImplementedError(f"RuntimeConfig.{name} {_LATER}")

    def effective_group_chunks(self) -> int:
        if self.group_chunks is None:
            return chunker.suggested_group_chunks(self.chunk_size)
        return max(1, self.group_chunks)


def _run_group(scan_fn, cfg: eng.EngineConfig, model: eng.EngineModel,
               events: eng.EventBatch, carry: eng.Carry, start: int, g: int,
               axis: int) -> tuple[eng.Carry, torch.Tensor]:
    """g consecutive chunks of ``events`` (the event axis ``axis``), each
    through the engine scan ``scan_fn`` with the carry handed over, so
    results equal g sequential chunk calls bit for bit.  Each chunk's
    stats vector is computed on the device and its StepOut dropped;
    returns the carry and the (g, 11) vectors, still on the device."""
    cs = chunker.num_events(events, axis) // g
    vecs = []
    for b in range(g):
        piece = eng.EventBatch(*(x.narrow(axis, b * cs, cs)
                                 for x in events))
        carry, outs = scan_fn(cfg, model, piece, carry,
                              eng.wrap_event_index(start + b * cs), own=True)
        vecs.append(TM.device_chunk_stats(outs, carry))
    return carry, torch.stack(vecs)


class StreamRuntime:
    """Single-tenant chunked runtime over one event stream.

    ``push`` ingests any number of events (the tail shorter than a chunk
    stays buffered); ``flush`` drains the remainder.  Chunked execution is
    bitwise-identical to one monolithic ``run_engine`` scan of the same
    events — chunking changes memory behavior and control cadence, never
    results.  Runs on CUDA unless ``device="cpu"``; the model (and a
    carry passed in, which the runtime then owns and updates) must lie
    there.
    """

    _axis = 0

    def __init__(self, cfg: eng.EngineConfig, model: eng.EngineModel,
                 rt: RuntimeConfig | None = None,
                 specs: Sequence[pat.PatternSpec] | None = None,
                 carry: eng.Carry | None = None, seed: int = 0,
                 device=None):
        self.device = resolve_device(device)
        check_on(self.device, trans=model.trans, ut_tables=model.ut_tables)
        self.cfg = cfg
        self.model = model
        self.rt = rt or RuntimeConfig()
        self.specs = list(specs) if specs is not None else None
        if self._refresh_on() and not cfg.gather_stats:
            raise ValueError("model refresh needs cfg.gather_stats=True "
                             "(the carry must accumulate observations)")
        if self._refresh_on() and self.specs is None:
            raise ValueError("model refresh needs the PatternSpec list")
        if self._refresh_on():
            # Refresh must never change array shapes mid-stream: widen
            # the utility tables to refresh width up front.
            self.model = RF.prepare_model(self.specs, self.model,
                                          self.rt.refresh)
        self.carry = carry if carry is not None else self._init_carry(seed)
        check_on(self.device, active=self.carry.pms.active,
                 sim_time=self.carry.sim_time)
        self.telemetry = TM.TelemetryLog()
        self.refresh_state = self._refresh_states()
        self._buf = chunker.ChunkBuffer(self.rt.chunk_size, axis=self._axis)
        self._chunk_i = 0
        self.events_processed = 0
        self._snapshot: dict[str, float] | None = None

    # -- what the lane runtime overrides ------------------------------------
    def _init_carry(self, seed: int) -> eng.Carry:
        return eng.init_carry(self.cfg, seed=seed, device=self.device)

    def _refresh_states(self):
        return RF.RefreshState()

    @staticmethod
    def _scan(cfg, model, events, carry, start, own):
        return eng._scan_events_backend(cfg, model, events, carry, start,
                                        own=own)

    def _n_lanes(self) -> int:
        return 1

    def _run(self, chunk: eng.EventBatch, start: int):
        eng._check_inputs(self.device, self.model, chunk, self.carry)
        return self._scan(self.cfg, self.model, chunk, self.carry,
                          eng.wrap_event_index(start), own=True)

    def _refresh_on(self) -> bool:
        r = self.rt.refresh
        return r is not None and r.every_chunks > 0

    def _maybe_refresh(self) -> bool:
        if not self._refresh_on() \
           or self._chunk_i % self.rt.refresh.every_chunks != 0:
            return False
        self.model, self.carry, did = RF.refresh_model(
            self.specs, self.cfg, self.model, self.carry, self.rt.refresh,
            self.refresh_state)
        return did

    # -- ingestion ----------------------------------------------------------
    def push(self, events: eng.EventBatch,
             flush: bool = False) -> list[TM.ChunkStats]:
        """Ingest events; run every full chunk now available.  With
        ``flush`` the sub-chunk remainder runs too (end of stream).

        Consecutive full chunks run in GROUPS of up to ``group_chunks``
        chunks, never crossing a refresh boundary, with one transfer of
        the group's stats vectors and results and per-chunk stats
        identical to chunk-at-a-time execution."""
        start, region, n_chunks = self._buf.push_region(events)
        stats = self._run_region(start, region, n_chunks)
        if flush:
            stats += self.flush()
        return stats

    def flush(self) -> list[TM.ChunkStats]:
        """Run the buffered remainder as one final short chunk."""
        return [self._run_piece(start, chunk)
                for start, chunk in self._buf.drain()]

    def _chunks_to_boundary(self) -> int:
        """Chunks until the next refresh decision — groups must not cross
        it, or the host would lose its control cadence."""
        if not self._refresh_on():
            return 1 << 30
        every = self.rt.refresh.every_chunks
        return every - (self._chunk_i % every)

    def _run_region(self, start: int, region: eng.EventBatch | None,
                    n_chunks: int) -> list[TM.ChunkStats]:
        stats: list[TM.ChunkStats] = []
        cs, j = self.rt.chunk_size, 0
        while j < n_chunks:
            g = min(n_chunks - j, self.rt.effective_group_chunks(),
                    self._chunks_to_boundary())
            # push_region owns the region, so groups are views of it.
            piece = eng.EventBatch(*(x.narrow(self._axis, j * cs, g * cs)
                                     for x in region))
            if g == 1:
                stats.append(self._run_piece(start + j * cs, piece))
            else:
                stats += self._run_group(start + j * cs, piece, g)
            j += g
        return stats

    def _run_group(self, start: int, piece: eng.EventBatch,
                   g: int) -> list[TM.ChunkStats]:
        before = self._snapshot or TM.counter_snapshot(self.carry)
        cs, n_lanes = self.rt.chunk_size, self._n_lanes()
        eng._check_inputs(self.device, self.model, piece, self.carry)
        t0 = time.perf_counter()
        self.carry, vecs = _run_group(self._scan, self.cfg, self.model,
                                      piece, self.carry, start, g,
                                      self._axis)
        vecs = vecs.cpu().numpy()              # ONE transfer for g chunks
        wall = time.perf_counter() - t0
        out = []
        for b in range(g):
            self._chunk_i += 1
            out.append(TM.summarize_chunk(
                self._chunk_i - 1, start + b * cs, n_lanes * cs, n_lanes,
                vecs[b], before, wall / g))
            before = TM.counters_from_vec(vecs[b])
        # g never crosses a refresh boundary, so at most the LAST chunk of
        # the group lands on one.
        t1 = time.perf_counter()
        out[-1].refreshed = self._maybe_refresh()
        out[-1].refresh_wall_s = time.perf_counter() - t1
        self._snapshot = before
        for s in out:
            self.telemetry.append(s)
            self.events_processed += s.n_events
        return out

    def _run_piece(self, start: int, chunk: eng.EventBatch) -> TM.ChunkStats:
        # The previous chunk's stats vector doubles as this chunk's
        # counter baseline (refresh never touches the counters), so the
        # steady state costs exactly ONE device→host transfer per chunk.
        before = self._snapshot or TM.counter_snapshot(self.carry)
        n = chunker.num_events(chunk, self._axis)
        n_lanes = self._n_lanes()
        t0 = time.perf_counter()
        self.carry, outs = self._run(chunk, start)
        vec = TM.device_chunk_stats(outs, self.carry).cpu().numpy()
        wall = time.perf_counter() - t0
        self._chunk_i += 1
        t1 = time.perf_counter()
        refreshed = self._maybe_refresh()
        refresh_wall = time.perf_counter() - t1
        stats = TM.summarize_chunk(
            self._chunk_i - 1, start, n_lanes * n, n_lanes, vec, before,
            wall, refreshed=refreshed, refresh_wall_s=refresh_wall)
        self._snapshot = TM.counters_from_vec(vec)
        self.telemetry.append(stats)
        self.events_processed += stats.n_events
        return stats


class MultiTenantRuntime(StreamRuntime):
    """L independent tenant lanes in lockstep (repro_torch.runtime.lanes).

    Events are pushed lane-stacked — every ``EventBatch`` tensor carries a
    leading ``(L,)`` axis (``lanes.stack``) — and lanes advance in lockstep
    over aligned chunk windows.  Models may be shared
    (``lanes.broadcast_model``) or per-lane; refresh runs PER LANE from
    each lane's own carry, so tenants adapt to their own stream's drift.
    On ``backend="cuda_block"`` each W-event block of a chunk is one
    launch of the block kernel's lane instance, one CTA per lane.
    ``mesh`` (lanes spread over devices) is not ported yet.
    """

    _axis = 1

    def __init__(self, cfg: eng.EngineConfig, model: eng.EngineModel,
                 num_lanes: int, rt: RuntimeConfig | None = None,
                 specs: Sequence[pat.PatternSpec] | None = None,
                 carry: eng.Carry | None = None, seed: int = 0, mesh=None,
                 device=None):
        if mesh is not None:
            raise NotImplementedError(
                "MultiTenantRuntime(mesh=...) spreads lanes over devices: "
                "it belongs to the port's 'dist' slice (ROADMAP.md queue "
                "1, item 4), not ported yet")
        self.num_lanes = num_lanes
        super().__init__(cfg, model, rt=rt, specs=specs, carry=carry,
                         seed=seed, device=device)

    def _init_carry(self, seed: int) -> eng.Carry:
        return LN.init_lane_carries(self.cfg, self.num_lanes, seed=seed,
                                    device=self.device)

    def _refresh_states(self):
        return [RF.RefreshState() for _ in range(self.num_lanes)]

    @staticmethod
    def _scan(cfg, model, events, carry, start, own):
        return eng._scan_events_lanes_backend(cfg, model, events, carry,
                                              start, own=own)

    def _n_lanes(self) -> int:
        return self.num_lanes

    def _maybe_refresh(self) -> bool:
        if not self._refresh_on() \
           or self._chunk_i % self.rt.refresh.every_chunks != 0:
            return False
        models, carries, did = [], [], False
        for lane in range(self.num_lanes):
            m, c, d = RF.refresh_model(
                self.specs, self.cfg, LN.unstack_lane(self.model, lane),
                LN.unstack_lane(self.carry, lane), self.rt.refresh,
                self.refresh_state[lane])
            models.append(m)
            carries.append(c)
            did |= d
        if did:
            self.model = LN.stack(models)
            self.carry = LN.stack(carries)
        return did

    def merged_carry(self) -> eng.Carry:
        """All lanes folded into one L·P-pattern carry (engine.merge_carries)
        — the global view telemetry and reporting aggregate over."""
        return eng.merge_carries(self.carry)
