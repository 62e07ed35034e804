"""The streaming runtime: chunk lifecycle orchestration (DESIGN.md §7).

Port of ``repro.runtime.service``.  ``StreamRuntime`` (one tenant) and
``MultiTenantRuntime`` (L tenant lanes in lockstep) drive the engine
chunk-by-chunk over unbounded streams:

    push(events) ─→ [ingest] ─→ ChunkBuffer ─→ [engine scan / lane scan]
         ▲                                        │ owned carry, global start
         │ host-side control                      ▼
         └── telemetry ◄── ladder/guard ◄── refresh? ◄── stats vector

Between chunks the host reads telemetry, and — on the refresh cadence —
re-estimates the Markov/utility model and the latency regression from the
carry's accumulated observations (``repro_torch.runtime.refresh``), so
the shedder tracks drifting stream statistics.  The runtime owns its
carry: the block kernel updates it in place chunk after chunk, so
steady-state memory is constant however long the stream runs.

The resilience layer (DESIGN.md §12) — bounded admission
(``runtime.ingest``), the degradation ladder below, the carry guard
(``runtime.guard``) — and durable persistence (DESIGN.md §13: snapshots
and a write-ahead log, ``runtime.persist``) are each present only when
configured; absent, the runtime takes the plain code path and its
results stay bitwise what they were.
"""
from __future__ import annotations

import dataclasses
import functools
import os
import time
from typing import Sequence

import numpy as np
import torch

from repro_torch import spans
from repro_torch.analysis import contracts as ctr
from repro_torch.cep import engine as eng
from repro_torch.cep import patterns as pat
from repro_torch.device import check_on, resolve_device
from repro_torch.dist import mesh as DM
from repro_torch.runtime import chunker, faults as FT, guard as GD, \
    ingest as IG, lanes as LN, persist as PS, refresh as RF, \
    telemetry as TM

# Degradation-ladder rungs (DESIGN.md §12), least to most drastic.  Rung 1
# is the paper's own mechanism (pSPICE PM shedding, always armed) made
# MORE aggressive: a standing between-chunk PM trim on top of the in-scan
# Algorithm-1/2 path.  Rung 2 adds eSPICE-style input-level shedding at
# admission; rung 3 stops ingesting entirely.
RUNG_NORMAL, RUNG_PM_TRIM, RUNG_INPUT_SHED, RUNG_QUARANTINE = 0, 1, 2, 3
RUNG_NAMES = ("normal", "pm_trim", "input_shed", "quarantine")


@dataclasses.dataclass(frozen=True)
class LadderConfig:
    """Degradation-ladder state machine knobs (DESIGN.md §12)."""
    escalate_streak: int = 3     # consecutive violating chunks to go up
    deescalate_streak: int = 8   # consecutive clean chunks to come down
    trim_frac: float = 0.25      # active-PM fraction trimmed per chunk @ r1+
    input_shed_frac: float = 0.5  # forced admission drop probability @ r2+
    max_rung: int = RUNG_QUARANTINE
    latency_bound: float | None = None   # default: cfg.latency_bound

    def __post_init__(self):
        if self.escalate_streak < 1 or self.deescalate_streak < 1:
            raise ValueError(
                "ladder streaks must be >= 1 chunk: escalate_streak="
                f"{self.escalate_streak}, deescalate_streak="
                f"{self.deescalate_streak}")
        for name in ("trim_frac", "input_shed_frac"):
            v = getattr(self, name)
            if not 0.0 <= v <= 1.0:
                raise ValueError(f"ladder.{name} is a drop ratio and must "
                                 f"be in [0, 1]: {v}")
        if not RUNG_NORMAL <= self.max_rung <= RUNG_QUARANTINE:
            raise ValueError("ladder.max_rung must be one of "
                             f"{list(range(len(RUNG_NAMES)))} "
                             f"({'/'.join(RUNG_NAMES)}): {self.max_rung}")
        if self.latency_bound is not None and not self.latency_bound > 0:
            raise ValueError("ladder.latency_bound must be > 0 seconds "
                             f"(or None to use the engine's): "
                             f"{self.latency_bound}")

    def rung_needs_ingest(self) -> bool:
        """Rungs 2+ act at ADMISSION (forced input shedding) — they are
        unreachable without an ingest front-end to carry them out."""
        return self.max_rung >= RUNG_INPUT_SHED


class DegradationLadder:
    """Hysteresis state machine over latency-bound violation streaks.

    ``observe`` is called once per completed chunk with its violation
    verdict; ``escalate_streak`` consecutive violations move one rung up,
    ``deescalate_streak`` consecutive clean chunks one rung down — streak
    counters reset on every transition, so each move needs a FULL fresh
    streak.  While quarantined no chunks run, so ``quarantine_tick``
    (called per rejected push) provides the de-escalation clock instead —
    quarantine can never be a terminal state.
    """

    def __init__(self, cfg: LadderConfig):
        self.cfg = cfg
        self.rung = RUNG_NORMAL
        self._bad = 0
        self._good = 0
        self._q_ticks = 0
        self.transitions: list[dict] = []

    def _move(self, new_rung: int, chunk_index: int, why: str) -> dict:
        tr = {"from": self.rung, "to": new_rung,
              "from_name": RUNG_NAMES[self.rung],
              "to_name": RUNG_NAMES[new_rung],
              "why": why, "chunk": chunk_index}
        self.rung = new_rung
        self._bad = self._good = self._q_ticks = 0
        self.transitions.append(tr)
        return tr

    def observe(self, violated: bool, chunk_index: int) -> dict | None:
        if violated:
            self._bad += 1
            self._good = 0
            if self._bad >= self.cfg.escalate_streak \
                    and self.rung < self.cfg.max_rung:
                return self._move(self.rung + 1, chunk_index, "escalate")
        else:
            self._good += 1
            self._bad = 0
            if self._good >= self.cfg.deescalate_streak \
                    and self.rung > RUNG_NORMAL:
                return self._move(self.rung - 1, chunk_index, "deescalate")
        return None

    def quarantine_tick(self, chunk_index: int) -> dict | None:
        """De-escalation clock while no chunks flow (rung 3)."""
        self._q_ticks += 1
        if self._q_ticks >= self.cfg.deescalate_streak \
                and self.rung > RUNG_NORMAL:
            return self._move(self.rung - 1, chunk_index,
                              "quarantine_timeout")
        return None

    # -- durable state (repro_torch.runtime.persist) -----------------------
    def control_state(self) -> dict:
        """Rung + hysteresis streaks — what a checkpoint rewind restores.
        The ``transitions`` log is append-only forensics (mirrored into
        telemetry) and travels only with FULL snapshots, never with
        in-memory guard rewinds — rewinding one side of the mirror would
        break the ladder/telemetry count invariant."""
        return {"rung": self.rung, "bad": self._bad, "good": self._good,
                "q_ticks": self._q_ticks}

    def restore_control_state(self, d: dict) -> None:
        self.rung = int(d["rung"])
        self._bad = int(d["bad"])
        self._good = int(d["good"])
        self._q_ticks = int(d["q_ticks"])


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
    # Resilience layer (DESIGN.md §12) — all three default OFF, and off
    # means provably off: the runtime takes the plain code path and
    # results stay bitwise-identical.
    ingest: IG.IngestConfig | None = None    # bounded admission front-end
    ladder: LadderConfig | None = None       # degradation state machine
    guard: GD.GuardConfig | None = None      # invariant checks + restore
    # Durable persistence (DESIGN.md §13): snapshot + write-ahead log
    # under one directory.  None means the plain code path bit for bit.
    persist: PS.PersistConfig | None = None

    def __post_init__(self):
        if self.chunk_size < 1:
            raise ValueError("runtime chunk_size must be >= 1 event: "
                             f"{self.chunk_size}")
        if self.group_chunks is not None and self.group_chunks < 1:
            raise ValueError(
                "runtime group_chunks must be >= 1 chunk per dispatch, or "
                f"None for the auto policy: {self.group_chunks}")
        if self.ladder is not None and self.ladder.rung_needs_ingest() \
                and self.ingest is None:
            raise ValueError(
                "ladder.max_rung >= RUNG_INPUT_SHED needs an ingest front-"
                "end to apply input shedding/quarantine — set rt.ingest "
                "(IngestConfig) or cap ladder.max_rung at RUNG_PM_TRIM")

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
        with spans.span("runtime.chunk_stats"):
            vecs.append(TM.device_chunk_stats(outs, carry))
    return carry, torch.stack(vecs)


def _to_host(t: torch.Tensor) -> np.ndarray:
    """A chunk's (or group's) stats on the host: the runtime's one read
    of the device a chunk, spanned as ``runtime.to_host`` (n = bytes)."""
    with spans.span("runtime.to_host", n=t.numel() * t.element_size()):
        return t.cpu().numpy()


# The group step over one stream and over lane-stacked streams: the
# carry is handed over and updated in place (the reference donates it).
# Each chunk's telemetry takes two quantiles of its latencies by a sort,
# as the reference's jnp.quantile does.
_GROUP = dict(eng.HOT_PATH, donate=("carry",), waived=("no-sort",),
              waiver_note="the telemetry's per-chunk quantiles sort the "
              "chunk's latencies (one sort per chunk, not per event)")
_run_group_single = ctr.contract("runtime._run_group_single", **_GROUP)(
    functools.partial(_run_group, eng._scan_events_backend, axis=0))
_run_group_lanes = ctr.contract(
    "runtime._run_group_lanes",
    **dict(_GROUP, max_temp_bytes=None, max_gather_bytes=None))(
    functools.partial(_run_group, eng._scan_events_lanes_backend, axis=1))


def _wal_start(header: dict | None) -> int:
    """The first WAL record a snapshot did not absorb (0 without one)."""
    return 0 if header is None else int(header["control"]["wal_next_record"])


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
        with spans.span("runtime.construct"):
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
            if carry is None:
                with spans.span("runtime.init_carry", n=self._n_lanes()):
                    carry = self._init_carry(seed)
            self.carry = carry
            check_on(self.device, active=self.carry.pms.active,
                     sim_time=self.carry.sim_time)
            self.telemetry = TM.TelemetryLog()
            self.refresh_state = self._refresh_states()
            self._buf = chunker.ChunkBuffer(self.rt.chunk_size,
                                            axis=self._axis)
            self._chunk_i = 0
            self.events_processed = 0
            self._snapshot: dict[str, float] | None = None
            self._init_resilience()

    # -- what the lane runtime overrides ------------------------------------
    def _init_carry(self, seed: int) -> eng.Carry:
        return eng.init_carry(self.cfg, seed=seed, device=self.device)

    def _refresh_states(self):
        return RF.RefreshState()

    @staticmethod
    def _scan(cfg, model, events, carry, start, own):
        return eng._scan_events_backend(cfg, model, events, carry, start,
                                        own=own)

    _group = staticmethod(_run_group_single)

    def _n_lanes(self) -> int:
        return 1

    def _make_ingest(self):
        return IG.IngestQueue(self.rt.ingest)

    def _guard_lanes(self) -> int | None:
        return None

    def _trim_call(self, i: int, frac: float) -> eng.Carry:
        return GD.trim_store(self.cfg, self.model, self.carry, i, frac)

    def _group_limit(self) -> int:
        return self.rt.effective_group_chunks()

    # -- resilience layer (DESIGN.md §12) -----------------------------------
    def _init_resilience(self) -> None:
        """Ingest queue / degradation ladder / carry guard, each present
        only when its config is — absent configs leave the plain code
        path (and its results) untouched bit for bit."""
        rt = self.rt
        self.ingest = self._make_ingest() if rt.ingest is not None else None
        self.ladder = DegradationLadder(rt.ladder) \
            if rt.ladder is not None else None
        self.guard = GD.CarryGuard(rt.guard, lanes=self._guard_lanes()) \
            if rt.guard is not None else None
        self._quarantined = False
        self._event_cursor = 0       # global index after the last chunk
        self.quarantine_dropped = 0  # events refused while quarantined
        self.persist = PS.Persistence(rt.persist) \
            if rt.persist is not None else None
        self._last_snap_chunk = 0
        self._replaying = False         # True while re-pushing WAL records
        self._replay_cursor: int | None = None  # next unabsorbed record id
        if self.guard is not None:
            self.guard.save(self.carry, self.model, chunk_i=0,
                            control=self._control_state(scope="guard"))

    def _record_admission(self, rep) -> None:
        for r in (rep if isinstance(rep, list) else [rep]):
            if r.shed or r.rejected or r.quarantined:
                self.telemetry.record_event(
                    "admission", self._chunk_i, dataclasses.asdict(r))

    @property
    def backpressure(self) -> bool:
        """True when the last offer hit the hard queue bound or left the
        queue above the high watermark — slow the producer."""
        if self.ingest is None:
            return False
        reps = self.ingest.reports
        return bool(reps and reps[-1].backpressure)

    def _apply_ladder(self, tr: dict | None) -> None:
        """Record a ladder transition and apply its standing effects."""
        if tr is None:
            return
        self.telemetry.record_event("ladder", tr["chunk"], tr)
        self._apply_rung()

    def _apply_rung(self) -> None:
        """The current rung's standing effects: forced input shedding at
        rung 2+, no ingestion at rung 3."""
        rung = self.ladder.rung
        if self.ingest is not None:
            self.ingest.forced_drop = self.rt.ladder.input_shed_frac \
                if rung >= RUNG_INPUT_SHED else 0.0
        self._quarantined = rung >= RUNG_QUARANTINE

    def _after_chunk(self, out: list[TM.ChunkStats]) -> None:
        """Ladder observation + guard check at the chunk-group boundary
        (the host's control cadence — same place refresh runs)."""
        if self.ladder is not None:
            bound = self.rt.ladder.latency_bound \
                if self.rt.ladder.latency_bound is not None \
                else self.cfg.latency_bound
            for s in out:
                self._apply_ladder(
                    self.ladder.observe(s.l_e_p99 > bound, s.chunk_index))
                s.rung = self.ladder.rung
            if self.ladder.rung >= RUNG_PM_TRIM and not self._quarantined:
                # Trim bumps pms_shed/shed_calls through the engine's own
                # shed; the stale counter snapshot folds them into the
                # NEXT chunk's deltas, so aggregate telemetry stays
                # complete.
                self.carry = self._trim_call(
                    eng.wrap_event_index(self._event_cursor),
                    self.rt.ladder.trim_frac)
        if self.guard is not None:
            self._guard_tick()

    def _guard_tick(self) -> None:
        gcfg = self.rt.guard
        if self._chunk_i % gcfg.check_every_chunks != 0:
            return
        viols = self.guard.check(self.carry, self.model)
        if viols:
            self._on_violations(viols)
        elif self._chunk_i % gcfg.checkpoint_every_chunks == 0:
            # Check-then-save: a poisoned state is never checkpointed.
            self.guard.save(self.carry, self.model, self._chunk_i,
                            control=self._control_state(scope="guard"))

    def _on_violations(self, viols: list[GD.GuardViolation]) -> None:
        for v in viols:
            self.telemetry.record_event("guard_violation", self._chunk_i,
                                        v.to_row())
        if self.rt.guard.restore_on_violation and self.guard.has_checkpoint:
            self._guard_restore(viols)

    def _guard_restore(self, viols: list[GD.GuardViolation]) -> None:
        self.carry, self.model = self.guard.restore(self.carry, self.model)
        # Restore REWINDS the carry counters — the cached snapshot is
        # stale; drop it so the next chunk re-baselines from the carry.
        self._snapshot = None
        # Rewind the control state captured WITH the checkpoint: ladder
        # rung/streaks, admission tokens/clock/latch/PRNG, quarantine
        # counters — otherwise a restore resumes the tensors at the
        # checkpoint but the controllers at their post-fault values.
        ctl = self.guard.checkpoint_control
        if ctl is not None:
            self._restore_control_state(ctl, scope="guard")
        self.telemetry.record_event("guard_restore", self._chunk_i, {
            "from_chunk": self.guard.checkpoint_chunk,
            "rung": None if self.ladder is None else self.ladder.rung,
            "lanes": sorted({v.lane for v in viols
                             if v.lane is not None}) or None})

    def guard_now(self) -> list[GD.GuardViolation]:
        """Run the invariant checks immediately (end-of-run sweep, tests,
        chaos harness); restores on violation per the guard config."""
        if self.guard is None:
            raise ValueError("guard_now needs rt.guard (GuardConfig)")
        viols = self.guard.check(self.carry, self.model)
        if viols:
            self._on_violations(viols)
        return viols

    # -- durable persistence (DESIGN.md §13) --------------------------------
    def _persist_extra(self) -> dict:
        """Subclass hook: JSON-able extras carried inside every durable
        snapshot (the supervisor's match accumulator rides here)."""
        return {}

    def _persist_restore_extra(self, extra: dict) -> None:
        """Subclass hook: inverse of ``_persist_extra``."""

    def _persist_queues(self) -> list:
        """(lane, IngestQueue) pairs whose queued events + control state
        the snapshot must carry; [] without an ingest front-end."""
        if self.ingest is None:
            return []
        queues = getattr(self.ingest, "queues", None)
        return list(enumerate(queues)) if queues is not None \
            else [(0, self.ingest)]

    def _control_state(self, scope: str = "full") -> dict:
        """Host-side control state in the snapshot codec's JSON form.

        ``scope="guard"`` keeps the subset an in-memory guard restore
        rewinds (ladder rung/streaks, admission control state, quarantine
        counters); ``scope="full"`` adds stream cursors, refresh state,
        telemetry and the forensic logs for the durable snapshot.
        """
        d: dict = {"quarantine_dropped": int(self.quarantine_dropped)}
        if self.ladder is not None:
            d["ladder"] = self.ladder.control_state()
        if self.ingest is not None:
            d["ingest"] = self.ingest.control_state()
        if scope != "full":
            return d
        d["chunk_i"] = int(self._chunk_i)
        d["event_cursor"] = int(self._event_cursor)
        d["events_processed"] = int(self.events_processed)
        d["counter_snapshot"] = self._snapshot
        d["buf_next_start"] = int(self._buf.next_start)
        d["telemetry"] = self.telemetry.to_json()
        d["extra"] = self._persist_extra()
        if self.ladder is not None:
            d["ladder"]["transitions"] = [dict(t) for t in
                                          self.ladder.transitions]
        states = self.refresh_state if isinstance(self.refresh_state, list) \
            else [self.refresh_state]
        d["refresh"] = [s.to_control() for s in states]
        if self.guard is not None:
            d["guard_counters"] = self.guard.counters()
        return d

    def _restore_control_state(self, d: dict, scope: str = "full") -> None:
        self.quarantine_dropped = int(d.get("quarantine_dropped", 0))
        if self.ladder is not None and "ladder" in d:
            self.ladder.restore_control_state(d["ladder"])
            if scope == "full" and "transitions" in d["ladder"]:
                self.ladder.transitions = [dict(t) for t in
                                           d["ladder"]["transitions"]]
            self._apply_rung()
        if self.ingest is not None and "ingest" in d:
            self.ingest.restore_control_state(d["ingest"])
        if scope != "full":
            return
        self._chunk_i = int(d["chunk_i"])
        self._event_cursor = int(d["event_cursor"])
        self.events_processed = int(d["events_processed"])
        self._snapshot = d["counter_snapshot"]
        self.telemetry = TM.TelemetryLog.from_json(d["telemetry"])
        states = [RF.RefreshState.from_control(s) for s in d["refresh"]]
        if isinstance(self.refresh_state, list):
            self.refresh_state = states
        else:
            self.refresh_state = states[0]
        if self.guard is not None and "guard_counters" in d:
            self.guard.restore_counters(d["guard_counters"])
        self._persist_restore_extra(d.get("extra", {}))

    def _maybe_snapshot(self) -> bool:
        if self._chunk_i - self._last_snap_chunk \
                < self.rt.persist.snapshot_every_chunks:
            return False
        self.snapshot_now()
        return True

    def snapshot_now(self) -> str:
        """Write one durable snapshot generation (atomic + CRC, rotated;
        repro_torch.runtime.persist).  Returns the file path.  Every
        device tensor is copied to the host before the write begins."""
        if self.persist is None:
            raise ValueError("snapshot_now needs rt.persist "
                             "(PersistConfig)")
        control = self._control_state("full")
        # First WAL record NOT absorbed into this snapshot: during normal
        # operation every appended record has been pushed; during replay
        # the cursor tracks the record being re-pushed, so a snapshot cut
        # mid-recovery is itself a correct recovery point.
        control["wal_next_record"] = int(
            self._replay_cursor if self._replay_cursor is not None
            else self.persist.wal.next_record_id)
        sections: dict = {"carry": self.carry, "model": self.model,
                          "pending": self._buf.buffered()}
        for lane, q in self._persist_queues():
            sections[f"ingest_queue_{lane}"] = q.queued_events()
        if self.guard is not None and self.guard.has_checkpoint:
            ck_carry, ck_model, ck_chunk, ck_ctl = self.guard.checkpoint
            sections["guard_carry"] = ck_carry
            sections["guard_model"] = ck_model
            control["guard_ckpt"] = {"chunk": int(ck_chunk),
                                     "control": ck_ctl}
        path = self.persist.store.save(self._chunk_i, control, sections)
        self._last_snap_chunk = self._chunk_i
        return path

    def recover_from_disk(self) -> dict:
        """Restore the newest valid snapshot generation, then replay the
        WAL tail through the normal push path (DESIGN.md §13).

        Because admission, shedding, refresh and chunk grouping are all
        driven by event content and seeded PRNG chains — never wall
        clock — the recovered state is bitwise-identical to the
        uninterrupted run.  With an empty directory this is a no-op
        returning a zero report, so a fresh start and a recovery share
        one entry point.  Returns the recovery report.
        """
        if self.persist is None:
            raise ValueError("recover_from_disk needs rt.persist "
                             "(PersistConfig)")
        t0 = time.perf_counter()
        header, sections, meta = self.persist.store.load_latest()
        records = self.persist.wal.records_since(_wal_start(header))
        return self._recover(header, sections, meta, records,
                             self.persist.wal.next_record_id, t0)

    def _recover(self, header, sections, meta: dict, records: list,
                 next_record: int, t0: float) -> dict:
        """Apply the snapshot (if any), replay the WAL ``records`` through
        the push path — snapshots that fall due are written, no record is
        logged again — and return the recovery report.  ``next_record``
        is the WAL's next record id: the first push the caller has not
        logged, where its push loop resumes."""
        start_id, snap_chunk = _wal_start(header), None
        if header is not None:
            self._apply_snapshot(header, sections)
            snap_chunk = int(header["chunk_index"])
        self._replaying = True
        try:
            for rid, ev in records:
                self._replay_cursor = rid + 1
                self._ingest_events(PS.to_device(ev, self.device))
                self._maybe_snapshot()
        finally:
            self._replaying = False
            self._replay_cursor = None
        return {
            "snapshot_chunk": snap_chunk,
            "snapshot_path": None if meta["path"] is None
            else os.path.basename(meta["path"]),
            "rejected_snapshots": meta["rejected"],
            "wal_start_record": int(start_id),
            "replayed_records": len(records),
            "next_record": int(next_record),
            "recovery_wall_s": time.perf_counter() - t0,
        }

    def _apply_snapshot(self, header: dict, sections: dict) -> None:
        dev = self.device
        self.carry = PS.to_device(PS.decode_tree(
            *sections["carry"], self.carry, what="carry"), dev)
        self.model = PS.to_device(PS.decode_tree(
            *sections["model"], self.model, what="model"), dev)
        ctl = header["control"]
        tmpl = PS.event_template()
        pend = None
        if "pending" in sections:
            pend = PS.to_device(PS.decode_tree(
                *sections["pending"], tmpl, what="pending", strict=False),
                dev)
        self._buf.restore(pend, ctl["buf_next_start"])
        for lane, q in self._persist_queues():
            key = f"ingest_queue_{lane}"
            batch = None
            if key in sections:
                batch = PS.to_device(PS.decode_tree(
                    *sections[key], tmpl, what=key, strict=False), dev)
            q.restore_queued(batch)
        self._restore_control_state(ctl, scope="full")
        self._last_snap_chunk = self._chunk_i
        if self.guard is not None:
            if "guard_ckpt" in ctl and "guard_carry" in sections:
                gc = PS.decode_tree(*sections["guard_carry"], self.carry,
                                    what="guard_carry")
                gm = PS.decode_tree(*sections["guard_model"], self.model,
                                    what="guard_model")
                self.guard.load_checkpoint(
                    PS.to_device(gc, "cpu"), PS.to_device(gm, "cpu"),
                    ctl["guard_ckpt"]["chunk"],
                    ctl["guard_ckpt"]["control"])
            else:
                self.guard.save(self.carry, self.model, self._chunk_i,
                                control=self._control_state(scope="guard"))

    # -- chunk execution ----------------------------------------------------
    def _run(self, chunk: eng.EventBatch, start: int):
        eng._check_inputs(self.device, self.model, chunk, self.carry)
        return self._scan(self.cfg, self.model, chunk, self.carry,
                          eng.wrap_event_index(start), own=True)

    def _refresh_on(self) -> bool:
        r = self.rt.refresh
        return r is not None and r.every_chunks > 0

    def _refresh_due(self) -> bool:
        """True on the refresh cadence; the ``refresh`` kill site."""
        if not self._refresh_on() \
           or self._chunk_i % self.rt.refresh.every_chunks != 0:
            return False
        FT.kill_point("refresh")
        return True

    def _maybe_refresh(self) -> bool:
        if not self._refresh_due():
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
        identical to chunk-at-a-time execution.

        With an ingest front-end (``rt.ingest``) events pass admission
        control first — the admitted subset queues, and up to
        ``pump_chunks`` chunks drain into execution per push.  While
        quarantined (ladder rung 3) pushes are refused outright.

        With ``rt.persist`` the batch is appended (and flushed) to the
        write-ahead log BEFORE any processing — admission included — so
        a crash mid-push replays the whole push through this same path
        and re-derives every decision (DESIGN.md §13)."""
        with spans.span("runtime.push"):
            if self.persist is not None and not self._replaying:
                self.persist.wal.append(events)
            stats = self._ingest_events(events)
            if flush:
                stats += self.flush()
            if self.persist is not None and not self._replaying:
                self._maybe_snapshot()
        return stats

    def _ingest_events(self, events: eng.EventBatch) -> list[TM.ChunkStats]:
        if self._quarantined:
            self._quarantine_refuse(events)
            if self._quarantined:
                return []
            # the refusal ticked the ladder out of quarantine: fall
            # through and ingest this push normally
        if self.ingest is not None:
            self._record_admission(self.ingest.offer(events))
            return self._pump()
        start, region, n_chunks = self._buf.push_region(events)
        return self._run_region(start, region, n_chunks)

    def _quarantine_refuse(self, events: eng.EventBatch) -> None:
        n = chunker.num_events(events, self._axis)
        self.quarantine_dropped += n
        if self.ladder is not None:
            self._apply_ladder(self.ladder.quarantine_tick(self._chunk_i))

    def _pump(self, drain: bool = False) -> list[TM.ChunkStats]:
        limit = self.rt.ingest.pump_chunks
        budget = None if limit <= 0 else limit * self.rt.chunk_size
        ev = self.ingest.take(budget, drain=drain)
        if ev is None:
            return []
        start, region, n_chunks = self._buf.push_region(ev)
        return self._run_region(start, region, n_chunks)

    def flush(self) -> list[TM.ChunkStats]:
        """Drain the ingest queue, then the buffered remainder as one
        final short chunk."""
        stats: list[TM.ChunkStats] = []
        if self.ingest is not None:
            while not self._quarantined:
                ev = self.ingest.take(None, drain=True)
                if ev is None:
                    break
                start, region, n_chunks = self._buf.push_region(ev)
                stats += self._run_region(start, region, n_chunks)
        stats += [self._run_piece(start, chunk)
                  for start, chunk in self._buf.drain()]
        return stats

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
            g = min(n_chunks - j, self._group_limit(),
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
        cs, n_lanes = self.rt.chunk_size, self._n_lanes()
        with spans.span("runtime.chunk", n=n_lanes * g * cs):
            before = self._snapshot or TM.counter_snapshot(self.carry)
            eng._check_inputs(self.device, self.model, piece, self.carry)
            with spans.span("runtime.run") as run:
                self.carry, vecs = self._group(self.cfg, self.model, piece,
                                               self.carry, start, g)
                vecs = _to_host(vecs)          # ONE transfer for g chunks
            FT.kill_point("chunk")
            self._chunk_i += g
            # g never crosses a refresh boundary, so at most the LAST chunk
            # of the group lands on one.
            with spans.span("runtime.refresh") as refresh:
                refreshed = self._maybe_refresh()
            with spans.span("runtime.summarize"):
                out = []
                for b in range(g):
                    out.append(TM.summarize_chunk(
                        self._chunk_i - g + b, start + b * cs, n_lanes * cs,
                        n_lanes, vecs[b], before, run.seconds / g))
                    before = TM.counters_from_vec(vecs[b])
                out[-1].refreshed = refreshed
                out[-1].refresh_wall_s = refresh.seconds
                self._snapshot = before
                for s in out:
                    self.telemetry.append(s)
                    self.events_processed += s.n_events
                self._event_cursor = start + g * cs
                self._after_chunk(out)
        return out

    def _run_piece(self, start: int, chunk: eng.EventBatch) -> TM.ChunkStats:
        n = chunker.num_events(chunk, self._axis)
        n_lanes = self._n_lanes()
        with spans.span("runtime.chunk", n=n_lanes * n):
            # The previous chunk's stats vector doubles as this chunk's
            # counter baseline (refresh never touches the counters), so
            # the steady state costs exactly ONE device→host transfer per
            # chunk.
            before = self._snapshot or TM.counter_snapshot(self.carry)
            with spans.span("runtime.run") as run:
                self.carry, outs = self._run(chunk, start)
                with spans.span("runtime.chunk_stats"):
                    vec = TM.device_chunk_stats(outs, self.carry)
                vec = _to_host(vec)
            FT.kill_point("chunk")
            self._chunk_i += 1
            with spans.span("runtime.refresh") as refresh:
                refreshed = self._maybe_refresh()
            with spans.span("runtime.summarize"):
                stats = TM.summarize_chunk(
                    self._chunk_i - 1, start, n_lanes * n, n_lanes, vec,
                    before, run.seconds, refreshed=refreshed,
                    refresh_wall_s=refresh.seconds)
                self._snapshot = TM.counters_from_vec(vec)
                self.telemetry.append(stats)
                self.events_processed += stats.n_events
                self._event_cursor = start + n
                self._after_chunk([stats])
        return stats


class MultiTenantRuntime(StreamRuntime):
    """L independent tenant lanes in lockstep (repro_torch.runtime.lanes).

    Events are pushed lane-stacked — every ``EventBatch`` tensor carries a
    leading ``(L,)`` axis (``lanes.stack``) — and lanes advance in lockstep
    over aligned chunk windows.  Models may be shared
    (``lanes.broadcast_model``) or per-lane; refresh runs PER LANE from
    each lane's own carry, so tenants adapt to their own stream's drift.
    On ``backend="cuda_block"`` each W-event block of a chunk is one
    launch of the block kernel's lane instance, one CTA per lane.  With
    resilience on, admission runs one queue per lane, the guard checks
    and restores per lane, and the ladder's PM trim runs over all lanes
    at once (``guard.trim_store_lanes``).

    On a mesh (``repro_torch.dist``; every rank constructs the runtime
    and pushes the same global events) each chunk runs through
    ``dist.run_chunk_lanes_sharded``: lanes over the mesh's "data" dim,
    each lane's patterns over "model", merged after every chunk, so every
    rank holds the global carry and ingest, guard, ladder and refresh run
    on it unchanged, chunk at a time.  On an ``AbstractMesh`` (no process
    group) this process runs every rank's block
    (``dist.run_chunk_lanes_plain``).

    With more than one rank only rank 0 writes snapshots and the WAL; the
    other ranks keep its snapshot cadence (and so reach the ``snapshot``
    kill site with it) and write nothing.  ``recover_from_disk`` on such
    a world: rank 0 reads the newest valid snapshot generation and the
    WAL tail after it and broadcasts them (the snapshot as its
    CRC-checked bytes, the records encoded); every rank applies the
    snapshot and replays the records, so the replay's merges keep the
    ranks in lockstep, rank 0 alone writing the snapshots that fall due;
    every rank returns the same report, whose ``next_record`` is the
    first push the world has not logged.
    """

    _axis = 1

    def __init__(self, cfg: eng.EngineConfig, model: eng.EngineModel,
                 num_lanes: int, rt: RuntimeConfig | None = None,
                 specs: Sequence[pat.PatternSpec] | None = None,
                 carry: eng.Carry | None = None, seed: int = 0, mesh=None,
                 device=None):
        self.num_lanes = num_lanes
        self.mesh = mesh
        rank = 0 if mesh is None else DM.mesh_rank(mesh)  # checks the mesh
        # A world of several ranks: a process group behind the mesh.
        self._world = mesh is not None and mesh.size() > 1 \
            and not isinstance(mesh, DM.AbstractMesh)
        # The writer's snapshot cadence, on a rank that does not write.
        self._follow_every = None
        if rank != 0 and rt is not None and rt.persist is not None:
            # Rank 0 alone writes snapshots and the WAL.
            self._follow_every = rt.persist.snapshot_every_chunks
            rt = dataclasses.replace(rt, persist=None)
        super().__init__(cfg, model, rt=rt, specs=specs, carry=carry,
                         seed=seed, device=device)

    def _run(self, chunk: eng.EventBatch, start: int):
        if self.mesh is None:
            return super()._run(chunk, start)
        from repro_torch.dist import sharding as SH
        run = SH.run_chunk_lanes_plain \
            if isinstance(self.mesh, DM.AbstractMesh) \
            else SH.run_chunk_lanes_sharded
        return run(self.cfg, self.model, chunk, self.carry,
                   eng.wrap_event_index(start), mesh=self.mesh,
                   device=self.device)

    def _group_limit(self) -> int:
        # The sharded path has no grouped runner: chunk at a time.
        return 1 if self.mesh is not None else super()._group_limit()

    def push(self, events: eng.EventBatch,
             flush: bool = False) -> list[TM.ChunkStats]:
        stats = super().push(events, flush=flush)
        if self._follow_every is not None and not self._replaying:
            self._maybe_snapshot()
        return stats

    def _maybe_snapshot(self) -> bool:
        if self._follow_every is None:
            return super()._maybe_snapshot()
        if self._chunk_i - self._last_snap_chunk < self._follow_every:
            return False
        FT.kill_point("snapshot")       # where rank 0 writes
        self._last_snap_chunk = self._chunk_i
        return True

    def recover_from_disk(self) -> dict:
        if not self._world:
            return super().recover_from_disk()
        if self.persist is None and self._follow_every is None:
            raise ValueError("recover_from_disk needs rt.persist "
                             "(PersistConfig)")
        t0 = time.perf_counter()
        sent = None
        if self.persist is not None:       # rank 0 reads
            data, header, sections, meta = \
                self.persist.store.load_latest_raw()
            sent = {"snapshot": data, "meta": meta,
                    "records": self.persist.wal.encoded_since(
                        _wal_start(header)),
                    "next_record": self.persist.wal.next_record_id}
        got = DM.broadcast_object(sent, self.mesh)
        meta = got["meta"]
        if self.persist is None:           # the other ranks parse it
            header = sections = None
            if got["snapshot"] is not None:
                header, sections = PS.parse_snapshot_bytes(
                    got["snapshot"], meta["path"])
        records = [(rid, PS.decode_record(man, blob))
                   for rid, man, blob in got["records"]]
        return self._recover(header, sections, meta, records,
                             got["next_record"], t0)

    def _init_carry(self, seed: int) -> eng.Carry:
        return LN.init_lane_carries(self.cfg, self.num_lanes, seed=seed,
                                    device=self.device)

    def _refresh_states(self):
        return [RF.RefreshState() for _ in range(self.num_lanes)]

    @staticmethod
    def _scan(cfg, model, events, carry, start, own):
        return eng._scan_events_lanes_backend(cfg, model, events, carry,
                                              start, own=own)

    _group = staticmethod(_run_group_lanes)

    def _n_lanes(self) -> int:
        return self.num_lanes

    def _make_ingest(self):
        # One bounded queue PER TENANT LANE, re-aligned into lockstep
        # lane-stacked batches on take (repro_torch.runtime.ingest).
        return IG.IngestFrontEnd(self.rt.ingest, self.num_lanes)

    def _guard_lanes(self) -> int | None:
        return self.num_lanes

    def _trim_call(self, i: int, frac: float) -> eng.Carry:
        return GD.trim_store_lanes(self.cfg, self.model, self.carry, i,
                                   frac)

    def _guard_restore(self, viols: list[GD.GuardViolation]) -> None:
        lanes_bad = sorted({v.lane for v in viols if v.lane is not None})
        if not lanes_bad:
            return super()._guard_restore(viols)
        # Per-lane rollback: only the poisoned lanes reset; their
        # neighbors keep live state bit for bit.
        self.carry, self.model = self.guard.restore(
            self.carry, self.model, lanes=lanes_bad)
        self._snapshot = None
        if self.ingest is not None \
                and self.rt.guard.quarantine_offers > 0:
            for lane in lanes_bad:
                purged = self.ingest.quarantine_lane(
                    lane, self.rt.guard.quarantine_offers)
                self.quarantine_dropped += purged
        # Rewind the poisoned lanes' admission state (token bucket,
        # watermark latches) to the checkpoint alongside their tensors.
        ctl = self.guard.checkpoint_control
        lanes_ctl = None if ctl is None \
            else ctl.get("ingest", {}).get("lanes")
        if lanes_ctl is not None and self.ingest is not None:
            for lane in lanes_bad:
                self.ingest.queues[lane].restore_control_state(
                    lanes_ctl[lane])
        self.telemetry.record_event("guard_restore", self._chunk_i, {
            "from_chunk": self.guard.checkpoint_chunk,
            "lanes": lanes_bad})

    def _maybe_refresh(self) -> bool:
        if not self._refresh_due():
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
