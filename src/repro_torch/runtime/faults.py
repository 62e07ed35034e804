"""Deterministic fault injection for chaos runs (DESIGN.md §12).

Port of ``repro.runtime.faults``.  Every fault a resilient front-end
must survive, as a SEEDED, REPLAYABLE transformation: stream faults
rewrite an ``EventBatch`` before it is offered to the runtime (bursts,
duplicates, reordering, stalls), state faults corrupt the live carry or
model between chunks (NaN/Inf into the refresh accumulators or utility
tables, latency spikes, lane poison).  All randomness comes from one
``np.random.default_rng(seed)`` drawn in the reference's order, and every
applied fault is appended to ``FaultInjector.log`` — the same seed and
call sequence produce the reference's events, carry, model and log bit
for bit.  Faulted tensors are new tensors on the input's device; the
input is never written.

Stream faults preserve the arrival-time monotonicity the engine's
simulated-time model assumes (a burst COMPRESSES gaps, a stall inserts a
silence then a pile-up); what they stress is the rate the admission
controller and shedder see, not the data-layer contract.
"""
from __future__ import annotations

import dataclasses
import os
import signal

import numpy as np
import torch

from repro_torch.cep import engine as eng
from repro_torch.runtime.chunker import num_events

STREAM_FAULTS = ("burst", "duplicate", "reorder", "stall")
STATE_FAULTS = ("nan_refresh", "table_corrupt", "lane_poison",
                "latency_spike")
# Process faults kill the WHOLE process (SIGKILL: no handlers, no atexit)
# at a seeded site — the fault the durable persistence layer exists for
# (DESIGN.md §13).  They are planned via ``FaultInjector.plan_kill`` and
# executed by a ``KillSwitch`` armed at the module's kill points.
PROCESS_FAULTS = ("process_kill",)
FAULT_KINDS = STREAM_FAULTS + STATE_FAULTS + PROCESS_FAULTS

# Instrumented death sites: after a chunk's device work returns but
# before its host bookkeeping lands; after the refresh cadence check
# fires; and inside the snapshot writer (which dies mid-write, leaving a
# deliberately torn file for recovery to CRC-reject).
KILL_SITES = ("chunk", "refresh", "snapshot")
KILL_ENV = "PSPICE_KILL"   # "site:after" spec for subprocess children


@dataclasses.dataclass(frozen=True)
class FaultConfig:
    kinds: tuple[str, ...] = FAULT_KINDS
    seed: int = 0
    p_fault: float = 0.5       # per-call chance each enabled fault fires
    burst_factor: float = 8.0  # arrival-gap compression inside a burst
    burst_len: int = 256
    dup_len: int = 64
    reorder_len: int = 128
    stall_gap_s: float = 0.5   # silence inserted before the pile-up
    spike_s: float = 0.25      # sim-time jump for latency_spike
    nan_frac: float = 0.02     # fraction of entries corrupted to NaN/Inf

    def __post_init__(self):
        unknown = set(self.kinds) - set(FAULT_KINDS)
        if unknown:
            raise ValueError(f"unknown fault kinds {sorted(unknown)}; "
                             f"expected a subset of {FAULT_KINDS}")
        if not 0.0 <= self.p_fault <= 1.0:
            raise ValueError("faults.p_fault is a probability and must be "
                             f"in [0, 1]: {self.p_fault}")
        if not 0.0 < self.nan_frac <= 1.0:
            raise ValueError("faults.nan_frac must be in (0, 1]: "
                             f"{self.nan_frac}")


def _np(x: torch.Tensor) -> np.ndarray:
    """A host copy of ``x`` that the injector may write."""
    return np.array(x.detach().cpu().numpy())


def _set(x: torch.Tensor, lane: int | None, v) -> torch.Tensor:
    """A new tensor: ``x`` with lane ``lane`` (or all of it) set to ``v``
    (a float32 value or an array)."""
    out = x.clone()
    val = torch.as_tensor(v, dtype=x.dtype).to(x.device)
    if lane is None:
        out.copy_(val.expand_as(out) if val.dim() == 0 else val)
    else:
        out[lane] = val
    return out


class FaultInjector:
    """Seeded source of stream/state faults with a replay log."""

    def __init__(self, cfg: FaultConfig):
        self.cfg = cfg
        self.rng = np.random.default_rng(cfg.seed)
        self.log: list[dict] = []
        self._call = 0

    def _fires(self, kind: str) -> bool:
        # The rng draw happens for every ENABLED kind so the stream of
        # random numbers — and hence the replay — depends only on cfg.
        return kind in self.cfg.kinds \
            and self.rng.random() < self.cfg.p_fault

    def _note(self, kind: str, **detail) -> None:
        self.log.append({"call": self._call, "kind": kind, **detail})

    # -- stream faults -----------------------------------------------------
    def corrupt_events(self, events: eng.EventBatch,
                       axis: int = 0) -> eng.EventBatch:
        """Apply whichever enabled stream faults fire to one push batch.
        ``axis`` is the event axis (1 for lane-stacked batches; lane
        leaves share the fault, like a front-end-wide hiccup would)."""
        self._call += 1
        n = num_events(events, axis)
        if n < 4:
            return events
        dev = events.arrival.device
        ev = eng.EventBatch(*(_np(x) for x in events))
        # arrival's event axis is its LAST for both layouts ((n,) / (L, n))
        # so the burst/stall transforms below can index axis=-1.
        arrival = np.array(ev.arrival)
        if self._fires("duplicate"):
            m = min(self.cfg.dup_len, n // 2)
            s = int(self.rng.integers(0, n - m))
            # Each event of the window delivered twice IN PLACE, so the
            # duplicated arrivals stay monotone (at-least-once delivery).
            idx = np.concatenate([np.arange(0, s),
                                  np.repeat(np.arange(s, s + m), 2),
                                  np.arange(s + m, n)])
            ev = _take_rows(ev, idx, axis)
            arrival = np.array(ev.arrival)
            n = idx.size
            self._note("duplicate", start=s, len=m)
        if self._fires("reorder"):
            m = min(self.cfg.reorder_len, n // 2)
            s = int(self.rng.integers(0, n - m))
            perm = np.arange(n)
            perm[s:s + m] = s + self.rng.permutation(m)
            # Reorder payloads only; arrivals keep their monotone order
            # (out-of-order CONTENT at in-order timestamps).
            old_arrival = arrival.copy()
            ev = _take_rows(ev, perm, axis)
            ev = ev._replace(arrival=old_arrival)
            arrival = old_arrival
            self._note("reorder", start=s, len=m)
        if self._fires("burst"):
            m = min(self.cfg.burst_len, n // 2)
            s = int(self.rng.integers(0, n - m))
            arrival = _compress_gaps(arrival, s, m, self.cfg.burst_factor)
            ev = ev._replace(arrival=arrival)
            self._note("burst", start=s, len=m,
                       factor=self.cfg.burst_factor)
        if self._fires("stall"):
            m = min(self.cfg.burst_len, n // 2)
            s = int(self.rng.integers(0, n - m))
            arrival = _stall(arrival, s, m, self.cfg.stall_gap_s)
            ev = ev._replace(arrival=arrival)
            self._note("stall", start=s, len=m, gap=self.cfg.stall_gap_s)
        return eng.EventBatch(*(torch.from_numpy(
            np.ascontiguousarray(x)).to(dev) for x in ev))

    # -- state faults ------------------------------------------------------
    def corrupt_carry(self, carry: eng.Carry,
                      lane: int | None = None) -> eng.Carry:
        """Whichever enabled carry faults fire, applied between chunks.
        ``lane`` targets one lane of a lane-stacked carry."""
        self._call += 1
        pick = (lambda x: x) if lane is None else (lambda x: x[lane])
        if self._fires("nan_refresh"):
            oc = _np(pick(carry.obs_counts))
            flat = oc.reshape(-1)
            k = max(1, int(self.cfg.nan_frac * flat.size))
            flat[self.rng.choice(flat.size, size=k, replace=False)] = np.nan
            carry = carry._replace(obs_counts=_set(carry.obs_counts, lane,
                                                   oc))
            ring = _np(pick(carry.lat_samples_l))
            ring[self.rng.integers(0, ring.shape[-1])] = np.inf
            carry = carry._replace(lat_samples_l=_set(carry.lat_samples_l,
                                                      lane, ring))
            self._note("nan_refresh", lane=lane, n_nan=k)
        if self._fires("latency_spike"):
            st = pick(carry.sim_time)
            spiked = st + torch.tensor(self.cfg.spike_s, dtype=st.dtype,
                                       device=st.device)
            carry = carry._replace(sim_time=_set(carry.sim_time, lane,
                                                 spiked.cpu()))
            self._note("latency_spike", lane=lane, spike=self.cfg.spike_s)
        if self._fires("lane_poison"):
            carry = carry._replace(
                sim_time=_set(carry.sim_time, lane, np.float32(np.nan)),
                ema_gap=_set(carry.ema_gap, lane, np.float32(np.nan)))
            self._note("lane_poison", lane=lane)
        return carry

    def corrupt_model(self, model: eng.EngineModel,
                      lane: int | None = None) -> eng.EngineModel:
        """NaN/Inf into the deployed utility tables + latency regression
        (what a bad refresh would deploy if the gate missed it)."""
        self._call += 1
        if not self._fires("table_corrupt"):
            return model
        ut = _np(model.ut_tables if lane is None else model.ut_tables[lane])
        flat = ut.reshape(-1)
        k = max(1, int(self.cfg.nan_frac * flat.size))
        pick = self.rng.choice(flat.size, size=k, replace=False)
        flat[pick[::2]] = np.nan
        flat[pick[1::2]] = np.inf
        model = model._replace(ut_tables=_set(model.ut_tables, lane, ut))
        f = model.f_model
        model = model._replace(f_model=f._replace(
            a=_set(f.a, lane, np.float32(np.nan))))
        self._note("table_corrupt", lane=lane, n_bad=k)
        return model

    # -- process faults ----------------------------------------------------
    def plan_kill(self, site: str, lo: int = 1, hi: int = 4
                  ) -> "KillSwitch":
        """Seeded kill plan: SIGKILL on the Nth hit of ``site`` with
        N ~ U[lo, hi] drawn from the injector's own rng stream (logged,
        so the same seed plans the same death)."""
        if "process_kill" not in self.cfg.kinds:
            raise ValueError("plan_kill needs 'process_kill' in "
                             f"FaultConfig.kinds: {self.cfg.kinds}")
        if lo < 1 or hi < lo:
            raise ValueError(f"plan_kill needs 1 <= lo <= hi: [{lo},{hi}]")
        self._call += 1
        after = int(self.rng.integers(lo, hi + 1))
        self._note("process_kill", site=site, after=after)
        return KillSwitch(site, after)


class KillSwitch:
    """Dies by SIGKILL on the Nth hit of one instrumented site.

    Installed per process (``install_kill_switch`` or the ``PSPICE_KILL``
    env spec, which is how the supervisor arms a child); the runtime's
    kill points cost one None-check when no switch is armed.
    """

    def __init__(self, site: str, after: int):
        if site not in KILL_SITES:
            raise ValueError(f"unknown kill site {site!r}; expected one "
                             f"of {KILL_SITES}")
        if after < 1:
            raise ValueError(f"kill after-count must be >= 1: {after}")
        self.site = site
        self.after = int(after)
        self.hits = 0

    @classmethod
    def from_spec(cls, spec: str) -> "KillSwitch":
        site, _, after = spec.partition(":")
        return cls(site, int(after or 1))

    def spec(self) -> str:
        return f"{self.site}:{self.after}"

    def pending(self, site: str) -> bool:
        """Count a hit of ``site``; True exactly when it is time to die
        (callers with pre-death work — the torn snapshot write — check
        this and then call ``kill``)."""
        if site != self.site:
            return False
        self.hits += 1
        return self.hits == self.after

    def kill(self) -> None:
        os.kill(os.getpid(), signal.SIGKILL)
        os._exit(137)   # unreachable on POSIX


_KILL: KillSwitch | None = None


def install_kill_switch(ks: KillSwitch | None) -> KillSwitch | None:
    """Arm (or with None, disarm) the process kill switch; returns the
    previously armed one."""
    global _KILL
    prev, _KILL = _KILL, ks
    return prev


def active_kill_switch() -> KillSwitch | None:
    return _KILL


def install_kill_from_env(environ=os.environ) -> KillSwitch | None:
    """Arm from the ``PSPICE_KILL=site:after`` env spec if present — the
    supervisor's channel into its subprocess children."""
    spec = environ.get(KILL_ENV)
    if not spec:
        return None
    ks = KillSwitch.from_spec(spec)
    install_kill_switch(ks)
    return ks


def kill_point(site: str) -> None:
    """Instrumented death site: a no-op unless an armed switch's count
    expires here, in which case the process dies by SIGKILL NOW."""
    if _KILL is not None and _KILL.pending(site):
        _KILL.kill()


def _take_rows(ev: eng.EventBatch, idx: np.ndarray,
               axis: int) -> eng.EventBatch:
    return eng.EventBatch(*(np.take(x, idx, axis=axis) for x in ev))


def _compress_gaps(arrival: np.ndarray, s: int, m: int,
                   factor: float) -> np.ndarray:
    """Divide inter-arrival gaps inside [s, s+m) by ``factor`` and shift
    the tail down so the sequence stays monotone — an instantaneous rate
    multiplication, the paper's canonical overload."""
    a = arrival.copy()
    seg = np.take(a, np.arange(s, s + m), axis=-1)
    first = np.take(seg, [0], axis=-1)
    compressed = first + (seg - first) / factor
    delta = np.take(seg, [-1], axis=-1) - np.take(compressed, [-1], axis=-1)
    idx_seg = [slice(None)] * (a.ndim - 1) + [slice(s, s + m)]
    idx_tail = [slice(None)] * (a.ndim - 1) + [slice(s + m, None)]
    a[tuple(idx_seg)] = compressed
    a[tuple(idx_tail)] = a[tuple(idx_tail)] - delta
    return a


def _stall(arrival: np.ndarray, s: int, m: int, gap: float) -> np.ndarray:
    """A silence of ``gap`` seconds at index ``s``, then the stalled
    events arrive in a pile-up (all at once), then the stream resumes
    shifted — what a stuck upstream producer looks like."""
    a = arrival.copy()
    idx_seg = [slice(None)] * (a.ndim - 1) + [slice(s, s + m)]
    idx_tail = [slice(None)] * (a.ndim - 1) + [slice(s + m, None)]
    pile = np.take(a, [s], axis=-1) + gap
    a[tuple(idx_seg)] = np.broadcast_to(pile, a[tuple(idx_seg)].shape)
    a[tuple(idx_tail)] = a[tuple(idx_tail)] + gap
    return a
