"""Carry/model invariant guard + checkpoint/restore (DESIGN.md §12).

Port of ``repro.runtime.guard``.  The runtime owns its carry and the
block kernel updates it in place chunk after chunk: one NaN that slips
in — a poisoned refresh, a corrupted table, broken input — contaminates
every later chunk, and the pre-fault tensors no longer exist.  The guard
makes corruption (a) DETECTABLE at chunk-group granularity via one
device computation whose boolean vector crosses to the host once per
check, and (b) RECOVERABLE via periodic host-side carry + model
checkpoints: true host copies, taken after the check passes
(check-then-save), never views of tensors the next chunk overwrites.

``trim_store`` is the degradation ladder's PM-trim rung: a between-chunk
call of the engine's own Algorithm-2 shed (``engine.shed_carry_lanes``)
dropping a fixed fraction of active PMs, paying the same simulated shed
cost and bumping the same counters as an in-scan shed.  Over lanes
(``trim_store_lanes``) it runs on the kernel backends as one
utility-lookup launch over the L·P pattern rows and one launch of the
histogram's lane instance per refinement level, with no host sync.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.cep import engine as eng

# Check-vector slot names — the single place that orders them.
CARRY_CHECKS = ("finite_time", "finite_latency_ring", "store_consistent",
                "counters_sane", "finite_obs")
MODEL_CHECKS = ("finite_tables", "finite_latency_model", "finite_params")


@dataclasses.dataclass(frozen=True)
class GuardConfig:
    check_every_chunks: int = 1       # invariant-check cadence
    checkpoint_every_chunks: int = 8  # checkpoint cadence (on clean checks)
    restore_on_violation: bool = True
    quarantine_offers: int = 2        # lane quarantine length after restore

    def __post_init__(self):
        if self.check_every_chunks < 1:
            raise ValueError("guard.check_every_chunks must be >= 1: "
                             f"{self.check_every_chunks}")
        if self.checkpoint_every_chunks < 1:
            raise ValueError("guard.checkpoint_every_chunks must be >= 1: "
                             f"{self.checkpoint_every_chunks}")
        if self.quarantine_offers < 0:
            raise ValueError("guard.quarantine_offers must be >= 0: "
                             f"{self.quarantine_offers}")


def _flat(x: torch.Tensor, lanes: bool) -> torch.Tensor:
    """Each lane's elements on one axis: (L, -1) over lanes, else (1, -1)."""
    return x.reshape(x.shape[0] if lanes else 1, -1)


def _all_finite(lanes: bool, *xs) -> torch.Tensor:
    return torch.stack([torch.isfinite(_flat(x, lanes)).all(1)
                        for x in xs]).all(0)


def _carry_checks(carry: eng.Carry, lanes: bool) -> torch.Tensor:
    """(L or 1, len(CARRY_CHECKS)) bool; every bound derived from the
    tensors' shapes, so one function serves any config, one lane or L."""
    f = lambda x: _flat(x, lanes)  # noqa: E731
    pms = carry.pms
    M = carry.obs_counts.shape[-1]
    K = carry.ring.shape[-1]
    finite_time = _all_finite(lanes, carry.sim_time, carry.prev_arrival,
                              carry.ema_gap) & (f(carry.ema_gap) > 0).all(1)
    finite_ring = _all_finite(lanes, carry.lat_samples_n,
                              carry.lat_samples_l)
    # Active PMs must hold a representable automaton state; ring pointers
    # must index the ring.  (Inactive slots may hold stale garbage.)
    state_ok = torch.where(f(pms.active), (f(pms.state) >= 1) &
                           (f(pms.state) <= M), True).all(1)
    ptr_ok = ((f(carry.ring_ptr) >= 0) & (f(carry.ring_ptr) < K)).all(1)

    def nonneg(x):
        return torch.isfinite(f(x)).all(1) & (f(x) >= 0).all(1)

    counters_ok = (nonneg(carry.complex_count) & nonneg(carry.pms_created)
                   & nonneg(carry.pms_shed) & nonneg(carry.shed_calls)
                   & nonneg(carry.overflow) & nonneg(carry.ebl_dropped)
                   & (f(carry.ebl_frac) >= 0).all(1)
                   & (f(carry.ebl_frac) <= 1).all(1))
    finite_obs = _all_finite(lanes, carry.obs_counts, carry.obs_rewards)
    return torch.stack([finite_time, finite_ring, state_ok & ptr_ok,
                        counters_ok, finite_obs], dim=1)


def _model_checks(model: eng.EngineModel, lanes: bool) -> torch.Tensor:
    """(L or 1, len(MODEL_CHECKS)) bool for the deployed model."""
    f = lambda x: _flat(x, lanes)  # noqa: E731
    finite_tables = (torch.isfinite(f(model.ut_tables)).all(1)
                     & (f(model.ut_bins) >= 1).all(1))
    finite_lat = _all_finite(lanes, model.f_model.a, model.f_model.b,
                             model.g_model.a, model.g_model.b)
    finite_params = _all_finite(lanes, model.proc_cost, model.ebl_raw_mean)
    return torch.stack([finite_tables, finite_lat, finite_params], dim=1)


def carry_check_vec(carry: eng.Carry) -> torch.Tensor:
    """(len(CARRY_CHECKS),) bool on the carry's device."""
    return _carry_checks(carry, lanes=False)[0]


def model_check_vec(model: eng.EngineModel) -> torch.Tensor:
    """(len(MODEL_CHECKS),) bool on the model's device."""
    return _model_checks(model, lanes=False)[0]


def carry_check_lanes(carry: eng.Carry) -> torch.Tensor:
    """(L, len(CARRY_CHECKS)) bool: each lane of a lane-stacked carry."""
    return _carry_checks(carry, lanes=True)


def model_check_lanes(model: eng.EngineModel) -> torch.Tensor:
    """(L, len(MODEL_CHECKS)) bool: each lane of a lane-stacked model."""
    return _model_checks(model, lanes=True)


def _trim_rho(carry: eng.Carry, frac) -> torch.Tensor:
    """ρ = ceil(frac · n_active) per lane, in float32 as the reference."""
    L = carry.sim_time.shape[0]
    n_active = carry.pms.active.reshape(L, -1).sum(1).float()
    f = torch.as_tensor(frac, dtype=torch.float32,
                        device=n_active.device)
    return torch.ceil(f * n_active).to(torch.int32)


def trim_store_lanes(cfg: eng.EngineConfig, model: eng.EngineModel,
                     carry: eng.Carry, i: int, frac) -> eng.Carry:
    """Trim ``frac`` of every lane's active PMs through the engine's shed
    (lane-stacked model and carry); each lane equals its ``trim_store``
    bit for bit."""
    return eng.shed_carry_lanes(cfg, model, carry, int(i),
                                _trim_rho(carry, frac))[0]


def trim_store(cfg: eng.EngineConfig, model: eng.EngineModel,
               carry: eng.Carry, i: int, frac) -> eng.Carry:
    """Trim ``frac`` of the active PMs of one operator (the ladder's
    PM-trim rung): ``trim_store_lanes`` with one lane."""
    one = lambda x: x[None]  # noqa: E731
    c = trim_store_lanes(cfg, eng.tree_map(one, model),
                         eng.tree_map(one, carry), i, frac)
    return eng.tree_map(lambda x: x[0], c)


@dataclasses.dataclass
class GuardViolation:
    scope: str              # "carry" | "model"
    failed: list[str]       # CARRY_CHECKS / MODEL_CHECKS names that failed
    lane: int | None = None

    def to_row(self) -> dict:
        return dataclasses.asdict(self)


def host_copy(tree):
    """True host copies of every tensor: the live tensors are updated in
    place by the next chunk, so a view (or a CPU tensor's own storage)
    would not survive it."""
    return eng.tree_map(lambda x: x.detach().to("cpu", copy=True), tree)


class CarryGuard:
    """Invariant checks + last-good checkpoint for one runtime's state.

    ``lanes=None`` guards a single-tenant carry; ``lanes=L`` expects
    lane-stacked carry/model trees and checks/restores PER LANE, so one
    poisoned tenant never resets its neighbors.
    """

    def __init__(self, cfg: GuardConfig, lanes: int | None = None):
        self.cfg = cfg
        self.lanes = lanes
        # (carry, model, chunk_i, control): host copies, and the runtime's
        # host-side control state in the durable snapshot codec's JSON
        # form (repro_torch.runtime.persist), captured at save so a
        # restore rewinds the ladder rung/streaks and admission state
        # along with the tensors.
        self._ckpt: tuple | None = None
        self.checks_run = 0
        self.violations = 0
        self.restores = 0
        self.checkpoints = 0

    @property
    def has_checkpoint(self) -> bool:
        return self._ckpt is not None

    @property
    def checkpoint_chunk(self) -> int | None:
        return None if self._ckpt is None else self._ckpt[2]

    @property
    def checkpoint_control(self) -> dict | None:
        return None if self._ckpt is None else self._ckpt[3]

    @property
    def checkpoint(self) -> tuple | None:
        """(carry, model, chunk_i, control) — read by the durable snapshot
        so a recovered process keeps its last good rollback."""
        return self._ckpt

    def save(self, carry: eng.Carry, model: eng.EngineModel,
             chunk_i: int, control: dict | None = None) -> None:
        self._ckpt = (host_copy(carry), host_copy(model), int(chunk_i),
                      control)
        self.checkpoints += 1

    def load_checkpoint(self, carry, model, chunk_i: int,
                        control: dict | None) -> None:
        """Install an externally decoded checkpoint (host tensors, from
        snapshot recovery); does NOT count as a new checkpoint."""
        self._ckpt = (carry, model, int(chunk_i), control)

    def check(self, carry: eng.Carry,
              model: eng.EngineModel) -> list[GuardViolation]:
        """Run the checks on the device; ONE host read of both vectors.
        Returns [] when healthy."""
        self.checks_run += 1
        lanes = self.lanes is not None
        cv = _carry_checks(carry, lanes)
        mv = _model_checks(model, lanes)
        both = torch.cat([cv, mv], dim=1).cpu().numpy()
        cv, mv = both[:, :len(CARRY_CHECKS)], both[:, len(CARRY_CHECKS):]
        out: list[GuardViolation] = []
        for row in range(cv.shape[0]):
            lane = row if lanes else None
            if not cv[row].all():
                out.append(GuardViolation("carry", [
                    CARRY_CHECKS[i] for i in np.nonzero(~cv[row])[0]],
                    lane=lane))
            if not mv[row].all():
                out.append(GuardViolation("model", [
                    MODEL_CHECKS[i] for i in np.nonzero(~mv[row])[0]],
                    lane=lane))
        self.violations += len(out)
        return out

    def restore(self, carry: eng.Carry, model: eng.EngineModel,
                lanes: list[int] | None = None
                ) -> tuple[eng.Carry, eng.EngineModel]:
        """Reset state from the last good checkpoint, onto the live
        state's device.  With ``lanes`` only those lanes' slices roll back
        (lane-stacked trees): the runtime's own carry in place, the model
        — which may be the caller's tensors — into new tensors; every
        other lane keeps its live state bit for bit."""
        if self._ckpt is None:
            raise RuntimeError("CarryGuard.restore called before any "
                               "checkpoint was saved")
        ck_carry, ck_model = self._ckpt[0], self._ckpt[1]
        self.restores += 1
        dev = carry.sim_time.device
        if lanes is None or self.lanes is None:
            to = lambda x: x.to(dev, copy=True)  # noqa: E731
            return eng.tree_map(to, ck_carry), eng.tree_map(to, ck_model)
        idx = torch.tensor(sorted(lanes), dtype=torch.long)

        def into(cur, ck):
            return cur.index_copy_(0, idx.to(cur.device),
                                   ck[idx].to(cur.device))

        def merged(cur, ck):
            return cur.index_copy(0, idx.to(cur.device),
                                  ck[idx].to(cur.device))

        return (eng.tree_map(into, carry, ck_carry),
                eng.tree_map(merged, model, ck_model))

    def counters(self) -> dict:
        return {"checks_run": self.checks_run,
                "violations": self.violations,
                "restores": self.restores,
                "checkpoints": self.checkpoints}

    def restore_counters(self, d: dict) -> None:
        """Reload the forensic counters from a durable snapshot."""
        self.checks_run = int(d["checks_run"])
        self.violations = int(d["violations"])
        self.restores = int(d["restores"])
        self.checkpoints = int(d["checkpoints"])
