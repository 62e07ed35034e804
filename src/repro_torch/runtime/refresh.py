"""Online model refresh between chunks (paper §III-C/§III-D; DESIGN.md §7).

Port of ``repro.runtime.refresh``.  A continuously running operator must
keep adapting: stream statistics drift, so the transition matrices — and
with them the completion probabilities, remaining-time tables and the
latency regression ``f`` — go stale.  The carry already accumulates
``obs_counts`` / ``obs_rewards`` (when ``gather_stats`` is on) and the
``(n_pm, t_proc)`` latency ring, so a refresh is a pure re-estimation
from the carry at a chunk boundary, no extra stream pass.

Refreshes are gated, in this order: a NaN gate (a poisoned accumulator
skips the refresh), a minimum observation count (don't fit noise) and an
optional drift threshold on the transition-matrix MSE between the
deployed and freshly-estimated chains (``markov.needs_retraining``,
§III-D), so stable streams skip the rebuild cost.  The tables are built
with the port's ``core`` (held to the reference within the model
builder's tolerance); the latency refit sums through
``overload.xla_sum`` and is the reference's bit for bit.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from repro_torch.cep import engine as eng
from repro_torch.cep import patterns as pat
from repro_torch.core import markov, overload as ovl, utility as util


@dataclasses.dataclass(frozen=True)
class RefreshConfig:
    every_chunks: int = 4          # cadence; <= 0 disables refresh
    min_observations: float = 256.0  # total transition obs before first fit
    drift_threshold: float = 0.0   # max per-pattern T-MSE gate; 0 = always
    bin_size: int = 64
    use_remaining_time: bool = True
    refit_latency: bool = True     # refit f from the carry's latency ring
    decay: float = 1.0             # obs decay applied after each refresh
                                   # (<1 = exponential forgetting, so the
                                   # model tracks drift instead of the
                                   # all-time average)


@dataclasses.dataclass
class RefreshState:
    """What the refresher remembers between invocations."""
    last_T: np.ndarray | None = None   # (P, M, M) deployed transition chains
    refresh_count: int = 0
    skipped_drift: int = 0
    skipped_obs: int = 0
    skipped_nonfinite: int = 0   # NaN-safe gate fired

    def to_control(self) -> dict:
        """JSON control form.  float32 → Python float → float32 is exact,
        so the drift gate computes the same MSE after a round trip."""
        lt = None
        if self.last_T is not None:
            lt = {"dtype": self.last_T.dtype.str,
                  "shape": list(self.last_T.shape),
                  "data": self.last_T.reshape(-1).tolist()}
        return {"last_T": lt, "refresh_count": self.refresh_count,
                "skipped_drift": self.skipped_drift,
                "skipped_obs": self.skipped_obs,
                "skipped_nonfinite": self.skipped_nonfinite}

    @classmethod
    def from_control(cls, d: dict) -> "RefreshState":
        lt = d["last_T"]
        arr = None if lt is None else np.asarray(
            lt["data"], dtype=np.dtype(lt["dtype"])).reshape(lt["shape"])
        return cls(last_T=arr,
                   refresh_count=int(d["refresh_count"]),
                   skipped_drift=int(d["skipped_drift"]),
                   skipped_obs=int(d["skipped_obs"]),
                   skipped_nonfinite=int(d["skipped_nonfinite"]))


def table_width(specs: Sequence[pat.PatternSpec], bin_size: int) -> int:
    """Bins a refreshed utility table will occupy: max ceil(ws/bs)."""
    return max(1, max(-(-s.window_size // bin_size) for s in specs))


def prepare_model(specs: Sequence[pat.PatternSpec], model: eng.EngineModel,
                  rcfg: RefreshConfig) -> eng.EngineModel:
    """Pre-widen ``ut_tables`` to the width refresh will produce
    (edge-replicated bins, a no-op for lookups), so a refresh never
    changes the model's shapes mid-stream.  Works on single and
    lane-stacked models (the bin axis is always second-to-last)."""
    width = table_width(specs, rcfg.bin_size)
    t = model.ut_tables
    cur = t.shape[-2]
    if cur >= width:
        return model
    edge = t[..., -1:, :].expand(t.shape[:-2] + (width - cur, t.shape[-1]))
    return model._replace(ut_tables=torch.cat([t, edge], dim=-2))


def estimate_chains(specs: Sequence[pat.PatternSpec], cfg: eng.EngineConfig,
                    obs_counts: torch.Tensor, obs_rewards: torch.Tensor):
    """Per-pattern (T, R) from the carry's accumulated observations."""
    Ts, Rs = [], []
    for p, spec in enumerate(specs):
        m = spec.num_states
        stats = markov.TransitionStats(counts=obs_counts[p, :m, :m],
                                       reward_sum=obs_rewards[p, :m, :m])
        Ts.append(markov.estimate_transition_matrix(stats))
        Rs.append(markov.estimate_reward_matrix(
            stats, default_reward=cfg.c_match * float(spec.proc_cost)))
    return Ts, Rs


def _stack_T(Ts, max_states: int) -> np.ndarray:
    out = np.zeros((len(Ts), max_states, max_states), np.float32)
    for p, T in enumerate(Ts):
        m = T.shape[0]
        out[p, :m, :m] = T.cpu().numpy()
    return out


def refit_latency_model(carry: eng.Carry) -> ovl.LatencyModel:
    """Refit f: n_pm -> l_p from the carry's rolling latency ring.

    ``lat_ptr`` increments once per event and, on a multi-billion-event
    stream, wraps negative (int32); by then the ring has long been full,
    so a wrapped pointer means every slot is valid — without the guard
    the mask would go all-zero and the fit would degenerate."""
    S = carry.lat_samples_n.shape[0]
    ptr = int(carry.lat_ptr.item())
    n_valid = S if ptr < 0 else min(ptr, S)
    valid = torch.arange(S, device=carry.lat_samples_n.device) < n_valid
    return ovl.fit_latency_model(carry.lat_samples_n, carry.lat_samples_l,
                                 valid)


def _finite(t: torch.Tensor) -> bool:
    return bool(torch.isfinite(t).all())


def refresh_model(specs: Sequence[pat.PatternSpec], cfg: eng.EngineConfig,
                  model: eng.EngineModel, carry: eng.Carry,
                  rcfg: RefreshConfig, state: RefreshState,
                  ) -> tuple[eng.EngineModel, eng.Carry, bool]:
    """Re-estimate the utility tables (+ latency model) from one
    operator's carry.

    Returns ``(model, carry, refreshed)``; the carry comes back with its
    observation accumulators decayed by ``rcfg.decay`` when a refresh ran
    (new tensors; the carry passed in is not written).  Mutates ``state``
    (refresh/skip counters, deployed chains).
    """
    # NaN gate first: a poisoned accumulator must SKIP the refresh, not
    # deploy corrupt tables (`nan < threshold` is False — the
    # min-observation gate alone would wave NaNs straight through).
    obs_c = carry.obs_counts.cpu().numpy()
    obs_r = carry.obs_rewards.cpu().numpy()
    if not (np.isfinite(obs_c).all() and np.isfinite(obs_r).all()):
        state.skipped_nonfinite += 1
        return model, carry, False
    total_obs = float(obs_c.sum())
    if total_obs < rcfg.min_observations:
        state.skipped_obs += 1
        return model, carry, False

    Ts, Rs = estimate_chains(specs, cfg, carry.obs_counts, carry.obs_rewards)
    fresh = _stack_T(Ts, cfg.max_states)
    if rcfg.drift_threshold > 0 and state.last_T is not None:
        mse = float(max(
            markov.transition_matrix_mse(torch.from_numpy(state.last_T[p]),
                                         torch.from_numpy(fresh[p]))
            for p in range(len(specs))))
        if mse <= rcfg.drift_threshold:
            state.skipped_drift += 1
            return model, carry, False

    tables = [util.build_utility_table(
        T, R, window_size=spec.window_size, bin_size=rcfg.bin_size,
        weight=spec.weight, use_remaining_time=rcfg.use_remaining_time)
        for spec, T, R in zip(specs, Ts, Rs)]
    ut_stacked, ut_bins = util.stack_tables(tables,
                                            max_states=cfg.max_states)
    # Keep the deployed bin width: the model's shapes never change.
    B = model.ut_tables.shape[1]
    if ut_stacked.shape[1] < B:
        ut_stacked = torch.nn.functional.pad(
            ut_stacked, (0, 0, 0, B - ut_stacked.shape[1]))
    elif ut_stacked.shape[1] > B:
        ut_stacked = ut_stacked[:, :B]
    # Same NaN discipline for the fresh tables and the latency refit: a
    # non-finite product keeps the deployed model.
    if not _finite(ut_stacked):
        state.skipped_nonfinite += 1
        return model, carry, False
    f_model = model.f_model
    if rcfg.refit_latency:
        cand = refit_latency_model(carry)
        if _finite(cand.a) and _finite(cand.b):
            f_model = cand
        else:
            state.skipped_nonfinite += 1
    dev = model.ut_tables.device
    model = model._replace(
        ut_tables=ut_stacked.to(dev, torch.float32).contiguous(),
        ut_bins=ut_bins.to(dev, torch.int32), f_model=f_model)
    if rcfg.decay < 1.0:
        carry = carry._replace(obs_counts=carry.obs_counts * rcfg.decay,
                               obs_rewards=carry.obs_rewards * rcfg.decay)
    state.last_T = fresh
    state.refresh_count += 1
    return model, carry, True
