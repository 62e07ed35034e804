"""Markov-chain / Markov-reward-process machinery for pSPICE (§III-C).

Port of ``repro.core.markov``.  The pattern's state machine is a Markov
chain over states s_1..s_m; its transition matrix is estimated from the
operator's <q, s, s', t> observations, and t becomes the reward of a
Markov reward process.  The matrices are m×m with m ≤ ~16, so plain
``torch.matmul`` serves; sums run in another order than XLA's, so the
builders are held to a tolerance against the reference, not to bits.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class TransitionStats:
    """counts[s, s'] observed transitions; reward_sum[s, s'] their summed
    processing time."""
    counts: torch.Tensor       # (m, m) float32
    reward_sum: torch.Tensor   # (m, m) float32

    @staticmethod
    def zeros(m: int, device=None) -> "TransitionStats":
        z = lambda: torch.zeros((m, m), dtype=torch.float32,  # noqa: E731
                                device=device)
        return TransitionStats(counts=z(), reward_sum=z())

    @property
    def num_states(self) -> int:
        return self.counts.shape[0]

    @property
    def num_observations(self) -> torch.Tensor:
        return self.counts.sum()


def add_observations(stats: TransitionStats, s: torch.Tensor,
                     s_next: torch.Tensor, t: torch.Tensor,
                     valid: torch.Tensor) -> TransitionStats:
    """Batched scatter-add of observations <s, s', t> masked by valid."""
    w = valid.float()
    m = stats.num_states
    flat = (s.long() * m + s_next.long())
    counts = stats.counts.reshape(-1).index_add(0, flat, w).reshape(m, m)
    rsum = stats.reward_sum.reshape(-1).index_add(0, flat, w * t
                                                  ).reshape(m, m)
    return TransitionStats(counts, rsum)


def estimate_transition_matrix(stats: TransitionStats,
                               absorbing_final: bool = True,
                               laplace: float = 0.0) -> torch.Tensor:
    """Row-normalized T[s, s']; unobserved rows self-loop, final absorbs."""
    m = stats.num_states
    c = stats.counts + laplace
    row = c.sum(dim=1, keepdim=True)
    eye = torch.eye(m, dtype=c.dtype, device=c.device)
    T = torch.where(row > 0, c / torch.clamp_min(row, 1e-30), eye)
    if absorbing_final:
        T = T.clone()
        T[m - 1] = eye[m - 1]
    return T


def estimate_reward_matrix(stats: TransitionStats,
                           default_reward: float = 0.0) -> torch.Tensor:
    """R[s, s'] = mean observed processing time of an s -> s' transition."""
    c = stats.counts
    return torch.where(c > 0, stats.reward_sum / torch.clamp_min(c, 1e-30),
                       torch.full_like(c, default_reward))


def _matrix_power(T: torch.Tensor, k: int) -> torch.Tensor:
    """T^k by binary exponentiation (k a Python int)."""
    result = torch.eye(T.shape[0], dtype=T.dtype, device=T.device)
    base = T
    while k > 0:
        if k & 1:
            result = result @ base
        base = base @ base
        k >>= 1
    return result


def binned_matrix_powers(T: torch.Tensor, num_bins: int,
                         bin_size: int) -> torch.Tensor:
    """[T^{bs}, T^{2·bs}, ..., T^{num_bins·bs}] → (num_bins, m, m)."""
    T_bs = _matrix_power(T, bin_size)
    acc = torch.eye(T.shape[0], dtype=T.dtype, device=T.device)
    powers = []
    for _ in range(num_bins):
        acc = acc @ T_bs
        powers.append(acc)
    return torch.stack(powers)


def completion_probability_table(T: torch.Tensor, num_bins: int,
                                 bin_size: int) -> torch.Tensor:
    """P[j, i]: a PM in state s_i completes given (j+1)·bs events left."""
    return binned_matrix_powers(T, num_bins, bin_size)[:, :, -1]


def remaining_time_table(T: torch.Tensor, R: torch.Tensor, num_bins: int,
                         bin_size: int) -> torch.Tensor:
    """tau[j, i]: expected remaining processing time of a PM in s_i given
    (j+1)·bs events remain — value iteration
    tau_k(s) = sum_s' T[s,s']·(R[s,s'] + tau_{k-1}(s')), final state
    absorbing at zero cost; every bin_size-th iterate is kept."""
    m = T.shape[0]
    r = (T * R).sum(dim=1)
    r[m - 1] = 0.0
    T_nofinal = T.clone()
    T_nofinal[m - 1] = 0.0
    tau = torch.zeros((m,), dtype=T.dtype, device=T.device)
    taus = []
    for _ in range(num_bins):
        for _ in range(bin_size):
            tau = r + T_nofinal @ tau
        taus.append(tau)
    return torch.stack(taus)


def transition_matrix_mse(T_model: torch.Tensor,
                          T_fresh: torch.Tensor) -> torch.Tensor:
    return torch.mean((T_model - T_fresh) ** 2)


def needs_retraining(T_model: torch.Tensor, T_fresh: torch.Tensor,
                     threshold: float = 1e-3) -> torch.Tensor:
    return transition_matrix_mse(T_model, T_fresh) > threshold


def np_completion_probability(T: np.ndarray, R_w: int) -> np.ndarray:
    """Oracle: last column of T^R_w (float64)."""
    return np.linalg.matrix_power(np.asarray(T, np.float64), R_w)[:, -1]


def np_remaining_time(T: np.ndarray, R: np.ndarray, R_w: int) -> np.ndarray:
    """Oracle: naive value iteration in float64."""
    T = np.asarray(T, np.float64).copy()
    R = np.asarray(R, np.float64)
    m = T.shape[0]
    r = (T * R).sum(axis=1)
    r[m - 1] = 0.0
    Tn = T.copy()
    Tn[m - 1] = 0.0
    tau = np.zeros(m)
    for _ in range(R_w):
        tau = r + Tn @ tau
    return tau
