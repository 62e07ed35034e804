"""Utility tables for partial matches (paper §III-B, §III-C-3).

Port of ``repro.core.utility``.  U_pm = w_q · P_pm / tau_pm (Eq. 1), with
P and tau min-max scaled to a common range first, materialized as
UT_q[(ws/bs) × m] so the shedder does O(1) lookups.

The interpolation ``u0·(1-frac) + u1·frac`` is one fused multiply-add in
the reference (XLA contracts the ``u1·frac`` product into the add), so
the port rounds it the same way through ``fp.fma``.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from repro_torch import fp
from repro_torch.core import markov

_EPS = 1e-6


def _minmax_scale(x: torch.Tensor, lo: float = _EPS,
                  hi: float = 1.0) -> torch.Tensor:
    """Scale x into [lo, hi].  Degenerate (constant) tables map to hi."""
    xmin, xmax = x.min(), x.max()
    span = xmax - xmin
    scaled = torch.where(span > 0,
                         (x - xmin) / torch.clamp_min(span, 1e-30),
                         torch.ones_like(x))
    return lo + scaled * (hi - lo)


@dataclasses.dataclass
class UtilityTable:
    """Per-pattern utility table UT_q plus the tables it came from.

    table[j, i] = utility of a PM in state s_i with (j+1)·bin_size events
    remaining in its window; intermediate R_w interpolate linearly.
    """
    table: torch.Tensor        # (num_bins, m)
    completion: torch.Tensor   # (num_bins, m) raw P
    remaining: torch.Tensor    # (num_bins, m) raw tau
    bin_size: int
    weight: float

    @property
    def num_bins(self) -> int:
        return self.table.shape[0]

    @property
    def num_states(self) -> int:
        return self.table.shape[1]


def build_utility_table(T: torch.Tensor, R: torch.Tensor, window_size: int,
                        bin_size: int, weight: float = 1.0,
                        use_remaining_time: bool = True) -> UtilityTable:
    """UT_q from a learned transition matrix + reward matrix
    (``use_remaining_time=False`` is the paper's pSPICE-- ablation)."""
    num_bins = max(1, -(-window_size // bin_size))
    P = markov.completion_probability_table(T, num_bins, bin_size)
    tau = markov.remaining_time_table(T, R, num_bins, bin_size)
    P_s = _minmax_scale(P)
    tau_s = _minmax_scale(tau) if use_remaining_time else \
        torch.ones_like(tau)
    table = weight * P_s / torch.clamp_min(tau_s, _EPS)
    return UtilityTable(table=table, completion=P, remaining=tau,
                        bin_size=bin_size, weight=weight)


def _interpolate(u0, u1, frac):
    """``u0·(1-frac) + u1·frac`` with the reference's rounding."""
    return fp.fma(u1, frac, u0 * (1.0 - frac))


def lookup_utility(ut_table: torch.Tensor, bin_size: int,
                   state: torch.Tensor, r_w: torch.Tensor) -> torch.Tensor:
    """O(1) utility lookup with linear interpolation between bins.

    ``bin_size`` is a Python constant here, and the reference's compiler
    turns ``r_w / bin_size - 1`` into ``fma(r_w, 1/bin_size, -1)``; the
    port rounds it the same way."""
    num_bins = ut_table.shape[0]
    inv = float(np.float32(1.0) / np.float32(bin_size))
    pos = torch.clamp(fp.fma(r_w.float(), inv, -1.0), 0.0, num_bins - 1.0)
    j0 = torch.floor(pos).to(torch.int64)
    j1 = torch.clamp_max(j0 + 1, num_bins - 1)
    frac = pos - j0.float()
    st = state.long()
    return _interpolate(ut_table[j0, st], ut_table[j1, st], frac)


def stack_tables(tables: Sequence[UtilityTable],
                 max_states: int | None = None):
    """Stack per-pattern tables into (n_patterns, num_bins, max_m),
    zero-padded, plus the (P,) int32 bin sizes."""
    if max_states is None:
        max_states = max(t.num_states for t in tables)
    num_bins = max(t.num_bins for t in tables)
    out = [torch.nn.functional.pad(
        t.table, (0, max_states - t.num_states, 0, num_bins - t.num_bins))
        for t in tables]
    dev = tables[0].table.device
    bins = torch.tensor([t.bin_size for t in tables], dtype=torch.int32,
                        device=dev)
    return torch.stack(out), bins


def multi_pattern_lookup(stacked: torch.Tensor, bin_sizes: torch.Tensor,
                         pattern_id: torch.Tensor, state: torch.Tensor,
                         r_w: torch.Tensor) -> torch.Tensor:
    """Utility lookup across patterns: stacked (P, B, M), all args (n,)."""
    num_bins = stacked.shape[1]
    pid = pattern_id.long()
    bs = bin_sizes[pid].float()
    pos = torch.clamp(r_w.float() / bs - 1.0, 0.0, num_bins - 1.0)
    j0 = torch.floor(pos).to(torch.int64)
    j1 = torch.clamp_max(j0 + 1, num_bins - 1)
    frac = pos - j0.float()
    st = state.long()
    return _interpolate(stacked[pid, j0, st], stacked[pid, j1, st], frac)
