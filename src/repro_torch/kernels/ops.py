"""The engine's kernel-dispatch surface (``EngineConfig.backend="cuda"``).

Port of ``repro.kernels.ops``.  The per-event engine never touches a
kernel directly: it calls ``advance_seq_multi`` / ``pm_utilities_multi``
/ ``shed_lowest_threshold`` below, which launch the hand-written CUDA
kernels for CUDA tensors (their plain PyTorch versions for CPU tensors).
The block backend calls ``kernels.block_step`` itself, and the
runtime's lanes its lane instance ``block_step_lanes``; ``KERNELS``
counts the launches of all five.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.core import shedder as shd
from repro_torch.kernels.block_step import block_step, block_step_lanes
from repro_torch.kernels.nfa_transition import nfa_advance
from repro_torch.kernels.shed_select import (utility_histogram,
                                             utility_histogram_edges,
                                             utility_lookup)

# Every kernel wrapper of the slice, by kernel name.
KERNELS = {
    "nfa_advance": nfa_advance,
    "utility_lookup": utility_lookup,
    "utility_histogram": utility_histogram_edges,
    "block_step": block_step,
    "block_step_lanes": block_step_lanes,
}


def launch_counts() -> dict[str, int]:
    """Launches of each kernel since the last reset (CUDA tensors only)."""
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def advance_seq_multi(state, bind, active, trans, ev_class, ev_bind,
                      final_state, uses_binding):
    """SEQ advance of the whole (P, N) store in one kernel launch.
    Returns (new_state (P, N) int32, completed (P, N) bool)."""
    return nfa_advance(state, bind, active, trans, ev_class, ev_bind,
                       final_state, uses_binding)


def pm_utilities_multi(state, r_w, active, tables, bin_sizes):
    """pSPICE utilities of the whole (P, N) store in one kernel launch,
    each pattern against its own (B, M) table and bin size."""
    return utility_lookup(state, r_w, active, tables, bin_sizes)


def shed_lowest_threshold(active: torch.Tensor, utilities: torch.Tensor,
                          rho: torch.Tensor, *,
                          nbins: int = 128) -> torch.Tensor:
    """Histogram-threshold drop mask over flat (N,) utilities with the
    histogram kernel as the bucket counter."""
    hist = functools.partial(utility_histogram, nbins=nbins)
    return shd.threshold_drop_mask(active, utilities, rho, nbins=nbins,
                                   hist_fn=hist)


def shed_lowest(active: torch.Tensor, state: torch.Tensor,
                r_w: torch.Tensor, table: torch.Tensor, rho: torch.Tensor,
                *, bin_size: int, nbins: int = 64) -> torch.Tensor:
    """Algorithm 2 for one pattern through the kernels: utility lookup →
    histogram-refinement threshold select.  (N,) in, new (N,) mask out."""
    dev = state.device
    bins = torch.tensor([bin_size], dtype=torch.int32, device=dev)
    u = utility_lookup(state[None], r_w[None], active[None], table[None],
                       bins)[0]
    hist = functools.partial(utility_histogram, nbins=nbins)
    return shd.threshold_drop_mask(active, u, rho, nbins=nbins,
                                   hist_fn=hist)
