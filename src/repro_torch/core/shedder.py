"""Load shedders (paper §III-F Algorithm 2 + §IV-A baselines).

Port of ``repro.core.shedder``.  Every shedder works on the operator's
dense PM store: dropping a PM clears its mask bit, nothing moves.

  - pSPICE: utility-table lookup (O(1)/PM) + drop the ρ lowest;
  - PM-BL (``random_drop``): a uniformly random ρ-subset, drawn from the
    engine's threefry key (``repro_torch.prng``, bitwise ``jax.random``);
  - E-BL's event-type utility model (``ebl_type_utilities``,
    ``ebl_drop_mask``); the engine's own E-BL sheds in its input path.

Plans: ``"threshold"`` (default) is ``threshold_drop_mask``, an O(N)
histogram-refinement select; ``"sort"`` is the stable-argsort oracle.
"""
from __future__ import annotations

import torch

from repro_torch import prng
from repro_torch.core import utility as util

# Finite inactive-slot sentinel (f32-safe inf).
_BIG = 3.4e38


def pspice_utilities(stacked_tables, bin_sizes, active, pattern_id, state,
                     r_w) -> torch.Tensor:
    """Utility per PM slot; inactive slots get +inf (never 'lowest')."""
    u = util.multi_pattern_lookup(stacked_tables, bin_sizes, pattern_id,
                                  state, r_w)
    return torch.where(active, u, torch.full_like(u, float("inf")))


def drop_lowest_utility(active: torch.Tensor, utilities: torch.Tensor,
                        rho: torch.Tensor) -> torch.Tensor:
    """Algorithm 2 oracle: clear the rho active PMs of lowest utility
    (stable argsort rank < rho).  O(N log N).  Over the last axis: a
    leading lane axis gives each lane its own ρ."""
    order = torch.argsort(utilities, dim=-1, stable=True)
    iota = torch.arange(order.shape[-1], device=order.device)
    ranks = torch.empty_like(order).scatter_(-1, order,
                                             iota.expand_as(order))
    return active & ~(ranks < rho[..., None])


def bucket_edges(lo: torch.Tensor, hi: torch.Tensor,
                 nbins: int) -> torch.Tensor:
    """The (nbins+1,) bucket edges every histogram shares; top edge +inf
    (the last bucket owns the max).  The histogram kernel receives these
    and never recomputes them.  Lane-stacked lo/hi (L,) give (L, nbins+1)
    edges, each row that lane's."""
    k = torch.arange(nbins + 1, dtype=torch.float32, device=lo.device)
    edges = lo[..., None] + (hi - lo)[..., None] * k / nbins
    edges[..., -1] = float("inf")
    return edges


def _histogram_jnp(u: torch.Tensor, mask: torch.Tensor, lo: torch.Tensor,
                   hi: torch.Tensor, nbins: int) -> torch.Tensor:
    """O(N) masked bucket counts: searchsorted against ``bucket_edges``
    + one scatter-add (the reference's jnp histogram), per lane."""
    edges = bucket_edges(lo, hi, nbins)
    v = torch.where(mask, u, lo[..., None])
    b = torch.clamp(torch.searchsorted(edges, v, right=True) - 1,
                    0, nbins - 1)
    return torch.zeros(u.shape[:-1] + (nbins,), dtype=torch.int32,
                       device=u.device).scatter_add_(-1, b,
                                                     mask.to(torch.int32))


def threshold_drop_mask(active: torch.Tensor, utilities: torch.Tensor,
                        rho: torch.Tensor, *, nbins: int = 128,
                        levels: int = 3, hist_fn=None) -> torch.Tensor:
    """Algorithm 2 without the sort: O(N·levels) histogram refinement.

    Each level buckets the surviving candidates over [lo, hi), finds the
    bucket holding the ρ-th lowest utility, drops everything strictly
    below it and recurses into it; the remaining budget then breaks ties
    by slot index.  Exactly min(ρ, n_active) PMs are dropped.

    Works over the last axis: (n,) utilities with a scalar ρ, or (L, n)
    with ρ (L,) — each lane its own select, equal to its one-lane call
    bit for bit (the reference vmaps this function over lanes).

    ``hist_fn(u, lo, hi) -> (..., nbins) int32`` may count the buckets
    (the CUDA backend passes the histogram kernel); excluded entries come
    in as NaN, which no bucket counts.
    """
    u = utilities.float()
    n_active = active.sum(-1).to(torch.int32)
    need = torch.minimum(rho.to(torch.int32), n_active)
    lo = torch.where(active, u, torch.full_like(u, _BIG)).amin(-1)
    hi0 = torch.where(active, u, torch.full_like(u, -_BIG)).amax(-1)
    hi = torch.where(hi0 > lo, hi0, lo + 1.0)
    mask = active
    drop = torch.zeros_like(active)
    nan = torch.full_like(u, float("nan"))
    for _ in range(levels):
        if hist_fn is None:
            hist = _histogram_jnp(u, mask, lo, hi, nbins)
        else:
            hist = hist_fn(torch.where(mask, u, nan), lo, hi)
        cum = torch.cumsum(hist, -1, dtype=torch.int32)
        kb = torch.clamp(torch.searchsorted(cum, need[..., None]),
                         0, nbins - 1)
        edges = bucket_edges(lo, hi, nbins)
        edge = torch.gather(edges, -1, kb)
        upper = torch.gather(edges, -1, kb + 1)
        below = mask & (u < edge)
        drop = drop | below
        need = torch.clamp_min(need - below.sum(-1).to(torch.int32), 0)
        mask = mask & ~below & (u < upper)
        lo = edge[..., 0]
        hi_next = torch.where(kb[..., 0] == nbins - 1, hi, upper[..., 0])
        hi = torch.where(hi_next > lo, hi_next, lo + 1.0)
    idx_rank = torch.cumsum(mask, -1, dtype=torch.int32) - 1
    drop = drop | (mask & (idx_rank < need[..., None]))
    return active & ~drop


def random_drop(key: torch.Tensor, active: torch.Tensor,
                rho: torch.Tensor) -> torch.Tensor:
    """PM-BL: drop a uniformly random ρ-subset of the active PMs — the
    threshold select over iid uniform scores (lane-stacked keys (L, 2)
    draw each lane's own)."""
    scores = prng.uniform(key, active.shape[-1:])
    return threshold_drop_mask(active, scores, rho)


def shed(kind: str, *, key: torch.Tensor, active: torch.Tensor,
         rho: torch.Tensor, stacked_tables=None, bin_sizes=None,
         pattern_id=None, state=None, r_w=None,
         plan: str = "threshold") -> torch.Tensor:
    """Dispatch used by the engine: kind in {'pspice', 'pmbl'}, plan in
    {'threshold', 'sort'}; over the last axis, lanes leading (keys
    (L, 2), ρ (L,))."""
    if kind == "pspice":
        u = pspice_utilities(stacked_tables, bin_sizes, active, pattern_id,
                             state, r_w)
        if plan == "sort":
            return drop_lowest_utility(active, u, rho)
        return threshold_drop_mask(active, u, rho)
    if kind == "pmbl":
        if plan == "sort":
            scores = prng.uniform(key, active.shape[-1:])
            scores = torch.where(active, scores,
                                 torch.full_like(scores, float("inf")))
            return drop_lowest_utility(active, scores, rho)
        return random_drop(key, active, rho)
    raise ValueError(f"unknown shedder kind: {kind}")


# ---------------------------------------------------------------------------
# E-BL event-utility model (paper §IV-A baseline 2, after He et al. [15] +
# weighted sampling [13]).  Event *types* get utility proportional to their
# repetition in patterns and in windows; low-utility types are dropped from
# incoming windows by uniform sampling within type.
# ---------------------------------------------------------------------------

def ebl_type_utilities(pattern_class_of_type: torch.Tensor,
                       class_repetition_in_patterns: torch.Tensor,
                       type_frequency_in_windows: torch.Tensor
                       ) -> torch.Tensor:
    """Utility per event type.

    pattern_class_of_type: (n_types,) int32 — pattern class each raw event
        type maps to (0 == irrelevant to every pattern).
    class_repetition_in_patterns: (n_classes,) float — how often the class
        appears across pattern definitions (importance ∝ repetition).
    type_frequency_in_windows: (n_types,) float — empirical frequency (types
        that are rare in windows are harder to replace → more valuable).
    """
    rep = class_repetition_in_patterns[pattern_class_of_type.long()]
    freq = torch.clamp_min(type_frequency_in_windows, 1e-9)
    u = rep / freq
    return torch.where(pattern_class_of_type > 0, u, torch.zeros_like(u))


def ebl_drop_mask(key: torch.Tensor, type_of_event: torch.Tensor,
                  type_utils: torch.Tensor, drop_fraction) -> torch.Tensor:
    """Per-event drop decision: drop probability inversely related to the
    event type's utility, scaled so the expected drop rate == drop_fraction.

    Returns bool (n_events,) — True means the event is dropped before window
    processing (black-box shedding).  The uniforms come from ``key``
    through ``repro_torch.prng``, so they follow ``prng.PARTITIONABLE``."""
    u = type_utils[type_of_event.long()]
    u_max = torch.clamp_min(u.max(), 1e-9)
    # Normalized "keep priority" in [0, 1]; uniform sampling within a type.
    keep_priority = u / u_max
    # Drop probability per event, renormalized to hit the global budget.
    raw = 1.0 - keep_priority
    mean_raw = torch.clamp_min(raw.mean(), 1e-9)
    frac = torch.as_tensor(drop_fraction, dtype=raw.dtype, device=raw.device)
    p_drop = torch.clamp(raw * (frac / mean_raw), 0.0, 1.0)
    return prng.uniform(key, tuple(type_of_event.shape)) < p_drop
