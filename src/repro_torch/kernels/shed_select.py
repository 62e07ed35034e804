"""The load shedder's kernels (paper Algorithm 2, threshold plan).

Port of ``repro.kernels.shed_select``:

  1. ``utility_lookup``: the pSPICE utility of every PM of every pattern
     (interpolated UT-table lookup, inactive slots 3.4e38) in ONE launch
     over the (P, N) store — the TPU ran one one-hot-matmul launch per
     pattern;
  2. ``utility_histogram``: bucket counts of the utilities over the
     shared ``core.shedder.bucket_edges`` — the bucket counter of
     ``threshold_drop_mask`` on the CUDA backend;
  3. ``utility_histogram_lanes``: its lane instance (the reference vmaps
     the histogram kernel over tenant lanes in the degradation ladder's
     PM trim): (L, n) utilities against (L, nbins+1) per-lane edges,
     one launch whose grid's y axis is the lane.  A trim over L lanes is
     one lookup launch over the L·P pattern rows laid end to end plus one
     lane-instance launch per refinement level.

Each wrapper launches its CUDA kernel (``csrc/shed_select.cu``) for CUDA
tensors and computes its plain PyTorch version for CPU tensors.  How
many CTAs (one, or a thread-block cluster of 8) a histogram lane takes is
chosen here, from n alone.
"""
from __future__ import annotations

import torch

from repro_torch import fp
from repro_torch.core.shedder import bucket_edges
from repro_torch.kernels import _build

INACTIVE = 3.4e38
# A histogram lane of up to HIST_ONE_CTA utilities takes one CTA (up to
# 1 024 threads, then 4 utilities a thread); a longer one a cluster of
# MAX_CLUSTER CTAs (the portable cluster size), which costs about a
# microsecond of its own and pays past ~4 096 utilities a lane
# (``tests/_shed_probe.py sweep`` on the H100).
HIST_ONE_CTA = 4096
MAX_CLUSTER = 8


def utility_lookup_plain(state, r_w, active, tables, bin_sizes):
    """Plain PyTorch version of the lookup kernel: (P, N) float32."""
    P, N = state.shape
    _, B, M = tables.shape
    bs = bin_sizes.float()[:, None]
    pos = torch.clamp(r_w.float() / bs - 1.0, 0.0, B - 1.0)
    j0 = torch.floor(pos).to(torch.int64)
    j1 = torch.clamp_max(j0 + 1, B - 1)
    frac = pos - j0.float()
    ok = (state >= 0) & (state < M)
    st = state.long().clamp(0, M - 1)
    pidx = torch.arange(P, device=state.device)[:, None]
    zero = torch.zeros((), dtype=torch.float32, device=state.device)
    u0 = torch.where(ok, tables[pidx, j0, st], zero)
    u1 = torch.where(ok, tables[pidx, j1, st], zero)
    # The reference kernel's rounding: fma(u0, 1 - frac, u1 * frac).
    u = fp.fma(u0, 1.0 - frac, u1 * frac)
    return torch.where(active, u, torch.full_like(u, INACTIVE))


def utility_histogram_plain(u: torch.Tensor,
                            edges: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the histogram kernel: (nbins,) int32
    counts of u in [edges[b], edges[b+1]) — NaN counts nowhere."""
    lo, hi = edges[:-1], edges[1:]
    inside = (u[:, None] >= lo[None, :]) & (u[:, None] < hi[None, :])
    return inside.sum(dim=0, dtype=torch.int32)


def utility_histogram_lanes_plain(u: torch.Tensor,
                                  edges: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the lane instance: (L, nbins) int32, row
    l the counts of u[l] over edges[l]."""
    lo, hi = edges[:, None, :-1], edges[:, None, 1:]
    inside = (u[:, :, None] >= lo) & (u[:, :, None] < hi)
    return inside.sum(dim=1, dtype=torch.int32)


def _check(fn, name, t, dtype, shape, dev):
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) or \
            not t.is_contiguous() or t.device != dev:
        raise ValueError(f"{fn}: {name} must be a contiguous {dtype} of "
                         f"shape {tuple(shape)} on {dev}, got {t.dtype} "
                         f"{tuple(t.shape)} on {t.device}")


def utility_lookup(state: torch.Tensor, r_w: torch.Tensor,
                   active: torch.Tensor, tables: torch.Tensor,
                   bin_sizes: torch.Tensor) -> torch.Tensor:
    """pSPICE utilities of the whole store.

    state/r_w (P, N) int32, active (P, N) bool, tables (P, B, M) float32,
    bin_sizes (P,) int32 → (P, N) float32 (inactive slots 3.4e38).
    """
    dev = state.device
    if dev.type == "cpu":
        return utility_lookup_plain(state, r_w, active, tables, bin_sizes)
    if dev.type != "cuda":
        raise ValueError(f"utility_lookup: unsupported device {dev}")
    P, N = state.shape
    _, B, M = tables.shape
    for name, t, dt, shp in (
            ("state", state, torch.int32, (P, N)),
            ("r_w", r_w, torch.int32, (P, N)),
            ("active", active, torch.bool, (P, N)),
            ("tables", tables, torch.float32, (P, B, M)),
            ("bin_sizes", bin_sizes, torch.int32, (P,))):
        _check("utility_lookup", name, t, dt, shp, dev)
    if P > 65535 or P * N >= 2 ** 31:
        raise ValueError(f"utility_lookup: rows must be at most 65 535 and "
                         f"P·N below 2**31: {P} x {N}")
    out = torch.empty((P, N), dtype=torch.float32, device=dev)
    lib = _build.load()
    _build.check(lib.utility_lookup_launch(
        state.data_ptr(), r_w.data_ptr(), active.data_ptr(),
        tables.data_ptr(), bin_sizes.data_ptr(), P, N, B, M,
        out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream),
        "utility_lookup")
    utility_lookup.launches += 1
    return out


def hist_ctas(n: int) -> int:
    """CTAs (the cluster's size) a histogram lane of n utilities takes."""
    return 1 if n <= HIST_ONE_CTA else MAX_CLUSTER


def utility_histogram_edges(u: torch.Tensor,
                            edges: torch.Tensor) -> torch.Tensor:
    """Bucket counts of flat float32 ``u`` over (nbins+1,) ``edges``."""
    dev = u.device
    if dev.type == "cpu":
        return utility_histogram_plain(u, edges)
    if dev.type != "cuda":
        raise ValueError(f"utility_histogram: unsupported device {dev}")
    nbins = edges.shape[0] - 1
    if not 1 <= nbins <= 4096:
        raise ValueError(f"utility_histogram: nbins must be in [1, 4096]: "
                         f"{nbins}")
    _check("utility_histogram", "u", u, torch.float32, (u.shape[0],), dev)
    if u.shape[0] > 2 ** 30:
        raise ValueError(f"utility_histogram: n must be at most 2**30: "
                         f"{u.shape[0]}")
    _check("utility_histogram", "edges", edges, torch.float32,
           (nbins + 1,), dev)
    out = torch.empty((nbins,), dtype=torch.int32, device=dev)
    lib = _build.load()
    _build.check(lib.utility_histogram_launch(
        u.data_ptr(), u.shape[0], edges.data_ptr(), nbins,
        hist_ctas(u.shape[0]), out.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream), "utility_histogram")
    utility_histogram_edges.launches += 1
    return out


def utility_histogram(u: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
                      *, nbins: int = 64) -> torch.Tensor:
    """Bucket counts of u within [lo, hi) over ``bucket_edges(lo, hi,
    nbins)`` — the ``hist_fn`` signature of ``threshold_drop_mask``;
    lane-stacked (L, n) utilities with (L,) lo/hi go through the lane
    instance when L > 1, one lane (the per-event engine's shed) through
    the one-lane kernel."""
    edges = bucket_edges(lo, hi, nbins)
    if u.dim() == 1:
        return utility_histogram_edges(u, edges)
    if u.shape[0] == 1:
        return utility_histogram_edges(u[0], edges[0])[None]
    return utility_histogram_lanes(u, edges)


def utility_histogram_lanes(u: torch.Tensor,
                            edges: torch.Tensor) -> torch.Tensor:
    """Bucket counts per lane: (L, n) float32 utilities over (L, nbins+1)
    per-lane edges → (L, nbins) int32.  Row l equals
    ``utility_histogram_edges(u[l], edges[l])`` bit for bit."""
    dev = u.device
    if dev.type == "cpu":
        return utility_histogram_lanes_plain(u, edges)
    if dev.type != "cuda":
        raise ValueError(f"utility_histogram_lanes: unsupported device {dev}")
    L, n = u.shape
    nbins = edges.shape[-1] - 1
    if not 1 <= nbins <= 4096:
        raise ValueError(f"utility_histogram_lanes: nbins must be in "
                         f"[1, 4096]: {nbins}")
    if not 1 <= L <= 65535:
        raise ValueError(f"utility_histogram_lanes: lanes must be in "
                         f"[1, 65535]: {L}")
    _check("utility_histogram_lanes", "u", u, torch.float32, (L, n), dev)
    if n > 2 ** 30:
        raise ValueError(f"utility_histogram_lanes: n must be at most "
                         f"2**30: {n}")
    _check("utility_histogram_lanes", "edges", edges, torch.float32,
           (L, nbins + 1), dev)
    out = torch.empty((L, nbins), dtype=torch.int32, device=dev)
    lib = _build.load()
    _build.check(lib.utility_histogram_lanes_launch(
        u.data_ptr(), L, n, edges.data_ptr(), nbins, hist_ctas(n),
        out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream),
        "utility_histogram_lanes")
    utility_histogram_lanes.launches += 1
    return out


utility_lookup.launches = 0
utility_histogram_edges.launches = 0
utility_histogram_lanes.launches = 0
