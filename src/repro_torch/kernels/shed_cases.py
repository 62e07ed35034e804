"""Seeded inputs that stress the shed kernels (``csrc/shed_select.cu``).

The CPU tests hold the plain versions against the reference on them, and
the card tests and ``chip_smoke.py`` hold the kernels against the plain
versions, bit for bit.  Each case is numpy arrays made from a seed.

Histogram cases (``hist_case``), each lane its own utilities and range:
  random      uniform utilities, 40 % NaN, the range their finite min/max
  edge_equal  utilities on their lane's bucket edges (the top one +inf
              included) and an ulp either side of them
  inf         ±inf among finite utilities and NaN
  collapsed   lo = 1e30 and hi = lo + 1, which rounds to lo in float32:
              every edge but the top one equal
  ulps        lo = 1e30 and hi three ulps above it: runs of equal edges
  narrow      a range of ~21 ulps over 128 buckets (lo = -1098.2369, as
              on a deep refinement level): uneven runs of equal edges
  refinement  two thirds NaN, the rest on 11 distinct values, as on a
              refinement level of stock's interpolated tables
  all_nan     nothing to count

Lookup cases (``lookup_case``): random stores (60 % active, states and
remaining windows past both ends of the table), all inactive, NaN in the
tables, and a large table (100 KB a row).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.shedder import bucket_edges

HIST_CASES = ("random", "edge_equal", "inf", "collapsed", "ulps",
              "narrow", "refinement", "all_nan")
LOOKUP_CASES = ("random", "all_inactive", "nan_tables", "oversized")


def _range(u: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Per-lane lo/hi as the engine takes them: the finite min and max,
    hi lifted above lo where they meet; (0, 1) for a lane with none."""
    fin = np.isfinite(u)
    lo = np.where(fin.any(1), np.where(fin, u, np.inf).min(1), 0.0)
    hi = np.where(fin.any(1), np.where(fin, u, -np.inf).max(1), 1.0)
    lo, hi = lo.astype(np.float32), hi.astype(np.float32)
    return lo, np.where(hi > lo, hi, lo + np.float32(1.0)).astype(np.float32)


def edges_of(lo: np.ndarray, hi: np.ndarray, nbins: int) -> np.ndarray:
    """(L, nbins+1) float32 edges, ``core.shedder.bucket_edges``'."""
    return bucket_edges(torch.from_numpy(lo), torch.from_numpy(hi),
                        nbins).numpy()


def _near_edges(rng, pick: np.ndarray) -> np.ndarray:
    """Half of ``pick`` as it is, a quarter an ulp below, a quarter an ulp
    above."""
    f32 = np.float32
    r = rng.random(pick.shape)
    return np.where(r < 0.25, np.nextafter(pick, f32(-np.inf)),
                    np.where(r < 0.5, np.nextafter(pick, f32(np.inf)),
                             pick)).astype(f32)


def hist_case(name: str, L: int, n: int, nbins: int, seed: int = 0):
    """``(u, lo, hi, edges)``: (L, n) float32 utilities, their lanes'
    (L,) ranges and the (L, nbins+1) edges made from them."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    if name in ("collapsed", "ulps", "narrow"):
        lo = np.full(L, 1e30, f32)
        hi = lo + f32(1.0)                      # == lo in float32
        if name == "narrow":
            lo = np.full(L, -1098.2369, f32)
            hi = np.full(L, -1098.2343, f32)
        if name == "ulps":
            hi = lo
            for _ in range(3):
                hi = np.nextafter(hi, f32(np.inf))
        e = edges_of(lo, hi, nbins)
        u = _near_edges(rng, e[:, :-1][np.arange(L)[:, None],
                                       rng.integers(0, nbins, (L, n))])
        u[rng.random((L, n)) < 0.2] = np.nan
        return u, lo, hi, e
    if name == "refinement":
        values = rng.random(11).astype(f32)
        u = values[rng.integers(0, 11, (L, n))]
        u[rng.random((L, n)) < 2 / 3] = np.nan
    elif name == "all_nan":
        u = np.full((L, n), np.nan, f32)
    else:
        u = rng.random((L, n)).astype(f32)
        u[rng.random((L, n)) < 0.4] = np.nan
    lo, hi = _range(u)
    e = edges_of(lo, hi, nbins)
    if name == "edge_equal":
        u = _near_edges(rng, e[np.arange(L)[:, None],
                               rng.integers(0, nbins + 1, (L, n))])
    elif name == "inf":
        r = rng.random((L, n))
        u[r < 0.15] = np.inf
        u[(r >= 0.15) & (r < 0.3)] = -np.inf
    return np.ascontiguousarray(u, f32), lo, hi, e


def lookup_case(name: str, P: int, N: int, seed: int = 0, M: int = 11,
                B: int = 38):
    """``(state, r_w, active, tables, bin_sizes)`` of a (P, N) store:
    int32, int32, bool, (P, B, M) float32, (P,) int32.  ``oversized``
    takes a (P, 400, 64) table (100 KB a row)."""
    rng = np.random.default_rng(seed)
    if name == "oversized":
        B, M = 400, 64
    state = rng.integers(-1, M + 1, (P, N)).astype(np.int32)
    active = rng.random((P, N)) < 0.6
    tables = rng.random((P, B, M)).astype(np.float32)
    bins = rng.integers(1, 80, P).astype(np.int32)
    r_w = rng.integers(-80, B * 80 + 80, (P, N)).astype(np.int32)
    if name == "all_inactive":
        active[:] = False
    elif name == "nan_tables":
        tables[rng.random(tables.shape) < 0.3] = np.nan
    return state, r_w, active, tables, bins
