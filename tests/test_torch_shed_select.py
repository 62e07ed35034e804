"""The shed kernels' hard inputs on the CPU (``kernels.shed_cases``).

The histogram kernel finds each utility's bucket by a guess from the
first bucket's width and a short walk (``bucket_near`` in
``csrc/shed_select.cu``), which cannot run here; a float32 numpy
emulation of it, step for step, is held against ``repro::bucket_of``'s
bisection and, through the counts, against the plain version and the
reference's Pallas kernel (``interpret=True``).  The plain lookup and the
lane histogram are held against the reference on the same cases; their
kernels' twins on the card are in tests/test_torch_gpu.py.
"""
import jax
import numpy as np
import pytest
import torch

from repro.kernels.shed_select import (utility_histogram_pallas,
                                       utility_lookup_dyn_pallas)
from repro_torch.kernels import shed_cases as sc
from repro_torch.kernels import shed_select as ks

WALK = 2          # kWalk in csrc/shed_select.cu


def bucket_of_np(v: np.ndarray, e: np.ndarray) -> np.ndarray:
    """repro::bucket_of (common.cuh): bisection for the largest b with
    e[b] <= v, confirmed by the two comparisons; -1 where none holds."""
    nb = e.size - 1
    ok = v >= e[0]
    lo, hi = np.zeros(v.shape, np.int64), np.full(v.shape, nb, np.int64)
    while np.any(ok & (lo < hi)):
        go = ok & (lo < hi)
        mid = (lo + hi + 1) >> 1
        le = e[mid] <= v
        lo = np.where(go & le, mid, lo)
        hi = np.where(go & ~le, mid - 1, hi)
    return _confirm(v, e, ok, lo)


def _confirm(v, e, ok, b):
    nb = e.size - 1
    top = np.minimum(b + 1, nb)
    return np.where(ok & (b < nb) & (v >= e[b]) & (v < e[top]), b, -1)


def bucket_near_np(v: np.ndarray, e: np.ndarray,
                   walk: int = WALK) -> np.ndarray:
    """bucket_near (csrc/shed_select.cu) in float32, step for step: the
    guess (v - e[0]) · (1 / (e[1] - e[0])) clamped to [0, nbins - 1] (NaN
    to 0, as fmaxf), a walk of ``walk`` steps up or down, then bisection
    of what is left, then the confirmation."""
    nb = e.size - 1
    v = v.astype(np.float32)
    e0 = e[0]
    ok = v >= e0
    with np.errstate(all="ignore"):
        inv = np.float32(1) / np.float32(e[1] - e0)
        g = (v - e0) * inv
    g = np.fmin(np.fmax(g, np.float32(0)), np.float32(nb - 1))
    b = np.where(ok, g.astype(np.int64), 0)
    up = ok & (e[b] <= v)
    lo = np.where(up, b, 0)
    hi = np.where(up, nb, b - 1)
    for _ in range(walk):
        go = ok & (lo < hi)
        nxt = e[np.minimum(lo + 1, nb)] <= v        # up: e[lo + 1] <= v
        over = e[np.maximum(hi, 0)] > v             # down: e[hi] > v
        lo = np.where(go & up, np.where(nxt, lo + 1, lo), lo)
        hi = np.where(go & up & ~nxt, lo, hi)
        hi = np.where(go & ~up & over, hi - 1, hi)
        lo = np.where(go & ~up & ~over, hi, lo)
    while np.any(ok & (lo < hi)):
        go = ok & (lo < hi)
        mid = (lo + hi + 1) >> 1
        le = e[mid] <= v
        lo = np.where(go & le, mid, lo)
        hi = np.where(go & ~le, mid - 1, hi)
    return _confirm(v, e, ok, lo)


def _counts(b: np.ndarray, nbins: int) -> np.ndarray:
    return np.bincount(b[b >= 0], minlength=nbins).astype(np.int32)


@pytest.mark.parametrize("nbins", [1, 64, 128, 4096])
@pytest.mark.parametrize("case", sc.HIST_CASES)
def test_bucket_walk_equals_bisection_plain_and_reference(case, nbins):
    u, lo, hi, e = sc.hist_case(case, 1, 1003, nbins, seed=nbins)
    u, e = u[0], e[0]
    walked = bucket_near_np(u, e)
    np.testing.assert_array_equal(walked, bucket_of_np(u, e))
    np.testing.assert_array_equal(bucket_near_np(u, e, walk=0), walked)
    counts = _counts(walked, nbins)
    plain = ks.utility_histogram_plain(torch.from_numpy(u),
                                       torch.from_numpy(e))
    np.testing.assert_array_equal(counts, plain.numpy())
    ref = np.asarray(utility_histogram_pallas(u, lo[0], hi[0], nbins=nbins,
                                              interpret=True))
    np.testing.assert_array_equal(counts, ref)


def test_bucket_walk_covers_its_cases():
    """Over the cases the guess is right, one or two buckets low or high
    (the walk settles it), and far off both ways (the bisection finishes
    it); and the cases hold values on edges, ±inf and NaN."""
    offs = []
    for case in sc.HIST_CASES:
        u, _, _, e = sc.hist_case(case, 1, 1003, 128)
        u, e = u[0], e[0]
        with np.errstate(all="ignore"):
            g = (u - e[0]) * (np.float32(1) / np.float32(e[1] - e[0]))
        g = np.fmin(np.fmax(g, np.float32(0)), np.float32(127))
        b = bucket_of_np(u, e)
        offs.append((b - g.astype(np.int64))[b >= 0])
    off = np.concatenate(offs)
    assert np.any(off == 0)
    assert np.any((off > 0) & (off <= WALK)) and \
        np.any((off < 0) & (off >= -WALK))
    assert np.any(off > WALK + 1) and np.any(off < -WALK - 1)
    u2, _, _, e2 = sc.hist_case("edge_equal", 1, 1003, 128)
    assert np.isin(u2[0], e2[0]).mean() > 0.4 and np.isposinf(u2).any()
    u3, *_ = sc.hist_case("inf", 1, 1003, 128)
    assert np.isposinf(u3).any() and np.isneginf(u3).any() and \
        np.isnan(u3).any()
    u4, *_ = sc.hist_case("refinement", 1, 1003, 128)
    assert len(np.unique(u4[~np.isnan(u4)])) <= 11 and \
        np.isnan(u4).mean() > 0.6


@pytest.mark.parametrize("case", sc.HIST_CASES)
def test_histogram_lanes_equal_reference_vmapped(case):
    """The lane instance's plain version against the reference histogram
    vmapped over lanes (as the trim vmaps it), each lane its own range;
    lanes of n = 1 003, so rows start off a 16-byte boundary."""
    L, n, nbins = 3, 1003, 128
    u, lo, hi, e = sc.hist_case(case, L, n, nbins, seed=5)
    got = ks.utility_histogram_lanes(torch.from_numpy(u),
                                     torch.from_numpy(e))
    ref = jax.vmap(lambda a, b, c: utility_histogram_pallas(
        a, b, c, nbins=nbins, interpret=True))(u, lo, hi)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    for k in range(L):
        np.testing.assert_array_equal(
            got[k].numpy(), _counts(bucket_near_np(u[k], e[k]), nbins))


def _lookup_ref(state, r_w, active, tables, bins):
    return np.stack([np.asarray(utility_lookup_dyn_pallas(
        state[p], r_w[p], active[p], tables[p], np.float32(bins[p]),
        interpret=True)) for p in range(state.shape[0])])


@pytest.mark.parametrize("case", ["random", "all_inactive"])
@pytest.mark.parametrize("P,N", [(3, 1003), (12, 256)])
def test_lookup_equals_reference(case, P, N):
    """The plain lookup against the reference, row by row: N = 1 003 (a
    store whose flat length leaves a tail past the last 4-PM group) and
    L·P = 12 rows laid end to end (four lanes of stock's three
    patterns, as the trim lays them).  Not on NaN tables: the reference
    reads its table through one-hot products, where a NaN anywhere in
    the row spreads, and the port gathers the entry (its kernel is held
    to the plain version on them on the card)."""
    args = sc.lookup_case(case, P, N, seed=N + P)
    got = ks.utility_lookup(*(torch.from_numpy(a) for a in args))
    want = _lookup_ref(*args)
    assert np.array_equal(got.numpy(), want, equal_nan=True)


def test_lookup_oversized_table_equals_reference():
    """A (400, 64) table a row (100 KB), states and windows past both of
    its ends."""
    args = sc.lookup_case("oversized", 2, 300, seed=3)
    assert args[3].shape == (2, 400, 64)
    got = ks.utility_lookup(*(torch.from_numpy(a) for a in args))
    assert np.array_equal(got.numpy(), _lookup_ref(*args), equal_nan=True)


@pytest.mark.parametrize("n,ctas", [(0, 1), (768, 1), (4096, 1),
                                    (4097, 8), (6144, 8), (1 << 24, 8)])
def test_hist_ctas(n, ctas):
    """The engine's shed and the trim (n = 768) take one CTA a lane; the
    parity cell's (n = 6 144) and longer lanes a cluster of 8."""
    assert ks.hist_ctas(n) == ctas
