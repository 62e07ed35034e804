"""The port's kernel wrappers against the reference's Pallas kernels.

On the CPU each wrapper computes its kernel's plain PyTorch version; it
must equal the Pallas kernel run with ``interpret=True`` (as
tests/test_kernels.py runs it) BITWISE, including store sizes that are
not a multiple of the 256-slot tile.  Their twins on the card, the CUDA
kernels against the plain versions, are in tests/test_torch_gpu.py.
"""
import numpy as np
import pytest
import torch

from repro.kernels import ops as rops
from repro.kernels.nfa_transition import nfa_advance_pallas
from repro.kernels.shed_select import (utility_histogram_pallas,
                                       utility_lookup_dyn_pallas)
from repro_torch.kernels import nfa_transition as kn
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref
from repro_torch.kernels import shed_select as ks
from repro_torch.kernels import tiling

SHAPES = [(3, 256, 11, 11, 38), (2, 1000, 5, 7, 9), (1, 37, 4, 3, 3),
          (8, 53, 11, 2, 3)]


def _inputs(P, N, M, C1, B, seed=0):
    rng = np.random.default_rng(seed + N)
    return dict(
        state=rng.integers(0, M, (P, N)).astype(np.int32),
        bind=rng.integers(-1, 3, (P, N)).astype(np.int32),
        active=rng.random((P, N)) < 0.6,
        trans=rng.integers(0, M, (P, M, C1)).astype(np.int32),
        ev_class=rng.integers(0, C1, P).astype(np.int32),
        ev_bind=rng.integers(-1, 3, P).astype(np.int32),
        final=np.full(P, M - 1, np.int32),
        uses=rng.random(P) < 0.5,
        tables=rng.random((P, B, M)).astype(np.float32),
        bins=rng.integers(1, 80, P).astype(np.int32),
        r_w=rng.integers(-50, B * 80 + 50, (P, N)).astype(np.int32),
        u=np.where(rng.random(P * N) < 0.7, rng.random(P * N),
                   np.nan).astype(np.float32))


def _t(d, device="cpu"):
    return {k: torch.from_numpy(v).to(device) for k, v in d.items()}


@pytest.mark.parametrize("P,N,M,C1,B", SHAPES)
def test_nfa_advance_equals_pallas(P, N, M, C1, B):
    d = _inputs(P, N, M, C1, B)
    t = _t(d)
    new_state, completed = kn.nfa_advance(
        t["state"], t["bind"], t["active"], t["trans"], t["ev_class"],
        t["ev_bind"], t["final"], t["uses"])
    for p in range(P):
        rs, rc = nfa_advance_pallas(
            d["state"][p], d["bind"][p], d["active"][p],
            d["trans"][p][:, d["ev_class"][p]], d["ev_bind"][p],
            d["final"][p], int(d["uses"][p]), interpret=True)
        np.testing.assert_array_equal(new_state[p].numpy(), np.asarray(rs))
        np.testing.assert_array_equal(completed[p].numpy(), np.asarray(rc))
    # The engine's dispatch surface returns the same pair, and the
    # reference's multi-pattern dispatch agrees on the next states.
    ns2, _ = kops.advance_seq_multi(t["state"], t["bind"], t["active"],
                                    t["trans"], t["ev_class"], t["ev_bind"],
                                    t["final"], t["uses"])
    np.testing.assert_array_equal(ns2.numpy(), np.asarray(
        rops.advance_seq_multi(d["state"], d["bind"], d["active"],
                               d["trans"], d["ev_class"], d["ev_bind"],
                               d["final"], d["uses"], interpret=True)))


@pytest.mark.parametrize("P,N,M,C1,B", SHAPES)
def test_utility_lookup_equals_pallas(P, N, M, C1, B):
    d = _inputs(P, N, M, C1, B)
    t = _t(d)
    u = kops.pm_utilities_multi(t["state"], t["r_w"], t["active"],
                                t["tables"], t["bins"])
    ref = np.asarray(rops.pm_utilities_multi(
        d["state"], d["r_w"], d["active"], d["tables"], d["bins"],
        interpret=True))
    np.testing.assert_array_equal(u.numpy(), ref)
    for p in range(P):
        np.testing.assert_array_equal(u[p].numpy(), np.asarray(
            utility_lookup_dyn_pallas(d["state"][p], d["r_w"][p],
                                      d["active"][p], d["tables"][p],
                                      d["bins"][p], interpret=True)))


@pytest.mark.parametrize("P,N,M,C1,B", SHAPES)
@pytest.mark.parametrize("nbins", [16, 64, 128])
def test_utility_histogram_equals_pallas(P, N, M, C1, B, nbins):
    u = _inputs(P, N, M, C1, B)["u"]
    fin = u[~np.isnan(u)]
    lo, hi = np.float32(fin.min()), np.float32(fin.max())
    ref = np.asarray(utility_histogram_pallas(u, lo, hi, nbins=nbins,
                                              interpret=True))
    got = ks.utility_histogram(torch.from_numpy(u), torch.tensor(lo),
                               torch.tensor(hi), nbins=nbins)
    np.testing.assert_array_equal(got.numpy(), ref)
    assert got.dtype == torch.int32 and int(got.sum()) == fin.size


@pytest.mark.parametrize("rho", [0, 3, 100, 10_000])
def test_shed_lowest_equals_pallas(rho):
    d = _inputs(1, 500, 6, 3, 12)
    t = _t(d)
    ref = np.asarray(rops.shed_lowest_pallas(
        d["active"][0], d["state"][0], d["r_w"][0], d["tables"][0],
        np.int32(rho), bin_size=int(d["bins"][0]), interpret=True))
    got = kops.shed_lowest(t["active"][0], t["state"][0], t["r_w"][0],
                           t["tables"][0], torch.tensor(rho),
                           bin_size=int(d["bins"][0]))
    np.testing.assert_array_equal(got.numpy(), ref)
    u = ks.utility_lookup(t["state"], t["r_w"], t["active"], t["tables"],
                          t["bins"]).reshape(-1)
    ref_t = np.asarray(rops.shed_lowest_threshold(
        d["active"][0], np.asarray(u), np.int32(rho), interpret=True))
    got_t = kops.shed_lowest_threshold(t["active"][0], u,
                                       torch.tensor(rho))
    np.testing.assert_array_equal(got_t.numpy(), ref_t)


def test_oracles_agree_with_wrappers():
    d = _inputs(1, 300, 7, 4, 10)
    t = _t(d)
    ns, cm = kref.nfa_advance_ref(
        t["state"][0], t["bind"][0], t["active"][0],
        t["trans"][0][:, int(d["ev_class"][0])], int(d["ev_bind"][0]),
        int(d["final"][0]), bool(d["uses"][0]))
    ks_, kc = kn.nfa_advance(t["state"], t["bind"], t["active"], t["trans"],
                             t["ev_class"], t["ev_bind"], t["final"],
                             t["uses"])
    assert torch.equal(ns, ks_[0]) and torch.equal(cm, kc[0])
    fin = t["u"][~torch.isnan(t["u"])]
    lo, hi = fin.min(), fin.max()
    assert torch.equal(kref.histogram_ref(t["u"], lo, hi, 32),
                       ks.utility_histogram(t["u"], lo, hi, nbins=32))
    # Sort-based oracle and threshold plan drop the same count.
    rho = torch.tensor(40)
    a = kref.shed_lowest_ref(t["active"][0], t["state"][0], t["r_w"][0],
                             t["tables"][0], rho, int(d["bins"][0]))
    b = kops.shed_lowest(t["active"][0], t["state"][0], t["r_w"][0],
                         t["tables"][0], rho, bin_size=int(d["bins"][0]))
    assert int((t["active"][0] & ~a).sum()) == int(
        (t["active"][0] & ~b).sum()) == 40


def test_cpu_wrappers_never_count_launches():
    kops.reset_launch_counts()
    test_nfa_advance_equals_pallas(*SHAPES[0])
    assert kops.launch_counts() == {"nfa_advance": 0, "utility_lookup": 0,
                                    "utility_histogram": 0,
                                    "utility_histogram_lanes": 0,
                                    "block_step": 0, "block_step_lanes": 0}


def test_tiling_matches_reference():
    from repro.kernels import tiling as rtiling
    for n in (1, 255, 256, 257, 1000):
        assert tiling.tile_pad(256, n) == rtiling.tile_pad(256, n)
    x = torch.arange(10, dtype=torch.int32)
    px, pad = tiling.pad_to_tile(8, (x, -1))
    assert pad == 6 and px.tolist() == list(range(10)) + [-1] * 6


def test_unsupported_device_raises():
    meta = torch.zeros((1, 4), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        kn.nfa_advance(meta, meta, meta.bool(), meta[:, :, None].expand(
            1, 4, 1), meta[:, 0], meta[:, 0], meta[:, 0], meta[:, 0].bool())
