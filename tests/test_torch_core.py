"""The port's core (Algorithm 1, the shedders, the utility lookup and the
model builders) against the reference.

Bars: Algorithm 1 on LINEAR fits, the drop masks, the histogram and the
lookups are BITWISE (the reference runs jitted, as in its engine, so its
fused multiply-adds are in place); NLOGN fits go through log2, which
differs between libms, so they must give the same decision (equal ρ);
the model builders sum in another order than XLA, so they are held to
rtol=1e-5, atol=1e-7.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import markov, overload as ovl, shedder as shd, utility
from repro_torch import fp
from repro_torch.core import markov as tmarkov
from repro_torch.core import overload as tovl
from repro_torch.core import shedder as tshd
from repro_torch.core import utility as tutility

T = torch.from_numpy
RTOL, ATOL = 1e-5, 1e-7


# ---------------------------------------------------------------------------
# Algorithm 1
# ---------------------------------------------------------------------------

def _alg1_inputs(kind, seed, n=400):
    rng = np.random.default_rng(seed)
    f = (np.float32(rng.uniform(1e-5, 1e-4)), np.float32(
        rng.uniform(1e-4, 5e-4)), kind)
    g = (np.float32(rng.uniform(1e-7, 1e-6)), np.float32(
        rng.uniform(1e-5, 2e-4)), tovl.LINEAR)
    l_q = (rng.random(n) * rng.choice([1e-3, 3e-2, 1.0], n)
           ).astype(np.float32)
    n_pm = rng.integers(0, 6000, n).astype(np.int32)
    return f, g, l_q, n_pm


def _ref_alg1(f, g, l_q, n_pm, lb, sb):
    fm = ovl.LatencyModel(jnp.float32(f[0]), jnp.float32(f[1]),
                          jnp.int32(f[2]))
    gm = ovl.LatencyModel(jnp.float32(g[0]), jnp.float32(g[1]),
                          jnp.int32(g[2]))
    fn = jax.jit(lambda lq, n: ovl.detect_overload(fm, gm, lq, n, lb, sb))
    d = fn(l_q, n_pm)
    return np.asarray(d.shed), np.asarray(d.rho), np.asarray(d.l_e)


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("lb,sb", [(0.05, 0.0), (1.0, 0.0), (0.02, 0.004)])
def test_alg1_linear_bitwise(seed, lb, sb):
    f, g, l_q, n_pm = _alg1_inputs(tovl.LINEAR, seed)
    shed, rho, l_e = _ref_alg1(f, g, l_q, n_pm, lb, sb)
    fm = tovl.latency_model(*f)
    gm = tovl.latency_model(*g)
    d = tovl.detect_overload(fm, gm, T(l_q), T(n_pm), lb, sb)
    np.testing.assert_array_equal(d.shed.numpy(), shed)
    np.testing.assert_array_equal(d.rho.numpy(), rho)
    np.testing.assert_array_equal(d.l_e.numpy(), l_e)
    hf, hg = tovl.HostLatencyModel(*f), tovl.HostLatencyModel(*g)
    for k in range(0, len(l_q), 7):
        s, r, e = tovl.detect_overload_host(hf, hg, l_q[k], int(n_pm[k]),
                                            lb, sb)
        assert (s, r, e) == (shed[k], rho[k], l_e[k]), k


@pytest.mark.parametrize("seed", range(3))
def test_alg1_nlogn_same_decision(seed):
    f, g, l_q, n_pm = _alg1_inputs(tovl.NLOGN, seed)
    f = (np.float32(f[0] / 10), f[1], f[2])
    shed, rho, _ = _ref_alg1(f, g, l_q, n_pm, 0.05, 0.0)
    d = tovl.detect_overload(tovl.latency_model(*f), tovl.latency_model(*g),
                             T(l_q), T(n_pm), 0.05, 0.0)
    np.testing.assert_array_equal(d.shed.numpy(), shed)
    np.testing.assert_array_equal(d.rho.numpy(), rho)
    hf, hg = tovl.HostLatencyModel(*f), tovl.HostLatencyModel(*g)
    for k in range(0, len(l_q), 5):
        s, r, _ = tovl.detect_overload_host(hf, hg, l_q[k], int(n_pm[k]),
                                            0.05)
        assert (s, r) == (shed[k], rho[k]), k


def test_fma_matches_xla_contraction():
    rng = np.random.default_rng(0)
    a, b, c = (rng.standard_normal(5000).astype(np.float32) for _ in range(3))
    ref = np.asarray(jax.jit(lambda a, b, c: a * b + c)(a, b, c))
    np.testing.assert_array_equal(fp.fma(T(a), T(b), T(c)).numpy(), ref)
    host = np.array([fp.fma32(x, y, z) for x, y, z in zip(a, b, c)])
    np.testing.assert_array_equal(host, ref)


def test_to_int32_saturates_like_xla():
    x = np.array([3e9, -3e9, np.nan, 2147483520.0, 5.7, -5.7, 0.0],
                 np.float32)
    ref = np.asarray(jnp.asarray(x).astype(jnp.int32))
    np.testing.assert_array_equal(fp.to_int32(T(x)).numpy(), ref)
    assert [fp.to_int32_host(v) for v in x] == ref.tolist()


# ---------------------------------------------------------------------------
# Shedders
# ---------------------------------------------------------------------------

def _shed_inputs(kind, n=700, seed=0):
    rng = np.random.default_rng(seed)
    active = rng.random(n) < 0.7
    if kind == "random":
        u = rng.random(n).astype(np.float32)
    elif kind == "ties":
        u = np.full(n, 0.375, np.float32)
    elif kind == "few_values":
        u = rng.choice([0.1, 0.2, 0.2000001, 5.0], n).astype(np.float32)
    else:  # all inactive
        u = rng.random(n).astype(np.float32)
        active[:] = False
    return active, u


KINDS = ("random", "ties", "few_values", "inactive")
RHOS = (0, 1, 37, 350, 10_000)           # 10_000 > n_active


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("rho", RHOS)
def test_threshold_drop_mask_bitwise(kind, rho):
    active, u = _shed_inputs(kind)
    ref = np.asarray(jax.jit(shd.threshold_drop_mask)(
        active, jnp.where(active, u, jnp.inf), jnp.int32(rho)))
    got = tshd.threshold_drop_mask(T(active), torch.where(
        T(active), T(u), torch.tensor(np.inf)), torch.tensor(rho))
    np.testing.assert_array_equal(got.numpy(), ref)
    assert int((T(active) & ~got).sum()) == min(rho, int(active.sum()))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("rho", RHOS)
def test_drop_lowest_utility_bitwise(kind, rho):
    active, u = _shed_inputs(kind, seed=1)
    uu = np.where(active, u, np.inf).astype(np.float32)
    ref = np.asarray(jax.jit(shd.drop_lowest_utility)(active, uu,
                                                      jnp.int32(rho)))
    got = tshd.drop_lowest_utility(T(active), T(uu), torch.tensor(rho))
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("nbins", [16, 128])
def test_histogram_bitwise(kind, nbins):
    active, u = _shed_inputs(kind, seed=2)
    lo = np.float32(u[active].min()) if active.any() else np.float32(0.0)
    hi = np.float32(u[active].max()) if active.any() else np.float32(1.0)
    hi = hi if hi > lo else np.float32(lo + 1.0)
    ref = np.asarray(jax.jit(shd._histogram_jnp, static_argnums=4)(
        u, active, lo, hi, nbins))
    got = tshd._histogram_jnp(T(u), T(active), torch.tensor(lo),
                              torch.tensor(hi), nbins)
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(
        tshd.bucket_edges(torch.tensor(lo), torch.tensor(hi), nbins).numpy(),
        np.asarray(jax.jit(shd.bucket_edges, static_argnums=2)(lo, hi,
                                                                nbins)))


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("rho", [0, 5, 200, 10_000])
@pytest.mark.parametrize("plan", ["threshold", "sort"])
def test_random_drop_bitwise(seed, rho, plan):
    active, _ = _shed_inputs("random", n=3 * 256, seed=seed)
    key = jax.random.PRNGKey(seed + 11)
    ref = np.asarray(jax.jit(lambda k, a, r: shd.shed(
        "pmbl", key=k, active=a, rho=r, plan=plan))(key, active,
                                                    jnp.int32(rho)))
    tkey = torch.from_numpy(np.array(key).view(np.int32))
    got = tshd.shed("pmbl", key=tkey, active=T(active), rho=torch.tensor(rho),
                    plan=plan)
    np.testing.assert_array_equal(got.numpy(), ref)


# ---------------------------------------------------------------------------
# Utility lookup
# ---------------------------------------------------------------------------

def _tables(seed, P=3, B=38, M=11):
    rng = np.random.default_rng(seed)
    return (rng.random((P, B, M)).astype(np.float32),
            rng.integers(1, 100, P).astype(np.int32))


@pytest.mark.parametrize("seed", range(3))
def test_multi_pattern_lookup_bitwise(seed):
    tabs, bins = _tables(seed)
    rng = np.random.default_rng(seed + 5)
    n = 3000
    pid = rng.integers(0, 3, n).astype(np.int32)
    st = rng.integers(0, 11, n).astype(np.int32)
    rw = rng.integers(-100, 4000, n).astype(np.int32)
    ref = np.asarray(jax.jit(utility.multi_pattern_lookup)(tabs, bins, pid,
                                                           st, rw))
    got = tutility.multi_pattern_lookup(T(tabs), T(bins), T(pid), T(st),
                                        T(rw))
    np.testing.assert_array_equal(got.numpy(), ref)
    ref_p = np.asarray(jax.jit(shd.pspice_utilities)(
        tabs, bins, pid % 2 == 0, pid, st, rw))
    got_p = tshd.pspice_utilities(T(tabs), T(bins), T(pid % 2 == 0), T(pid),
                                  T(st), T(rw))
    np.testing.assert_array_equal(got_p.numpy(), ref_p)


@pytest.mark.parametrize("bin_size", [1, 64, 100])
def test_lookup_utility_bitwise(bin_size):
    tabs, _ = _tables(9)
    rng = np.random.default_rng(bin_size)
    st = rng.integers(0, 11, 2000).astype(np.int32)
    rw = rng.integers(-10, 40 * bin_size, 2000).astype(np.int32)
    ref = np.asarray(jax.jit(utility.lookup_utility, static_argnums=1)(
        tabs[0], bin_size, st, rw))
    got = tutility.lookup_utility(T(tabs[0]), bin_size, T(st), T(rw))
    np.testing.assert_array_equal(got.numpy(), ref)


# ---------------------------------------------------------------------------
# Model builders (tolerance: reductions run in another order)
# ---------------------------------------------------------------------------

def _counts(seed, m):
    rng = np.random.default_rng(seed)
    c = (rng.random((m, m)) * 50 * (rng.random((m, m)) < 0.5)
         ).astype(np.float32)
    c[1] = 0.0                                   # an unobserved row
    r = (c * rng.uniform(1e-5, 1e-4, (m, m))).astype(np.float32)
    return c, r


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("m,window,bin_size", [(11, 600, 64),
                                               (5, 150, 64), (4, 400, 20)])
def test_markov_and_utility_builders(seed, m, window, bin_size):
    c, r = _counts(seed, m)
    stats = markov.TransitionStats(jnp.asarray(c), jnp.asarray(r))
    tstats = tmarkov.TransitionStats(T(c), T(r))
    Tm = markov.estimate_transition_matrix(stats)
    Tt = tmarkov.estimate_transition_matrix(tstats)
    np.testing.assert_allclose(Tt.numpy(), np.asarray(Tm), RTOL, ATOL)
    Rm = markov.estimate_reward_matrix(stats, default_reward=6e-5)
    Rt = tmarkov.estimate_reward_matrix(tstats, default_reward=6e-5)
    np.testing.assert_allclose(Rt.numpy(), np.asarray(Rm), RTOL, ATOL)
    ut = utility.build_utility_table(Tm, Rm, window, bin_size, weight=1.5)
    tut = tutility.build_utility_table(T(np.asarray(Tm)), T(np.asarray(Rm)),
                                       window, bin_size, weight=1.5)
    for f in ("table", "completion", "remaining"):
        np.testing.assert_allclose(getattr(tut, f).numpy(),
                                   np.asarray(getattr(ut, f)), RTOL, ATOL,
                                   err_msg=f)
    st, bins = utility.stack_tables([ut, ut], max_states=m + 2)
    tst, tbins = tutility.stack_tables([tut, tut], max_states=m + 2)
    np.testing.assert_array_equal(tbins.numpy(), np.asarray(bins))
    np.testing.assert_allclose(tst.numpy(), np.asarray(st), RTOL, ATOL)


@pytest.mark.parametrize("n", [1, 5, 32, 33, 100, 1000, 3000, 4096, 4097,
                               40000])
def test_xla_sum_bitwise(n):
    """The reduction order of the reference's jitted sums on the CPU."""
    rng = np.random.default_rng(n)
    sum_ = jax.jit(lambda v: v.sum())
    for _ in range(3):
        v = (rng.standard_normal(n) * rng.choice([1e-3, 1.0, 1e3])).astype(
            np.float32)
        np.testing.assert_array_equal(tovl.xla_sum(T(v)).numpy(),
                                      np.asarray(sum_(v)))


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("S,n_valid", [(4096, 4096), (4096, 3000),
                                       (200, 150), (37, 37)])
def test_fit_latency_model_linear_bitwise(seed, S, n_valid):
    """On samples of a linear cost (the engine's simulated time), the fit
    is the reference's bit for bit: a, b and kind."""
    rng = np.random.default_rng(seed)
    n = rng.integers(0, 300, S).astype(np.float32)
    lat = (np.float32(3e-4) + np.float32(6e-5) * n).astype(np.float32)
    lat = lat * rng.uniform(0.999, 1.001, S).astype(np.float32)
    valid = np.arange(S) < n_valid
    ref = ovl.fit_latency_model(n, lat, valid)
    got = tovl.fit_latency_model(T(n), T(lat), T(valid))
    assert int(got.kind) == int(ref.kind) == tovl.LINEAR
    assert got.a.numpy().tobytes() == np.asarray(ref.a).tobytes()
    assert got.b.numpy().tobytes() == np.asarray(ref.b).tobytes()


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("shape", ["linear", "nlogn"])
def test_fit_latency_model(seed, shape):
    rng = np.random.default_rng(seed)
    S = 4096
    n = rng.integers(0, 800, S).astype(np.float32)
    base = n if shape == "linear" else n * np.log2(n + 1)
    lat = (3e-4 + 6e-5 * base * rng.uniform(0.98, 1.02, S)).astype(
        np.float32)
    valid = np.arange(S) < 3000
    ref = ovl.fit_latency_model(n, lat, valid)
    got = tovl.fit_latency_model(T(n), T(lat), T(valid))
    assert int(got.kind) == int(ref.kind)
    np.testing.assert_allclose(float(got.a), float(ref.a), rtol=RTOL)
    np.testing.assert_allclose(float(got.b), float(ref.b), rtol=RTOL,
                               atol=ATOL)
