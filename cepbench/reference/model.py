"""The plain reference of pSPICE's model builder (arXiv:2002.04436
§III-C to §III-E): a warm-up run without shedding that counts each PM's
state transitions and their processing time; per pattern the
transition matrix T and reward matrix R from those counts; the utility
table from T's powers (completion probability) and value iteration
(remaining processing time), both min-max scaled; the latency model
l_p = a·n_pm + b (or a·n·log2(n+1) + b, whichever fits with the lower
squared error) from the warm-up's samples; the operator's capacity
1 / f(mean PMs over the warm-up's second half).

It imports nothing of the program.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from cepbench.reference import engine as E
from cepbench.reference.arith import F32, Arith, xla_sum


@dataclasses.dataclass
class Built:
    T: list                    # per pattern (m, m) float32
    R: list
    tables: np.ndarray         # (P, B, M) float32, zero-padded
    bins: np.ndarray           # (P,) int32
    f: tuple                   # (a, b, kind)
    g: tuple
    steady_n_pm: float
    max_rate: float


def _matpow(T: np.ndarray, k: int, ar: Arith) -> np.ndarray:
    out = np.eye(T.shape[0], dtype=F32)
    base = T
    while k > 0:
        if k & 1:
            out = ar.r(out @ base)
        base = ar.r(base @ base)
        k >>= 1
    return out


def _minmax(x: np.ndarray, ar: Arith, lo: float = 1e-6,
            hi: float = 1.0) -> np.ndarray:
    span = ar.r(x.max() - x.min())
    scaled = ar.r((x - x.min()) / max(span, F32(1e-30))) if span > 0 \
        else np.ones_like(x)
    return ar.r(F32(lo) + ar.r(scaled * F32(hi - lo)))


def utility_table(T: np.ndarray, R: np.ndarray, window: int, bin_size: int,
                  weight: float, ar: Arith) -> np.ndarray:
    """UT[j, s] = w · P_s / tau_s with (j + 1)·bin_size events left."""
    m = T.shape[0]
    nb = max(1, -(-window // bin_size))
    step = _matpow(T, bin_size, ar)
    acc = np.eye(m, dtype=F32)
    P = np.zeros((nb, m), F32)
    for j in range(nb):
        acc = ar.r(acc @ step)
        P[j] = acc[:, -1]
    r = ar.r((T * R).sum(1))
    r[m - 1] = 0
    Tn = T.copy()
    Tn[m - 1] = 0
    tau = np.zeros(m, F32)
    taus = np.zeros((nb, m), F32)
    for j in range(nb):
        for _ in range(bin_size):
            tau = ar.r(r + ar.r(Tn @ tau))
        taus[j] = tau
    Ps, ts = _minmax(P, ar), _minmax(taus, ar)
    return ar.r(ar.r(F32(weight) * Ps) / np.maximum(ts, F32(1e-6)))


def _lstsq(x: np.ndarray, y: np.ndarray, valid: np.ndarray, ar: Arith):
    """y ≈ a·x + b over the valid samples by the closed form, each sum
    over the whole sample ring in ``xla_sum``'s order."""
    z = np.zeros_like(x)
    sw = max(xla_sum(valid.astype(F32), ar), F32(1e-30))
    mx = ar.r(xla_sum(np.where(valid, x, z), ar) / sw)
    my = ar.r(xla_sum(np.where(valid, y, z), ar) / sw)
    dx = ar.r(x - mx)
    cov = xla_sum(ar.r(np.where(valid, dx, z) * ar.r(y - my)), ar)
    var = max(xla_sum(np.where(valid, ar.r(dx * dx), z), ar), F32(1e-30))
    a = ar.r(cov / var)
    return a, ar.fma(-a, mx, my)


def fit_latency(n: np.ndarray, lat: np.ndarray, valid: np.ndarray,
                ar: Arith) -> tuple:
    """The lower-SSE fit of lat against n and against n·log2(n + 1)."""
    fits = []
    for kind in (E.LINEAR, E.NLOGN):
        x = n if kind == E.LINEAR else ar.r(n * ar.r(np.log2(ar.r(
            n + F32(1)))))
        a, b = _lstsq(x, lat, valid, ar)
        a = max(a, F32(1e-12))
        res = ar.r(ar.fma(a, x, b) - lat)
        sse = xla_sum(np.where(valid, ar.r(res * res), F32(0)), ar)
        fits.append((a, b, kind, sse))
    best = fits[0] if fits[0][3] <= fits[1][3] else fits[1]
    return F32(best[0]), F32(best[1]), best[2]


def build(prm: E.Params, pats: dict, warm: dict, bin_size: int,
          ar: Arith | None = None) -> Built:
    """The model from a warm-up stream ``warm`` (one lane's arrays,
    (n, ...)), run without shedding."""
    ar = ar or Arith()
    P, M = pats["trans"].shape[:2]
    wprm = dataclasses.replace(prm, shedder="none")
    st = E.State.fresh(1, P, M, wprm)
    ones = E.Model(ut_tables=np.ones((P, 1, M), F32),
                   ut_bins=np.ones(P, np.int32),
                   f=(F32(prm.c_match), F32(prm.c_base), E.LINEAR),
                   g=(F32(prm.c_shed_pm), F32(prm.c_shed_base), E.LINEAR))
    out = E.run(wprm, pats, ones, st, {k: v[None] for k, v in warm.items()},
                0, ar, gather=True)
    Ts, Rs, tables = [], [], []
    for p, s in enumerate(pats["specs"]):
        m = s["num_states"]
        c = st.obs_counts[0, p, :m, :m]
        rs = st.obs_rewards[0, p, :m, :m]
        row = c.sum(1, keepdims=True, dtype=F32)
        eye = np.eye(m, dtype=F32)
        T = np.where(row > 0, ar.r(c / np.maximum(row, F32(1e-30))), eye)
        T[m - 1] = eye[m - 1]
        R = np.where(c > 0, ar.r(rs / np.maximum(c, F32(1e-30))),
                     F32(prm.c_match * s["proc_cost"]))
        Ts.append(T.astype(F32))
        Rs.append(R.astype(F32))
        tables.append(utility_table(T.astype(F32), R.astype(F32),
                                    s["window_size"], bin_size, s["weight"],
                                    ar))
    nb = max(t.shape[0] for t in tables)
    stacked = np.zeros((P, nb, M), F32)
    for p, t in enumerate(tables):
        stacked[p, :t.shape[0], :t.shape[1]] = t
    S = st.lat_n.shape[1]
    valid = np.arange(S) < min(int(st.lat_ptr[0]), S)
    f = fit_latency(st.lat_n[0], st.lat_l[0], valid, ar)
    n_pm = out.n_pm[0]
    steady = float(n_pm[-max(1, n_pm.shape[0] // 2):].mean())
    t_proc = ar.r(ar.r(f[0] * (F32(steady) if f[2] == E.LINEAR else ar.r(
        F32(steady) * np.log2(F32(steady) + F32(1))))) + f[1])
    return Built(T=Ts, R=Rs, tables=stacked,
                 bins=np.full(P, bin_size, np.int32), f=f,
                 g=(F32(prm.c_shed_pm), F32(prm.c_shed_base), E.LINEAR),
                 steady_n_pm=steady,
                 max_rate=1.0 / max(float(t_proc), 1e-9))
