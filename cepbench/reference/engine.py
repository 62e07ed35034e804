"""The plain reference of the pSPICE operator (arXiv:2002.04436 §III):
one event at a time, in NumPy, over a batch of independent tenant lanes.

Per event and lane: expire PMs whose window closed; Algorithm 1 (l_e =
l_q + f(n_pm), shed when l_e + g(n_pm) exceeds the bound, ρ = n_pm -
f^-1(LB - l_q - g(n_pm))); Algorithm 2 (drop the ρ PMs of lowest
utility, chosen by the histogram-threshold select over 128 buckets and
three levels, the rest of the budget by slot order); the inter-arrival
average; advance every live PM (SEQ through its transition table, ANY by
distinct ids bound to the opener); completions; spawns; the simulated
processing time c_base + Σ_p c_match·proc_cost_p·n_p, which moves the
lane's clock.

The float arithmetic follows the operator's float32 rounding site by
site (``arith``): each result rounded to float32, the fused
multiply-adds where the operator contracts one, the cost sum in the
order its reduction uses.  Lanes never mix: every array has the lane on
its first axis and each lane's result equals its own run alone.

It imports nothing of the program.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from cepbench.reference.arith import F32, Arith
from cepbench.reference.patterns import SEQ

INACTIVE = F32(3.4e38)          # the utility of an empty slot
BIG = F32(3.4e38)
NBINS, LEVELS = 128, 3          # the threshold select's buckets, levels
LINEAR, NLOGN = 0, 1


@dataclasses.dataclass
class Params:
    """What the reference needs of a configuration: sizes, costs, bound."""
    num_pms: int               # N slots per pattern
    any_ids: int               # A distinct ids per PM
    ring: int                  # K open windows kept (the program's ring)
    latency_bound: float
    c_base: float
    c_match: float
    c_shed_base: float
    c_shed_pm: float
    shedder: str               # "none" | "pspice"
    safety_buffer: float = 0.0
    lat_capacity: int = 4096


@dataclasses.dataclass
class Model:
    """The learned inputs: utility tables and the two latency models."""
    ut_tables: np.ndarray      # (P, B, M) float32
    ut_bins: np.ndarray        # (P,) int
    f: tuple                   # (a, b, kind) of l_p = f(n_pm)
    g: tuple                   # (a, b, kind) of l_s = g(n_pm)


@dataclasses.dataclass
class State:
    """L lanes of operator state (the lane on axis 0)."""
    active: np.ndarray         # (L, P, N) bool
    state: np.ndarray          # (L, P, N) int32
    open_idx: np.ndarray       # (L, P, N) int32
    bind: np.ndarray           # (L, P, N) int32
    idset: np.ndarray          # (L, P, N, A) int32
    ring: np.ndarray           # (L, P, K) int64
    ring_ptr: np.ndarray       # (L, P) int64
    sim_time: np.ndarray       # (L,) float32
    ema_gap: np.ndarray
    prev_arrival: np.ndarray
    pms_shed: np.ndarray
    shed_calls: np.ndarray
    overflow: np.ndarray
    complex_count: np.ndarray  # (L, P) float32
    pms_created: np.ndarray
    lat_n: np.ndarray          # (L, S) float32
    lat_l: np.ndarray
    lat_ptr: np.ndarray        # (L,) int64
    obs_counts: np.ndarray | None = None   # (L, P, M, M) when gathering
    obs_rewards: np.ndarray | None = None

    @staticmethod
    def fresh(L: int, P: int, M: int, prm: Params) -> "State":
        N, A, K, S = prm.num_pms, prm.any_ids, prm.ring, prm.lat_capacity
        z = lambda *s: np.zeros(s, F32)  # noqa: E731
        return State(
            active=np.zeros((L, P, N), bool),
            state=np.zeros((L, P, N), np.int32),
            open_idx=np.zeros((L, P, N), np.int32),
            bind=np.full((L, P, N), -1, np.int32),
            idset=np.full((L, P, N, A), -1, np.int32),
            ring=np.full((L, P, K), -1, np.int64),
            ring_ptr=np.zeros((L, P), np.int64),
            sim_time=z(L), ema_gap=np.full(L, F32(1e-3), F32),
            prev_arrival=z(L), pms_shed=z(L), shed_calls=z(L),
            overflow=z(L), complex_count=z(L, P), pms_created=z(L, P),
            lat_n=z(L, S), lat_l=z(L, S), lat_ptr=np.zeros(L, np.int64),
            obs_counts=z(L, P, M, M), obs_rewards=z(L, P, M, M))


@dataclasses.dataclass
class Outputs:
    """Per-event rows of every lane: (L, n)."""
    l_e: np.ndarray
    n_pm: np.ndarray
    shed: np.ndarray


def _predict(m: tuple, n: np.ndarray, ar: Arith) -> np.ndarray:
    a, b, kind = m
    basis = n if kind == LINEAR else ar.r(n * ar.r(np.log2(ar.r(n + F32(1)))))
    return ar.fma(a, basis, b)


def _invert(m: tuple, l_target: np.ndarray, ar: Arith) -> np.ndarray:
    a, b, kind = m
    t = np.maximum(ar.r(ar.r(l_target - F32(b)) / F32(a)), F32(0))
    if kind == LINEAR:
        return t
    one, ln2 = F32(1.0), F32(np.log(2.0))
    n = np.maximum(t, one)
    for _ in range(16):
        lg = ar.r(np.log2(ar.r(n + one)))
        fn = ar.r(ar.r(n * lg) - t)
        dfn = ar.r(lg + ar.r(n / ar.r(ar.r(n + one) * ln2)))
        n = np.clip(ar.r(n - ar.r(fn / np.maximum(dfn, F32(1e-9)))),
                    F32(0), F32(1e12))
    return n


def _to_int32(x: np.ndarray) -> np.ndarray:
    """float → int32 saturating, NaN → 0."""
    x = np.asarray(x, np.float64)
    out = np.clip(np.where(np.isnan(x), 0.0, x), -2.0 ** 31, 2.0 ** 31 - 1)
    return out.astype(np.int64)


def detect_overload(prm: Params, model: Model, l_q: np.ndarray,
                    n_pm: np.ndarray, ar: Arith):
    """Algorithm 1 per lane → (shed (L,) bool, rho (L,) int)."""
    n_f = n_pm.astype(F32)
    lb, sb = F32(prm.latency_bound), F32(prm.safety_buffer)
    l_p = _predict(model.f, n_f, ar)
    l_s = _predict(model.g, n_f, ar)
    l_e = ar.r(l_q + l_p)
    shed = ar.r(ar.r(l_e + l_s) + sb) > lb
    l_p_new = np.maximum(ar.r(ar.r(ar.r(lb - l_q) - l_s) - sb), F32(0))
    n_keep = _to_int32(np.floor(ar.r(_invert(model.f, l_p_new, ar) +
                                     F32(1e-4))))
    rho = np.where(shed, np.maximum(n_pm - n_keep, 0), 0)
    return shed, rho


def utilities(model: Model, state: np.ndarray, r_w: np.ndarray,
              active: np.ndarray, ar: Arith) -> np.ndarray:
    """Utility of each PM (F, P, N): the table of its pattern, linearly
    interpolated between the bins around its remaining window."""
    tab = model.ut_tables
    P, B, M = tab.shape
    bs = model.ut_bins.astype(F32)[None, :, None]
    pos = np.clip(ar.r(ar.r(r_w.astype(F32) / bs) - F32(1)), F32(0),
                  F32(B - 1))
    j0 = np.floor(pos).astype(np.int64)
    j1 = np.minimum(j0 + 1, B - 1)
    frac = ar.r(pos - j0.astype(F32))
    ok = (state >= 0) & (state < M)
    st = np.clip(state, 0, M - 1)
    p = np.arange(P)[None, :, None]
    u0 = np.where(ok, tab[p, j0, st], F32(0))
    u1 = np.where(ok, tab[p, j1, st], F32(0))
    u = ar.fma(u0, ar.r(F32(1) - frac), ar.r(u1 * frac))
    return np.where(active, u, INACTIVE).astype(F32)


def bucket_edges(lo: np.ndarray, hi: np.ndarray, ar: Arith) -> np.ndarray:
    """(F, NBINS + 1) edges lo + (hi - lo)·k / NBINS; the top one +inf."""
    k = np.arange(NBINS + 1, dtype=F32)
    e = ar.r(lo[:, None] + ar.r(ar.r(ar.r(hi - lo)[:, None] * k) /
                                F32(NBINS)))
    e[:, -1] = np.inf
    return e


def _bucket(u: np.ndarray, rows: np.ndarray, edges: np.ndarray) -> np.ndarray:
    """Per value ``u`` of row ``rows``: the last bucket whose lower edge
    is at most the value, clamped to [0, NBINS - 1].  A guess from the
    bucket width, then walked to the edges themselves."""
    e0 = edges[rows, 0].astype(np.float64)
    span = edges[rows, NBINS - 1].astype(np.float64) - e0
    with np.errstate(divide="ignore", invalid="ignore"):
        g = np.floor((u - e0) / span * (NBINS - 1))
    g = np.clip(np.nan_to_num(g), 0, NBINS - 1).astype(np.int64)
    while True:
        up = (g < NBINS - 1) & (edges[rows, np.minimum(g + 1, NBINS)] <= u)
        down = (g > 0) & (edges[rows, g] > u)
        if not (up.any() or down.any()):
            return g
        g = g + up - down


def threshold_drop(active: np.ndarray, u: np.ndarray, rho: np.ndarray,
                   ar: Arith) -> np.ndarray:
    """Algorithm 2 without a sort, per row (F, n): each level buckets the
    remaining candidates over [lo, hi), finds the bucket of the ρ-th
    lowest utility, drops everything below it and narrows to it; the
    rest of the budget goes by slot order.  Exactly min(ρ, n_active)
    are dropped.  Returns the new active mask."""
    F, n = u.shape
    rows = np.arange(F)
    need = np.minimum(rho, active.sum(1))
    lo = np.where(active, u, BIG).min(1).astype(F32)
    hi0 = np.where(active, u, -BIG).max(1).astype(F32)
    hi = np.where(hi0 > lo, hi0, ar.r(lo + F32(1))).astype(F32)
    mask = active.copy()
    drop = np.zeros_like(active)
    for _ in range(LEVELS):
        edges = bucket_edges(lo, hi, ar)
        rr, cc = np.nonzero(mask)
        b = _bucket(u[rr, cc], rr, edges)
        hist = np.bincount(rr * NBINS + b, minlength=F * NBINS).reshape(
            F, NBINS)
        cum = np.cumsum(hist, 1)
        kb = np.clip((cum < need[:, None]).sum(1), 0, NBINS - 1)
        edge, upper = edges[rows, kb], edges[rows, kb + 1]
        below = mask & (u < edge[:, None])
        drop |= below
        need = np.maximum(need - below.sum(1), 0)
        mask = mask & ~below & (u < upper[:, None])
        lo = edge.astype(F32)
        hi_next = np.where(kb == NBINS - 1, hi, upper).astype(F32)
        hi = np.where(hi_next > lo, hi_next, ar.r(lo + F32(1))).astype(F32)
    rank = np.cumsum(mask, 1) - 1
    drop |= mask & (rank < need[:, None])
    return active & ~drop


def cost_sum(cp: np.ndarray, n: np.ndarray, c_base, ar: Arith) -> np.ndarray:
    """c_base + Σ_p cp_p·n_p per lane (n (L, P)), in the operator's order:
    one fused multiply-add for P = 1; for P = 4 or a multiple of 8, lanes
    of fused chains over p ≡ lane (width min(P, 8)) and a halving tree;
    otherwise a fused chain over p; the base added last."""
    L, P = n.shape
    nf = n.astype(F32)
    base = F32(c_base)
    if P == 1:
        return ar.fma(cp[0], nf[:, 0], base)
    if P == 4 or P % 8 == 0:
        vf = min(P, 8)
        parts = [ar.r(cp[k] * nf[:, k]) for k in range(vf)]
        for p in range(vf, P):
            parts[p % vf] = ar.fma(cp[p], nf[:, p], parts[p % vf])
        while len(parts) > 1:
            h = len(parts) // 2
            parts = [ar.r(parts[k] + parts[k + h]) for k in range(h)]
        return ar.r(parts[0] + base)
    acc = ar.r(cp[0] * nf[:, 0])
    for p in range(1, P):
        acc = ar.fma(cp[p], nf[:, p], acc)
    return ar.r(acc + base)


def run(prm: Params, pats: dict, model: Model, st: State, ev: dict,
        start: int, ar: Arith | None = None,
        gather: bool = False) -> Outputs:
    """Events ``start, start + 1, ...`` of ``ev`` (arrays (L, n, ...):
    ``cls``, ``bind``, ``open`` per pattern; ``id``, ``arrival``) through
    every lane; ``st`` is advanced in place."""
    ar = ar or Arith()
    if prm.shedder not in ("none", "pspice"):
        raise ValueError(f"the reference runs shedders none and pspice: "
                         f"{prm.shedder!r}")
    L, n, P = ev["cls"].shape
    N, A = prm.num_pms, prm.any_ids
    M = pats["trans"].shape[1]
    S = st.lat_n.shape[1]
    trans = pats["trans"]
    ws = pats["window_size"][None, :, None].astype(np.int32)
    final = pats["final_state"][None, :, None].astype(np.int32)
    is_seq = (pats["kind"] == SEQ)[None, :, None]
    uses = pats["uses_binding"][None, :, None]
    cp = ar.r(F32(prm.c_match) * pats["proc_cost"].astype(F32))
    pspice = prm.shedder == "pspice"
    lanes = np.arange(L)
    pidx = np.arange(P)[None, :, None]
    has_seq = bool((pats["kind"] == SEQ).any())
    has_any = not bool((pats["kind"] == SEQ).all())
    out = Outputs(l_e=np.zeros((L, n), F32), n_pm=np.zeros((L, n), F32),
                  shed=np.zeros((L, n), bool))
    n_act = np.count_nonzero(st.active, axis=2)
    next_exp = _next_expiry(st, ws)
    # Distinct ids under 31 are kept as a bit mask too: membership is
    # then one shift per PM.
    idmask = None
    if has_any and st.idset.max(initial=-1) < 31:
        idmask = np.zeros(st.active.shape, np.int32)
        ll, pp, nn, aa = np.nonzero(st.idset >= 0)
        np.bitwise_or.at(idmask, (ll, pp, nn),
                         np.left_shift(1, st.idset[ll, pp, nn, aa]).astype(
                             np.int32))
    for j in range(n):
        i = start + j
        arr = ev["arrival"][:, j].astype(F32)
        ec, eb = ev["cls"][:, j], ev["bind"][:, j]
        eo, eid = ev["open"][:, j], ev["id"][:, j]
        # -- expiry and Algorithm 1 ---------------------------------------
        # No PM expires before the earliest open_idx + window.
        if i >= next_exp:
            expired = st.active & ((i - st.open_idx) >= ws)
            n_act = n_act - np.count_nonzero(expired, axis=2)
            st.active &= ~expired
            next_exp = _next_expiry(st, ws)
        sim = np.maximum(st.sim_time, arr)
        l_q = ar.r(sim - arr)
        n_pm = n_act.sum(1)
        n_pm_f = n_pm.astype(F32)
        fire = np.zeros(L, bool)
        if pspice:
            shed, rho = detect_overload(prm, model, l_q, n_pm, ar)
            fire = shed & (rho > 0)
        st.sim_time = sim
        # -- Algorithm 2 in the lanes that fire ----------------------------
        if fire.any():
            f = np.nonzero(fire)[0]
            r_w = (ws - (i - st.open_idx[f])).astype(np.int64)
            u = utilities(model, st.state[f], r_w, st.active[f], ar)
            keep = threshold_drop(st.active[f].reshape(len(f), -1),
                                  u.reshape(len(f), -1), rho[f], ar)
            st.active[f] = keep.reshape(len(f), P, N)
            n_act[f] = np.count_nonzero(st.active[f], axis=2)
            st.pms_shed[f] = ar.r(st.pms_shed[f] + (
                n_pm[f] - n_act[f].sum(1)).astype(F32))
            st.shed_calls[f] = ar.r(st.shed_calls[f] + F32(1))
            st.sim_time[f] = ar.r(st.sim_time[f] + ar.fma(
                prm.c_shed_pm, n_pm_f[f], prm.c_shed_base))
        # -- the inter-arrival average -------------------------------------
        gap = np.maximum(ar.r(arr - st.prev_arrival), F32(1e-9))
        st.ema_gap = ar.fma(F32(0.99), st.ema_gap, ar.r(F32(0.01) * gap))
        st.prev_arrival = arr
        n_proc = n_act.copy()
        # -- advance and completions (an event of class 0 for every
        # pattern advances nothing) ---------------------------------------
        act = st.active
        if ec.any():
            bind_ok = ~uses | (st.bind == eb[:, :, None])
            cls3 = ec[:, :, None]
            nxt = st.state
            if has_seq:
                nxt = np.where(bind_ok, trans[pidx, st.state, cls3], nxt)
            if has_any:
                if idmask is not None:
                    in_set = ((idmask >> np.clip(eid, 0, 30)[:, None, None])
                              & 1).astype(bool)
                    odd = (eid < 0) | (eid > 30)
                    if odd.any():
                        in_set[odd] = (st.idset[odd] ==
                                       eid[odd, None, None, None]).any(-1)
                else:
                    in_set = (st.idset == eid[:, None, None, None]).any(-1)
                any_match = bind_ok & (cls3 == 1) & ~in_set & \
                    (st.state < final)
                ins = ~is_seq & act & any_match
                if ins.any():
                    ll, pp, nn = np.nonzero(ins)
                    slot = np.clip(st.state[ll, pp, nn] - 1, 0, A - 1)
                    st.idset[ll, pp, nn, slot] = eid[ll]
                    if idmask is not None:
                        idmask = _set_ids(idmask, st, ll, pp, nn)
                any_next = st.state + any_match.astype(np.int32)
                nxt = any_next if not has_seq else np.where(is_seq, nxt,
                                                            any_next)
            new_state = np.where(act, nxt, st.state)
            completed = act & (nxt == final) & (st.state != final)
        else:
            new_state = st.state
            completed = np.zeros_like(act)
        ncomp = np.count_nonzero(completed, axis=2)
        st.complex_count = ar.r(st.complex_count + ncomp.astype(F32))
        if gather:
            ll, pp, nn = np.nonzero(act)
            cell = ((pp * M + st.state[ll, pp, nn]) * M +
                    new_state[ll, pp, nn])
            flat = ll * (P * M * M) + cell
            oc = st.obs_counts.reshape(-1)
            np.add.at(oc, flat, F32(1))
            orw = st.obs_rewards.reshape(-1)
            np.add.at(orw, flat, cp[pp])
            st.obs_counts = ar.r(oc).reshape(st.obs_counts.shape)
            st.obs_rewards = ar.r(orw).reshape(st.obs_rewards.shape)
        st.active = act & ~completed
        st.state = new_state
        n_act = n_act - ncomp
        # -- spawns: an opening event spawns a PM in the first free slot -
        if eo.any():
            can = eo & (N - n_act > 0)
            st.overflow = ar.r(st.overflow + (eo & ~can).sum(1).astype(F32))
            ll, pp = np.nonzero(can)
            nn = np.argmax(~st.active[ll, pp], axis=1)
            st.active[ll, pp, nn] = True
            st.state[ll, pp, nn] = 1
            st.open_idx[ll, pp, nn] = i
            st.bind[ll, pp, nn] = eb[ll, pp]
            st.idset[ll, pp, nn, :] = -1
            if idmask is not None:
                idmask[ll, pp, nn] = 0
            st.pms_created = ar.r(st.pms_created + can.astype(F32))
            n_act = n_act + can
            if len(ll):
                next_exp = min(next_exp,
                               i + int(pats["window_size"][pp].min()))
        # -- simulated processing time, latency ring, the row --------------
        t_proc = cost_sum(cp, n_proc, prm.c_base, ar)
        st.sim_time = ar.r(st.sim_time + t_proc)
        ptr = st.lat_ptr % S
        st.lat_n[lanes, ptr] = n_pm_f
        st.lat_l[lanes, ptr] = t_proc
        st.lat_ptr = st.lat_ptr + 1
        out.l_e[:, j] = ar.r(st.sim_time - arr)
        out.n_pm[:, j] = n_act.sum(1)
        out.shed[:, j] = fire
    return out


def _next_expiry(st: State, ws: np.ndarray) -> int:
    """The first event index at which an active PM's window closes."""
    if not st.active.any():
        return 1 << 62
    return int((st.open_idx + ws)[st.active].min())


def _set_ids(idmask: np.ndarray, st: State, ll, pp, nn) -> np.ndarray:
    """``idmask`` with the ids of PMs (ll, pp, nn) set from their idset,
    or None where an id leaves the mask's range (0..30)."""
    ids = st.idset[ll, pp, nn]
    if (ids >= 31).any():
        return None
    bits = np.where(ids >= 0, np.left_shift(1, np.maximum(ids, 0)),
                    0).astype(np.int32)
    idmask[ll, pp, nn] |= np.bitwise_or.reduce(bits, axis=-1)
    return idmask

