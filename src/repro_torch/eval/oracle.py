"""Differential-testing oracle: a slow, obvious, trusted CEP engine.

Port of ``repro.eval.oracle``: the same structure and names, reading the
port's ``EngineConfig`` / ``EngineModel`` / ``EventBatch`` (tensors come
to NumPy through ``.cpu().numpy()``).  It is host code by nature.

A pure-NumPy/Python *event-at-a-time* implementation of the paper's
operator semantics (§III) — PMs live in a slot-addressed store, every
event is processed by plain Python loops, and the load shedder is the
LITERAL sort-based Algorithm 2 (stable sort by utility ascending, drop
the first ρ).  Nothing here shares code with the vectorized engine in
``repro_torch.cep.engine``: no tensor code, no masked scatters, no
histogram select — which is the point.  ``tests/test_torch_oracle.py``
asserts that the port's engines produce EXACTLY this oracle's match set
and that this oracle equals the reference's bit for bit, so every
hot-path refactor is cross-checked against an independent
implementation (DESIGN.md §9).

Scope and fidelity:

  * Matching semantics (expire / advance / complete / spawn, capacity,
    distinctness, binding, ring bookkeeping) are replicated exactly —
    they are integer-valued, so "exact" is well-defined on any platform.
  * The simulated-time / overload-detector arithmetic is replicated in
    float32 with the engine's operation order (NumPy float32 scalars
    throughout: a Python float would round differently), so shed
    decisions agree with the engine for the seeded test configurations.
    Keep latency models LINEAR for bitwise agreement (``log2`` may
    differ by an ulp between libms).
  * The engine's PM-BL shedder draws its random ρ-subset from threefry
    (``repro_torch.prng``, bitwise ``jax.random``); for PM-BL only the
    oracle draws its scores through the same ``prng`` calls
    (``PRNGKey``, ``split``, ``uniform``), so they follow
    ``prng.PARTITIONABLE``.  The shedding *logic* stays independent;
    only the raw uniforms are shared.
  * Observation gathering (``gather_stats``) and the latency-sample ring
    are not replicated: they feed model building, not matching, and are
    covered by the engine's own unit tests.

The oracle intentionally has no knobs the engine lacks: it consumes the
same ``EngineConfig`` / ``EngineModel`` / ``EventBatch``.  The engine's
``shed_plan="threshold"`` is an O(N) *approximation* of Algorithm 2 (it
may pick a different equal-size low-utility subset); differential tests
that shed therefore pin ``shed_plan="sort"`` to compare against the
literal algorithm implemented here.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch import prng
from repro_torch.cep import engine as eng
from repro_torch.cep import patterns as pat
from repro_torch.core import overload as ovl

f32 = np.float32


@dataclasses.dataclass
class OraclePM:
    """One partial match: plain Python state, one object per live PM."""
    state: int
    open_idx: int
    bind: int
    idset: list        # length max_any_ids, -1 = empty slot


@dataclasses.dataclass
class OracleResult:
    """What the oracle tracks — the comparable surface of a run."""
    matches: list              # per pattern: set of (open_idx, bind, end_idx)
    complex_count: np.ndarray  # (P,) completions
    pms_created: np.ndarray    # (P,) spawns that got a slot
    pms_shed: float
    shed_calls: float
    overflow: float
    ebl_dropped: float
    l_e: np.ndarray            # (n,) realized event latency (f32 replica)
    n_pm: np.ndarray           # (n,) active PMs after each step
    shed: np.ndarray           # (n,) bool — shed triggered at this event
    dropped: np.ndarray        # (n,) bool — E-BL input drop


def _predict(a: f32, b: f32, kind: int, n: f32) -> f32:
    """f32 replica of ``overload.predict_latency``."""
    basis = n if kind == ovl.LINEAR else f32(n * np.log2(f32(n + f32(1.0))))
    return f32(f32(a * basis) + b)


def _invert(a: f32, b: f32, kind: int, l_target: f32) -> f32:
    """f32 replica of ``overload.invert_latency`` (16 Newton steps)."""
    t = f32(max(f32(f32(l_target - b) / a), f32(0.0)))
    if kind == ovl.LINEAR:
        return t
    n = f32(max(t, f32(1.0)))
    for _ in range(16):
        fn = f32(f32(n * np.log2(f32(n + f32(1.0)))) - t)
        dfn = f32(np.log2(f32(n + f32(1.0)))
                  + f32(n / f32(f32(n + f32(1.0)) * f32(np.log(2.0)))))
        n = f32(min(max(f32(n - f32(fn / max(dfn, f32(1e-9)))),
                        f32(0.0)), f32(1e12)))
    return n


def _detect_overload(model, l_q: f32, n_pm: int, latency_bound: float,
                     safety_buffer: float) -> tuple[bool, int, f32]:
    """Algorithm 1 (paper §III-E), f32 replica of ``detect_overload``."""
    fa, fb, fk = model["f_a"], model["f_b"], model["f_kind"]
    ga, gb, gk = model["g_a"], model["g_b"], model["g_kind"]
    n_f = f32(n_pm)
    l_p = _predict(fa, fb, fk, n_f)
    l_s = _predict(ga, gb, gk, n_f)
    l_e = f32(l_q + l_p)
    shed = bool(f32(f32(l_e + l_s) + f32(safety_buffer)) > f32(latency_bound))
    l_p_new = f32(max(f32(f32(f32(f32(latency_bound) - l_q) - l_s)
                          - f32(safety_buffer)), f32(0.0)))
    n_keep = int(np.floor(f32(_invert(fa, fb, fk, l_p_new) + f32(1e-4))))
    rho = max(n_pm - n_keep, 0) if shed else 0
    return shed, rho, l_e


def _utility(model, p: int, state: int, r_w: int) -> f32:
    """f32 replica of ``utility.multi_pattern_lookup`` for one PM."""
    tab = model["ut_tables"]                    # (P, B, M) f32
    B = tab.shape[1]
    bs = f32(model["ut_bins"][p])
    pos = f32(min(max(f32(f32(f32(r_w) / bs) - f32(1.0)), f32(0.0)),
                  f32(B - 1.0)))
    j0 = int(np.floor(pos))
    j1 = min(j0 + 1, B - 1)
    frac = f32(pos - f32(j0))
    u0, u1 = tab[p, j0, state], tab[p, j1, state]
    return f32(f32(u0 * f32(f32(1.0) - frac)) + f32(u1 * frac))


def _shed_literal_alg2(cfg, model, store, i: int, rho: int,
                       scores: np.ndarray | None) -> int:
    """The paper's Algorithm 2, literally: collect every active PM across
    all patterns, sort ascending by utility (stable — ties keep slot
    order), drop the first ρ.  ``scores`` (PM-BL) replaces utilities with
    the uniform draws; inactive slots are +inf and never chosen."""
    N = cfg.max_pms
    flat_u = np.full(cfg.num_patterns * N, np.inf, f32)
    for p, slots in enumerate(store):
        ws = int(model["window_size"][p])
        for s, pm in enumerate(slots):
            if pm is None:
                continue
            if scores is not None:                    # PM-BL uniform scores
                flat_u[p * N + s] = scores[p * N + s]
            else:
                r_w = ws - (i - pm.open_idx)
                flat_u[p * N + s] = _utility(model, p, pm.state, r_w)
    order = np.argsort(flat_u, kind="stable")
    dropped = 0
    for flat in order[:rho]:
        p, s = divmod(int(flat), N)
        if store[p][s] is not None:
            store[p][s] = None
            dropped += 1
    return dropped


def _np(x) -> np.ndarray:
    """A tensor (on any device) as a NumPy array."""
    return x.detach().cpu().numpy()


def _model_np(model: eng.EngineModel) -> dict:
    g = _np
    return dict(
        trans=g(model.trans), kind=g(model.kind),
        spawn_mode=g(model.spawn_mode), window_size=g(model.window_size),
        slide=g(model.slide), final_state=g(model.final_state),
        proc_cost=g(model.proc_cost).astype(f32),
        uses_binding=g(model.uses_binding),
        spawn_counts=g(model.spawn_counts),
        ut_tables=g(model.ut_tables).astype(f32),
        ut_bins=g(model.ut_bins),
        f_a=f32(g(model.f_model.a)), f_b=f32(g(model.f_model.b)),
        f_kind=int(g(model.f_model.kind)),
        g_a=f32(g(model.g_model.a)), g_b=f32(g(model.g_model.b)),
        g_kind=int(g(model.g_model.kind)),
        ebl_raw_mean=f32(g(model.ebl_raw_mean)),
    )


def run_oracle(cfg: eng.EngineConfig, model: eng.EngineModel,
               events: eng.EventBatch, seed: int = 0,
               start: int = 0) -> OracleResult:
    """Run the reference engine over a whole stream.

    ``seed`` must match the ``init_carry`` seed of the engine run being
    diffed (it only matters for PM-BL's shared random stream, drawn in
    the layout ``prng.PARTITIONABLE`` names at call time); ``start``
    is the global index of the first event (0 for ``run_engine``).
    """
    m = _model_np(model)
    P, N, A, K = (cfg.num_patterns, cfg.max_pms, cfg.max_any_ids,
                  cfg.ring_size)
    ev_class = _np(events.ev_class)
    ev_bind = _np(events.ev_bind)
    ev_open = _np(events.ev_open)
    ev_id = _np(events.ev_id)
    ev_rand = _np(events.ev_rand).astype(f32)
    ebl_raw = _np(events.ebl_raw).astype(f32)
    arrival = _np(events.arrival).astype(f32)
    n = ev_class.shape[0]

    store: list[list[OraclePM | None]] = [[None] * N for _ in range(P)]
    ring = [[-1] * K for _ in range(P)]
    ring_ptr = [0] * P

    # PM-BL shares the engine's threefry stream (see module docstring).
    key = None
    if cfg.shedder == eng.SHED_PMBL:
        key = prng.PRNGKey(seed)

    sim_time = f32(0.0)
    ebl_frac = f32(0.0)
    ema_gap = f32(1e-3)
    prev_arrival = f32(0.0)
    matches: list[set] = [set() for _ in range(P)]
    complex_count = np.zeros(P, np.int64)
    pms_created = np.zeros(P, np.int64)
    pms_shed = 0
    shed_calls = 0
    overflow = 0
    ebl_dropped = 0
    l_e_out = np.zeros(n, f32)
    n_pm_out = np.zeros(n, np.int64)
    shed_out = np.zeros(n, bool)
    drop_out = np.zeros(n, bool)

    at_open = m["spawn_mode"] == pat.SPAWN_AT_OPEN
    is_seq = m["kind"] == pat.KIND_SEQ

    for e in range(n):
        i = start + e

        # -- 1. expire closed windows + ring bookkeeping --------------------
        for p in range(P):
            ws = int(m["window_size"][p])
            for s in range(N):
                pm = store[p][s]
                if pm is not None and (i - pm.open_idx) >= ws:
                    store[p][s] = None
            if not at_open[p] and ev_open[e, p]:
                ring[p][ring_ptr[p]] = i
                ring_ptr[p] = (ring_ptr[p] + 1) % K

        # -- 2. queueing latency & overload check (Alg. 1) -------------------
        sim_time = f32(max(sim_time, arrival[e]))
        l_q = f32(sim_time - arrival[e])
        n_pm = sum(1 for slots in store for pm in slots if pm is not None)

        did_shed = False
        if cfg.shedder in (eng.SHED_PSPICE, eng.SHED_PMBL):
            shed, rho, _ = _detect_overload(m, l_q, n_pm, cfg.latency_bound,
                                            cfg.safety_buffer)
            if shed and rho > 0:
                scores = None
                if cfg.shedder == eng.SHED_PMBL:
                    key, sub = prng.split(key)
                    scores = _np(prng.uniform(sub, (P * N,))).astype(f32)
                d = _shed_literal_alg2(cfg, m, store, i, rho, scores)
                pms_shed += d
                shed_calls += 1
                sim_time = f32(sim_time + f32(f32(cfg.c_shed_base)
                                              + f32(f32(cfg.c_shed_pm)
                                                    * f32(n_pm))))
                did_shed = True

        # -- 3. E-BL input drop ---------------------------------------------
        ev_dropped = False
        gap = f32(max(f32(arrival[e] - prev_arrival), f32(1e-9)))
        ema_gap = f32(f32(f32(0.99) * ema_gap) + f32(f32(0.01) * gap))
        prev_arrival = arrival[e]
        if cfg.shedder == eng.SHED_EBL:
            shed, _, _ = _detect_overload(m, l_q, n_pm, cfg.latency_bound,
                                          cfg.safety_buffer)
            l_p_est = _predict(m["f_a"], m["f_b"], m["f_kind"], f32(n_pm))
            d_ff = f32(f32(l_p_est - ema_gap)
                       / max(f32(l_p_est - f32(cfg.c_ebl)), f32(1e-9)))
            d_bk = f32(f32(f32(cfg.ebl_backlog_gain) * l_q)
                       / f32(cfg.latency_bound))
            d_need = f32(min(max(f32(d_ff + d_bk), f32(0.0)), f32(1.0)))
            decayed = f32(ebl_frac * f32(cfg.ebl_decay))
            ebl_frac = f32(max(decayed, d_need)) if shed else decayed
            fl = f32(cfg.ebl_floor)
            one_m = f32(1.0 - cfg.ebl_floor)
            raw_eff = f32(fl + f32(one_m * ebl_raw[e]))
            mean_eff = f32(fl + f32(one_m * m["ebl_raw_mean"]))
            p_drop = f32(min(max(f32(f32(raw_eff * ebl_frac)
                                     / max(mean_eff, f32(1e-9))),
                                 f32(0.0)), f32(1.0)))
            ev_dropped = bool(ev_rand[e] < p_drop)
            if ev_dropped:
                ebl_dropped += 1
            did_shed = shed

        # per-pattern matched-against counts BEFORE advance (sim-time model)
        n_active_p = [sum(1 for pm in store[p] if pm is not None)
                      for p in range(P)]

        # -- 4. advance + completions ---------------------------------------
        for p in range(P):
            cls = 0 if ev_dropped else int(ev_class[e, p])
            b = int(ev_bind[e, p])
            eid = int(ev_id[e])
            final = int(m["final_state"][p])
            for s in range(N):
                pm = store[p][s]
                if pm is None:
                    continue
                bind_ok = (pm.bind == b) if m["uses_binding"][p] else True
                c_eff = cls if bind_ok else 0
                if is_seq[p]:
                    new_state = int(m["trans"][p, pm.state, c_eff])
                else:
                    in_set = eid in pm.idset
                    advances = (c_eff == 1 and not in_set
                                and pm.state < final)
                    new_state = pm.state + (1 if advances else 0)
                    if advances:
                        sc = 1 if m["spawn_counts"][p] else 0
                        slot = min(max(pm.state - 1 + sc, 0), A - 1)
                        pm.idset[slot] = eid
                if new_state == final and pm.state != final:
                    matches[p].add((pm.open_idx, pm.bind, i))
                    complex_count[p] += 1
                    store[p][s] = None
                else:
                    pm.state = new_state

        # -- 5. spawn --------------------------------------------------------
        for p in range(P):
            cls = 0 if ev_dropped else int(ev_class[e, p])
            opened = False if ev_dropped else bool(ev_open[e, p])
            b = int(ev_bind[e, p])
            eid = int(ev_id[e])
            ws = int(m["window_size"][p])
            # Candidates in ring-slot order (the AT_OPEN candidate is k=0).
            cand_opens: list[int] = []
            if at_open[p]:
                if opened:
                    cand_opens.append(i)
            elif cls == 1:
                for k in range(K):
                    r = ring[p][k]
                    if r < 0 or (i - r) >= ws:
                        continue
                    exists = any(pm is not None and pm.open_idx == r
                                 and pm.bind == b for pm in store[p])
                    if not exists:
                        cand_opens.append(r)
            free = [s for s in range(N) if store[p][s] is None]
            for rank, open_idx in enumerate(cand_opens):
                if rank >= len(free):
                    overflow += 1
                    continue
                idset = [-1] * A
                if m["spawn_counts"][p]:
                    idset[0] = eid
                store[p][free[rank]] = OraclePM(
                    state=1, open_idx=open_idx, bind=b, idset=idset)
                pms_created[p] += 1

        # -- 7. simulated processing time & latency --------------------------
        if ev_dropped:
            t_proc = f32(cfg.c_ebl)
        else:
            acc = f32(0.0)
            for p in range(P):
                acc = f32(acc + f32(f32(f32(cfg.c_match)
                                        * m["proc_cost"][p])
                                    * f32(n_active_p[p])))
            t_proc = f32(f32(cfg.c_base) + acc)
        sim_time = f32(sim_time + t_proc)
        l_e_out[e] = f32(sim_time - arrival[e])
        n_pm_out[e] = sum(1 for slots in store
                          for pm in slots if pm is not None)
        shed_out[e] = did_shed
        drop_out[e] = ev_dropped

    return OracleResult(
        matches=matches,
        complex_count=complex_count, pms_created=pms_created,
        pms_shed=float(pms_shed), shed_calls=float(shed_calls),
        overflow=float(overflow), ebl_dropped=float(ebl_dropped),
        l_e=l_e_out, n_pm=n_pm_out, shed=shed_out, dropped=drop_out)
