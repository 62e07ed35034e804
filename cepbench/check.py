"""How ``correct`` is decided: the program's outputs of the window against
the plain reference (``cepbench.reference``), which imports nothing of
the program.

Three comparisons, in worker processes once the window has closed:

* ``model``: the pSPICE model the program built at set-up against the
  reference's own build from the same warm-up events: the transition and
  reward matrices, both latency fits, the bin sizes, the steady PM count
  and capacity exactly, the utility tables to ``ut_table_gap`` (their
  matrix powers and value iteration sum in another order on the card);
* ``lanes``: sampled lanes (drawn from the seed) of the checked session
  replayed by the reference from the session's start to the start of
  the checked push, against the program's state of those lanes there
  (every carry leaf but the PRNG key, which only PM-BL reads), exactly;
* ``push``: the checked push (drawn from the seed) over every lane,
  replayed from the program's state at its start (the lanes in shares,
  one worker each), against the telemetry the program returned for it
  (``ChunkStats``: latency quantiles and maximum, PMs at the end, shed
  and dropped events, the counters), exactly.

The replays run on the reference's own build (``model`` returns it), so
nothing the program made but its state at the checked push's start
(``push``) enters them.
"""
from __future__ import annotations

import numpy as np

from cepbench.reference import engine as E, model as RM, patterns as RP
from cepbench.reference.arith import F32, Arith, fma32

# The program's carry leaves the reference keeps, by the program's names.
STATE_LEAVES = {
    "active": "active", "state": "state", "open_idx": "open_idx",
    "bind": "bind", "idset": "idset", "ring": "ring",
    "ring_ptr": "ring_ptr", "sim_time": "sim_time", "ema_gap": "ema_gap",
    "prev_arrival": "prev_arrival", "pms_shed": "pms_shed",
    "shed_calls": "shed_calls", "overflow": "overflow",
    "complex_count": "complex_count", "pms_created": "pms_created",
    "lat_samples_n": "lat_n", "lat_samples_l": "lat_l",
    "lat_ptr": "lat_ptr", "obs_counts": "obs_counts",
    "obs_rewards": "obs_rewards"}
ZERO_LEAVES = ("ebl_frac", "ebl_dropped")   # E-BL's: nought under pSPICE
STATS = ("l_e_p50", "l_e_p99", "l_e_max", "n_pm_end", "shed_events",
         "dropped_events", "pms_shed", "shed_calls", "overflow",
         "ebl_dropped", "completions")


def params(cfg: dict, pats: dict) -> E.Params:
    c = cfg["cost"]
    return E.Params(
        num_pms=cfg["max_pms"],
        any_ids=max(8, int(pats["final_state"].max()) + 1), ring=8,
        latency_bound=cfg["latency_bound"], c_base=c["c_base"],
        c_match=c["c_match"], c_shed_base=c["c_shed_base"],
        c_shed_pm=c["c_shed_pm"], shedder=cfg["shedder"])


def ref_model(m: dict) -> E.Model:
    """Learned inputs (host arrays: ``ut_tables``, ``ut_bins``, ``f``,
    ``g``) as the reference engine's."""
    return E.Model(ut_tables=np.asarray(m["ut_tables"], F32),
                   ut_bins=np.asarray(m["ut_bins"]),
                   f=(F32(m["f"][0]), F32(m["f"][1]), int(m["f"][2])),
                   g=(F32(m["g"][0]), F32(m["g"][1]), int(m["g"][2])))


def state_from(carry: dict, lanes) -> E.State:
    """The reference's state of ``lanes`` from the program's carry."""
    kw = {}
    for k, v in STATE_LEAVES.items():
        a = np.asarray(carry[k])[lanes]
        if k in ("ring", "ring_ptr", "lat_ptr"):
            a = a.astype(np.int64)
        kw[v] = a.copy()
    return E.State(**kw)


def leaves_differing(carry: dict, st: E.State, lanes) -> list[str]:
    """The carry leaves (of ``lanes``) that differ in any bit."""
    bad = []
    for k, v in STATE_LEAVES.items():
        a, b = np.asarray(carry[k])[lanes], getattr(st, v)
        if a.shape != b.shape or not np.array_equal(
                a.astype(b.dtype) if a.dtype != b.dtype else a, b):
            bad.append(k)
    for k in ZERO_LEAVES:
        if np.asarray(carry[k])[lanes].any():
            bad.append(k)
    return bad


def lanes(job: dict) -> dict:
    """Comparison ``lanes``: the reference from a fresh state over the
    sampled lanes' events [0, start) (``events``), against the program's
    carry of those lanes at ``start``."""
    cfg, ev, ln = job["config"], job["events"], np.asarray(job["lanes"])
    ar = Arith(job.get("precision", "float32"))
    pats = RP.compile_specs(cfg["patterns"])
    prm = params(cfg, pats)
    st = E.State.fresh(len(ln), *pats["trans"].shape[:2], prm)
    E.run(prm, pats, ref_model(job["model"]), st, ev, 0, ar)
    bad = leaves_differing(job["carry"], st, ln)
    return {"carry_leaves_differing": len(bad),
            "note": f"lanes {ln.tolist()} at event {job['start']}: "
                    f"differing leaves {bad}"}


def merge_lanes(results: list[dict]) -> dict:
    """``lanes``' readings of several workers as one: the differing
    leaves summed, the notes joined."""
    return {"carry_leaves_differing": sum(r["carry_leaves_differing"]
                                          for r in results),
            "note": "; ".join(r["note"] for r in results)}


def quantiles(x: np.ndarray, ar: Arith) -> np.ndarray:
    """Linear quantiles 0.5, 0.99 of float32 ``x``: the sorted values
    around q·(n - 1), the lower weighted by 1 - w fused into the upper
    weighted by w."""
    a = np.sort(x.reshape(-1))
    n = a.shape[0]
    q = np.array([0.5, 0.99], F32) * F32(n - 1)
    low, high = np.floor(q), np.ceil(q)
    hw = ar.r(q - low)
    lo = a[np.clip(low.astype(np.int64), 0, n - 1)]
    hi = a[np.clip(high.astype(np.int64), 0, n - 1)]
    return ar.r(fma32(lo, ar.r(F32(1) - hw), ar.r(hi * hw)))


def counters(st: E.State) -> dict:
    """The telemetry's cumulative counters, summed over the lanes."""
    return {"pms_shed": float(st.pms_shed.sum()),
            "shed_calls": float(st.shed_calls.sum()),
            "overflow": float(st.overflow.sum()), "ebl_dropped": 0.0,
            "completions": float(st.complex_count.sum())}


def chunk_stats(out: E.Outputs, before: dict, after: dict,
                ar: Arith) -> dict:
    """One chunk's telemetry (``ChunkStats``' fields) from the reference's
    rows over every lane and the counters around the chunk."""
    p50, p99 = quantiles(out.l_e, ar)
    return dict(l_e_p50=float(p50), l_e_p99=float(p99),
                l_e_max=float(out.l_e.max()),
                n_pm_end=float(out.n_pm[:, -1].sum()),
                shed_events=int(out.shed.sum()), dropped_events=0,
                **{n: after[n] - before[n] for n in before})


def push_part(job: dict) -> list[dict]:
    """Comparison ``push`` for a share of the lanes (``lanes``): from the
    program's carry at the push's start through its chunks (``events``
    those lanes' events of the push, from global index ``start``); per
    chunk the rows and the counters around it."""
    cfg, ev = job["config"], job["events"]
    ar = Arith(job.get("precision", "float32"))
    pats = RP.compile_specs(cfg["patterns"])
    prm = params(cfg, pats)
    st = state_from(job["carry"], np.asarray(job["lanes"]))
    model = ref_model(job["model"])
    a, n, cs = job["start"], ev["cls"].shape[1], cfg["chunk_events"]
    out = []
    for c0 in range(0, n, cs):
        before = counters(st)
        rows = E.run(prm, pats, model, st,
                     {f: v[:, c0:min(c0 + cs, n)] for f, v in ev.items()},
                     a + c0, ar)
        out.append(dict(rows=rows, before=before, after=counters(st)))
    return out


def push_compare(parts: list, stats: list, what: str,
                 precision: str = "float32") -> dict:
    """Each chunk's telemetry from every share's rows and counters,
    against the program's ``ChunkStats`` rows ``stats``."""
    ar = Arith(precision)
    bad = []
    for k, prog in enumerate(stats):
        chunk = [p[k] for p in parts]
        rows = E.Outputs(*(np.concatenate([getattr(c["rows"], f)
                                           for c in chunk])
                           for f in ("l_e", "n_pm", "shed")))
        sums = {side: {n: sum(c[side][n] for c in chunk)
                       for n in chunk[0][side]}
                for side in ("before", "after")}
        ref = chunk_stats(rows, sums["before"], sums["after"], ar)
        bad += [f"chunk {k} {n}: {prog[n]!r} != {ref[n]!r}" for n in STATS
                if prog[n] != ref[n]]
    return {"push_stats_differing": len(bad),
            "note": what + ": " + ("; ".join(bad[:6]) if bad else
                                   "every field equal")}


def built_model(b: RM.Built) -> dict:
    """The reference's build as the replays' learned inputs."""
    return dict(ut_tables=b.tables, ut_bins=b.bins, f=b.f, g=b.g)


def model(job: dict) -> dict:
    """Comparison ``model``: the reference's build from the warm-up
    events against the program's; also returns the reference's build
    (``built``) for the replays."""
    cfg = job["config"]
    ar = Arith(job.get("precision", "float32"))
    pats = RP.compile_specs(cfg["patterns"])
    ref = RM.build(params(cfg, pats), pats, job["warm"], cfg["bin_size"],
                   ar)
    prog = job["built"]
    bad = []
    for name in ("T", "R"):
        for p, (x, y) in enumerate(zip(prog[name], getattr(ref, name))):
            n = int((np.asarray(x, F32) != y).sum())
            if n:
                bad.append(f"{name}[{p}] {n} entries")
    bins = np.asarray(prog["ut_bins"])
    if bins.shape != ref.bins.shape or (bins != ref.bins).any():
        bad.append(f"ut_bins {bins.tolist()} != {ref.bins.tolist()}")
    pairs = [(f"{m}.{k}", prog[m][i], getattr(ref, m)[i])
             for m in ("f", "g") for i, k in enumerate(("a", "b", "kind"))]
    for name, x, y in pairs + [
            ("steady_n_pm", prog["steady_n_pm"], ref.steady_n_pm),
            ("max_rate", prog["max_rate"], ref.max_rate)]:
        if float(x) != float(y):
            bad.append(f"{name} {float(x)!r} != {float(y)!r}")
    ut = np.asarray(prog["ut_tables"], F32)
    gap = 0.0
    for p in range(ut.shape[0]):
        scale = float(np.abs(ref.tables[p]).max())
        gap = max(gap, float(np.abs(ut[p].astype(np.float64) -
                                    ref.tables[p]).max()) / max(scale,
                                                                1e-30))
    return {"model_values_differing": len(bad), "ut_table_gap": gap,
            "note": "model: " + ("; ".join(bad) if bad else
                                 "T, R, f, g, bins, steady PMs, capacity "
                                 "equal"),
            "built": built_model(ref)}
