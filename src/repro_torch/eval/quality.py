"""Quality-of-results metrics: match sets, false negatives, degradation.

A copy of ``repro.eval.quality`` (NumPy only), kept in the port so it
never imports the reference package.

The paper's headline claim is about *quality*, not throughput: under the
same latency bound, pSPICE's utility-driven PM drop loses far fewer
matches than random PM drop (PM-BL) or event-level shedding (E-BL).
This module defines the measurement (DESIGN.md §9):

  * ground truth = the match set of a no-shed run on the identical
    stream (``cfg.emit_matches`` runs expose it via
    ``engine.match_sets`` / ``RunResult.matches``);
  * a match identity is ``(open_idx, bind, end_idx)`` — window-open
    event index, binding value, completing event index — so "the same
    match" is well-defined across engines, backends and chunkings;
  * false-negative ratio = 1 − recall, recall = |found ∩ gt| / |gt|,
    weighted across patterns by the pattern weights w_q (§II-B);
  * QUALITY comparisons project identities to the *window* level,
    ``(open_idx, bind)``, as a multiset: a shedder that detects the
    complex event of a window through a slightly later constituent
    event (an input drop shifts the completing event) still detected
    it — that is the paper's complex-event count, not a loss.  The full
    3-tuple ("identity") equality is for DIFFERENTIAL testing, where
    the two runs see byte-identical inputs and must agree exactly;
  * a shedder can only LOSE window completions, never invent them
    (events seen by a shed run are a subset of the no-shed run's, and
    skip-till-next-match is monotone in its input), PROVIDED the
    ground-truth run had no PM-store overflow: any found \\ gt
    remainder ("spurious") under that proviso is an engine bug, and
    the metamorphic suite asserts it is empty.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Sequence

import numpy as np


@dataclasses.dataclass
class QualityReport:
    """Match-set comparison of one run against a ground truth."""
    recall: float                    # weighted |found ∩ gt| / |gt|
    fn_ratio: float                  # 1 - recall (weighted FN fraction)
    per_pattern_recall: np.ndarray   # (P,) — 1.0 where gt is empty
    per_pattern_fn: np.ndarray       # (P,)
    n_gt: int                        # total ground-truth matches
    n_found: int                     # total matches the run produced
    n_spurious: int                  # found \ gt — MUST be 0 for shedders

    def to_row(self) -> dict:
        d = dataclasses.asdict(self)
        d["per_pattern_recall"] = [float(x) for x in self.per_pattern_recall]
        d["per_pattern_fn"] = [float(x) for x in self.per_pattern_fn]
        return d


def project_matches(matches: Sequence[set],
                    key: str = "window") -> list[collections.Counter]:
    """Project per-pattern match-identity sets to comparison multisets.

    key="identity": the full (open_idx, bind, end_idx) tuple — exact,
    for differential testing.  key="window": (open_idx, bind) — one
    entry per detected complex event of a window/group; a multiset
    because an IN_WINDOWS window can legitimately complete more than
    once (the exists-check only blocks while a PM is live)."""
    if key == "identity":
        return [collections.Counter(m) for m in matches]
    if key == "window":
        return [collections.Counter((o, b) for (o, b, _e) in m)
                for m in matches]
    raise ValueError(f"unknown match key {key!r}")


def compare_match_sets(found: Sequence[set], gt: Sequence[set],
                       weights: np.ndarray | None = None,
                       key: str = "window") -> QualityReport:
    """Compare per-pattern match sets against a ground truth.

    Patterns with an empty ground truth contribute recall 1 (nothing to
    lose) and weight 0 to the aggregate — matching the paper's convention
    that the FN ratio is "of the matches the no-shed operator produced".
    """
    if len(found) != len(gt):
        raise ValueError(f"pattern count mismatch: {len(found)} vs {len(gt)}")
    P = len(gt)
    w = np.ones(P) if weights is None else np.asarray(weights, float)
    fc = project_matches(found, key)
    gc = project_matches(gt, key)
    per_recall = np.ones(P)
    hit = np.zeros(P)
    total = np.zeros(P)
    spurious = 0
    for p in range(P):
        total[p] = sum(gc[p].values())
        hit[p] = sum((fc[p] & gc[p]).values())     # multiset intersection
        spurious += sum((fc[p] - gc[p]).values())
        if total[p] > 0:
            per_recall[p] = hit[p] / total[p]
    denom = float((w * total).sum())
    recall = float((w * hit).sum() / denom) if denom > 0 else 1.0
    return QualityReport(
        recall=recall, fn_ratio=1.0 - recall,
        per_pattern_recall=per_recall, per_pattern_fn=1.0 - per_recall,
        n_gt=int(total.sum()),
        n_found=int(sum(sum(c.values()) for c in fc)),
        n_spurious=int(spurious))


def latency_compliance(l_e: np.ndarray, latency_bound: float,
                       tolerance: float = 0.0) -> float:
    """Fraction of events whose realized latency met the bound (§IV-B
    'the latency bound is kept'): mean(l_e <= LB·(1+tolerance))."""
    l_e = np.asarray(l_e).reshape(-1)
    if l_e.size == 0:
        return 1.0
    return float((l_e <= latency_bound * (1.0 + tolerance)).mean())


def drop_fraction(result) -> float:
    """Fraction of the run's created PMs that were shed (PM shedders) or
    of its events that were dropped (E-BL) — the x-axis of degradation
    curves.  ``result`` is an ``engine.RunResult``."""
    created = float(np.asarray(result.pms_created).sum())
    frac_pm = result.pms_shed / max(created, 1.0)
    n_events = int(np.asarray(result.l_e).size)
    frac_ev = result.ebl_dropped / max(n_events, 1)
    return float(max(frac_pm, frac_ev))


def degradation_point(res, gt_res, weights=None,
                      latency_bound: float = 1.0) -> dict:
    """One point of a degradation curve: quality + load metrics of a
    shedder run (``RunResult`` with matches) vs its ground truth."""
    if res.matches is None or gt_res.matches is None:
        raise ValueError(
            "degradation_point needs match sets on both runs — run with "
            "cfg.emit_matches=True (extract_matches) so the FN ratio can "
            "be computed against the ground truth")
    rep = compare_match_sets(res.matches, gt_res.matches, weights)
    return {
        "fn_ratio": rep.fn_ratio,
        "recall": rep.recall,
        "n_gt": rep.n_gt,
        "n_found": rep.n_found,
        "n_spurious": rep.n_spurious,
        "drop_fraction": drop_fraction(res),
        "lb_compliance": latency_compliance(res.l_e, latency_bound),
        "pms_shed": res.pms_shed,
        "ebl_dropped": res.ebl_dropped,
    }


def degradation_curve(points: Sequence[tuple[float, dict]]) -> dict:
    """Assemble (level → point) pairs into a curve dict for JSON output,
    with the levels sorted ascending."""
    pts = sorted(points, key=lambda lp: lp[0])
    return {
        "levels": [float(l) for l, _ in pts],
        "fn_ratio": [p["fn_ratio"] for _, p in pts],
        "drop_fraction": [p["drop_fraction"] for _, p in pts],
        "lb_compliance": [p["lb_compliance"] for _, p in pts],
        "points": [dict(p, level=float(l)) for l, p in pts],
    }
