"""repro_torch.eval — quality-of-results evaluation (port of
``repro.eval``, DESIGN.md §9).

Three pieces:
  * ``oracle``  — a slow, pure-NumPy/Python reference CEP engine (the
    literal sort-based Algorithm 2) used as a differential-testing oracle
    for the port's engines;
  * ``quality`` — match-set extraction and metrics: false-negative ratio
    / recall vs a no-shed ground truth, latency-bound compliance,
    degradation curves;
  * ``sweep``   — the paper-figure experiment grid ({stock, soccer, bus}
    × {pspice, pmbl, ebl} × overload levels), with its command line
    ``python -m repro_torch.eval.sweep``.
"""
from repro_torch.eval.oracle import OraclePM, OracleResult, run_oracle
from repro_torch.eval.quality import (QualityReport, compare_match_sets,
                                      degradation_curve, degradation_point,
                                      drop_fraction, latency_compliance,
                                      project_matches)

__all__ = [
    "OraclePM", "OracleResult", "run_oracle",
    "QualityReport", "compare_match_sets", "degradation_curve",
    "degradation_point", "drop_fraction", "latency_compliance",
    "project_matches",
    "run_quality_sweep", "check_headline", "OVERLOAD_LEVELS",
]

_SWEEP_NAMES = ("run_quality_sweep", "check_headline", "OVERLOAD_LEVELS")


def __getattr__(name: str):
    # The sweep driver imports repro_torch.cep.runner, which itself uses
    # repro_torch.eval.quality — loading it lazily keeps the package
    # cycle-free.
    if name in _SWEEP_NAMES:
        from repro_torch.eval import sweep
        return getattr(sweep, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
