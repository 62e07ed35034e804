"""Rebuild guard (DESIGN.md §11): compilation counting as a contract.

Port of ``repro.analysis.tracing``.  Under eager PyTorch nothing is
traced or jit-compiled; what the port builds is its kernel library
(``kernels/_build.py``: ``build`` runs nvcc, ``load`` opens the library)
and its cached plans (the scale-out's ``dist.sharding._lanes_plan``).
After warm-up none of them may be made again: the budget is 0.

* :class:`CompileCounter` — snapshots each source's count (a function
  attribute ``compiles``, or an ``lru_cache``'s misses) and reports the
  DELTA inside the ``with`` block.  A plan keyed on a per-call value
  misses once per VALUE and blows the budget immediately.

* :func:`count_traces` — counts calls of a Python body.  Under jit a
  body runs once per trace; under eager torch a trace is a call, so the
  counter counts calls (the reference's name is kept).

Both feed :func:`retrace_findings`, which converts measured counts into
the same Finding rows the cell rules emit.
"""
from __future__ import annotations

import collections
import functools

from repro_torch.analysis.rules import Finding

_TRACE_COUNTS: collections.Counter = collections.Counter()


def count_traces(name: str):
    """Count executions of ``fn``'s body (under eager torch: calls)."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kw):
            _TRACE_COUNTS[name] += 1
            return fn(*args, **kw)
        wrapper.__wrapped__ = fn
        wrapper._trace_counter_name = name
        return wrapper
    return deco


def trace_counts() -> dict:
    return dict(_TRACE_COUNTS)


def reset_trace_counts() -> None:
    _TRACE_COUNTS.clear()


def _compiles(src) -> int:
    if hasattr(src, "cache_info"):
        return src.cache_info().misses
    return getattr(src, "compiles", 0)


def build_sources() -> dict:
    """name -> source of everything the port builds or plans: the kernel
    library's builds and loads, and the scale-out's plan cache."""
    from repro_torch.dist import sharding
    from repro_torch.kernels import _build
    return {"kernels.build": _build.build, "kernels.load": _build.load,
            "dist.lanes_plan": sharding._lanes_plan}


class CompileCounter:
    """Measure builds and plan misses across a sweep.

        with CompileCounter(*build_sources().values()) as cc:
            ... run the {backend x shedder x chunked} sweep ...
        cc.compiles(_build.build)   # nvcc runs inside the block
    """

    def __init__(self, *sources):
        self._sources = sources
        self._base = {}

    def __enter__(self):
        self._base = {id(s): _compiles(s) for s in self._sources}
        self._trace_base = dict(_TRACE_COUNTS)
        return self

    def __exit__(self, *exc):
        return False

    def compiles(self, src) -> int:
        return _compiles(src) - self._base.get(id(src), 0)

    def traces(self, name: str) -> int:
        return _TRACE_COUNTS.get(name, 0) - self._trace_base.get(name, 0)


def retrace_findings(measured: dict, budgets: dict, cell: str = "sweep",
                     ) -> list:
    """Findings for measured build/plan counts vs per-entry budgets.

    ``measured``: name -> builds observed over the sweep.  ``budgets``:
    name -> max allowed (entries missing a budget are reported as
    informational passes — measured but unbounded).
    """
    out = []
    for name, n in sorted(measured.items()):
        budget = budgets.get(name)
        if budget is None:
            out.append(Finding("retrace", True,
                               f"{name}: {n} builds (no budget)", cell))
            continue
        out.append(Finding(
            "retrace", n <= budget,
            f"{name}: {n} builds vs budget {budget}"
            + ("" if n <= budget else
               " (a plan keyed on a per-call value? a library reloaded?)"),
            cell))
    return out
