"""Rebuild guard (DESIGN.md §11): compilation counting as a contract.

Port of ``repro.analysis.tracing``'s rebuild guard.  Under eager PyTorch
nothing is traced or jit-compiled; what the port builds is its kernel
library (``kernels/_build.py``: ``build`` runs nvcc, ``load`` opens the
library) and its cached plans (the scale-out's
``dist.sharding._lanes_plan``).  After warm-up none of them may be made
again: the budget is 0.

:class:`CompileCounter` snapshots each source's count (a function
attribute ``compiles``, or an ``lru_cache``'s misses) and reports the
DELTA inside the ``with`` block.  A plan keyed on a per-call value
misses once per VALUE and blows the budget immediately.
:func:`retrace_findings` converts the measured counts into the same
Finding rows the cell rules emit.

The runtime's own timeline (what its host work costs, step by step) is
``repro_torch.spans``.
"""
from __future__ import annotations

from repro_torch.analysis.rules import Finding


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
        return self

    def __exit__(self, *exc):
        return False

    def compiles(self, src) -> int:
        return _compiles(src) - self._base.get(id(src), 0)


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
