"""repro_torch.analysis — the contract checker (DESIGN.md §11).

Port of ``repro.analysis``.  Checks over EXECUTED cells of the port's
hot path: a dispatch census (aten ops, float64 outputs, gather bytes,
host reads), the CUDA sync debug mode, the profiler's kernel rows,
device memory statistics, the carry's storage pointers, and ptxas's
report and the SASS of the built kernel library.  Entry points declare
their invariants with :func:`contracts.contract`; ``check_all`` sweeps
every config cell.

``contracts`` / ``rules`` / ``tracing`` are import-light (the engine
imports ``contracts``); ``driver`` imports the engine, so it is exposed
lazily here.
"""
from repro_torch.analysis.contracts import (      # noqa: F401
    Contract, contract, get_contract, get_entry, registry)
from repro_torch.analysis.rules import (          # noqa: F401
    Artifact, Finding, Rule, RULES, run_artifact, run_rules)
from repro_torch.analysis.tracing import CompileCounter  # noqa: F401

__all__ = ["Contract", "contract", "get_contract", "get_entry",
           "registry", "Artifact", "Finding", "Rule", "RULES",
           "run_artifact", "run_rules", "CompileCounter", "check_all"]


def __getattr__(name):
    import importlib
    if name in ("check_all", "driver"):
        driver = importlib.import_module("repro_torch.analysis.driver")
        return driver if name == "driver" else driver.check_all
    if name == "kernel_rules":
        return importlib.import_module("repro_torch.analysis.kernel_rules")
    raise AttributeError(f"module 'repro_torch.analysis' has no attribute "
                         f"{name!r}")
