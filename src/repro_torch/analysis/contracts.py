"""Performance contracts for the port's hot path (DESIGN.md §11).

Port of ``repro.analysis.contracts``.  A :class:`Contract` is the
machine-checked statement of the invariants an entry point must uphold:
sort-free, sync-free where the design says so, allocation-bounded,
rebuild-free after warm-up, with an owned carry updated in place.
Entry points declare theirs with the :func:`contract` decorator::

    @ctr.contract("cep.run_engine", max_compiles=0, ...)
    def run_engine(cfg, model, events, carry, device=None): ...

The decorator is ZERO-COST at call time: it registers the (function,
contract) pair in a module registry and returns the function unchanged —
no wrapper frame on the hot path.  ``repro_torch.analysis.rules``
evaluates the contract against the record of one EXECUTED cell (there is
no compiled artifact under eager PyTorch), and
``repro_torch.analysis.driver.check_all`` sweeps the config cells.

This module is import-cycle-free by design: the engine and the runtime
import it, so it must never import them (budget callables below are
duck-typed over ``EngineConfig``'s attributes).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable

# Byte budgets may depend on the config cell being checked, so a budget
# is either a plain number or a callable ``(cfg, n_events) -> int``
# resolved at check time (the decorator site cannot know the cell's
# shapes).  The sync budget also takes the cell's fires.


@dataclasses.dataclass(frozen=True)
class Contract:
    """The hot-path invariants one entry point promises (DESIGN.md §11).

    The reference's fields, with its structural loop budgets
    (``max_while``/``max_cond``, which need a trace) replaced by what an
    eager run can count: kernel launches per W-event block, aten ops per
    event and host syncs per event.  Rule provenance lives with the rule
    definitions in ``rules.RULES``.
    """
    name: str
    # Banned work: no sort (spawn allocation and Algorithm 2 are O(N)),
    # no host sync beyond ``max_syncs_per_event``, no float64 (an
    # accidental promotion doubles every store pass).
    no_sort: bool = True
    no_sync: bool = True
    no_f64: bool = True
    # Host syncs (device→host reads) a scan may make, per event of the
    # cell: a callable ``(cfg, n_events, fires) -> float`` (0 on the fused
    # block path).
    max_syncs_per_event: object = None
    # Launches of the path's kernel per block of W events (on the
    # per-event backend a block is one event), and aten ops per event
    # outside the kernels: new data-dependent loops show up in both.
    max_launches_per_block: int | None = None
    max_ops_per_event: int | None = None
    # Owned carry: argument names whose storage the entry point updates
    # in place (the port's form of the reference's donation).
    donate: tuple = ()
    # Rebuild budget after warm-up: kernel builds, library loads and plan
    # cache misses across repeated calls with fresh same-shape data.
    max_compiles: int | None = None
    # Allocation budgets, resolved per cell: device bytes a scan holds
    # beyond its inputs and outputs, and the largest single gather /
    # index / scatter result.
    max_temp_bytes: object = None
    max_gather_bytes: object = None
    # Rule names waived for this entry point, and why: a waived rule
    # reports a passing finding whose evidence names the waiver.
    waived: tuple = ()
    waiver_note: str = ""

    def budget(self, field: str, cfg, n_events: int, **kw):
        """Resolve a budget for one cell (callables get the cell)."""
        v = getattr(self, field)
        return v(cfg, n_events, **kw) if callable(v) else v


_REGISTRY: dict = {}


def contract(name: str, **kw) -> Callable:
    """Declare a contract on an entry point; returns the function as-is."""
    c = Contract(name=name, **kw)

    def deco(fn):
        _REGISTRY[name] = (fn, c)
        return fn

    return deco


def get_contract(name: str) -> Contract:
    return _REGISTRY[name][1]


def get_entry(name: str):
    return _REGISTRY[name][0]


def registry() -> dict:
    """name -> (entry point, Contract); a copy — callers cannot mutate."""
    return dict(_REGISTRY)


# ---------------------------------------------------------------------------
# Shared budget formulas (duck-typed over EngineConfig attributes)
# ---------------------------------------------------------------------------

def store_bytes(cfg) -> int:
    """Bytes of one PM store: the unit allocation budgets scale in."""
    per_slot = 4 * 4 + 1 + 4 * cfg.max_any_ids   # i32 ×4 + mask + idset
    return cfg.num_patterns * cfg.max_pms * per_slot


def hot_path_temp_budget(cfg, n_events: int) -> int:
    """Temp-buffer budget for one engine scan (the reference's formula).

    Legitimate temps are a bounded number of store-shaped buffers plus
    per-event StepOut columns; ~11× store + ~40 B/event was the largest
    cell the reference observed, with ~2× headroom — tight enough that
    one resurrected (P, N, C+1)-per-event temp blows the budget.
    """
    return 24 * store_bytes(cfg) + 128 * n_events * cfg.num_patterns \
        + (1 << 17)


def hot_path_gather_budget(cfg, n_events: int) -> int:
    """Largest single gather result allowed (the reference's formula).

    The flat SEQ advance gather is (P·N,) i32; event-batch gathers are
    O(n_events).  Anything store×classes-sized means the flat-gather
    rewrite regressed.
    """
    del n_events
    return 8 * 4 * cfg.num_patterns * cfg.max_pms + (1 << 16)


# Host reads of the per-event loop: one per event (the active counts), a
# second per event that fires a shed, and a fixed set per call: 26 today
# (8 model columns, 11 carry scalars and rings, 5 event columns, 2
# pattern masks) and the last count read out, allowed 48.
SYNCS_PER_EVENT, SYNCS_PER_FIRE, SYNCS_PER_CALL = 1, 1, 48


def hot_path_sync_budget(cfg, n_events: int, fires: int = 0) -> float:
    """Host syncs per event one scan may make.

    0 on the fused block path (``block_shed="fused"`` and the threshold
    plan, or no PM shedder): the whole block runs in the kernel.  The
    replay protocol reads each launch's status and replays each fire
    through the per-event step; the per-event backends read once per
    event, once more per fire, and a fixed set per call."""
    n = max(n_events, 1)
    per_event_scan = SYNCS_PER_CALL + SYNCS_PER_EVENT + SYNCS_PER_FIRE
    if cfg.backend == "cuda_block":
        replay = cfg.shedder in ("pspice", "pmbl") and not (
            cfg.shed_plan == "threshold" and cfg.block_shed == "fused")
        if not replay:
            return 0.0
        launches = math.ceil(n_events / cfg.block_events) + fires
        return (launches + fires * per_event_scan) / n
    return (SYNCS_PER_CALL + SYNCS_PER_EVENT * n_events
            + SYNCS_PER_FIRE * fires) / n
