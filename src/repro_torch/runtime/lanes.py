"""Tenant lanes: multi-stream execution in lockstep (DESIGN.md §7).

Port of ``repro.runtime.lanes``.  A lane is one tenant's independent
operator: its own event stream (own arrival rate), its own carry, its own
utility tables / latency model.  All lanes share one static
``EngineConfig``.  Lane-stacked trees are ordinary ``EngineModel`` /
``EventBatch`` / ``Carry`` structures whose every tensor grew a leading
``(L,)`` axis; build them with ``stack`` / ``broadcast_model``, recover
one lane with ``unstack_lane``.

On ``backend="cuda_block"`` a chunk runs ONE launch of the block
kernel's lane instance per W-event block (one CTA per lane); on "torch"
and "cuda" the per-event loop runs every lane in lockstep, its device
half once over the L·P pattern rows (``cep.engine._scan_events_lanes``).

Where the reference donates the carry to a jitted step, the port hands it
over: ``run_chunk_lanes`` leaves the caller's carry as it was (the scan
updates a copy), ``run_chunk_lanes_donated`` takes it over (the block
kernel updates its contiguous tensors in place, the per-event loop
writes its result into them, and the caller must use only the returned
carry).  Events are never written.
"""
from __future__ import annotations

from typing import Any, Sequence

import torch

from repro_torch.analysis import contracts as ctr
from repro_torch.cep import engine as eng
from repro_torch.device import resolve_device

Tree = Any


def stack(trees: Sequence[Tree]) -> Tree:
    """Stack per-lane trees (models, carries, event batches) on axis 0."""
    return eng.tree_map(lambda *xs: torch.stack(xs), *trees)


def unstack_lane(tree: Tree, lane: int) -> Tree:
    """Lane ``lane`` of a lane-stacked tree (views)."""
    return eng.tree_map(lambda x: x[lane], tree)


def num_lanes(tree: Tree) -> int:
    return next(iter(_leaves(tree))).shape[0]


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    else:
        for x in tree:
            yield from _leaves(x)


def broadcast_model(model: eng.EngineModel, n: int) -> eng.EngineModel:
    """Replicate one model across n lanes, each lane its own copy (lanes
    may diverge later via per-lane refresh — each lane's tables refit
    from its own carry)."""
    return eng.tree_map(
        lambda x: x[None].expand((n,) + tuple(x.shape)).contiguous(), model)


def init_lane_carries(cfg: eng.EngineConfig, n: int, seed: int = 0,
                      lat_capacity: int = 4096, device=None) -> eng.Carry:
    """n independent carries (PRNG seeds ``seed + i``), lane-stacked."""
    dev = resolve_device(device)
    return stack([eng.init_carry(cfg, seed=seed + i,
                                 lat_capacity=lat_capacity, device=dev)
                  for i in range(n)])


def _run(cfg, model, events, carry, start, device, own: bool):
    dev = resolve_device(device)
    eng._check_inputs(dev, model, events, carry)
    if isinstance(start, torch.Tensor):
        start = int(start.item())
    return eng._scan_events_lanes_backend(
        cfg, model, events, carry, eng.wrap_event_index(start), own=own)


# The lane entries keep the scan's budgets but the byte budgets, which
# the reference states for one lane.
_LANES = dict(eng.HOT_PATH, max_temp_bytes=None, max_gather_bytes=None)


@ctr.contract("runtime.run_chunk_lanes", **_LANES, **eng.NOT_OWNED)
def run_chunk_lanes(cfg: eng.EngineConfig, model: eng.EngineModel,
                    events: eng.EventBatch, carry: eng.Carry, start,
                    device=None) -> tuple[eng.Carry, eng.StepOut]:
    """Lane-batched ``run_engine_chunk`` over the leading lane axis.

    ``start`` is shared: lanes advance in lockstep over aligned chunk
    windows (each lane still has its own arrival clock inside its
    EventBatch).  Every lane equals that lane's own ``run_engine`` bit
    for bit.  The caller's carry stays as it was."""
    return _run(cfg, model, events, carry, start, device, own=False)


@ctr.contract("runtime.run_chunk_lanes_donated", donate=("carry",),
              **_LANES)
def run_chunk_lanes_donated(cfg: eng.EngineConfig, model: eng.EngineModel,
                            events: eng.EventBatch, carry: eng.Carry, start,
                            device=None) -> tuple[eng.Carry, eng.StepOut]:
    """``run_chunk_lanes`` that takes the carry over: its tensors are
    updated in place and returned (the MultiTenantRuntime's steady-state
    loop, which keeps only the returned carry)."""
    return _run(cfg, model, events, carry, start, device, own=True)
