"""Pattern- and lane-parallel scale-out of the CEP operator, and the
model zoo's sharding specs.

Port of the CEP half of ``repro.dist.sharding`` (``pm_specs``,
``_merge_pattern_shards``, ``run_engine_sharded``, ``lane_specs``,
``run_chunk_lanes_sharded``) over ``torch.distributed``, and of its model
half (param, batch, cache, train and decode specs, at the end of this
module), whose specs the dry-run (``launch.dryrun``) lays out as DTensor
placements.

* **Pattern parallelism.**  The (P, N) PM store splits on its pattern
  axis: each rank scans the whole stream against P/n patterns as its own
  simulated operator (``cfg.num_patterns = P/n``, so its per-pattern cost
  sum rounds at the local P as the reference's shard does), then the
  shards merge: clocks by max (``pmax``), counters and the global PM
  count by sum (``psum``), the pattern-local leaves by concatenation on
  the pattern axis (the reference's ``out_specs``).
* **Lane parallelism.**  Tenant lanes split over a lane axis; on a 2-D
  mesh this composes with a pattern split over the other axis.

SPMD: every rank is handed the same global inputs, slices its own block
by the specs, runs the port's engine on it (the block kernel on
``cuda_block``) and merges with collectives — ``all_reduce(SUM)`` for
``psum``, ``all_reduce(MAX)`` for ``pmax``, ``all_gather`` where the
reference concatenates shards — so every rank holds the reference's
GLOBAL carry and ``StepOut``, and the runner, guard, refresh and
telemetry run on top unchanged.  A spec leaf is a tuple with one entry
per tensor dim (a mesh dim name or None): the reference's
``PartitionSpec``.  With no process group the world is one rank: the
result equals the plain engine bit for bit.

The summed carry leaves (the counters and the latency ring's PM counts)
are whole on every shard, so every shard but the first starts them from
zero and the sum adds the carry-in once and each shard's own part.  (The
reference psums them as they come in, which counts the carry-in n times:
from a runtime's second chunk on its counters grow n-fold a chunk;
``ROADMAP.md`` §3.)  The merge rules hold exactly: the float32 counters
summed are integers below 2**24, so their sum is exact in any order
(checked on every merge);
the threefry key's max is over its two words as uint32, widened to int64
for the collective (gloo has no uint32); a max over float leaves keeps a
NaN, as ``jnp.maximum`` does.  gloo collectives of CUDA tensors are
staged through host memory here (the one-card worlds, several ranks on
one GPU); NCCL takes them on the device.  ``merge_shards_plain`` is the
plain version of the merge — per-shard results of one process merged
with ``torch.sum`` / ``torch.amax`` / ``torch.cat`` — which the tests
and ``chip_smoke.py`` hold the collective path to.  ``stats`` counts the
merges' collectives: calls, bytes and seconds (from the end of the
shard's device work, so a rank's seconds include its wait for the
slowest rank of its group).
"""
from __future__ import annotations

import dataclasses
import time
from functools import lru_cache

import torch
import torch.distributed as dist

from repro_torch.cep import engine as eng
from repro_torch.core import overload as ovl
from repro_torch.device import resolve_device
from repro_torch.dist.mesh import (axis_group, axis_rank, axis_size,
                                   backend_device_type, dim_names,
                                   world_mesh)
from repro_torch.models.config import ModelConfig

# How a leaf of a pattern shard's result merges across the pattern axis
# (the reference's psum / pmax); a leaf sharded on the axis concatenates
# on it; every other leaf is the same on every shard.
CARRY_MERGE = {"sim_time": "max", "key": "max_u32", "ebl_frac": "max",
               "pms_shed": "sum", "shed_calls": "sum", "overflow": "sum",
               "ebl_dropped": "sum", "lat_samples_n": "sum",
               "lat_samples_l": "max"}
OUT_MERGE = {"l_e": "max", "n_pm": "sum", "shed": "any", "dropped": "any"}
EXACT_SUM_LIMIT = 2.0 ** 24     # integers in float32 add exactly below it


@dataclasses.dataclass
class CollectiveStats:
    """What the merges cost: collective calls, bytes each rank took out,
    and seconds (host clock, device synchronized)."""
    calls: int = 0
    bytes_out: int = 0
    seconds: float = 0.0

    def reset(self) -> None:
        self.calls = self.bytes_out = 0
        self.seconds = 0.0


stats = CollectiveStats()


# ---------------------------------------------------------------------------
# Specs
# ---------------------------------------------------------------------------

def _is_spec(x) -> bool:
    return type(x) is tuple


def _map(fn, specs, *trees):
    """``fn(spec, *leaves)`` over a spec tree and trees of its structure."""
    if _is_spec(specs):
        return fn(specs, *trees)
    return type(specs)(*(_map(fn, s, *xs)
                         for s, *xs in zip(specs, *trees)))


def pm_specs(mesh, cfg: eng.EngineConfig, axis: str = "data") -> dict:
    """Spec trees of the operator state with the pattern axis over mesh
    dim ``axis``: {"carry", "model", "events", "out", "pattern_axis"},
    the first four mirroring Carry / EngineModel / EventBatch / StepOut.
    Falls back to replicated (``pattern_axis`` None) when the mesh has no
    dim ``axis`` or ``num_patterns`` does not divide it."""
    divisible = (axis in dim_names(mesh)
                 and cfg.num_patterns % axis_size(mesh, axis) == 0)
    pax = axis if divisible else None
    pms = eng.PMStore(active=(pax, None), state=(pax, None),
                      open_idx=(pax, None), bind=(pax, None),
                      idset=(pax, None, None))
    carry = eng.Carry(
        pms=pms, ring=(pax, None), ring_ptr=(pax,),
        sim_time=(), key=(None,), ebl_frac=(), ema_gap=(),
        prev_arrival=(),
        complex_count=(pax,), pms_created=(pax,), pms_shed=(),
        shed_calls=(), overflow=(), ebl_dropped=(),
        obs_counts=(pax, None, None), obs_rewards=(pax, None, None),
        lat_samples_n=(None,), lat_samples_l=(None,), lat_ptr=())
    lat = ovl.LatencyModel(a=(), b=(), kind=())
    model = eng.EngineModel(
        trans=(pax, None, None), kind=(pax,), spawn_mode=(pax,),
        window_size=(pax,), slide=(pax,), final_state=(pax,),
        proc_cost=(pax,), uses_binding=(pax,), spawn_counts=(pax,),
        ut_tables=(pax, None, None), ut_bins=(pax,),
        f_model=lat, g_model=lat, ebl_raw_mean=())
    events = eng.EventBatch(
        ev_class=(None, pax), ev_bind=(None, pax), ev_open=(None, pax),
        ev_id=(None,), ev_rand=(None,), ebl_raw=(None,), arrival=(None,))
    out = eng.StepOut(l_e=(None,), n_pm=(None,), shed=(None,),
                      dropped=(None,), match_open=(None, pax, None),
                      match_bind=(None, pax, None))
    return {"carry": carry, "model": model, "events": events, "out": out,
            "pattern_axis": pax}


def _prepend_axis(spec_tree, lane_ax):
    """Grow every spec in a tree by a leading lane entry."""
    return _map(lambda s: (lane_ax,) + s, spec_tree)


def lane_specs(mesh, cfg: eng.EngineConfig, num_lanes: int,
               lane_axis: str = "data",
               pattern_axis: str | None = "model") -> dict:
    """``pm_specs`` with a leading lane dim: lanes over ``lane_axis``,
    each lane's pattern dim over ``pattern_axis``.  Either axis falls
    back to replicated (None) when missing from the mesh, equal to the
    other, or not dividing its dim.  Returns {"carry", "model", "events",
    "out", "lane_axis", "pattern_axis"}."""
    lax_ok = (lane_axis in dim_names(mesh)
              and num_lanes % axis_size(mesh, lane_axis) == 0)
    lane_ax = lane_axis if lax_ok else None
    pax_name = pattern_axis if pattern_axis != lane_axis else None
    inner = pm_specs(mesh, cfg, axis=pax_name or "__none__")
    return {
        "carry": _prepend_axis(inner["carry"], lane_ax),
        "model": _prepend_axis(inner["model"], lane_ax),
        "events": _prepend_axis(inner["events"], lane_ax),
        "out": _prepend_axis(inner["out"], lane_ax),
        "lane_axis": lane_ax,
        "pattern_axis": inner["pattern_axis"],
    }


SUMMED = tuple(k for k, op in CARRY_MERGE.items() if op == "sum")


def _block(tree, spec_tree, coords: dict):
    """This rank's block of a global tree: each dim whose spec names a
    mesh dim in ``coords`` ({dim: (coordinate, size)}) narrowed to the
    coordinate's slice."""
    def f(spec, x):
        for d, ax in enumerate(spec):
            if ax in coords:
                r, n = coords[ax]
                k = x.shape[d] // n
                x = x.narrow(d, r * k, k)
        return x.contiguous()
    return _map(f, spec_tree, tree)


def _carry_block(carry: eng.Carry, spec_tree, coords: dict, pax
                 ) -> eng.Carry:
    """This rank's block of the carry, its summed leaves zero unless its
    coordinate on the pattern axis ``pax`` is 0: the merge's sum then
    holds the carry-in once plus every shard's own part.  The engine only
    adds to these leaves (or overwrites ring entries), so a shard's run
    is the same either way."""
    c = _block(carry, spec_tree, coords)
    if pax is None or coords[pax][0] == 0:
        return c
    return c._replace(**{k: torch.zeros_like(getattr(c, k))
                         for k in SUMMED})


# ---------------------------------------------------------------------------
# The merge: one rule table, two ways to apply it
# ---------------------------------------------------------------------------

def _u32(x: torch.Tensor) -> torch.Tensor:
    """The int32 key words as their uint32 values, in int64."""
    return x.to(torch.int64) & 0xFFFFFFFF


def _from_u32(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x >= 2 ** 31, x - 2 ** 32, x).to(torch.int32)


def _nan_low(x: torch.Tensor) -> torch.Tensor:
    """NaN as -inf: the max of the rest, its NaN flag reduced apart."""
    return torch.where(x.isnan(), -torch.inf, x)


def _check_exact(total: torch.Tensor, what: str) -> torch.Tensor:
    """Refuse a float32 sum whose order could matter: every finite total
    must be an integer below 2**24 (the counters are non-negative, so
    each summand and partial sum is one too, and adds exactly)."""
    fin = total[torch.isfinite(total)]
    if fin.numel() and bool(((fin.abs() >= EXACT_SUM_LIMIT)
                             | (fin != fin.round())).any()):
        raise ValueError(f"{what}: a float32 counter left the range where "
                         "its sum over shards is exact (integers below "
                         "2**24)")
    return total


def _merge_tree(tree, spec_tree, rules: dict, axis: str, ops):
    """Apply ``rules`` by field name to a Carry or StepOut (nested trees
    follow their spec): reduce, concatenate on ``axis``, or keep."""
    def leaf(name, spec, x):
        op = rules.get(name)
        if op is not None:
            return ops.reduce(op, x, name)
        if axis in spec:
            return ops.gather(x, spec.index(axis))
        return ops.keep(x)
    return type(tree)(*(
        leaf(name, spec, x) if _is_spec(spec)
        else _merge_tree(x, spec, {}, axis, ops)
        for name, spec, x in zip(tree._fields, spec_tree, tree)))


class _Plain:
    """The merge over per-shard leaves held in one process (lists)."""

    @staticmethod
    def reduce(op, xs, what):
        s = torch.stack(xs)
        if op == "sum":
            return _check_exact(s.sum(0), what)
        if op == "max_u32":
            return _from_u32(_u32(s).amax(0))
        if op == "any":
            return s.any(0)
        return torch.where(s.isnan().any(0), torch.nan,
                           _nan_low(s).amax(0))

    @staticmethod
    def gather(xs, dim):
        return torch.cat(xs, dim=dim)

    @staticmethod
    def keep(xs):
        return xs[0]


class _Slot:
    """A merged leaf that the batched collectives fill in."""
    __slots__ = ("op", "x", "dim", "what", "value")

    def __init__(self, op: str, x: torch.Tensor, dim: int | None = None,
                 what: str = ""):
        self.op, self.x, self.dim, self.what = op, x, dim, what
        self.value = None


class _Collective:
    """The merge over this rank's leaves with its group's collectives,
    batched: every leaf is queued (``reduce`` / ``gather`` return a
    ``_Slot``), then ``flush`` runs at most four collectives — one SUM
    over the float32 counters, one MAX over the float32 clocks (NaN taken
    as -inf), one MAX over int64 words (the clocks' NaN flags, the key as
    uint32, the any-flags), and one ``all_gather`` of every concatenated
    leaf's bytes.  gloo collectives of CUDA tensors go through host
    memory."""

    def __init__(self, group):
        self.group = group
        self.host = dist.get_backend(group) == "gloo"
        self.slots: list[_Slot] = []

    def reduce(self, op, x, what):
        self.slots.append(_Slot(op, x, what=what))
        return self.slots[-1]

    def gather(self, x, dim):
        self.slots.append(_Slot("cat", x, dim))
        return self.slots[-1]

    @staticmethod
    def keep(x):
        return x

    def _put(self, x: torch.Tensor) -> torch.Tensor:
        stats.calls += 1
        return x.cpu() if self.host else x

    def _all_reduce(self, parts: list, op) -> list:
        if not parts:
            return []
        dev = parts[0].device
        buf = self._put(torch.cat([p.reshape(-1) for p in parts]))
        dist.all_reduce(buf, op=op, group=self.group)
        stats.bytes_out += buf.numel() * buf.element_size()
        buf = buf.to(dev)
        sizes = [p.numel() for p in parts]
        return [v.reshape(p.shape) for v, p in zip(buf.split(sizes), parts)]

    def _all_gather(self, parts: list) -> list:
        """[[rank 0's leaf, rank 1's, ...] for each of ``parts``]."""
        if not parts:
            return []
        dev = parts[0].device
        raw = [p.contiguous().reshape(-1).view(torch.uint8) for p in parts]
        buf = self._put(torch.cat(raw))
        bufs = [torch.empty_like(buf)
                for _ in range(dist.get_world_size(self.group))]
        dist.all_gather(bufs, buf, group=self.group)
        stats.bytes_out += sum(b.numel() for b in bufs)
        sizes = [r.numel() for r in raw]
        out = [[] for _ in parts]
        for b in bufs:
            b = b.to(dev)
            for k, (piece, p) in enumerate(zip(b.split(sizes), parts)):
                out[k].append(piece.clone().view(p.dtype).reshape(p.shape))
        return out

    def flush(self) -> None:
        by = {op: [s for s in self.slots if s.op == op]
              for op in ("sum", "max", "max_u32", "any", "cat")}
        for s in by["sum"] + by["max"]:
            if s.x.dtype != torch.float32:
                raise TypeError(f"{s.what}: {s.op} merges float32 leaves, "
                                f"not {s.x.dtype}")
        sums = self._all_reduce([s.x for s in by["sum"]], dist.ReduceOp.SUM)
        for s, v in zip(by["sum"], sums):
            s.value = _check_exact(v, s.what)
        tops = self._all_reduce([_nan_low(s.x) for s in by["max"]],
                                dist.ReduceOp.MAX)
        words = self._all_reduce(
            [s.x.isnan().to(torch.int64) for s in by["max"]] +
            [_u32(s.x) for s in by["max_u32"]] +
            [s.x.to(torch.int64) for s in by["any"]], dist.ReduceOp.MAX)
        nmax, nkey = len(by["max"]), len(by["max_u32"])
        for s, top, nan in zip(by["max"], tops, words[:nmax]):
            s.value = torch.where(nan > 0, torch.nan, top)
        for s, w in zip(by["max_u32"], words[nmax:nmax + nkey]):
            s.value = _from_u32(w)
        for s, w in zip(by["any"], words[nmax + nkey:]):
            s.value = w > 0
        for s, xs in zip(by["cat"], self._all_gather([s.x for s in
                                                      by["cat"]])):
            s.value = torch.cat(xs, dim=s.dim)
        self.slots = []


def _fill(tree):
    """A tree with every ``_Slot`` replaced by its value."""
    if isinstance(tree, _Slot):
        return tree.value
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_fill(x) for x in tree))
    return tree


def _merge_pattern_shards(carry: eng.Carry, outs: eng.StepOut, specs: dict,
                          axis: str, group) -> tuple[eng.Carry, eng.StepOut]:
    """This rank's pattern shard merged across ``axis`` (the reference's
    ``_merge_pattern_shards`` and its ``out_specs``): each shard is its
    own simulated parallel operator, so clocks take the slowest shard,
    counters aggregate, the latency ring pairs global PM counts with the
    slowest shard's per-event time, and pattern-local state concatenates.
    Elementwise over a leading lane dim."""
    if group is None:                      # a world of one
        return carry, outs
    t0 = _start_timer(carry.sim_time)
    ops = _Collective(group)
    carry = _merge_tree(carry, specs["carry"], CARRY_MERGE, axis, ops)
    outs = _merge_tree(outs, specs["out"], OUT_MERGE, axis, ops)
    ops.flush()
    carry, outs = _fill(carry), _fill(outs)
    _stop_timer(t0, carry.sim_time)
    return carry, outs


def _gather_lanes(carry: eng.Carry, outs: eng.StepOut, specs: dict, group
                  ) -> tuple[eng.Carry, eng.StepOut]:
    """Lane blocks gathered on dim 0 (the lane out_spec): one
    ``all_gather``."""
    t0 = _start_timer(carry.sim_time)
    ops = _Collective(group)
    carry = _map(lambda s, x: ops.gather(x, 0), specs["carry"], carry)
    outs = _map(lambda s, x: ops.gather(x, 0), specs["out"], outs)
    ops.flush()
    carry, outs = _fill(carry), _fill(outs)
    _stop_timer(t0, carry.sim_time)
    return carry, outs


def _start_timer(x: torch.Tensor) -> float:
    """The merge's clock starts once the device has finished the shard's
    run (the engine's launches are asynchronous)."""
    if x.is_cuda:
        torch.cuda.synchronize(x.device)
    return time.perf_counter()


def _stop_timer(t0: float, x: torch.Tensor) -> None:
    if x.is_cuda:
        torch.cuda.synchronize(x.device)
    stats.seconds += time.perf_counter() - t0


def merge_shards_plain(shards, specs: dict, axis: str
                       ) -> tuple[eng.Carry, eng.StepOut]:
    """The plain version of the merge: ``shards`` [(carry, outs), ...] of
    one process, in the order of their coordinate on ``axis``, merged by
    the same rules with ``torch.sum`` / ``torch.amax`` / ``torch.cat``.
    Each shard's run starts from its ``_carry_block`` (the summed leaves
    zero on every shard but the first), as on the collective path."""
    carries = _map(lambda s, *xs: list(xs), specs["carry"],
                   *(c for c, _ in shards))
    outs = _map(lambda s, *xs: list(xs), specs["out"],
                *(o for _, o in shards))
    return (_merge_tree(carries, specs["carry"], CARRY_MERGE, axis, _Plain),
            _merge_tree(outs, specs["out"], OUT_MERGE, axis, _Plain))


# ---------------------------------------------------------------------------
# Pattern-parallel engine
# ---------------------------------------------------------------------------

def _local_cfg(cfg: eng.EngineConfig, mesh, pax) -> eng.EngineConfig:
    return cfg if pax is None else dataclasses.replace(
        cfg, num_patterns=cfg.num_patterns // axis_size(mesh, pax))


def run_engine_sharded(cfg: eng.EngineConfig, model: eng.EngineModel,
                       events: eng.EventBatch, carry: eng.Carry, mesh=None,
                       axis: str = "data", device=None
                       ) -> tuple[eng.Carry, eng.StepOut]:
    """Pattern-parallel ``run_engine``: this rank scans the whole stream
    against its num_patterns / n patterns as its OWN simulated operator,
    then the shards merge, so every rank returns the global carry and
    StepOut.  With more than one shard the semantics are a genuinely
    parallel deployment, not a replay of the serial engine: per-event
    latency is the slowest shard's clock, overload and E-BL decisions are
    shard-local, and shed and drop counters add up the shards'
    decisions.  ``mesh`` defaults to the world on one dim ``axis`` (one
    rank without a process group, where the result equals the plain
    engine bit for bit).  Falls back to the plain engine when the pattern
    axis cannot shard."""
    dev = resolve_device(device)
    if mesh is None:
        mesh = world_mesh(axis, backend_device_type())
    specs = pm_specs(mesh, cfg, axis=axis)
    pax = specs["pattern_axis"]
    if pax is None:
        return eng.run_engine(cfg, model, events, carry, device=dev)
    coords = {pax: (axis_rank(mesh, pax), axis_size(mesh, pax))}
    c, o = eng.run_engine(
        _local_cfg(cfg, mesh, pax), _block(model, specs["model"], coords),
        _block(events, specs["events"], coords),
        _carry_block(carry, specs["carry"], coords, pax), device=dev)
    return _merge_pattern_shards(c, o, specs, pax, axis_group(mesh, pax))


def run_engine_shards_plain(cfg: eng.EngineConfig, model: eng.EngineModel,
                            events: eng.EventBatch, carry: eng.Carry, mesh,
                            axis: str = "data", device=None
                            ) -> tuple[eng.Carry, eng.StepOut]:
    """The plain version of ``run_engine_sharded`` on ``mesh`` (its shape
    alone counts: an AbstractMesh will do): every pattern shard's run in
    this process, one after the other, then ``merge_shards_plain``."""
    specs = pm_specs(mesh, cfg, axis=axis)
    pax = specs["pattern_axis"]
    if pax is None:
        return eng.run_engine(cfg, model, events, carry, device=device)
    n = axis_size(mesh, pax)
    shards = []
    for r in range(n):
        coords = {pax: (r, n)}
        shards.append(eng.run_engine(
            _local_cfg(cfg, mesh, pax),
            _block(model, specs["model"], coords),
            _block(events, specs["events"], coords),
            _carry_block(carry, specs["carry"], coords, pax), device=device))
    return merge_shards_plain(shards, specs, pax)


# ---------------------------------------------------------------------------
# Runtime tenant lanes: lanes x patterns over the mesh
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class _LanePlan:
    specs: dict
    lane_ax: str | None
    pax: str | None
    local_cfg: eng.EngineConfig


@lru_cache(maxsize=32)
def _lanes_plan(cfg: eng.EngineConfig, mesh, num_lanes: int,
                lane_axis: str, pattern_axis: str | None):
    """The lane chunk step's plan — specs, axes and the shard's config —
    made ONCE per (cfg, mesh, lane count, axes), as the reference caches
    its compiled step.  None when neither axis can shard."""
    specs = lane_specs(mesh, cfg, num_lanes, lane_axis=lane_axis,
                       pattern_axis=pattern_axis)
    lane_ax, pax = specs["lane_axis"], specs["pattern_axis"]
    if lane_ax is None and pax is None:
        return None
    return _LanePlan(specs, lane_ax, pax, _local_cfg(cfg, mesh, pax))


def _coords(mesh, plan: _LanePlan, lane: int | None = None,
            pattern: int | None = None) -> dict:
    """{mesh dim: (coordinate, size)} of a block: this rank's, or the
    given one's."""
    out = {}
    for ax, k in ((plan.lane_ax, lane), (plan.pax, pattern)):
        if ax is not None:
            out[ax] = (axis_rank(mesh, ax) if k is None else k,
                       axis_size(mesh, ax))
    return out


def _run_lane_block(plan: _LanePlan, model, events, carry, start: int,
                    coords: dict):
    sp = plan.specs
    return eng._scan_events_lanes_backend(
        plan.local_cfg, _block(model, sp["model"], coords),
        _block(events, sp["events"], coords),
        _carry_block(carry, sp["carry"], coords, plan.pax),
        eng.wrap_event_index(start))


def _start(start) -> int:
    return int(start.item()) if isinstance(start, torch.Tensor) \
        else int(start)


def run_chunk_lanes_sharded(cfg: eng.EngineConfig, model: eng.EngineModel,
                            events: eng.EventBatch, carry: eng.Carry, start,
                            mesh=None, lane_axis: str = "data",
                            pattern_axis: str | None = "model",
                            device=None) -> tuple[eng.Carry, eng.StepOut]:
    """Mesh-parallel chunk step of the multi-tenant runtime: this rank
    runs the lane-batched engine over its lanes x its pattern slice (on
    "cuda_block" the block kernel's lane instance), its pattern shard
    merges across the pattern axis lane by lane as in
    ``run_engine_sharded``, and the lane blocks gather, so every rank
    returns the global lane-stacked carry and StepOut.  Lanes are
    independent, so the lane axis needs no reduction.  The caller's carry
    stays as it was.  Falls back to the plain ``run_chunk_lanes`` when
    neither axis can shard."""
    from repro_torch.runtime import lanes as LN

    dev = resolve_device(device)
    eng._check_inputs(dev, model, events, carry)
    num_lanes = events.ev_class.shape[0]
    if mesh is None:
        mesh = world_mesh(lane_axis, backend_device_type())
    plan = _lanes_plan(cfg, mesh, num_lanes, lane_axis, pattern_axis)
    if plan is None:
        return LN.run_chunk_lanes(cfg, model, events, carry, start,
                                  device=dev)
    c, o = _run_lane_block(plan, model, events, carry, _start(start),
                           _coords(mesh, plan))
    sp = plan.specs
    if plan.pax is not None:
        c, o = _merge_pattern_shards(c, o, sp, plan.pax,
                                     axis_group(mesh, plan.pax))
    if plan.lane_ax is not None:
        group = axis_group(mesh, plan.lane_ax)
        if group is not None:
            c, o = _gather_lanes(c, o, sp, group)
    return c, o


def run_chunk_lanes_plain(cfg: eng.EngineConfig, model: eng.EngineModel,
                          events: eng.EventBatch, carry: eng.Carry, start,
                          mesh, lane_axis: str = "data",
                          pattern_axis: str | None = "model",
                          device=None) -> tuple[eng.Carry, eng.StepOut]:
    """The plain version of ``run_chunk_lanes_sharded`` on ``mesh`` (its
    shape alone counts): every (lane block, pattern block) in this
    process, one after the other; pattern blocks merge with
    ``merge_shards_plain``, lane blocks concatenate."""
    from repro_torch.runtime import lanes as LN

    plan = _lanes_plan(cfg, mesh, events.ev_class.shape[0], lane_axis,
                       pattern_axis)
    if plan is None:
        return LN.run_chunk_lanes(cfg, model, events, carry, start,
                                  device=device)
    sp = plan.specs
    nl = axis_size(mesh, plan.lane_ax) if plan.lane_ax else 1
    npat = axis_size(mesh, plan.pax) if plan.pax else 1
    blocks = []
    for i in range(nl):
        shards = [_run_lane_block(plan, model, events, carry, _start(start),
                                  _coords(mesh, plan, i, j))
                  for j in range(npat)]
        blocks.append(merge_shards_plain(shards, sp, plan.pax)
                      if plan.pax else shards[0])
    return tuple(_map(lambda s, *xs: torch.cat(xs, dim=0), sp[k],
                      *(b[t] for b in blocks))
                 for t, k in enumerate(("carry", "out")))


# ---------------------------------------------------------------------------
# The model half: parameter, batch, cache and step specs (DESIGN.md §5)
# ---------------------------------------------------------------------------
#
# The specs of ``repro.dist.sharding``'s model half, rule for rule, as
# spec tuples (one entry per tensor dim: None, a mesh dim name or a tuple
# of names), on a ``DeviceMesh`` or an ``AbstractMesh``.  Every rule goes
# through ``_fit``, which drops (from the left) any axis absent from the
# mesh or not dividing the dim, so every shard is even.
# ``placements``/``placements_tree`` turn specs into DTensor placements
# and ``distribute_tree`` a tree of tensors into DTensors; the dry-run
# (``launch.dryrun``) runs on them.

def _axis_size(mesh, axes) -> int:
    size = 1
    for a in axes:
        size *= axis_size(mesh, a)
    return size


def _norm(axes):
    """Normalize an axis group to a spec entry."""
    if not axes:
        return None
    if len(axes) == 1:
        return axes[0]
    return tuple(axes)


def _fit(mesh, shape, entries) -> tuple:
    """Spec from per-dim axis proposals, dropping (from the left) any
    axes absent from the mesh or not dividing the dim."""
    names = set(dim_names(mesh))
    out = []
    for dim, ax in zip(shape, entries):
        if ax is None:
            out.append(None)
            continue
        ax_t = (ax,) if isinstance(ax, str) else tuple(ax)
        ax_t = tuple(a for a in ax_t if a in names)
        while ax_t and dim % _axis_size(mesh, ax_t) != 0:
            ax_t = ax_t[1:]
        out.append(_norm(ax_t))
    return tuple(out)


def spec(mesh, shape, *entries) -> tuple:
    """Ad-hoc spec builder with the same divisibility fallback."""
    return _fit(mesh, shape, entries)


_BLOCKS = ("attn", "mlp", "moe", "mamba")


def _leaf_spec(mesh, cfg: ModelConfig, scheme: str, block: str | None,
               name: str, shape) -> tuple:
    """Sharding rule for one parameter leaf (the reference's, rule for
    rule).  Axis indices are negative so the same rule covers stacked
    (leading L axis) and unstacked (shared_attn) leaves.  scheme:
      "tp"    — tensor parallelism over "model" (+FSDP over "data" when
                cfg.fsdp), the default.
      "fsdp"  — no tensor axis; params shard over ("data", "model") as one
                flat FSDP axis group.
      "moe2d" — tp + experts sharded (E × d_ff) two-dimensionally.
    """
    nd = len(shape)
    fsdp = cfg.fsdp or scheme == "fsdp"
    dp = ("data", "model") if scheme == "fsdp" else ("data",)
    tp = None if scheme == "fsdp" else "model"
    ax: dict = {}
    if block == "attn":
        head_tp = tp if cfg.attn_head_tp else None
        if name in ("wq", "bq", "wq_b", "wk", "wv", "bk", "bv",
                    "wk_b", "wv_b"):
            ax[-2] = head_tp
            if fsdp and nd >= 3 and not name.startswith("b"):
                ax[-3] = dp                 # d (or lora rank) over data
        elif name == "wo":
            ax[-3] = head_tp
            if fsdp:
                ax[-1] = dp
        elif name in ("wq_a", "wkv_a"):
            if fsdp:
                ax[-2] = dp
    elif block == "mlp":
        if name in ("wi", "wg"):
            ax[-1] = tp
            if fsdp:
                ax[-2] = dp
        elif name == "wo":
            ax[-2] = tp
            if fsdp:
                ax[-1] = dp
    elif block == "moe":
        if name == "router":
            ax[-1] = tp
        elif name in ("wi", "wg"):
            ax[-3] = "model"                # experts on the model axis
            if scheme == "moe2d":
                ax[-1] = "data"             # (E × d_ff) 2-D expert shard
        elif name == "wo":
            ax[-3] = "model"
            if scheme == "moe2d":
                ax[-2] = "data"
    elif block == "mamba":
        if name in ("wz", "wx"):
            ax[-1] = tp                     # channel (d_inner) sharding
            if fsdp:
                ax[-2] = dp
        elif name == "wo":
            ax[-2] = tp
            if fsdp:
                ax[-1] = dp
        elif name == "wdt":
            ax[-1] = tp                     # SSD heads are channel groups
    else:
        if name == "embed":
            ax[-2] = tp if tp else ("data", "model")
            if fsdp and tp:
                ax[-1] = "data"
        elif name == "lm_head":
            ax[-1] = tp if tp else ("data", "model")
            if fsdp and tp:
                ax[-2] = "data"
    entries = [None] * nd
    for i, a in ax.items():
        if a is not None and -nd <= i:
            entries[i] = a
    return _fit(mesh, shape, entries)


def param_specs(mesh, cfg: ModelConfig, params, scheme: str = "tp") -> dict:
    """Spec tree mirroring ``params`` (tensors of any device, meta and
    fake included): per-architecture rules with divisibility fallback to
    replicated — starcoder2's 48 query heads shard over "model" while its
    4 KV heads stay replicated, and minitron's 24 heads fall back
    entirely on a 16-way axis."""
    def walk(tree: dict, block: str | None) -> dict:
        out = {}
        for key, val in tree.items():
            if isinstance(val, dict):
                if key in _BLOCKS:
                    nb = key
                elif key == "shared" and block == "moe":
                    nb = "mlp"              # shared experts are a plain MLP
                else:
                    nb = block
                out[key] = walk(val, nb)
            else:
                out[key] = _leaf_spec(mesh, cfg, scheme, block, key,
                                      tuple(val.shape))
        return out

    return walk(params, None)


def batch_axes(mesh, global_batch: int, scheme: str = "tp"):
    """Mesh axes the batch dim shards over, or None.  Multi-pod meshes
    flatten to ("pod", "data"); pure FSDP adds "model".  Leading axes drop
    until the batch divides (batch 16 on a (2, 16, 16) mesh keeps only
    ("data",))."""
    wanted = ("pod", "data", "model") if scheme == "fsdp" else ("pod", "data")
    axes = tuple(a for a in wanted if a in dim_names(mesh))
    while axes and global_batch % _axis_size(mesh, axes) != 0:
        axes = axes[1:]
    return axes or None


def batch_specs(mesh, cfg: ModelConfig, batch: dict,
                scheme: str = "tp") -> dict:
    """Specs for the train/prefill input dict (leading dim = batch)."""
    out = {}
    for key, val in batch.items():
        if key == "cache":
            out[key] = cache_specs(mesh, cfg, val)
            continue
        bax = batch_axes(mesh, val.shape[0], scheme)
        out[key] = (_norm(bax) if bax else None,) + (None,) * (val.dim() - 1)
    return out


# Cache entries whose axis 2 is a (max_len) sequence axis sharded over
# "model", the decode-memory-critical layout; ck/cv hold encoder frames
# at axis 2, replicated by the fallback when the frame count (whisper's
# 1500) does not divide.
_CACHE_SEQ = ("k", "v", "sk", "sv", "ckv", "krope", "ck", "cv")


def cache_specs(mesh, cfg: ModelConfig, cache: dict) -> dict:
    """Decode-cache layout: (L, B, S, ...) -> batch over the data axes,
    cache sequence over "model"; SSD state heads over "model"."""
    out = {}
    for name, leaf in cache.items():
        nd = leaf.dim()
        if nd == 0:
            out[name] = ()
            continue
        entries: list = [None] * nd
        if nd >= 2:
            bax = batch_axes(mesh, leaf.shape[1])
            entries[1] = _norm(bax) if bax else None
        if name in _CACHE_SEQ and nd >= 3:
            entries[2] = "model"
        if name == "state" and nd >= 3:
            entries[2] = "model"            # SSD heads = channel groups
        out[name] = _fit(mesh, tuple(leaf.shape), entries)
    return out


def train_specs(mesh, cfg: ModelConfig, params, batch: dict,
                scheme: str = "tp", pspecs=None):
    """(pspecs, ospecs, bspecs) of the train step: AdamW's moments mirror
    the param specs, its step count is replicated.  A precomputed
    ``pspecs`` skips walking the parameters again."""
    if pspecs is None:
        pspecs = param_specs(mesh, cfg, params, scheme=scheme)
    ospecs = {"m": pspecs, "v": pspecs, "step": ()}
    return pspecs, ospecs, batch_specs(mesh, cfg, batch, scheme=scheme)


def decode_specs(mesh, cfg: ModelConfig, global_batch: int):
    """(token_spec, logit_spec) of decode_step: tokens over the batch
    axes, logits (B, V) with vocab over "model"."""
    bax = batch_axes(mesh, global_batch)
    tok = _fit(mesh, (global_batch,), [bax])
    logits = _fit(mesh, (global_batch, cfg.vocab_size), [bax, "model"])
    return tok, logits


def map_specs(fn, specs, *trees):
    """``fn(spec, *leaves)`` over a tree of dicts whose leaves are specs
    and trees of the same structure."""
    if isinstance(specs, dict):
        return {k: map_specs(fn, s, *(t[k] for t in trees))
                for k, s in specs.items()}
    return fn(specs, *trees)


def placements(mesh, spec_: tuple) -> list:
    """DTensor placements (one per mesh dim) of one spec.  An entry
    ("data", "model") on tensor dim d is ``Shard(d)`` on both mesh dims,
    the first named the outer block, as jax lays out a tuple entry; the
    names of one entry must follow the mesh's dim order.  A mesh dim of
    size 1 is ``Replicate`` (the same layout)."""
    from torch.distributed.tensor import Replicate, Shard
    names = dim_names(mesh)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec_):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry!r} is not in the mesh's dim "
                             f"order {names}")
        for md in idx:
            if not isinstance(out[md], Replicate):
                raise ValueError(f"mesh dim {names[md]!r} shards two tensor "
                                 f"dims in {spec_}")
            if mesh.size(md) > 1:
                out[md] = Shard(d)
    return out


def placements_tree(mesh, specs):
    """``placements`` over a spec tree."""
    return map_specs(lambda s: placements(mesh, s), specs)


def shard_slices(mesh, shape, spec_: tuple, coord) -> tuple:
    """The (start, stop) of each dim of the shard at mesh coordinate
    ``coord`` (one index per mesh dim): a dim over axes (a1, .., ak) is cut
    into prod(sizes) even blocks, a1 the outermost."""
    names = dim_names(mesh)
    out = []
    for dim, entry in zip(shape, tuple(spec_) + (None,) * len(shape)):
        axes = () if entry is None else (
            (entry,) if isinstance(entry, str) else tuple(entry))
        block, n = 0, 1
        for a in axes:
            i = names.index(a)
            block = block * mesh.size(i) + coord[i]
            n *= mesh.size(i)
        size = dim // n
        out.append((block * size, (block + 1) * size))
    return tuple(out)


def local_shape(mesh, shape, spec_: tuple) -> tuple:
    """The shape of every shard of a tensor of ``shape`` laid out by
    ``spec_`` (even by construction of ``_fit``)."""
    return tuple(b - a for a, b in shard_slices(
        mesh, shape, spec_, (0,) * len(dim_names(mesh))))


def local_bytes(mesh, tree, specs) -> int:
    """Bytes one device holds of a tree of tensors (or structures) laid
    out by ``specs``: the sum of its shards' bytes."""
    total = 0

    def add(s, t):
        nonlocal total
        n = 1
        for x in local_shape(mesh, tuple(t.shape), s):
            n *= x
        total += n * t.element_size()
    map_specs(add, specs, tree)
    return total


def distribute_tree(mesh, tree, specs, device=None):
    """A tree of DTensors on the ``DeviceMesh`` ``mesh`` laid out by
    ``specs``.  A leaf on the meta device is a structure: its shard is
    made empty on ``device`` (this rank's shard; under ``FakeTensorMode``
    a fake tensor) without the global tensor; a DTensor leaf is
    redistributed where its layout differs (an all-reduce of partial
    sums: the counterpart of jax's ``out_shardings``); any other leaf is
    a global tensor this rank cuts its own shard from (no collective)."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    def one(s, t):
        pl = placements(mesh, s)
        if isinstance(t, DTensor):
            return t if tuple(t.placements) == tuple(pl) else \
                t.redistribute(mesh, pl)
        if t.device.type != "meta":
            return distribute_tensor(t, mesh, pl, src_data_rank=None)
        local = torch.empty(local_shape(mesh, tuple(t.shape), s),
                            dtype=t.dtype, device=device)
        return DTensor.from_local(local, mesh, pl, run_check=False,
                                  shape=t.shape, stride=t.stride())
    return map_specs(one, specs, tree)
