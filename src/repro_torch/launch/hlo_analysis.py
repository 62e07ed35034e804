"""Roofline terms of a traced step (port of ``repro.launch.hlo_analysis``;
the name is kept so that a reader finds the counterpart, but nothing
here reads HLO: there is none).

The reference compiles each step and reads XLA's per-device cost
analysis and the partitioned HLO's collectives.  The port runs the step
once on DTensors over a fake mesh under ``FakeTensorMode`` (no memory,
no kernel, no communication) with :class:`TraceRecorder` active, a
``TorchDispatchMode`` that sees every op one rank runs on its local
shards — DTensor desugars its ops into those (the recorder returns
``NotImplemented`` to DTensor's own ops); the global-shape ops DTensor
runs only to propagate shapes are not counted.  Per device:

  FLOPs       ``torch.utils.flop_counter``'s formulas on the local
              shapes (the products; the flash op by its own formula);
  bytes       each op's distinct tensor inputs and outputs, views and
              allocations excluded (no fusion assumed);
  collectives the ``_c10d_functional`` ops DTensor issues to
              redistribute: the local tensor's bytes and the group's
              size, times the ring factors below;
  peak        the live bytes of the storages the rank holds, the
              step's arguments included, at their most; and per phase
              ("forward" until autograd's first backward op, "backward"
              while autograd runs, "update" after it) the live bytes
              after each op (``timeline``), from which
              ``launch.dryrun.extrapolated_peak`` extrapolates a shallow trace
              to the full depth.

compute term    = FLOPs / 989 TFLOP/s (H100 SXM, bf16 dense)
memory term     = bytes / 3.35 TB/s (H100 SXM HBM3)
collective term = collective wire bytes / 50 GB/s (one NDR port)
"""
from __future__ import annotations

import dataclasses
import math
import sys
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.launch import mesh as M

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")
# c10d functional op -> collective kind.
_KIND = {"all_gather_into_tensor": "all-gather", "all_reduce": "all-reduce",
         "reduce_scatter_tensor": "reduce-scatter",
         "all_to_all_single": "all-to-all"}
_ALLOC_ALIGN = 512          # the CUDA caching allocator's block


@dataclasses.dataclass
class CollectiveStats:
    """Per-device WIRE bytes (ring-algorithm volumes) by collective kind."""
    bytes_by_kind: dict
    count_by_kind: dict

    @classmethod
    def empty(cls) -> "CollectiveStats":
        return cls({k: 0.0 for k in _COLLECTIVES},
                   {k: 0 for k in _COLLECTIVES})

    @property
    def total_bytes(self) -> float:
        return sum(self.bytes_by_kind.values())

    def scaled(self, factor: float) -> "CollectiveStats":
        return CollectiveStats(
            {k: v * factor for k, v in self.bytes_by_kind.items()},
            dict(self.count_by_kind))

    def minus(self, other: "CollectiveStats") -> "CollectiveStats":
        return CollectiveStats(
            {k: max(0.0, self.bytes_by_kind[k] - other.bytes_by_kind[k])
             for k in self.bytes_by_kind},
            {k: max(0, self.count_by_kind[k] - other.count_by_kind[k])
             for k in self.count_by_kind})

    def plus(self, other: "CollectiveStats") -> "CollectiveStats":
        return CollectiveStats(
            {k: self.bytes_by_kind[k] + other.bytes_by_kind[k]
             for k in self.bytes_by_kind},
            {k: self.count_by_kind[k] + other.count_by_kind[k]
             for k in self.count_by_kind})


def _wire_factor(kind: str, g: int) -> float:
    """Per-device ring wire volume as a multiple of the RESULT bytes."""
    if kind == "all-reduce":
        return 2.0 * (g - 1) / g
    if kind == "all-gather":
        return (g - 1) / g
    if kind == "reduce-scatter":
        return float(g - 1)       # operand = result × g
    if kind == "all-to-all":
        return (g - 1) / g
    return 1.0                    # collective-permute


def _group_size(name: str) -> int:
    from torch.distributed.distributed_c10d import _resolve_process_group
    return _resolve_process_group(name).size()


def collective(func, args) -> tuple[str, int, int] | None:
    """(kind, result bytes, group size) of a ``_c10d_functional``
    collective call on local tensors, or None for any other op."""
    ns, _, name = func.name().partition("::")
    if not ns.startswith("_c10d_functional") or name not in _KIND:
        return None
    kind, t = _KIND[name], args[0]
    nbytes = t.numel() * t.element_size()
    if kind == "all-gather":
        g = int(args[1])
        return kind, nbytes * g, g
    if kind == "reduce-scatter":
        g = int(args[2])
        return kind, nbytes // g, g
    if kind == "all-reduce":
        return kind, nbytes, _group_size(args[2])
    return kind, nbytes, _group_size(args[3])


def _in_shape_propagation() -> bool:
    """Whether DTensor is running an op on global-shape fake tensors only
    to learn its output's shape (``ShardingPropagator``), not as a
    rank's work."""
    f = sys._getframe(2)
    while f is not None:
        if f.f_code.co_name == "_propagate_tensor_meta_non_cached":
            return True
        f = f.f_back
    return False


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for y in x:
            yield from _tensors(y)
    elif isinstance(x, dict):
        for y in x.values():
            yield from _tensors(y)


_FREE = {"aten.empty", "aten.empty_strided", "aten.new_empty",
         "aten.new_empty_strided", "aten.empty_like", "prim.device",
         "aten.lift_fresh", "aten.detach", "aten.alias"}


class TraceRecorder(TorchDispatchMode):
    """Counts one rank's FLOPs, bytes, collectives and live memory while a
    DTensor step runs under it (see the module's docstring).  ``cuda``
    rounds each storage to the caching allocator's 512 B."""

    def __init__(self, device_type: str = "cuda"):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self._flops_of = flop_registry
        self.align = _ALLOC_ALIGN if device_type == "cuda" else 1
        self.flops = 0
        self.bytes = 0
        self.coll = CollectiveStats.empty()
        self.live = 0
        self.peak = 0
        self.timeline = {"forward": [], "backward": [], "update": []}
        self._phase = "forward"
        self._held: dict = {}          # id(storage) -> (weakref, bytes)

    # -- memory ----------------------------------------------------------
    def hold(self, tree) -> None:
        """Count the storages of ``tree``'s tensors (DTensors: their local
        shards) as live from now on, as the step's arguments."""
        from torch.distributed.tensor import DTensor
        for t in _tensors(tree):
            self._track(t._local_tensor if isinstance(t, DTensor) else t)
        self._note()

    def _note(self) -> None:
        if torch._C._current_autograd_node() is not None:
            self._phase = "backward"
        elif self._phase == "backward":
            self._phase = "update"
        self.peak = max(self.peak, self.live)
        self.timeline[self._phase].append(self.live)

    def _track(self, t: torch.Tensor) -> None:
        if t.device.type == "meta":        # a structure, not memory
            return
        st = t.untyped_storage()
        key = id(st)
        if key in self._held and self._held[key][0]() is st:
            return
        n = st.nbytes()
        n = -(-n // self.align) * self.align
        self._held[key] = (weakref.ref(st, lambda _, k=key: self._drop(k)),
                           n)
        self.live += n

    def _drop(self, key) -> None:
        ref, n = self._held.pop(key, (None, 0))
        self.live -= n

    # -- dispatch --------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        if func is torch.ops._c10d_functional.wait_tensor.default:
            # Eager wait_tensor returns its input; the fake kernel makes a
            # new tensor, which would count the result twice.
            return args[0]
        out = func(*args, **kwargs)
        if _in_shape_propagation():
            return out
        c = collective(func, args)
        if c is not None:
            kind, nbytes, g = c
            self.coll.bytes_by_kind[kind] += nbytes * _wire_factor(kind, g)
            self.coll.count_by_kind[kind] += 1
        else:
            packet = func._overloadpacket
            if packet in self._flops_of:
                self.flops += int(self._flops_of[packet](
                    *args, **kwargs, out_val=out))
            name = str(packet)
            if not func.is_view and name not in _FREE:
                seen = {}
                for t in list(_tensors(args)) + list(_tensors(kwargs)) + \
                        list(_tensors(out)):
                    if t.device.type != "meta":
                        seen[id(t)] = t.numel() * t.element_size()
                self.bytes += sum(seen.values())
        if not func.is_view:
            ins = {id(t.untyped_storage()) for t in _tensors(args)}
            for t in _tensors(out):
                if id(t.untyped_storage()) not in ins:
                    self._track(t)
        self._note()
        return out


@dataclasses.dataclass
class Roofline:
    flops: float
    bytes_accessed: float
    collective_bytes: float
    chips: int
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str
    model_flops: float
    useful_ratio: float
    collectives: CollectiveStats
    per_device_mem: float

    def row(self) -> dict:
        return {
            "flops": self.flops, "bytes": self.bytes_accessed,
            "coll_bytes": self.collective_bytes, "chips": self.chips,
            "compute_s": self.compute_s, "memory_s": self.memory_s,
            "collective_s": self.collective_s, "dominant": self.dominant,
            "model_flops": self.model_flops,
            "useful_ratio": self.useful_ratio,
            "per_device_mem_gb": self.per_device_mem / 1e9,
            "coll_by_kind": self.collectives.bytes_by_kind,
        }


def roofline(flops: float, byts: float, coll: CollectiveStats, chips: int,
             model_flops: float = 0.0, per_device_mem: float = 0.0
             ) -> Roofline:
    """The three terms from per-device counts, and the dominant one."""
    compute_s = flops / M.PEAK_FLOPS_BF16
    memory_s = byts / M.HBM_BW
    collective_s = coll.total_bytes / M.COLL_BW_PER_GPU
    dominant = max((("compute", compute_s), ("memory", memory_s),
                    ("collective", collective_s)), key=lambda kv: kv[1])[0]
    useful = model_flops / (flops * chips) if flops else 0.0
    return Roofline(flops=flops, bytes_accessed=byts,
                    collective_bytes=coll.total_bytes, chips=chips,
                    compute_s=compute_s, memory_s=memory_s,
                    collective_s=collective_s, dominant=dominant,
                    model_flops=model_flops, useful_ratio=useful,
                    collectives=coll, per_device_mem=per_device_mem)


def analyze(rec: TraceRecorder, chips: int,
            model_flops: float = 0.0) -> Roofline:
    """Roofline terms of one traced step (the recorder that watched it)."""
    return roofline(float(rec.flops), float(rec.bytes), rec.coll, chips,
                    model_flops, float(rec.peak))
