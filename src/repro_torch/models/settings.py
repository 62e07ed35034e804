"""Model settings (port of ``repro.models.settings``).

The reference's settings serve its compiler: ``scan`` rolls the layer
loop into one HLO loop, ``constrain`` pins shardings on a mesh, and an
analysis mode coarsens the chunk sizes for the roofline lowering.  The
port runs eagerly: ``scan`` is a Python loop over the leading axis.
Under an active mesh (``use_mesh``, the dry-run's DTensor trace) the
same model code runs on DTensors, and ``constrain`` redistributes a
DTensor to the layout its axis names give — on a plain tensor it is the
identity, so no eager path on the card changes.  ``use_scheme`` picks
the parallelism scheme the specs and ``constrain`` follow;
``analysis_mode`` coarsens the flash and loss chunks to 4 096 (the
reference's, for its unrolled lowering; the port's roofline traces at
two depths under it, ``launch.roofline``).
"""
from __future__ import annotations

import contextlib
import contextvars

import torch

from repro_torch.kernels import flash_attention as _flash

_LOSS_CHUNK = contextvars.ContextVar("repro_torch_loss_chunk", default=512)
# Parallelism scheme: "tp" (TP over "model" + optional FSDP over "data"),
# "fsdp" (pure FSDP: batch over ALL axes, params sharded over data×model,
# no tensor parallelism), "moe2d" (TP + experts sharded (E × d_ff) 2-D).
_SCHEME = contextvars.ContextVar("repro_torch_scheme", default="tp")
# Flip attention activations to batch-over-(data×model) when heads don't
# divide the model axis.
_ATTN_BATCH_FLIP = contextvars.ContextVar("repro_torch_attn_flip",
                                          default=False)
# The DeviceMesh the model's DTensors live on (the counterpart of jax's
# active mesh, ``compat.use_mesh``).
_MESH = contextvars.ContextVar("repro_torch_mesh", default=None)


def scheme() -> str:
    return _SCHEME.get()


def attn_batch_flip() -> bool:
    return _ATTN_BATCH_FLIP.get()


@contextlib.contextmanager
def use_scheme(name: str = "tp", attn_flip: bool = False):
    t1 = _SCHEME.set(name)
    t2 = _ATTN_BATCH_FLIP.set(attn_flip)
    try:
        yield
    finally:
        _SCHEME.reset(t1)
        _ATTN_BATCH_FLIP.reset(t2)


def active_mesh():
    """The mesh of ``use_mesh``, or None."""
    return _MESH.get()


def register_rules() -> None:
    """The DTensor sharding rules the model needs beyond torch's own
    (once per process): the flash op's, and in-place ``cumsum_`` (the
    SSD's segment sums) sharded on any dim but the summed one."""
    _flash.register_dtensor_rule()
    if getattr(register_rules, "done", False):
        return
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import register_sharding

    @register_sharding(torch.ops.aten.cumsum_.default)
    def _cumsum_(x, dim, *args, **kwargs):
        d = dim % len(x.shape)
        rest = [None] * (1 + len(args))
        return [([p], [p] + rest) for p in
                [Replicate()] + [Shard(i) for i in range(len(x.shape))
                                 if i != d]]

    register_rules.done = True


@contextlib.contextmanager
def use_mesh(mesh):
    """Run the model on DTensors over ``mesh`` (a DeviceMesh): activates
    ``constrain`` and the cache's layout (``decode.init_cache``), treats
    the plain tensors the model makes (masks, positions, zeros) as
    replicated (DTensor's ``implicit_replication``) and registers the
    model's sharding rules (``register_rules``)."""
    from torch.distributed.tensor.experimental import implicit_replication
    register_rules()
    t = _MESH.set(mesh)
    try:
        with implicit_replication():
            yield
    finally:
        _MESH.reset(t)


def flash_chunks() -> tuple[int, int]:
    """(q_chunk, kv_chunk) of the plain flash attention in force."""
    return _flash.chunks()


def loss_chunk() -> int:
    return _LOSS_CHUNK.get()


@contextlib.contextmanager
def analysis_mode(flash_q: int = 4096, flash_kv: int = 4096,
                  loss_chunk_: int = 4096):
    """Coarsen the chunk granularity to the reference's analysis sizes
    (its roofline lowering's)."""
    t = _LOSS_CHUNK.set(loss_chunk_)
    try:
        with _flash.use_chunks(flash_q, flash_kv):
            yield
    finally:
        _LOSS_CHUNK.reset(t)


def constrain(x, *axes):
    """Lay out ``x`` by axis names, one entry per dim (None = replicated):
    under an active mesh a DTensor is redistributed to that layout (the
    reference's ``with_sharding_constraint``); a plain tensor, or no
    mesh, returns ``x`` as it is.  Axes absent from the mesh or not
    dividing the dim drop from the left; entries may be tuples;
    "data" gains a leading "pod" where the mesh has one; under the
    "fsdp" scheme "model" alone drops and a batch entry spreads over
    "model" too (the reference's rules)."""
    mesh = active_mesh()
    if mesh is None:
        return x
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    from repro_torch.dist.mesh import axis_size, dim_names
    from repro_torch.dist.sharding import placements
    names = set(dim_names(mesh))
    sch = scheme()
    spec = []
    for dim, ax in zip(x.shape, axes):
        if ax is None:
            spec.append(None)
            continue
        ax_t = (ax,) if isinstance(ax, str) else tuple(ax)
        if sch == "fsdp":
            if ax_t == ("model",):
                spec.append(None)
                continue
            if "data" in ax_t and "model" not in ax_t:
                ax_t = ax_t + ("model",)
        if "data" in ax_t and "pod" in names and "pod" not in ax_t:
            ax_t = ("pod",) + ax_t
        ax_t = tuple(a for a in ax_t if a in names)
        size = 1
        for a in ax_t:
            size *= axis_size(mesh, a)
        while ax_t and dim % size != 0:
            ax_t = ax_t[1:]
            size = 1
            for a in ax_t:
                size *= axis_size(mesh, a)
        spec.append(ax_t if ax_t else None)
    spec += [None] * (x.dim() - len(spec))
    pl = placements(mesh, tuple(spec))
    if tuple(x.placements) == tuple(pl):
        return x
    return x.redistribute(mesh, pl)


def gather_weights(tree):
    """FSDP's gather of weights about to be used: under an active mesh
    every DTensor of ``tree`` (a dict/tuple) replicated over the data
    axes ("pod", "data"; every axis under the "fsdp" scheme), its "model"
    shards kept; without a mesh ``tree`` itself.  Its gradient is the
    matching reduce-scatter."""
    mesh = active_mesh()
    if mesh is None:
        return tree
    from torch.distributed.tensor import DTensor, Replicate
    from repro_torch.dist.mesh import dim_names
    names = dim_names(mesh)
    drop = ("pod", "data") + (("model",) if scheme() == "fsdp" else ())

    def one(w):
        if isinstance(w, dict):
            return {k: one(v) for k, v in w.items()}
        if isinstance(w, (tuple, list)):
            return type(w)(one(v) for v in w)
        if not isinstance(w, DTensor):
            return w
        pl = tuple(Replicate() if names[i] in drop else p
                   for i, p in enumerate(w.placements))
        return w if pl == tuple(w.placements) else w.redistribute(mesh, pl)
    return one(tree)


class _Split(tuple):
    """A stack already split along its leading axis (``_unbound``)."""


def tree_index(tree, i: int):
    """Entry ``i`` of every tensor of a nested dict/tuple (a layer's
    parameters out of the stacked ones)."""
    if isinstance(tree, dict):
        return {k: tree_index(v, i) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)) and not isinstance(tree, _Split):
        return type(tree)(tree_index(v, i) for v in tree)
    return tree[i]


def _length(xs) -> int:
    while isinstance(xs, (dict, tuple, list)):
        xs = next(iter(xs.values())) if isinstance(xs, dict) else xs[0]
    return xs.shape[0]


def _unbound(tree):
    """``tree`` with every tensor that requires grad split along its
    leading axis once (``torch.unbind``): the gradient of the stack is
    then one ``stack`` of the steps' gradients, where indexing it step by
    step would allocate and add a whole stack of zeros per step."""
    if isinstance(tree, dict):
        return {k: _unbound(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_unbound(v) for v in tree)
    return _Split(torch.unbind(tree, 0)) if tree.requires_grad else tree


def scan(f, init, xs):
    """``lax.scan`` as a Python loop: ``f(carry, x_i) -> (carry, _)``
    over the leading axis of ``xs`` (stacks that require grad split once,
    ``_unbound``).  No caller of the port collects per-step outputs (the
    cache is written in place), so none are returned."""
    carry = init
    n = _length(xs)
    xs = _unbound(xs)
    for i in range(n):
        carry, _ = f(carry, tree_index(xs, i))
    return carry
