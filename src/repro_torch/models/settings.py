"""Model settings (port of ``repro.models.settings``).

The reference's settings serve its compiler: ``scan`` rolls the layer
loop into one HLO loop, ``constrain`` pins shardings on a mesh, and an
analysis mode unrolls and coarsens everything for the roofline lowering.
The port runs eagerly on one card, so ``scan`` is a Python loop over
the leading axis, ``constrain`` has nothing to do (sharding is the
``dist`` slice) and is left out, and the chunk sizes keep the
reference's defaults.
"""
from __future__ import annotations

from repro_torch.kernels import flash_attention as _flash

LOSS_CHUNK = 512


def flash_chunks() -> tuple[int, int]:
    """(q_chunk, kv_chunk) of the plain flash attention."""
    return _flash.Q_CHUNK, _flash.KV_CHUNK


def loss_chunk() -> int:
    return LOSS_CHUNK


def tree_index(tree, i: int):
    """Entry ``i`` of every tensor of a nested dict/tuple (a layer's
    parameters out of the stacked ones)."""
    if isinstance(tree, dict):
        return {k: tree_index(v, i) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_index(v, i) for v in tree)
    return tree[i]


def _length(xs) -> int:
    while isinstance(xs, (dict, tuple, list)):
        xs = next(iter(xs.values())) if isinstance(xs, dict) else xs[0]
    return xs.shape[0]


def scan(f, init, xs):
    """``lax.scan`` as a Python loop: ``f(carry, x_i) -> (carry, _)``
    over the leading axis of ``xs``.  No caller of the port collects
    per-step outputs (the cache is written in place), so none are
    returned."""
    carry = init
    for i in range(_length(xs)):
        carry, _ = f(carry, tree_index(xs, i))
    return carry
