"""Error-feedback int8 gradient compression for the data-parallel
all-reduce (port of ``repro.training.compression``).

Each gradient is quantized to int8 against a per-tensor scale before the
sum, and the quantization residual stays local (error feedback).  The
reference's ``compressed_psum`` runs inside a ``shard_map`` over a named
axis; here the axis is a ``torch.distributed`` process group (the whole
world by default, or a mesh dim's group, ``dist.mesh.axis_group``): the
shared scale by ``all_reduce(MAX)``, the int8 values summed as int32 by
``all_reduce(SUM)``, divided by the group's rank count.  Rounding is
half to even (``torch.round``), as ``jnp.round``.

The reference's collective runs only compiled, where XLA turns the scale's
``/ 127`` into ``* (1/127)`` and ``corrected - q * scale`` into one
fused multiply-add: ``compressed_psum`` rounds both so.
``quantize_int8`` and ``compress_decompress`` round as the reference's
eager calls do.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch import fp
from repro_torch.training.tree import leaves, tree_map, unflatten


def quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(int8 values, float32 scale = max|x| / 127)."""
    scale = torch.clamp_min(x.abs().max(), 1e-12) / 127.0
    return _quantize(x, scale), scale


def _quantize(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def init_error_state(grads_like):
    return tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                          device=g.device), grads_like)


def compress_decompress(g: torch.Tensor, err: torch.Tensor):
    """One error-feedback round without the collective: returns
    (decompressed, new_err)."""
    corrected = g.float() + err
    q, scale = quantize_int8(corrected)
    deq = dequantize_int8(q, scale)
    return deq, corrected - deq


def compressed_psum(g: torch.Tensor, err: torch.Tensor, group=None):
    """The mean of ``g`` over the ranks of ``group``, sent as int8: the
    ranks agree on the largest scale first (so the int32 sum dequantizes
    exactly), quantize against it, sum in int32 and dequantize.  Returns
    (mean, new_err)."""
    corrected = g.float() + err
    scale = torch.clamp_min(corrected.abs().max(), 1e-12) * (1.0 / 127.0)
    dist.all_reduce(scale, op=dist.ReduceOp.MAX, group=group)
    q = _quantize(corrected, scale)
    new_err = fp.fma(-q.float(), scale, corrected)     # XLA contracts it
    total = q.to(torch.int32)
    dist.all_reduce(total, op=dist.ReduceOp.SUM, group=group)
    n = float(dist.get_world_size(group))
    return total.float() * scale / n, new_err


def sync_tree(grads, err, group=None):
    """``compressed_psum`` over every leaf, in the reference's leaf
    order.  Returns (mean_grads, new_err)."""
    out = [compressed_psum(g, e, group)
           for g, e in zip(leaves(grads), leaves(err))]
    return (unflatten(grads, [o[0] for o in out]),
            unflatten(grads, [o[1] for o in out]))


def wire_bytes_saved(grads) -> tuple[int, int]:
    """(float32 bytes, int8 bytes) per all-reduce round."""
    n = sum(int(g.numel()) for g in leaves(grads))
    return 4 * n, n
