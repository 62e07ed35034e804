"""Tail-padding helpers (port of ``repro.kernels.tiling``).

The CUDA kernels mask the ragged edge themselves and need no host
padding; these helpers remain for callers that want tile-multiple
buffers (and for parity with the reference's padding arithmetic).
"""
from __future__ import annotations

import torch


def tile_pad(tile: int, n: int) -> int:
    """Elements of tail padding needed to reach a multiple of ``tile``."""
    return (-n) % tile


def pad_to_tile(tile: int, *pairs):
    """Pad each ``(tensor, fill)`` pair's dim 0 to a multiple of ``tile``.

    Returns ``(padded_0, ..., padded_k, pad)``; ``pad`` is the tail length
    callers slice back off (0 when the length already divides).
    """
    n = pairs[0][0].shape[0]
    pad = tile_pad(tile, n)
    if not pad:
        return tuple(x for x, _ in pairs) + (0,)
    padded = tuple(
        torch.cat([x, torch.full((pad,) + tuple(x.shape[1:]), fill,
                                 dtype=x.dtype, device=x.device)])
        for x, fill in pairs)
    return padded + (pad,)
