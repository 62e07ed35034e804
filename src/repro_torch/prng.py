"""Threefry-2x32 in PyTorch, bitwise equal to ``jax.random``.

PM-BL draws its uniforms from the engine carry's key, so the port keeps
JAX's counter-based generator: ``PRNGKey``, ``split`` and ``uniform``
for the default ``threefry2x32`` implementation.  Both of JAX's layouts
are implemented; ``PARTITIONABLE`` is the default of the JAX release the
reference was pinned against (``jax_threefry_partitionable`` = True).

Keys are (2,) int32 tensors holding the bits of JAX's uint32 key words
(torch's uint32 support is partial).  The uint32 arithmetic runs in
int64, masked to 32 bits after every add.
"""
from __future__ import annotations

import contextlib

import torch

PARTITIONABLE = True

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


@contextlib.contextmanager
def layout(partitionable: bool):
    """Draw in the given layout inside the ``with`` block (sets
    ``PARTITIONABLE`` and restores it on exit)."""
    global PARTITIONABLE
    old = PARTITIONABLE
    PARTITIONABLE = partitionable
    try:
        yield
    finally:
        PARTITIONABLE = old


def _u32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.int64) & _MASK


def _as_i32(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x >= 2 ** 31, x - 2 ** 32, x).to(torch.int32)


def threefry2x32(k1, k2, x0, x1):
    """The 20-round Threefry-2x32 hash of counter pairs (x0, x1) under
    key (k1, k2); every argument an int64 tensor of uint32 values."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for blk in range(5):
        for r in _ROTATIONS[blk % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = (((x1 << r) | (x1 >> (32 - r))) & _MASK) ^ x0
        x0 = (x0 + ks[(blk + 1) % 3]) & _MASK
        x1 = (x1 + ks[(blk + 2) % 3] + (blk + 1)) & _MASK
    return x0, x1


def PRNGKey(seed: int, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` as the reference calls it: 64-bit
    types disabled, so the seed is a 32-bit integer, the high key word
    is 0 and the low word holds the seed's low 32 bits."""
    words = torch.tensor([0, int(seed) & _MASK], dtype=torch.int64,
                         device=device)
    return _as_i32(words)


def _counts(n: int, device):
    lo = torch.arange(n, dtype=torch.int64, device=device)
    return lo >> 32, lo & _MASK


def _hash_flat(key, n: int, partitionable: bool):
    """(bits1, bits2) of the n-counter hash in the given layout; a key of
    shape (..., 2) (lane-stacked keys) hashes each key's counters, giving
    (..., n) words."""
    k = _u32(key)
    k1, k2 = k[..., 0:1], k[..., 1:2]
    if partitionable:
        hi, lo = _counts(n, key.device)
        return threefry2x32(k1, k2, hi, lo)
    # Original layout: counters 0..n-1 (odd n padded with one 0), split
    # into halves that hash pairwise; the results concatenate back.
    cnt = torch.arange(n, dtype=torch.int64, device=key.device)
    if n % 2:
        cnt = torch.cat([cnt, cnt.new_zeros(1)])
    h = cnt.shape[0] // 2
    b0, b1 = threefry2x32(k1, k2, cnt[:h], cnt[h:])
    return torch.cat([b0, b1], dim=-1)[..., :n], None


def split(key: torch.Tensor, num: int = 2,
          partitionable: bool | None = None) -> torch.Tensor:
    """``jax.random.split(key, num)`` → (num, 2) int32 keys; for
    lane-stacked keys (..., 2) each lane's split, (..., num, 2)."""
    part = PARTITIONABLE if partitionable is None else partitionable
    lead = tuple(key.shape[:-1])
    if part:
        b1, b2 = _hash_flat(key, num, True)
        return _as_i32(torch.stack([b1, b2], dim=-1))
    bits, _ = _hash_flat(key, 2 * num, False)
    return _as_i32(bits.reshape(lead + (num, 2)))


def random_bits(key: torch.Tensor, n: int,
                partitionable: bool | None = None) -> torch.Tensor:
    """The n 32-bit words ``jax.random.bits`` draws (int64, uint32 values);
    (..., n) for lane-stacked keys."""
    part = PARTITIONABLE if partitionable is None else partitionable
    b1, b2 = _hash_flat(key, n, part)
    return b1 ^ b2 if part else b1


def uniform(key: torch.Tensor, shape, partitionable: bool | None = None
            ) -> torch.Tensor:
    """``jax.random.uniform(key, shape)`` in [0, 1), float32; for
    lane-stacked keys (..., 2) each lane's draw, (...) + shape."""
    shape = (shape,) if isinstance(shape, int) else tuple(shape)
    n = 1
    for d in shape:
        n *= d
    bits = random_bits(key, n, partitionable)
    fbits = _as_i32((bits >> 9) | 0x3F800000)
    floats = fbits.view(torch.float32) - 1.0
    return torch.clamp_min(floats, 0.0).reshape(tuple(key.shape[:-1]) +
                                                shape)
