"""Float32 helpers that pin the rounding of the reference engine.

The reference runs under XLA on the CPU, which contracts ``a*b + c``
into one fused multiply-add wherever the product feeds the add inside
one fusion.  PyTorch rounds every elementwise op separately, so each
contracted site of the reference goes through :func:`fma` here, which is
the correctly rounded float32 FMA on any device.

XLA also saturates float→int32 conversion (NaN → 0), where a plain
``.to(torch.int32)`` of an out-of-range float is undefined;
:func:`to_int32` reproduces XLA's conversion.
"""
from __future__ import annotations

import math
import struct

import numpy as np
import torch

_I32_MAX_F = 2147483648.0     # 2**31, exact in float32
F32 = np.float32


def fma32(a, b, c) -> np.float32:
    """:func:`fma` for host scalars: correctly rounded float32
    ``a*b + c`` (each argument first rounded to float32)."""
    a, b, c = float(F32(a)), float(F32(b)), float(F32(c))
    p = a * b                      # exact: 24 + 24 bits < 53
    s = p + c
    if math.isfinite(s):
        bb = s - p
        err = (p - (s - bb)) + (c - bb)
        if err != 0.0 and not struct.unpack("<q", struct.pack("<d", s))[0] & 1:
            s = math.nextafter(s, math.inf if err > 0 else -math.inf)
    return F32(s)


def nan_max32(a, b) -> np.float32:
    """``jnp.maximum`` of two host float32 scalars: a NaN in either
    argument is the result (Python's ``max`` drops one in its second)."""
    a, b = F32(a), F32(b)
    if np.isnan(a):
        return a
    if np.isnan(b):
        return b
    return max(a, b)


def to_int32_host(x) -> int:
    """:func:`to_int32` for a host scalar."""
    x = float(x)
    if math.isnan(x):
        return 0
    if x >= _I32_MAX_F:
        return 2147483647
    if x <= -_I32_MAX_F:
        return -2147483648
    return int(x)


def fma(a, b, c) -> torch.Tensor:
    """Correctly rounded float32 ``a*b + c`` (one rounding).

    The product of two float32 values is exact in float64; the float64
    sum is rounded to odd (TwoSum error + sticky last bit), and rounding
    a round-to-odd float64 to float32 is correctly rounded because
    53 >= 24 + 2.  Scalars and tensors broadcast as in ``a*b + c``.
    """
    ref = next(x for x in (a, b, c) if isinstance(x, torch.Tensor))
    a64, b64, c64 = (torch.as_tensor(x, dtype=torch.float32,
                                     device=ref.device).double()
                     for x in (a, b, c))
    p = a64 * b64
    s = p + c64
    bb = s - p
    err = (p - (s - bb)) + (c64 - bb)
    bits = s.view(torch.int64)
    fix = (err != 0) & ((bits & 1) == 0) & torch.isfinite(s)
    away = (err > 0) == (s > 0)
    bits = torch.where(fix, torch.where(away, bits + 1, bits - 1), bits)
    return bits.view(torch.float64).float()


def to_int32(x: torch.Tensor) -> torch.Tensor:
    """float32 → int32 with XLA's saturating semantics (NaN → 0)."""
    lo = x.clamp(-_I32_MAX_F, 2147483520.0)      # largest f32 below 2**31
    out = torch.nan_to_num(lo, nan=0.0).to(torch.int32)
    return torch.where(x >= _I32_MAX_F,
                       torch.full_like(out, 2147483647), out)
