"""Float arithmetic of the plain reference.

Every float the reference computes is a float32 value rounded after each
operation, as the operator's simulated-time arithmetic states.  The
control of ``correct`` runs the same code with every result rounded
further to bfloat16 (``Arith("bfloat16")``), the nearest precision below
float32.  ``fma`` is the correctly rounded fused multiply-add: where the
operator's arithmetic contracts a product into a sum, it rounds once.
"""
from __future__ import annotations

import math
import struct

import numpy as np

F32 = np.float32
PRECISIONS = ("float32", "bfloat16")


def fma32(a, b, c) -> np.ndarray:
    """Correctly rounded float32 ``a*b + c`` over arrays.

    The float32 product is exact in float64, so the float64 sum is the
    exact value rounded once; rounding that to float32 can go wrong only
    where it fell on a midpoint between two float32 values (the low 29
    bits of its significand 1 followed by zeros).  There the sum is
    rounded to odd instead (the TwoSum error decides the sticky last
    bit), and a round-to-odd float64 rounds to float32 correctly
    (53 >= 24 + 2)."""
    a, b, c = np.asarray(a, F32), np.asarray(b, F32), np.asarray(c, F32)
    if a.size == 1 and b.size == 1 and c.size == 1:
        shape = np.broadcast_shapes(a.shape, b.shape, c.shape)
        return np.full(shape, _fma1(float(a.flat[0]), float(b.flat[0]),
                                    float(c.flat[0])), F32)
    p = np.multiply(a, b, dtype=np.float64)
    s = np.asarray(p + c)
    if ((s.view(np.int64) & _LOW29) == _MID29).any():
        c = c.astype(np.float64)
        bb = s - p
        err = (p - (s - bb)) + (c - bb)
        fix = (err != 0) & ((s.view(np.int64) & 1) == 0) & np.isfinite(s)
        s = np.where(fix, np.nextafter(s, np.where(err > 0, np.inf,
                                                   -np.inf)), s)
    return s.astype(F32)


_LOW29 = np.int64((1 << 29) - 1)    # float64 bits below float32's
_MID29 = np.int64(1 << 28)          # a float32 midpoint


def _fma1(a: float, b: float, c: float) -> np.float32:
    """``fma32`` of three float32 values given as Python floats."""
    p = a * b
    s = p + c
    if math.isfinite(s) and (struct.unpack("<q", struct.pack("<d", s))[0]
                             & 0x1FFFFFFF) == 0x10000000:
        bb = s - p
        err = (p - (s - bb)) + (c - bb)
        if err != 0.0:
            s = math.nextafter(s, math.inf if err > 0 else -math.inf)
    return F32(s)


def to_bf16(x) -> np.ndarray:
    """float32 values rounded to the nearest bfloat16 (ties to even),
    kept as float32."""
    x = np.array(x, F32)
    u = x.reshape(-1).view(np.uint32)
    bias = np.uint32(0x7FFF) + ((u >> np.uint32(16)) & np.uint32(1))
    out = ((u + bias) & np.uint32(0xFFFF0000)).view(F32).reshape(x.shape)
    return np.where(np.isnan(x), x, out).astype(F32)


class Arith:
    """``r`` rounds a float result to the run's precision; ``fma`` is the
    fused multiply-add at that precision."""

    def __init__(self, precision: str = "float32"):
        if precision not in PRECISIONS:
            raise ValueError(f"precision must be one of {PRECISIONS}: "
                             f"{precision!r}")
        self.precision = precision
        self.low = precision == "bfloat16"

    def r(self, x) -> np.ndarray:
        x = np.asarray(x, F32)
        return to_bf16(x) if self.low else x

    def fma(self, a, b, c) -> np.ndarray:
        return self.r(fma32(a, b, c))


def xla_sum(v: np.ndarray, ar: Arith) -> np.float32:
    """Sum of a 1-D float32 array in the order the operator's model fit
    uses: windows of 32 consecutive elements (the padding centred, the
    smaller half first), each summed left to right from 0, repeated on
    the partial sums until at most 32 remain, then left to right."""
    v = ar.r(np.asarray(v, F32).reshape(-1))
    while v.shape[0] > 32:
        n = v.shape[0]
        m = -(-n // 32)
        pad = m * 32 - n
        v = np.concatenate([np.zeros(pad // 2, F32), v,
                            np.zeros(pad - pad // 2, F32)]).reshape(m, 32)
        acc = ar.r(v[:, 0] + F32(0.0))
        for j in range(1, 32):
            acc = ar.r(acc + v[:, j])
        v = acc
    acc = F32(0.0)
    for j in range(v.shape[0]):
        acc = ar.r(acc + v[j])
    return F32(acc)
