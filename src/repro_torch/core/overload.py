"""Overload detection & shed-amount computation (paper §III-E, Algorithm 1).

Port of ``repro.core.overload``.  Per input event the detector estimates
    l_e = l_q + l_p        (queueing + processing latency)
and triggers shedding when  l_e + l_s (+ b_s) > LB, with l_p = f(n_pm)
and l_s = g(n_pm) fitted regressions (linear or n·log2(n+1), the lower
SSE wins).  ``a·basis + b`` is one fused multiply-add, as the reference
evaluates it (``fp.fma``).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch import fp

LINEAR, NLOGN = 0, 1
_LN2 = torch.tensor(2.0).log().item()   # float32 log(2), as jnp.log(2.0)


class LatencyModel(NamedTuple):
    """l = a·basis(n) + b with basis either n or n·log2(n+1)."""
    a: torch.Tensor      # () float32
    b: torch.Tensor      # () float32
    kind: torch.Tensor   # () int32: LINEAR or NLOGN


def latency_model(a: float, b: float, kind: int = LINEAR,
                  device=None) -> LatencyModel:
    return LatencyModel(
        a=torch.tensor(a, dtype=torch.float32, device=device),
        b=torch.tensor(b, dtype=torch.float32, device=device),
        kind=torch.tensor(kind, dtype=torch.int32, device=device))


def _basis(n: torch.Tensor, kind) -> torch.Tensor:
    """n or n·log2(n+1); ``kind`` an int (a fit's candidate) or a tensor."""
    n = n.float()
    if isinstance(kind, int) and kind == LINEAR:
        return n
    nlogn = n * torch.log2(n + 1.0)
    if isinstance(kind, int):
        return nlogn
    return torch.where(kind == LINEAR, n, nlogn)


def xla_sum(v: torch.Tensor) -> torch.Tensor:
    """Σ v of a 1-D float32 tensor, rounded as the reference's jitted
    reductions round it on the CPU: XLA splits the sum into windows of
    32 consecutive elements (the padding centred, pad // 2 zeros first),
    sums each window left to right from 0, repeats on the partial sums
    until at most 32 remain, and sums those left to right.  Every add is
    one exactly rounded float32 add, so the result is the same on any
    device."""
    v = v.float().reshape(-1)
    while v.shape[0] > 32:
        n = v.shape[0]
        m = -(-n // 32)
        pad = m * 32 - n
        v = torch.nn.functional.pad(v, (pad // 2, pad - pad // 2))
        v = v.reshape(m, 32)
        acc = v[:, 0] + 0.0
        for j in range(1, 32):
            acc = acc + v[:, j]
        v = acc
    acc = torch.zeros((), dtype=torch.float32, device=v.device)
    for j in range(v.shape[0]):
        acc = acc + v[j]
    return acc


def _lstsq_1d(x, y, valid):
    """Weighted least squares for y = a·x + b (closed form), with the
    reference's rounding: the 0/1 weights select, every sum is
    ``xla_sum`` and b = my − a·mx is one fused multiply-add."""
    zero = torch.zeros_like(x)
    sw = torch.clamp_min(xla_sum(valid.float()), 1e-30)
    mx = xla_sum(torch.where(valid, x, zero)) / sw
    my = xla_sum(torch.where(valid, y, zero)) / sw
    dx = x - mx
    cov = xla_sum(torch.where(valid, dx, zero) * (y - my))
    var = torch.clamp_min(xla_sum(torch.where(valid, dx * dx, zero)),
                          1e-30)
    a = cov / var
    b = fp.fma(-a, mx, my)
    return a, b


def fit_latency_model(n_pm: torch.Tensor, latency: torch.Tensor,
                      valid: torch.Tensor | None = None) -> LatencyModel:
    """Fit both candidate regressions, keep the lower-SSE one (§III-E).
    The sums and the contracted sites round as the reference's jitted
    fit does on the CPU; on LINEAR data the fit is bitwise the
    reference's (an n·log2(n+1) basis goes through log2, whose libms
    differ)."""
    valid = torch.ones_like(latency, dtype=torch.bool) if valid is None \
        else valid.bool()

    def fit(kind):
        x = _basis(n_pm, kind)
        a, b = _lstsq_1d(x, latency, valid)
        a = torch.clamp_min(a, 1e-12)
        r = fp.fma(a, x, b) - latency
        sse = xla_sum(torch.where(valid, r * r, torch.zeros_like(r)))
        return a, b, sse

    a0, b0, e0 = fit(LINEAR)
    a1, b1, e1 = fit(NLOGN)
    pick_lin = e0 <= e1
    return LatencyModel(
        a=torch.where(pick_lin, a0, a1), b=torch.where(pick_lin, b0, b1),
        kind=torch.where(pick_lin, LINEAR, NLOGN).to(torch.int32))


def predict_latency(model: LatencyModel, n_pm) -> torch.Tensor:
    n = torch.as_tensor(n_pm, device=model.a.device)
    return fp.fma(model.a, _basis(n, model.kind), model.b)


def predict_latency_unfused(model: LatencyModel, n_pm) -> torch.Tensor:
    """``predict_latency`` with a·basis and + b rounded apart, as the
    reference's model builder evaluates it outside jit."""
    n = torch.as_tensor(n_pm, device=model.a.device)
    return model.a * _basis(n, model.kind) + model.b


def _newton(t: torch.Tensor) -> torch.Tensor:
    n = torch.clamp_min(t, 1.0)
    for _ in range(16):
        fn = n * torch.log2(n + 1.0) - t
        dfn = torch.log2(n + 1.0) + n / ((n + 1.0) * _LN2)
        n = torch.clamp(n - fn / torch.clamp_min(dfn, 1e-9), 0.0, 1e12)
    return n


def invert_latency(model: LatencyModel,
                   l_target: torch.Tensor) -> torch.Tensor:
    """n'_pm = f^{-1}(l'_p)  (Alg. 1 line 7).
    Linear: n = (l-b)/a.  n·log2(n+1): 16 fixed Newton steps."""
    t = torch.clamp_min((l_target - model.b) / model.a, 0.0)
    return torch.where(model.kind == LINEAR, t, _newton(t))


# The reference's name for the inverse its block kernel runs; the same
# function here.
invert_latency_lazy = invert_latency


class OverloadDecision(NamedTuple):
    shed: torch.Tensor   # () bool — does l_e + l_s (+ b_s) exceed LB?
    rho: torch.Tensor    # () int32 — PMs to drop (0 if not shedding)
    l_e: torch.Tensor    # () float32 — estimated event latency


def detect_overload(f_model: LatencyModel, g_model: LatencyModel,
                    l_q: torch.Tensor, n_pm: torch.Tensor,
                    latency_bound: float,
                    safety_buffer: float = 0.0) -> OverloadDecision:
    """Algorithm 1 on tensors: l'_p = LB - l_q - l_s;
    n'_pm = f^{-1}(l'_p);  rho = n_pm - n'_pm.  (The engine runs the same
    check on host scalars, ``detect_overload_host``.)"""
    n_pm_f = n_pm.float()
    l_p = predict_latency(f_model, n_pm_f)
    l_s = predict_latency(g_model, n_pm_f)
    l_e = l_q + l_p
    shed = l_e + l_s + safety_buffer > latency_bound
    l_p_new = torch.clamp_min(latency_bound - l_q - l_s - safety_buffer,
                              0.0)
    # +eps guards float32 round-down at exact solutions.
    n_keep = fp.to_int32(torch.floor(
        invert_latency(f_model, l_p_new) + 1e-4))
    rho = torch.where(shed, torch.clamp_min(n_pm - n_keep, 0),
                      torch.zeros_like(n_pm)).to(torch.int32)
    return OverloadDecision(shed=shed, rho=rho, l_e=l_e)


# ---------------------------------------------------------------------------
# Algorithm 1 on host float32 scalars.  The engine keeps the operator's
# scalar control state on the host (the PM store lives on the device), so
# the per-event check runs here: the same float32 operations, rounded
# one by one as numpy float32 scalars (fused multiply-adds via fp.fma32),
# which gives the reference's bits without a device launch per op.
# ---------------------------------------------------------------------------

F32 = fp.F32


class HostLatencyModel(NamedTuple):
    a: np.float32
    b: np.float32
    kind: int


def to_host(model: LatencyModel) -> HostLatencyModel:
    return HostLatencyModel(a=F32(model.a.item()), b=F32(model.b.item()),
                            kind=int(model.kind.item()))


def predict_latency_host(m: HostLatencyModel, n: np.float32) -> np.float32:
    n = F32(n)
    basis = n if m.kind == LINEAR else F32(n * np.log2(n + F32(1.0)))
    return fp.fma32(m.a, basis, m.b)


def invert_latency_host(m: HostLatencyModel, l_target) -> np.float32:
    t = max(F32((F32(l_target) - m.b) / m.a), F32(0.0))
    if m.kind == LINEAR:
        return t
    n = max(t, F32(1.0))
    one, ln2 = F32(1.0), F32(_LN2)
    for _ in range(16):
        fn = F32(n * np.log2(n + one)) - t
        dfn = np.log2(n + one) + n / ((n + one) * ln2)
        n = min(max(F32(n - fn / max(dfn, F32(1e-9))), F32(0.0)),
                F32(1e12))
    return F32(n)


def detect_overload_host(f: HostLatencyModel, g: HostLatencyModel,
                         l_q: np.float32, n_pm: int, latency_bound: float,
                         safety_buffer: float = 0.0
                         ) -> tuple[bool, int, np.float32]:
    """Algorithm 1 on host scalars → (shed, rho, l_e)."""
    n_f = F32(n_pm)
    l_p = predict_latency_host(f, n_f)
    l_s = predict_latency_host(g, n_f)
    l_e = F32(l_q + l_p)
    lb, sb = F32(latency_bound), F32(safety_buffer)
    shed = bool(F32(F32(l_e + l_s) + sb) > lb)
    l_p_new = max(F32(F32(F32(lb - l_q) - l_s) - sb), F32(0.0))
    n_keep = fp.to_int32_host(
        np.floor(F32(invert_latency_host(f, l_p_new) + F32(1e-4))))
    rho = max(n_pm - n_keep, 0) if shed else 0
    return shed, rho, l_e
