"""SEQ advance of the whole (P, N) PM store against one event.

Port of ``repro.kernels.nfa_transition``.  The TPU kernel rewrote the
per-PM gather ``next = trans[state, class]`` as a one-hot MXU matmul and
ran once per pattern; the CUDA kernel (``csrc/nfa_transition.cu``)
gathers directly and covers all P patterns in one launch, with the
binding check and the completion flag fused in and the ragged tail
masked in-kernel.

``nfa_advance`` launches the kernel for CUDA tensors and computes
``nfa_advance_plain`` (the same function in plain PyTorch) for CPU
tensors; nothing falls back from one to the other.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build


def nfa_advance_plain(state, bind, active, trans, ev_class, ev_bind,
                      final_state, uses_binding):
    """Plain PyTorch version: returns (new_state (P, N) int32,
    completed (P, N) bool)."""
    P, N = state.shape
    M, C1 = trans.shape[1], trans.shape[2]
    cls = ev_class.long()[:, None]
    ok = (state >= 0) & (state < M) & (cls >= 0) & (cls < C1)
    pidx = torch.arange(P, device=state.device)[:, None]
    flat = (pidx * M + state.long().clamp(0, M - 1)) * C1 + \
        cls.clamp(0, C1 - 1)
    nxt = trans.reshape(-1)[flat]
    bind_ok = ~uses_binding[:, None] | (bind == ev_bind[:, None])
    live = active
    new_state = torch.where(live & bind_ok & ok, nxt, state)
    final = final_state[:, None]
    completed = live & (new_state == final) & (state != final)
    return new_state, completed


def _check(name, t, dtype, shape):
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) or \
            not t.is_contiguous():
        raise ValueError(f"nfa_advance: {name} must be a contiguous {dtype} "
                         f"of shape {tuple(shape)}, got {t.dtype} "
                         f"{tuple(t.shape)}")


def nfa_advance(state: torch.Tensor, bind: torch.Tensor,
                active: torch.Tensor, trans: torch.Tensor,
                ev_class: torch.Tensor, ev_bind: torch.Tensor,
                final_state: torch.Tensor, uses_binding: torch.Tensor):
    """Advance every PM of every pattern against one event.

    state/bind (P, N) int32, active (P, N) bool, trans (P, M, C+1) int32,
    ev_class/ev_bind/final_state (P,) int32, uses_binding (P,) bool.
    Returns (new_state (P, N) int32, completed (P, N) bool).
    """
    if state.device.type == "cpu":
        return nfa_advance_plain(state, bind, active, trans, ev_class,
                                 ev_bind, final_state, uses_binding)
    if state.device.type != "cuda":
        raise ValueError(f"nfa_advance: unsupported device {state.device}")
    P, N = state.shape
    _, M, C1 = trans.shape
    for name, t, dt, shp in (
            ("state", state, torch.int32, (P, N)),
            ("bind", bind, torch.int32, (P, N)),
            ("active", active, torch.bool, (P, N)),
            ("trans", trans, torch.int32, (P, M, C1)),
            ("ev_class", ev_class, torch.int32, (P,)),
            ("ev_bind", ev_bind, torch.int32, (P,)),
            ("final_state", final_state, torch.int32, (P,)),
            ("uses_binding", uses_binding, torch.bool, (P,))):
        _check(name, t, dt, shp)
        if t.device != state.device:
            raise ValueError(f"nfa_advance: {name} on {t.device}")
    new_state = torch.empty_like(state)
    completed = torch.empty_like(active)
    lib = _build.load()
    stream = torch.cuda.current_stream(state.device).cuda_stream
    _build.check(lib.nfa_advance_launch(
        state.data_ptr(), bind.data_ptr(), active.data_ptr(),
        trans.data_ptr(), ev_class.data_ptr(), ev_bind.data_ptr(),
        final_state.data_ptr(), uses_binding.data_ptr(), P, N, M, C1,
        new_state.data_ptr(), completed.data_ptr(), stream), "nfa_advance")
    nfa_advance.launches += 1
    return new_state, completed


nfa_advance.launches = 0


def empty_kernels(count: int, device=None) -> None:
    """Launch ``count`` empty kernels back to back on ``device``'s current
    stream (CUDA only): what a launch costs the card with no work in it,
    the floor the per-event kernels are held against."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda":
        raise ValueError(f"empty_kernels: needs a CUDA device, got {dev}")
    _build.check(_build.load().empty_kernel_launch(
        int(count), torch.cuda.current_stream(dev).cuda_stream),
        "empty_kernel")
