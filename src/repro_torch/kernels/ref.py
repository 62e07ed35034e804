"""Plain PyTorch oracles for every kernel of the port (port of
``repro.kernels.ref``, single-pattern signatures as in the reference;
``attention_ref`` is the port of ``repro.models.layers.attention_ref``,
the flash kernel's oracle)."""
from __future__ import annotations

import math

import torch

from repro_torch.core import shedder as _shedder
from repro_torch.core import utility as _utility


def nfa_advance_ref(state, bind, active, trans_col, ev_bind, final,
                    use_binding):
    """Oracle of one pattern's advance: plain gather semantics."""
    nxt = trans_col[state.long()]
    bind_ok = (bind == ev_bind) if use_binding else torch.ones_like(active)
    nxt = torch.where(active & bind_ok, nxt, state)
    completed = active & (nxt == final) & (state != final)
    return nxt, completed


def utility_lookup_ref(state, r_w, active, table, bin_size):
    """Oracle of one pattern's lookup (+inf sentinel on inactive slots)."""
    u = _utility.lookup_utility(table, bin_size, state, r_w)
    return torch.where(active, u, torch.full_like(u, 3.4e38))


def histogram_ref(u, lo, hi, nbins):
    edges = _shedder.bucket_edges(lo, hi, nbins)
    return ((u[:, None] >= edges[:-1][None]) &
            (u[:, None] < edges[1:][None])).sum(dim=0, dtype=torch.int32)


def shed_lowest_ref(active, state, r_w, table, rho, bin_size):
    """Oracle of ``ops.shed_lowest``: the sort-based Algorithm 2."""
    u = utility_lookup_ref(state, r_w, active, table, bin_size)
    return _shedder.drop_lowest_utility(
        active, torch.where(active, u, torch.full_like(u, float("inf"))),
        rho)


def attention_ref(q, k, v, *, causal=True, q_offset=0, scale=None):
    """Naive softmax attention in float32 (the flash oracle): q (B, Sq, H,
    D), k/v (B, Sk, KVH, ·), GQA via KVH | H; returns q's type."""
    B, Sq, H, Dk = q.shape
    _, Sk, KVH, _ = k.shape
    G = H // KVH
    if scale is None:
        scale = 1.0 / math.sqrt(Dk)
    kh = k.repeat_interleave(G, dim=2)
    vh = v.repeat_interleave(G, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kh.float()) * scale
    if causal:
        qpos = q_offset + torch.arange(Sq, device=q.device)
        mask = qpos[:, None] >= torch.arange(Sk, device=q.device)[None, :]
        s = torch.where(mask[None, None], s,
                        torch.full_like(s, float("-inf")))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p, vh.float())
    return out.to(q.dtype)
