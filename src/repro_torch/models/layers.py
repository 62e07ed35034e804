"""Shared layers of the dense model zoo (port of ``repro.models.layers``):
norms, RoPE, flash attention, GQA attention and the gated MLP.

Parameters are nested dicts of tensors with the reference's layouts
(``wq`` (d, H, hd), ``wo`` (H, hd, d)), and every function is pure.
``flash_attention`` is the kernel's wrapper: the hand-written CUDA kernel
for CUDA tensors, its plain version for CPU tensors.  MLA
(``layers.py:254-308``) and MoE (``:332-391``) wait for later slices
(ROADMAP queue 1 item 11).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models.config import ModelConfig


# ---------------------------------------------------------------------------
# Norms & embeddings
# ---------------------------------------------------------------------------

def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps)
    return (x * scale).to(dt)


def init_dense(gen: torch.Generator, d_in: int, d_out: int, dtype, *,
               lead: tuple = ()) -> torch.Tensor:
    """N(0, 1/d_in) weights of shape lead + (d_in, d_out), drawn in float32
    from ``gen`` (on the device the weights go to) and cast to ``dtype``."""
    w = torch.randn(lead + (d_in, d_out), generator=gen, dtype=torch.float32,
                    device=gen.device)
    return (w * (1.0 / math.sqrt(d_in))).to(dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    # theta stays a Python scalar: a tensor made from it would be a host
    # copy, which makes the stream wait on every call.
    ar = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device)
    return 1.0 / (theta ** (ar / head_dim))


def apply_rope(x: torch.Tensor, pos: torch.Tensor,
               theta: float = 1e4) -> torch.Tensor:
    """x: (..., S, H, D) with pos (..., S) or (S,)."""
    D = x.shape[-1]
    freqs = rope_freqs(D, theta, x.device)                 # (D/2,)
    angles = pos[..., None].float() * freqs                # (..., S, D/2)
    cos = torch.cos(angles)[..., None, :]                  # (..., S, 1, D/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# GQA attention block
# ---------------------------------------------------------------------------

def init_attention(gen: torch.Generator, cfg: ModelConfig, dtype, *,
                   lead: tuple = ()) -> dict:
    d, H, KVH, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    p = {
        "wq": init_dense(gen, d, H * hd, dtype, lead=lead).reshape(
            lead + (d, H, hd)),
        "wk": init_dense(gen, d, KVH * hd, dtype, lead=lead).reshape(
            lead + (d, KVH, hd)),
        "wv": init_dense(gen, d, KVH * hd, dtype, lead=lead).reshape(
            lead + (d, KVH, hd)),
        "wo": init_dense(gen, H * hd, d, dtype, lead=lead).reshape(
            lead + (H, hd, d)),
    }
    if cfg.qkv_bias:
        z = lambda *s: torch.zeros(lead + s, dtype=dtype,  # noqa: E731
                                   device=gen.device)
        p["bq"], p["bk"], p["bv"] = z(H, hd), z(KVH, hd), z(KVH, hd)
    return p


def attention_qkv(p: dict, x: torch.Tensor, cfg: ModelConfig,
                  pos: torch.Tensor):
    """Project to q, k, v with RoPE applied (each contiguous)."""
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"])
    if cfg.qkv_bias:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    q = apply_rope(q, pos, cfg.rope_theta)
    k = apply_rope(k, pos, cfg.rope_theta)
    return q, k, v.contiguous()


def attention_block(p: dict, x: torch.Tensor,
                    cfg: ModelConfig) -> torch.Tensor:
    """Causal self-attention over the whole sequence (prefill)."""
    pos = torch.arange(x.shape[1], device=x.device)
    q, k, v = attention_qkv(p, x, cfg, pos)
    return torch.einsum("bshk,hkd->bsd", flash_attention(q, k, v), p["wo"])


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

def init_mlp(gen: torch.Generator, d: int, ff: int, dtype, *,
             lead: tuple = ()) -> dict:
    return {"wi": init_dense(gen, d, ff, dtype, lead=lead),
            "wg": init_dense(gen, d, ff, dtype, lead=lead),
            "wo": init_dense(gen, ff, d, dtype, lead=lead)}


def mlp_block(p: dict, x: torch.Tensor) -> torch.Tensor:
    h = F.silu(x @ p["wg"]) * (x @ p["wi"])
    return h @ p["wo"]
