"""Serving forward passes: prefill (cache build) and single-token decode
(port of ``repro.models.decode``, the dense non-MLA path).

Prefill runs the flash kernel in every layer; decode attends densely over
the cache, one token's scores over the Smax cached positions in float32
(``_gqa_cached_attn``), as the reference leaves it to XLA.

The cache is ``{"pos": () int32, "k": (L, B, Smax, KVH, hd), "v": ...}``.
Unlike the reference's immutable arrays, ``decode_step`` writes the new
token's K/V into the cache tensors in place (a copy of the whole cache per
step would cost more than the step) and returns a new dict that shares
them, with ``pos`` advanced.  The write position is clamped into
[0, Smax - 1] as ``jax.lax.dynamic_update_slice`` clamps it.  SSM, hybrid,
MLA and encoder-decoder configs raise ``NotImplementedError``.
"""
from __future__ import annotations

import math

import torch

from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import settings as SET
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import (_dtype, check_supported,
                                            embed_inputs, lm_head_logits)


# ---------------------------------------------------------------------------
# Cache construction
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=None,
               device=None) -> dict:
    check_supported(cfg)
    dev = resolve_device(device)
    dt = dtype or _dtype(cfg)
    shape = (cfg.num_layers, batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    return {"pos": torch.zeros((), dtype=torch.int32, device=dev),
            "k": torch.zeros(shape, dtype=dt, device=dev),
            "v": torch.zeros(shape, dtype=dt, device=dev)}


# ---------------------------------------------------------------------------
# Cached attention
# ---------------------------------------------------------------------------

def _gqa_cached_attn(p: dict, x: torch.Tensor, kc: torch.Tensor,
                     vc: torch.Tensor, pos: torch.Tensor, cfg: ModelConfig):
    """x: (B, d) one token; kc/vc: (B, Smax, KVH, hd), written in place at
    ``pos``.  Returns (out (B, d), kc, vc)."""
    B, d = x.shape
    H, KVH, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    G = H // KVH
    q = torch.einsum("bd,dhk->bhk", x, p["wq"])
    k_new = torch.einsum("bd,dhk->bhk", x, p["wk"])
    v_new = torch.einsum("bd,dhk->bhk", x, p["wv"])
    if cfg.qkv_bias:
        q, k_new, v_new = q + p["bq"], k_new + p["bk"], v_new + p["bv"]
    posv = pos.expand(B, 1)
    q = L.apply_rope(q[:, None], posv, cfg.rope_theta)[:, 0]
    k_new = L.apply_rope(k_new[:, None], posv, cfg.rope_theta)
    at = pos.clamp(0, kc.shape[1] - 1).reshape(1).long()
    kc.index_copy_(1, at, k_new.to(kc.dtype))
    vc.index_copy_(1, at, v_new[:, None].to(vc.dtype))
    qg = q.reshape(B, KVH, G, hd)
    s = torch.einsum("bkgh,bskh->bkgs", qg.float(), kc.float()) / \
        math.sqrt(hd)
    valid = torch.arange(kc.shape[1], device=x.device) <= pos
    s = torch.where(valid[None, None, None, :], s,
                    torch.full_like(s, float("-inf")))
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgs,bskh->bkgh", w, vc.float())
    o = o.reshape(B, H, hd).to(x.dtype)
    return torch.einsum("bhk,hkd->bd", o, p["wo"]), kc, vc


# ---------------------------------------------------------------------------
# Decode step (one token for the whole batch)
# ---------------------------------------------------------------------------

def decode_step(cfg: ModelConfig, params: dict, cache: dict,
                tokens: torch.Tensor) -> tuple[torch.Tensor, dict]:
    """tokens: (B,) int — the newest token per sequence.  Returns (logits
    (B, V), the cache advanced by one position; its K/V tensors are the
    input's, written in place)."""
    check_supported(cfg)
    pos = cache["pos"]
    x = params["embed"][tokens.long()]                 # (B, d)

    def body(x, inp):
        lp, kc, vc = inp
        h = L.rmsnorm(x, lp["norm1"], cfg.norm_eps)
        h, _, _ = _gqa_cached_attn(lp["attn"], h, kc, vc, pos, cfg)
        x = x + h
        h = L.rmsnorm(x, lp["norm2"], cfg.norm_eps)
        h = L.mlp_block(lp["mlp"], h) if cfg.d_ff else torch.zeros_like(x)
        return x + h, None

    x = SET.scan(body, x, (params["layers"], cache["k"], cache["v"]))
    h = L.rmsnorm(x, params["final_norm"], cfg.norm_eps)
    logits = lm_head_logits(cfg, params, h[:, None])[:, 0]
    new_cache = dict(cache)
    new_cache["pos"] = pos + 1
    return logits, new_cache


# ---------------------------------------------------------------------------
# Prefill
# ---------------------------------------------------------------------------

def prefill(cfg: ModelConfig, params: dict, batch: dict,
            max_len: int) -> tuple[dict, torch.Tensor]:
    """Run the full prompt (``batch["tokens"]`` (B, S) [+ ``patches``]),
    building the cache.  Returns (cache, logits of the last position)."""
    check_supported(cfg)
    x = embed_inputs(cfg, params, batch)
    B, Sq, _ = x.shape
    if max_len < Sq:
        raise ValueError(f"prefill: max_len {max_len} < prompt length {Sq}")
    pos = torch.arange(Sq, device=x.device)
    cache = init_cache(cfg, B, max_len, device=x.device)

    def body(x, inp):
        lp, kc, vc = inp
        h = L.rmsnorm(x, lp["norm1"], cfg.norm_eps)
        q, k, v = L.attention_qkv(lp["attn"], h, cfg, pos)
        o = L.flash_attention(q, k, v, causal=True)
        x = x + torch.einsum("bshk,hkd->bsd", o, lp["attn"]["wo"])
        h = L.rmsnorm(x, lp["norm2"], cfg.norm_eps)
        h = L.mlp_block(lp["mlp"], h) if cfg.d_ff else torch.zeros_like(x)
        kc[:, :Sq] = k.to(kc.dtype)
        vc[:, :Sq] = v.to(vc.dtype)
        return x + h, None

    x = SET.scan(body, x, (params["layers"], cache["k"], cache["v"]))
    h = L.rmsnorm(x, params["final_norm"], cfg.norm_eps)
    logits = lm_head_logits(cfg, params, h[:, -1:, :])[:, 0]
    cache["pos"] = torch.tensor(Sq, dtype=torch.int32, device=x.device)
    return cache, logits
