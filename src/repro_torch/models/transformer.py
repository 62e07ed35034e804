"""The decoder-LM of the model zoo (port of ``repro.models.transformer``):
init, embedding, the layer stack's forward and the LM head.

Covers the dense families (starcoder2, qwen1.5 with QKV bias, internlm2,
minitron), the VLM's LM backbone (internvl2, patch embeddings
prepended), the MoE family (deepseek-moe-16b; deepseek-v3 with MLA
attention), the SSM (mamba2: Mamba2 blocks only) and the hybrid (zamba2:
a Mamba2 backbone and one shared attention + MLP block, applied after
every ``hybrid_attn_every``-th layer with the same parameters).  Layer
parameters stay stacked along a leading L axis and the layer loop is
``settings.scan`` (a Python loop); the forward is inference only, so the
reference's ``remat`` has nothing to do here.  Encoder-decoder configs
raise ``NotImplementedError`` naming the ROADMAP item that ports them
(queue 1 item 6); ``chunked_ce_loss`` and ``forward_train`` wait for the
training slice.
"""
from __future__ import annotations

import math

import torch

from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import settings as SET
from repro_torch.models import ssm as SSM
from repro_torch.models.config import ModelConfig

# What each unported family waits for (ROADMAP queue 1 item 6).
_LATER = (("enc_dec", "6d", "the encoder-decoder (whisper)"),)


def check_supported(cfg: ModelConfig) -> None:
    """Raise for a config whose layers the port does not have yet."""
    for flag, item, what in _LATER:
        if getattr(cfg, flag):
            raise NotImplementedError(
                f"{cfg.name}: {what} are not ported yet — ROADMAP queue 1 "
                f"item 6 ({item}: {what}); the port serves the dense and "
                "MoE configs")


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def shared_slot(cfg: ModelConfig, idx: int) -> int | None:
    """The hybrid's shared block runs after layer ``idx`` when (idx + 1)
    is a multiple of ``hybrid_attn_every``; returns that application's
    cache slot (idx // every), or None (also for every non-hybrid)."""
    every = cfg.hybrid_attn_every
    if every and (idx + 1) % every == 0:
        return idx // every
    return None


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def init_params(cfg: ModelConfig, seed: int = 0, device=None) -> dict:
    """Random weights (the reference's distributions and layouts) drawn
    from a ``torch.Generator`` seeded with ``seed`` on ``device``."""
    check_supported(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    dtype = _dtype(cfg)
    Ln, d = cfg.num_layers, cfg.d_model
    embed = torch.randn((cfg.vocab_size, d), generator=gen,
                        dtype=torch.float32, device=dev)
    params: dict = {
        "embed": embed.mul_(1.0 / math.sqrt(d)).to(dtype),
        "final_norm": torch.ones((d,), dtype=dtype, device=dev),
    }
    del embed
    if not cfg.tie_embeddings:
        params["lm_head"] = L.init_dense(gen, d, cfg.vocab_size, dtype)
    if cfg.ssm:
        params["layers"] = {
            "norm1": torch.ones((Ln, d), dtype=dtype, device=dev),
            "mamba": SSM.init_mamba2(gen, cfg, dtype, lead=(Ln,))}
        if cfg.hybrid_attn_every:
            params["shared_attn"] = {
                "norm1": torch.ones((d,), dtype=dtype, device=dev),
                "attn": L.init_attention(gen, cfg, dtype),
                "norm2": torch.ones((d,), dtype=dtype, device=dev),
                "mlp": L.init_mlp(gen, d, cfg.d_ff, dtype)}
        return params
    init_attn = L.init_mla if cfg.use_mla else L.init_attention
    layers = {"norm1": torch.ones((Ln, d), dtype=dtype, device=dev),
              "attn": init_attn(gen, cfg, dtype, lead=(Ln,)),
              "norm2": torch.ones((Ln, d), dtype=dtype, device=dev)}
    if cfg.moe:
        layers["moe"] = L.init_moe(gen, cfg, dtype, lead=(Ln,))
    elif cfg.d_ff:
        layers["mlp"] = L.init_mlp(gen, d, cfg.d_ff, dtype, lead=(Ln,))
    params["layers"] = layers
    return params


# ---------------------------------------------------------------------------
# Full-sequence forward (prefill compute)
# ---------------------------------------------------------------------------

def _layer_fwd(cfg: ModelConfig, lp: dict, x: torch.Tensor):
    """One backbone layer (no cache).  Returns (x, aux_loss)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    h = L.rmsnorm(x, lp["norm1"], cfg.norm_eps)
    if cfg.ssm:
        return x + SSM.ssd_forward(lp["mamba"], h, cfg)[0], aux
    if cfg.use_mla:
        h = L.mla_block(lp["attn"], h, cfg)
    else:
        h = L.attention_block(lp["attn"], h, cfg)
    x = x + h
    h = L.rmsnorm(x, lp["norm2"], cfg.norm_eps)
    if cfg.moe:
        h, aux = L.moe_block(lp["moe"], h, cfg)
    elif cfg.d_ff:
        h = L.mlp_block(lp["mlp"], h)
    else:
        h = torch.zeros_like(x)
    return x + h, aux


def shared_fwd_kv(cfg: ModelConfig, sp: dict, x: torch.Tensor):
    """The hybrid's shared attention + MLP block over x (B, S, d), its
    attention on the flash kernel for CUDA tensors.  Returns (x, k, v),
    the block's K and V (B, S, KVH, hd) for the prefill's cache."""
    h = L.rmsnorm(x, sp["norm1"], cfg.norm_eps)
    pos = torch.arange(x.shape[1], device=x.device)
    q, k, v = L.attention_qkv(sp["attn"], h, cfg, pos)
    o = L.flash_attention(q, k, v, causal=True)
    x = x + torch.einsum("bshk,hkd->bsd", o, sp["attn"]["wo"])
    h = L.rmsnorm(x, sp["norm2"], cfg.norm_eps)
    return x + L.mlp_block(sp["mlp"], h), k, v


def backbone(cfg: ModelConfig, params: dict, x: torch.Tensor):
    """Run the stacked layers over x (B, S, d), the hybrid's shared block
    after every ``hybrid_attn_every``-th.  Returns (hidden,
    total_aux_loss)."""
    check_supported(cfg)

    def body(carry, lp):
        x, aux, idx = carry
        x, a = _layer_fwd(cfg, lp, x)
        if shared_slot(cfg, idx) is not None:
            x = shared_fwd_kv(cfg, params["shared_attn"], x)[0]
        return (x, aux + a, idx + 1), None

    aux0 = torch.zeros((), dtype=torch.float32, device=x.device)
    x, aux, _ = SET.scan(body, (x, aux0, 0), params["layers"])
    return x, aux


def embed_inputs(cfg: ModelConfig, params: dict, batch: dict) -> torch.Tensor:
    """tokens (+ stubbed patch embeddings) -> (B, S, d)."""
    x = params["embed"][batch["tokens"].long()]
    if cfg.vlm_patches and "patches" in batch:
        x = torch.cat([batch["patches"].to(x.dtype), x], dim=1)
    return x


def lm_head_logits(cfg: ModelConfig, params: dict,
                   h: torch.Tensor) -> torch.Tensor:
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return torch.einsum("bsd,dv->bsv", h, w.to(h.dtype))
