"""The model zoo's transformer (port of ``repro.models.transformer``):
init, embedding, the layer stack's forward, the encoder, the LM head and
the training loss.

Covers the dense families (starcoder2, qwen1.5 with QKV bias, internlm2,
minitron), the VLM's LM backbone (internvl2, patch embeddings
prepended), the MoE family (deepseek-moe-16b; deepseek-v3 with MLA
attention), the SSM (mamba2: Mamba2 blocks only), the hybrid (zamba2:
a Mamba2 backbone and one shared attention + MLP block, applied after
every ``hybrid_attn_every``-th layer with the same parameters) and the
encoder-decoder (whisper: a non-causal encoder over stubbed
conv-frontend frames with a sinusoid added, and decoder layers of
self-attention, cross-attention over the encoder's output and an MLP).
Layer parameters stay stacked along a leading L axis and the layer loop
is ``settings.scan`` (a Python loop).  ``forward_train`` is
differentiable by autograd (the flash kernel's gradient is its plain
version's, ``kernels.flash_attention``); with ``remat`` (the default,
as the reference's ``jax.checkpoint``) each layer of the backbone and
the encoder runs under ``torch.utils.checkpoint`` and is recomputed in
the backward, so only the layers' inputs are kept.  ``param_structs``
gives the parameters' shapes and dtypes on the meta device, drawing
nothing (the dry-run's structures).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import settings as SET
from repro_torch.models import ssm as SSM
from repro_torch.models.config import ModelConfig


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
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return _params(cfg, gen)


def param_structs(cfg: ModelConfig) -> dict:
    """``init_params``' tree as meta tensors: its shapes and dtypes, no
    draw and no memory (the counterpart of ``jax.eval_shape`` over
    ``init_params``)."""
    return _params(cfg, L.STRUCTURE)


def _params(cfg: ModelConfig, gen) -> dict:
    dev = gen.device
    dtype = _dtype(cfg)
    Ln, d = cfg.num_layers, cfg.d_model
    embed = L.normal(gen, (cfg.vocab_size, d))
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
    if cfg.enc_dec:
        Le = cfg.enc_layers
        params["enc_layers"] = {
            "norm1": torch.ones((Le, d), dtype=dtype, device=dev),
            "attn": L.init_attention(gen, cfg, dtype, lead=(Le,)),
            "norm2": torch.ones((Le, d), dtype=dtype, device=dev),
            "mlp": L.init_mlp(gen, d, cfg.d_ff, dtype, lead=(Le,))}
        params["enc_final_norm"] = torch.ones((d,), dtype=dtype, device=dev)
        params["cross_layers"] = {
            "norm": torch.ones((Ln, d), dtype=dtype, device=dev),
            "attn": L.init_attention(gen, cfg, dtype, lead=(Ln,))}
    return params


# ---------------------------------------------------------------------------
# Full-sequence forward (train / prefill compute)
# ---------------------------------------------------------------------------

def _layer_fwd(cfg: ModelConfig, lp: dict, x: torch.Tensor,
               causal_skip: bool = True):
    """One backbone layer (no cache).  Returns (x, aux_loss)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    h = L.rmsnorm(x, lp["norm1"], cfg.norm_eps)
    if cfg.ssm:
        return x + SSM.ssd_forward(lp["mamba"], h, cfg)[0], aux
    if cfg.use_mla:
        h = L.mla_block(lp["attn"], h, cfg, causal_skip=causal_skip)
    else:
        h = L.attention_block(lp["attn"], h, cfg, causal_skip=causal_skip)
    x = x + h
    h = L.rmsnorm(x, lp["norm2"], cfg.norm_eps)
    if cfg.moe:
        h, aux = L.moe_block(lp["moe"], h, cfg)
    elif cfg.d_ff:
        h = L.mlp_block(lp["mlp"], h)
    else:
        h = torch.zeros_like(x)
    return x + h, aux


def shared_fwd_kv(cfg: ModelConfig, sp: dict, x: torch.Tensor,
                  causal_skip: bool = True):
    """The hybrid's shared attention + MLP block over x (B, S, d), its
    attention on the flash kernel for CUDA tensors.  Returns (x, k, v),
    the block's K and V (B, S, KVH, hd) for the prefill's cache."""
    sp = SET.gather_weights(sp)
    h = L.rmsnorm(x, sp["norm1"], cfg.norm_eps)
    pos = torch.arange(x.shape[1], device=x.device)
    q, k, v = L.attention_qkv(sp["attn"], h, cfg, pos)
    o = L.flash_attention(q, k, v, causal=True, causal_skip=causal_skip)
    x = x + L.residual(torch.einsum("bshk,hkd->bsd", L.heads(o, cfg),
                                    sp["attn"]["wo"]))
    h = L.rmsnorm(x, sp["norm2"], cfg.norm_eps)
    return x + L.mlp_block(sp["mlp"], h), k, v


def cross_kv(cp: dict, enc_out: torch.Tensor):
    """A cross layer's K and V (B, F, KVH, hd) from the encoder's output:
    projections only (no bias, no RoPE), as the reference takes them."""
    return (torch.einsum("bsd,dhk->bshk", enc_out, cp["attn"]["wk"]),
            torch.einsum("bsd,dhk->bshk", enc_out, cp["attn"]["wv"]))


def _remat(fn, remat: bool):
    """``fn`` under ``torch.utils.checkpoint`` (non-reentrant) when
    ``remat`` and autograd records: its activations are recomputed in
    the backward instead of kept."""
    if not (remat and torch.is_grad_enabled()):
        return fn
    # The layers draw no random numbers: no generator state is stashed for
    # the recomputation (which would also touch every device's generator).
    return lambda *a: checkpoint(fn, *a, use_reentrant=False,
                                 preserve_rng_state=False)


def backbone(cfg: ModelConfig, params: dict, x: torch.Tensor, *,
             remat: bool = True, causal_skip: bool = True,
             enc_out: torch.Tensor | None = None):
    """Run the stacked layers over x (B, S, d): the hybrid's shared block
    after every ``hybrid_attn_every``-th, the encoder-decoder's layers as
    self-attention -> cross-attention over ``enc_out`` -> MLP; each layer
    rematerialised under ``remat``.  Returns (hidden, total_aux_loss)."""
    aux0 = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.enc_dec:
        if enc_out is None:
            raise ValueError(f"{cfg.name}: the decoder needs the encoder's "
                             "output (enc_out)")

        def dec_layer(x, lp, cp, enc_out):
            lp, cp = SET.gather_weights((lp, cp))
            h = L.rmsnorm(x, lp["norm1"], cfg.norm_eps)
            x = x + L.attention_block(lp["attn"], h, cfg,
                                      causal_skip=causal_skip)
            h = L.rmsnorm(x, cp["norm"], cfg.norm_eps)
            x = x + L.attention_block(cp["attn"], h, cfg, causal=False,
                                      kv_override=cross_kv(cp, enc_out))
            h = L.rmsnorm(x, lp["norm2"], cfg.norm_eps)
            return x + L.mlp_block(lp["mlp"], h)

        step = _remat(dec_layer, remat)

        def dec_body(x, inp):
            x = L.residual(x)
            return step(x, *inp, enc_out), None

        return SET.scan(dec_body, x, (params["layers"],
                                      params["cross_layers"])), aux0

    def layer(x, lp, idx):
        x, a = _layer_fwd(cfg, SET.gather_weights(lp), x, causal_skip)
        if shared_slot(cfg, idx) is not None:
            x = shared_fwd_kv(cfg, params["shared_attn"], x, causal_skip)[0]
        return x, a

    def body(carry, lp):
        x, aux, idx = carry
        x = L.residual(x)
        x, a = _remat(lambda x, lp: layer(x, lp, idx), remat)(x, lp)
        return (x, aux + a, idx + 1), None

    x, aux, _ = SET.scan(body, (x, aux0, 0), params["layers"])
    return x, aux


def encoder(cfg: ModelConfig, params: dict, frames: torch.Tensor, *,
            remat: bool = True) -> torch.Tensor:
    """The whisper encoder over stubbed conv-frontend frames (B, F, d):
    the sinusoid added, then per layer (rematerialised under ``remat``)
    non-causal attention (the flash kernel) and an MLP, then the final
    norm.  Frames are taken in the model's type (the reference promotes
    a bf16 model's encoder to float32 when it is given float32
    frames)."""
    frames = frames.to(_dtype(cfg))
    pos = torch.arange(frames.shape[1], device=frames.device)
    x = frames + _sinusoid(pos, cfg.d_model).to(frames.dtype)

    def enc_layer(x, lp):
        lp = SET.gather_weights(lp)
        x = L.residual(x)
        h = L.rmsnorm(x, lp["norm1"], cfg.norm_eps)
        x = x + L.attention_block(lp["attn"], h, cfg, causal=False)
        h = L.rmsnorm(x, lp["norm2"], cfg.norm_eps)
        return x + L.mlp_block(lp["mlp"], h)

    step = _remat(enc_layer, remat)
    x = SET.scan(lambda x, lp: (step(x, lp), None), x, params["enc_layers"])
    return L.rmsnorm(x, params["enc_final_norm"], cfg.norm_eps)


def _sinusoid(pos: torch.Tensor, d: int) -> torch.Tensor:
    """(1, S, d) float32: sin then cos of pos / 1e4^(2i/d)."""
    ar = torch.arange(0, d, 2, device=pos.device).float() / d
    inv = 1.0 / (1e4 ** ar)
    ang = pos[:, None].float() * inv[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)[None]


def _lookup_table(params: dict) -> torch.Tensor:
    """The embedding table as the lookup takes it: under a mesh whole on
    every rank (DTensor's vocab-parallel lookup has no backward from a
    summed gradient in torch 2.11-2.13; the table's gather shows as a
    collective), else itself."""
    return SET.constrain(SET.gather_weights(params["embed"]), None, None)


def embed_inputs(cfg: ModelConfig, params: dict, batch: dict) -> torch.Tensor:
    """tokens (+ stubbed patch embeddings) -> (B, S, d)."""
    x = SET.constrain(F.embedding(batch["tokens"].long(),
                                  _lookup_table(params)), "data", None, None)
    if cfg.vlm_patches and "patches" in batch:
        patches = SET.constrain(batch["patches"].to(x.dtype), "data", None,
                                None)
        x = torch.cat([patches, x], dim=1)
    return x


def lm_head_logits(cfg: ModelConfig, params: dict,
                   h: torch.Tensor) -> torch.Tensor:
    w = SET.gather_weights(
        params["embed"].T if cfg.tie_embeddings else params["lm_head"])
    return torch.einsum("bsd,dv->bsv", h, w.to(h.dtype))


def chunked_ce_loss(cfg: ModelConfig, params: dict, h: torch.Tensor,
                    labels: torch.Tensor,
                    mask: torch.Tensor | None = None) -> torch.Tensor:
    """Mean cross-entropy of h (B, S, d) against labels (B, S) over the
    positions ``mask`` keeps, the float32 logits formed one chunk of
    ``settings.loss_chunk()`` positions at a time, never as a whole
    (B, S, V)."""
    B, Sq, d = h.shape
    h = L.residual(h)
    ck = min(SET.loss_chunk(), Sq)
    if Sq % ck:
        raise ValueError(f"chunked_ce_loss: {Sq} positions are not a "
                         f"multiple of the loss chunk {ck}")
    w = SET.gather_weights(
        params["embed"].T if cfg.tie_embeddings else params["lm_head"])
    w = w.to(h.dtype)
    if mask is None:
        mask = torch.ones_like(labels, dtype=torch.float32)
    nll = _chunk_nll
    from torch.distributed.tensor import DTensor
    if isinstance(h, DTensor):
        nll = _sharded_nll(h.device_mesh)
    tot = torch.zeros((), dtype=torch.float32, device=h.device)
    cnt = torch.zeros((), dtype=torch.float32, device=h.device)
    for c in range(0, Sq, ck):
        logits = torch.einsum("bsd,dv->bsv", h[:, c:c + ck], w).float()
        # Under a mesh the chunk's vocab is gathered: DTensor's
        # logsumexp would gather it anyway.
        logits = SET.constrain(logits, "data", None, None)
        s, n = nll(logits, labels[:, c:c + ck], mask[:, c:c + ck])
        tot = tot + s
        cnt = cnt + n
    return tot / torch.clamp_min(cnt, 1.0)


def _chunk_nll(logits: torch.Tensor, labels: torch.Tensor,
               mask: torch.Tensor):
    """(sum of the masked negative log-likelihoods, sum of the mask) of
    one chunk's float32 logits (B, ck, V)."""
    lse = torch.logsumexp(logits, dim=-1)
    ll = logits.gather(-1, labels.unsqueeze(-1).long()).squeeze(-1)
    mc = mask.float()
    return ((lse - ll) * mc).sum(), mc.sum()


def _sharded_nll(mesh):
    """``_chunk_nll`` on each rank's rows of DTensors over ``mesh``,
    summed across the batch axes: the label lookup's backward then
    scatters into the rank's own rows, not into a replicated (B, ck, V)
    tensor of zeros."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    def run(logits, labels, mask):
        rows = [Shard(0) if p == Shard(0) else Replicate()
                for p in logits.placements]
        sums = [Partial() if p == Shard(0) else p for p in rows]
        return local_map(_chunk_nll, out_placements=(sums, sums),
                         in_placements=(rows, rows, rows), device_mesh=mesh,
                         redistribute_inputs=True)(logits, labels, mask)
    return run


def forward_train(cfg: ModelConfig, params: dict, batch: dict, *,
                  remat: bool = True, causal_skip: bool = True):
    """The training loss over batch["tokens"] and batch["labels"] (B, S)
    [+ "patches", the VLM's stub, whose positions carry no loss; "frames",
    whisper's; "loss_mask"], each layer rematerialised under ``remat``.
    Returns (ce + 0.01 · the MoE's aux loss, {"ce", "aux"})."""
    enc_out = None
    if cfg.enc_dec:
        enc_out = encoder(cfg, params, batch["frames"], remat=remat)
    x = embed_inputs(cfg, params, batch)
    h, aux = backbone(cfg, params, x, remat=remat, causal_skip=causal_skip,
                      enc_out=enc_out)
    h = L.rmsnorm(L.residual(h), params["final_norm"], cfg.norm_eps)
    if cfg.vlm_patches and "patches" in batch:
        h = h[:, batch["patches"].shape[1]:]   # the loss over text only
    loss = chunked_ce_loss(cfg, params, h, batch["labels"],
                           batch.get("loss_mask"))
    return loss + 0.01 * aux, {"ce": loss, "aux": aux}
