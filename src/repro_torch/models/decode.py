"""Serving forward passes: prefill (cache build) and single-token decode
(port of ``repro.models.decode``: the dense and MoE paths, GQA and MLA
attention, the SSM, the hybrid and the encoder-decoder).

Prefill runs the flash kernel in every attention layer; decode attends
densely over the cache, one token's scores over the Smax cached positions
in float32 (``_gqa_cached_attn``), as the reference leaves it to XLA.
MLA decode absorbs ``wk_b`` into the query and ``wv_b`` into the output
and scores in the compressed kv_lora_rank space (``_mla_cached_attn``),
so its cache holds only (c_kv, k_rope) per token.  An MoE layer decodes
the whole batch as one dispatch row (``layers.moe_block``).  A Mamba2
layer decodes by its recurrent update (``ssm.ssd_decode_step``); the
hybrid's shared attention block keeps one K/V cache per application.
The encoder-decoder's prefill runs the encoder once and writes each
decoder layer's cross K/V (the encoder output's projections) into the
cache; its decode attends over them non-causally, with no RoPE on the
query, and never writes them.

The cache is ``{"pos": () int32, "k": (L, B, Smax, KVH, hd), "v": ...}``,
with MLA ``{"pos", "ckv": (L, B, Smax, rkv), "krope": (L, B, Smax,
dr)}``, and for the SSM ``{"pos", "conv": (L, B, W - 1, d_inner + 2
state) in the activation type (the last W - 1 tokens' pre-conv inputs),
"state": (L, B, heads, head_dim, state) float32}``, with the hybrid's
``"sk"``/``"sv"``: (L // every, B, Smax, KVH, hd) beside them; the
encoder-decoder's adds ``"ck"``/``"cv"``: (L, B, enc_frames, KVH, hd)
to ``"k"``/``"v"``.  Unlike
the reference's immutable arrays, ``decode_step`` writes the new token's
entries (and each SSM layer's conv and state) into the cache tensors in
place (a copy of the whole cache per step would cost more than the step)
and returns a new dict that shares them, with ``pos`` advanced.  The
write position is clamped into [0, Smax - 1] as
``jax.lax.dynamic_update_slice`` clamps it.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import settings as SET
from repro_torch.models import ssm as SSM
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import (_dtype, _lookup_table,
                                            cross_kv, embed_inputs,
                                            encoder, lm_head_logits,
                                            shared_fwd_kv, shared_slot)


# ---------------------------------------------------------------------------
# Cache construction
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=None,
               device=None) -> dict:
    """The zero cache on ``device``; under an active mesh, DTensors laid
    out by ``cache_specs`` (each rank allocating and zeroing its own
    shard)."""
    dev = resolve_device(device)
    mesh = SET.active_mesh()
    if mesh is None:
        return _cache(cfg, batch, max_len, dtype, dev)
    from repro_torch.dist.sharding import cache_specs, distribute_tree
    structs = cache_structs(cfg, batch, max_len, dtype)
    cache = distribute_tree(mesh, structs, cache_specs(mesh, cfg, structs),
                            device=dev)
    for leaf in cache.values():
        leaf.to_local().zero_()     # each rank's shard, made empty
    return cache


def cache_structs(cfg: ModelConfig, batch: int, max_len: int,
                  dtype=None) -> dict:
    """``init_cache``'s tree as meta tensors: shapes and dtypes only."""
    return _cache(cfg, batch, max_len, dtype, torch.device("meta"))


def _cache(cfg: ModelConfig, batch: int, max_len: int, dtype, dev) -> dict:
    dt = dtype or _dtype(cfg)
    cache = {"pos": torch.zeros((), dtype=torch.int32, device=dev)}
    Ln = cfg.num_layers
    if cfg.ssm:
        C = cfg.d_inner + 2 * cfg.ssm_state
        cache["conv"] = torch.zeros((Ln, batch, cfg.conv_width - 1, C),
                                    dtype=dt, device=dev)
        cache["state"] = torch.zeros(
            (Ln, batch, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state),
            dtype=torch.float32, device=dev)
        if cfg.hybrid_attn_every:
            shape = (Ln // cfg.hybrid_attn_every, batch, max_len,
                     cfg.num_kv_heads, cfg.head_dim)
            cache["sk"] = torch.zeros(shape, dtype=dt, device=dev)
            cache["sv"] = torch.zeros(shape, dtype=dt, device=dev)
        return cache
    lead = (Ln, batch, max_len)
    if cfg.use_mla:
        cache["ckv"] = torch.zeros(lead + (cfg.kv_lora_rank,), dtype=dt,
                                   device=dev)
        cache["krope"] = torch.zeros(lead + (cfg.rope_head_dim,), dtype=dt,
                                     device=dev)
    else:
        shape = lead + (cfg.num_kv_heads, cfg.head_dim)
        cache["k"] = torch.zeros(shape, dtype=dt, device=dev)
        cache["v"] = torch.zeros(shape, dtype=dt, device=dev)
    if cfg.enc_dec:
        shape = (Ln, batch, cfg.enc_frames, cfg.num_kv_heads, cfg.head_dim)
        cache["ck"] = torch.zeros(shape, dtype=dt, device=dev)
        cache["cv"] = torch.zeros(shape, dtype=dt, device=dev)
    return cache


def _cache_names(cfg: ModelConfig) -> tuple[str, str]:
    """The two per-layer cache tensors of this config."""
    return ("ckv", "krope") if cfg.use_mla else ("k", "v")


# ---------------------------------------------------------------------------
# Cached attention
# ---------------------------------------------------------------------------

def _write_token(c: torch.Tensor, at: torch.Tensor, x: torch.Tensor) -> None:
    """Write x (B, 1, ...) into the cache c (B, Smax, ...) at position
    ``at`` ((1,) int64), in place.  On a DTensor each rank writes its own
    shard: where the sequence is sharded, the rank whose slice holds the
    position writes it and every other rank writes back what it holds."""
    if SET.active_mesh() is None:
        c.index_copy_(1, at, x.to(c.dtype))
        return
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh, pl = c.device_mesh, tuple(c.placements)
    # This rank's first position: mesh dims cut the sequence in mesh order.
    off, size = 0, c.shape[1]
    for md, p in enumerate(pl):
        if isinstance(p, Shard) and p.dim == 1:
            size //= mesh.size(md)
            off += mesh.get_coordinate()[md] * size
    x_pl = tuple(p if isinstance(p, Shard) and p.dim == 0 else Replicate()
                 for p in pl)
    rep = (Replicate(),) * mesh.ndim

    def local(c_l, at_l, x_l):
        i = at_l - off
        keep = ((i >= 0) & (i < c_l.shape[1])).reshape(
            (1, 1) + (1,) * (c_l.dim() - 2))
        i = i.clamp(0, c_l.shape[1] - 1)
        c_l.index_copy_(1, i, torch.where(keep, x_l.to(c_l.dtype),
                                          c_l.index_select(1, i)))
        return (c_l,)

    local_map(local, out_placements=(pl,), in_placements=(pl, rep, x_pl),
              device_mesh=mesh, redistribute_inputs=True)(c, at, x)


def _gqa_cached_attn(p: dict, x: torch.Tensor, kc: torch.Tensor,
                     vc: torch.Tensor, pos: torch.Tensor, cfg: ModelConfig,
                     *, update: bool = True, causal: bool = True):
    """x: (B, d) one token; kc/vc: (B, Smax, KVH, hd).  With ``update``
    the token's K/V are written in place at ``pos`` and q and k take
    RoPE; without (cross-attention over the encoder's K/V) q takes none
    and the cache is only read.  ``causal`` masks the positions past
    ``pos``.  Returns (out (B, d), kc, vc)."""
    B, d = x.shape
    H, KVH, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    G = H // KVH
    q = torch.einsum("bd,dhk->bhk", x, p["wq"])
    if cfg.qkv_bias:
        q = q + p["bq"]
    if update:
        k_new = torch.einsum("bd,dhk->bhk", x, p["wk"])
        v_new = torch.einsum("bd,dhk->bhk", x, p["wv"])
        if cfg.qkv_bias:
            k_new, v_new = k_new + p["bk"], v_new + p["bv"]
        posv = pos.expand(B, 1)
        q = L.apply_rope(q[:, None], posv, cfg.rope_theta)[:, 0]
        k_new = L.apply_rope(k_new[:, None], posv, cfg.rope_theta)
        at = pos.clamp(0, kc.shape[1] - 1).reshape(1).long()
        _write_token(kc, at, k_new)
        _write_token(vc, at, v_new[:, None])
    # Under a mesh the query keeps its batch sharding only: the scores
    # are taken against each rank's slice of the cache's sequence.
    qg = SET.constrain(q, "data", None, None).reshape(B, KVH, G, hd)
    s = torch.einsum("bkgh,bskh->bkgs", qg.float(), kc.float()) / \
        math.sqrt(hd)
    if causal:
        valid = torch.arange(kc.shape[1], device=x.device) <= pos
        s = torch.where(valid[None, None, None, :], s,
                        torch.full_like(s, float("-inf")))
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgs,bskh->bkgh", w, vc.float())
    o = o.reshape(B, H, hd).to(x.dtype)
    return torch.einsum("bhk,hkd->bd", o, p["wo"]), kc, vc


def _mla_cached_attn(p: dict, x: torch.Tensor, ckv: torch.Tensor,
                     krope: torch.Tensor, pos: torch.Tensor,
                     cfg: ModelConfig):
    """Absorbed MLA decode.  x: (B, d) one token; ckv (B, Smax, rkv) and
    krope (B, Smax, dr), written in place at ``pos``.  The scores are taken
    in the compressed space, in float32 as the reference computes them.
    Returns (out (B, d), ckv, krope)."""
    posv = pos.expand(x.shape[0], 1)
    ckv_new, krope_new = L.mla_compress(p, x[:, None], cfg, posv)
    at = pos.clamp(0, ckv.shape[1] - 1).reshape(1).long()
    _write_token(ckv, at, ckv_new)
    _write_token(krope, at, krope_new)
    q_nope, q_rope = L.mla_queries(p, x[:, None], cfg, posv)
    q_nope, q_rope = q_nope[:, 0], q_rope[:, 0]            # (B, H, ·)
    # Absorb W_kb into the query: score in the compressed space.
    q_t = torch.einsum("bhn,rhn->bhr", q_nope.float(), p["wk_b"].float())
    s = torch.einsum("bhr,bsr->bhs", q_t, ckv.float()) + torch.einsum(
        "bhr,bsr->bhs", q_rope.float(), krope.float())
    s = s / math.sqrt(cfg.qk_head_dim)
    valid = torch.arange(ckv.shape[1], device=x.device) <= pos
    s = torch.where(valid[None, None, :], s,
                    torch.full_like(s, float("-inf")))
    w = torch.softmax(s, dim=-1)
    ctx = torch.einsum("bhs,bsr->bhr", w, ckv.float())
    o = torch.einsum("bhr,rhv->bhv", ctx, p["wv_b"].float())
    out = torch.einsum("bhv,hvd->bd", o.to(x.dtype), p["wo"])
    return out, ckv, krope


def _ffn(cfg: ModelConfig, lp: dict, h: torch.Tensor) -> torch.Tensor:
    """The layer's feed-forward half on h (B, S, d) or (B, d): MoE (a
    decode batch is one dispatch row), the MLP, or nothing."""
    if cfg.moe:
        if h.dim() == 2:
            return L.moe_block(lp["moe"], h[:, None], cfg)[0][:, 0]
        return L.moe_block(lp["moe"], h, cfg)[0]
    if cfg.d_ff:
        return L.mlp_block(lp["mlp"], h)
    return torch.zeros_like(h)


# ---------------------------------------------------------------------------
# Decode step (one token for the whole batch)
# ---------------------------------------------------------------------------

def decode_weights(cfg: ModelConfig, params: dict) -> dict:
    """The part of ``params`` that ``decode_step`` reads: all of it but,
    for the encoder-decoder, the encoder's weights and the cross layers'
    K/V projections, whose output the cache holds (the reference's jit
    drops them from a decode step's arguments)."""
    if not cfg.enc_dec:
        return params
    out = {k: v for k, v in params.items()
           if k not in ("enc_layers", "enc_final_norm")}
    cross = dict(params["cross_layers"])
    cross["attn"] = {k: v for k, v in cross["attn"].items()
                     if k not in ("wk", "wv", "bk", "bv")}
    out["cross_layers"] = cross
    return out


def decode_step(cfg: ModelConfig, params: dict, cache: dict,
                tokens: torch.Tensor) -> tuple[torch.Tensor, dict]:
    """tokens: (B,) int — the newest token per sequence.  Returns (logits
    (B, V), the cache advanced by one position; its K/V (or MLA's
    ckv/krope) tensors are the input's, written in place)."""
    pos = cache["pos"]
    x = F.embedding(tokens.long(), _lookup_table(params))  # (B, d)
    if cfg.ssm:
        x = _ssm_decode(cfg, params, cache, x)
        return _last_logits(cfg, params, x[:, None]), dict(cache,
                                                           pos=pos + 1)
    attn = _mla_cached_attn if cfg.use_mla else _gqa_cached_attn

    def body(x, inp):
        lp, kc, vc = inp[:3]
        lp = SET.gather_weights(lp)
        x = L.residual(x)
        h = L.rmsnorm(x, lp["norm1"], cfg.norm_eps)
        h, _, _ = attn(lp["attn"], h, kc, vc, pos, cfg)
        x = x + L.residual(h)
        if cfg.enc_dec:
            cp, ck, cv = inp[3:]
            cp = SET.gather_weights(cp)
            h = L.rmsnorm(x, cp["norm"], cfg.norm_eps)
            x = x + _gqa_cached_attn(cp["attn"], h, ck, cv, pos, cfg,
                                     update=False, causal=False)[0]
        h = L.rmsnorm(x, lp["norm2"], cfg.norm_eps)
        return x + _ffn(cfg, lp, h), None

    a, b = _cache_names(cfg)
    xs = (params["layers"], cache[a], cache[b])
    if cfg.enc_dec:
        xs += (params["cross_layers"], cache["ck"], cache["cv"])
    x = SET.scan(body, x, xs)
    return _last_logits(cfg, params, x[:, None]), dict(cache, pos=pos + 1)


def _last_logits(cfg: ModelConfig, params: dict,
                 x: torch.Tensor) -> torch.Tensor:
    """The final norm and the LM head at the last position of x (B, S,
    d): logits (B, V)."""
    h = L.rmsnorm(L.residual(x[:, -1:]), params["final_norm"], cfg.norm_eps)
    return lm_head_logits(cfg, params, h)[:, 0]


def _shared_cached(cfg: ModelConfig, sp: dict, x: torch.Tensor,
                   kc: torch.Tensor, vc: torch.Tensor,
                   pos: torch.Tensor) -> torch.Tensor:
    """The hybrid's shared block on one token x (B, d), attending over
    its application's K/V cache (written in place at ``pos``)."""
    sp = SET.gather_weights(sp)
    h = L.rmsnorm(x, sp["norm1"], cfg.norm_eps)
    x = x + _gqa_cached_attn(sp["attn"], h, kc, vc, pos, cfg)[0]
    h = L.rmsnorm(x, sp["norm2"], cfg.norm_eps)
    return x + L.mlp_block(sp["mlp"], h)


def _ssm_decode(cfg: ModelConfig, params: dict, cache: dict,
                x: torch.Tensor) -> torch.Tensor:
    """The SSM / hybrid layers on one token x (B, d): each layer's conv
    and state are written back into the cache in place, and the shared
    block's K/V into its slot.  Returns the last hidden state (B, d)."""
    def body(carry, inp):
        x, idx = carry
        lp, conv_l, state_l = inp
        lp = SET.gather_weights(lp)
        x = L.residual(x)
        h = L.rmsnorm(x, lp["norm1"], cfg.norm_eps)
        h, conv, state = SSM.ssd_decode_step(lp["mamba"], h, conv_l,
                                             state_l, cfg)
        conv_l.copy_(conv)
        state_l.copy_(state)
        x = x + h
        slot = shared_slot(cfg, idx)
        if slot is not None:
            x = _shared_cached(cfg, params["shared_attn"], x,
                               cache["sk"][slot], cache["sv"][slot],
                               cache["pos"])
        return (x, idx + 1), None

    x, _ = SET.scan(body, (x, 0), (params["layers"], cache["conv"],
                                   cache["state"]))
    return x


# ---------------------------------------------------------------------------
# Prefill
# ---------------------------------------------------------------------------

def prefill(cfg: ModelConfig, params: dict, batch: dict, max_len: int, *,
            remat: bool = True, causal_skip: bool = True
            ) -> tuple[dict, torch.Tensor]:
    """Run the full prompt (``batch["tokens"]`` (B, S) [+ ``patches``;
    whisper's ``frames`` (B, enc_frames, d)]), building the cache.
    Returns (cache, logits of the last position).  ``remat`` reaches the
    encoder (as the reference's; no effect without autograd);
    ``causal_skip`` the flash attention."""
    enc_out = None
    if cfg.enc_dec:
        frames = batch["frames"].shape[1]
        if frames != cfg.enc_frames:
            raise ValueError(f"prefill: {frames} frames, but the cross cache "
                             f"holds enc_frames = {cfg.enc_frames}")
        enc_out = encoder(cfg, params, batch["frames"], remat=remat)
    x = embed_inputs(cfg, params, batch)
    B, Sq, _ = x.shape
    if max_len < Sq and (not cfg.ssm or cfg.hybrid_attn_every):
        raise ValueError(f"prefill: max_len {max_len} < prompt length {Sq}")
    cache = init_cache(cfg, B, max_len, device=x.device)
    if cfg.ssm:
        x = _ssm_prefill(cfg, params, cache, x, causal_skip)
        cache["pos"] = torch.tensor(Sq, dtype=torch.int32, device=x.device)
        return cache, _last_logits(cfg, params, x)
    pos = torch.arange(Sq, device=x.device)

    def body(x, inp):
        lp, kc, vc = inp[:3]
        lp = SET.gather_weights(lp)
        x = L.residual(x)
        h = L.rmsnorm(x, lp["norm1"], cfg.norm_eps)
        if cfg.use_mla:
            k, v = L.mla_compress(lp["attn"], h, cfg, pos)  # (ckv, krope)
            x = x + L.mla_block(lp["attn"], h, cfg, compressed=(k, v),
                                causal_skip=causal_skip)
        else:
            q, k, v = L.attention_qkv(lp["attn"], h, cfg, pos)
            o = L.flash_attention(q, k, v, causal=True,
                                  causal_skip=causal_skip)
            x = x + L.residual(torch.einsum("bshk,hkd->bsd", L.heads(o, cfg),
                                            lp["attn"]["wo"]))
        kc[:, :Sq] = k.to(kc.dtype)
        vc[:, :Sq] = v.to(vc.dtype)
        if cfg.enc_dec:
            cp, ck, cv = inp[3:]
            cp = SET.gather_weights(cp)
            kv = cross_kv(cp, enc_out)
            h = L.rmsnorm(x, cp["norm"], cfg.norm_eps)
            x = x + L.attention_block(cp["attn"], h, cfg, causal=False,
                                      kv_override=kv)
            ck.copy_(kv[0])
            cv.copy_(kv[1])
        h = L.rmsnorm(x, lp["norm2"], cfg.norm_eps)
        return x + _ffn(cfg, lp, h), None

    a, b = _cache_names(cfg)
    xs = (params["layers"], cache[a], cache[b])
    if cfg.enc_dec:
        xs += (params["cross_layers"], cache["ck"], cache["cv"])
    x = SET.scan(body, x, xs)
    cache["pos"] = torch.tensor(Sq, dtype=torch.int32, device=x.device)
    return cache, _last_logits(cfg, params, x)


def _ssm_prefill(cfg: ModelConfig, params: dict, cache: dict,
                 x: torch.Tensor, causal_skip: bool = True) -> torch.Tensor:
    """The SSM / hybrid layers over the prompt x (B, S, d), writing each
    layer's final state and conv tail into the cache, and at each
    application point the shared block's K/V into its slot.  Returns the
    hidden states (B, S, d)."""
    W, Sq = cfg.conv_width, x.shape[1]
    if Sq < W - 1:
        raise ValueError(
            f"prefill: a prompt of {Sq} tokens is shorter than the conv "
            f"state's {W - 1} (conv_width - 1); the reference builds a conv "
            "state of the wrong length there and its next decode fails")

    def body(carry, inp):
        x, idx = carry
        lp, conv_l, state_l = inp
        lp = SET.gather_weights(lp)
        x = L.residual(x)
        h = L.rmsnorm(x, lp["norm1"], cfg.norm_eps)
        y, state = SSM.ssd_forward(lp["mamba"], h, cfg)
        conv_l.copy_(_conv_tail(lp["mamba"], h, cfg))
        state_l.copy_(state)
        x = x + y
        slot = shared_slot(cfg, idx)
        if slot is not None:
            x, k, v = shared_fwd_kv(cfg, params["shared_attn"], x,
                                    causal_skip)
            cache["sk"][slot, :, :Sq] = k.to(cache["sk"].dtype)
            cache["sv"][slot, :, :Sq] = v.to(cache["sv"].dtype)
        return (x, idx + 1), None

    x, _ = SET.scan(body, (x, 0), (params["layers"], cache["conv"],
                                   cache["state"]))
    return x


def _conv_tail(mp: dict, h: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The last (conv_width - 1) tokens' pre-conv inputs [x | B | C]: the
    decode conv state.  Only those tokens are projected (the reference
    projects all S and keeps the tail)."""
    t = h[:, -(cfg.conv_width - 1):]
    return torch.cat([t @ mp["wx"], t @ mp["wB"], t @ mp["wC"]], dim=-1)
