"""Shared layers of the model zoo (port of ``repro.models.layers``):
norms, RoPE, flash attention, GQA attention, MLA attention (deepseek-v3's
compressed KV with decoupled RoPE), the gated MLP and the capacity-based
top-k MoE.

Parameters are nested dicts of tensors with the reference's layouts
(``wq`` (d, H, hd), ``wo`` (H, hd, d), expert stacks (E, d, ff)), and
every function is pure.  ``flash_attention`` is the kernel's wrapper: the
hand-written CUDA kernel for CUDA tensors, its plain version for CPU
tensors (differentiable: its backward is the plain version's); MLA's
prefill runs it at (D, Dv) = (192, 128).

The same functions run on DTensors under an active mesh (the dry-run):
``settings.constrain`` pins the reference's layouts at its sites
(attention's q, k, v and output, the MLP's hidden, the residual stream)
and is the identity on plain tensors; the MoE dispatch runs on each
rank's rows and experts (``_moe_block_sharded``).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models import settings as SET
from repro_torch.models.config import ModelConfig


class Structure:
    """Stands in for the generator where only shapes and dtypes are
    wanted (the dry-run's structures): the init functions then allocate
    on the meta device and draw nothing."""
    device = torch.device("meta")


STRUCTURE = Structure()


def normal(gen, shape: tuple) -> torch.Tensor:
    """N(0, 1) float32 of ``shape`` drawn from ``gen`` on its device
    (uninitialised on the meta device for ``STRUCTURE``)."""
    if isinstance(gen, Structure):
        return torch.empty(shape, dtype=torch.float32, device=gen.device)
    return torch.randn(shape, generator=gen, dtype=torch.float32,
                       device=gen.device)


# ---------------------------------------------------------------------------
# Norms & embeddings
# ---------------------------------------------------------------------------

def residual(x: torch.Tensor) -> torch.Tensor:
    """The residual stream's layout under a mesh: batch over "data",
    the rest replicated (the reference's per-layer constraint)."""
    return SET.constrain(x, "data", *([None] * (x.dim() - 1)))


def heads(t: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """q, k, v or attention's output (B, S, heads, hd) in the reference's
    layout under a mesh: batch over "data" and heads over "model" where
    ``attn_head_tp`` (batch over both under
    ``settings.attn_batch_flip``)."""
    tp = "model" if cfg.attn_head_tp else None
    flip = SET.attn_batch_flip() and not cfg.attn_head_tp
    return SET.constrain(t, ("data", "model") if flip else "data", None, tp,
                         None)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps)
    return (x * scale).to(dt)


def init_dense(gen: torch.Generator, d_in: int, d_out: int, dtype, *,
               lead: tuple = ()) -> torch.Tensor:
    """N(0, 1/d_in) weights of shape lead + (d_in, d_out), drawn from
    ``gen`` (on the device the weights go to) in float32 one (d_in, d_out)
    matrix at a time and cast to ``dtype``: a whole stack drawn in float32
    at once (deepseek-moe-16b's 28 x 64 experts, 20.7 GB) would not fit
    beside the weights already drawn.  ``STRUCTURE`` draws nothing."""
    w = torch.empty(lead + (d_in, d_out), dtype=dtype, device=gen.device)
    if isinstance(gen, Structure):
        return w
    scale = 1.0 / math.sqrt(d_in)
    for m in w.view(-1, d_in, d_out):
        m.copy_(torch.randn((d_in, d_out), generator=gen,
                            dtype=torch.float32, device=gen.device)
                .mul_(scale))
    return w


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
    """Project to q, k, v with RoPE applied (each contiguous; under a
    mesh in the layout of ``heads``)."""
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"])
    if cfg.qkv_bias:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    q = heads(apply_rope(q, pos, cfg.rope_theta), cfg)
    k = heads(apply_rope(k, pos, cfg.rope_theta), cfg)
    return q, k, heads(v.contiguous(), cfg)


def attention_block(p: dict, x: torch.Tensor, cfg: ModelConfig, *,
                    causal: bool = True, causal_skip: bool = True,
                    kv_override: tuple | None = None) -> torch.Tensor:
    """Attention over the whole sequence (training, prefill, the
    encoder).  ``kv_override`` supplies (k, v) for cross-attention (the
    whisper decoder over the encoder's output): then q takes no RoPE and
    k, v are used as given (made contiguous for the kernel).  Under a
    mesh q, k, v and the output take the reference's layouts: batch over
    "data" and heads over "model" where ``attn_head_tp`` (batch over
    both axes under ``settings.attn_batch_flip``)."""
    if kv_override is None:
        pos = torch.arange(x.shape[1], device=x.device)
        q, k, v = attention_qkv(p, x, cfg, pos)
    else:
        q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
        if cfg.qkv_bias:
            q = q + p["bq"]
        q = q.contiguous()
        k, v = (t.contiguous() for t in kv_override)
    o = flash_attention(heads(q, cfg), k, v, causal=causal,
                        causal_skip=causal_skip)
    return residual(torch.einsum("bshk,hkd->bsd", heads(o, cfg), p["wo"]))


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

def init_mlp(gen: torch.Generator, d: int, ff: int, dtype, *,
             lead: tuple = ()) -> dict:
    return {"wi": init_dense(gen, d, ff, dtype, lead=lead),
            "wg": init_dense(gen, d, ff, dtype, lead=lead),
            "wo": init_dense(gen, ff, d, dtype, lead=lead)}


def mlp_block(p: dict, x: torch.Tensor) -> torch.Tensor:
    x = residual(x)
    h = F.silu(x @ p["wg"]) * (x @ p["wi"])
    h = SET.constrain(h, "data", *([None] * (h.dim() - 2)), "model")
    return h @ p["wo"]


# ---------------------------------------------------------------------------
# MLA attention (deepseek-v3): low-rank compressed KV + decoupled RoPE
# ---------------------------------------------------------------------------

def init_mla(gen: torch.Generator, cfg: ModelConfig, dtype, *,
             lead: tuple = ()) -> dict:
    d, H = cfg.d_model, cfg.num_heads
    rq, rkv = cfg.q_lora_rank, cfg.kv_lora_rank
    dn, dr, dv = cfg.head_dim, cfg.rope_head_dim, cfg.v_head_dim
    dense = lambda a, b: init_dense(gen, a, b, dtype, lead=lead)  # noqa: E731
    return {
        "wq_a": dense(d, rq),                                    # q down
        "wq_b": dense(rq, H * (dn + dr)).reshape(lead + (rq, H, dn + dr)),
        "wkv_a": dense(d, rkv + dr),                             # kv down+rope
        "wk_b": dense(rkv, H * dn).reshape(lead + (rkv, H, dn)),
        "wv_b": dense(rkv, H * dv).reshape(lead + (rkv, H, dv)),
        "wo": dense(H * dv, d).reshape(lead + (H, dv, d)),
        "norm_kv": torch.ones(lead + (rkv,), dtype=dtype, device=gen.device),
        "norm_q": torch.ones(lead + (rq,), dtype=dtype, device=gen.device),
    }


def mla_compress(p: dict, x: torch.Tensor, cfg: ModelConfig,
                 pos: torch.Tensor):
    """x -> (c_kv (B, S, rkv), k_rope (B, S, dr)): the compressed cache
    entries."""
    kv_a = torch.einsum("bsd,dr->bsr", x, p["wkv_a"])
    c_kv = rmsnorm(kv_a[..., :cfg.kv_lora_rank], p["norm_kv"], cfg.norm_eps)
    k_rope = kv_a[..., cfg.kv_lora_rank:]
    k_rope = apply_rope(k_rope[:, :, None, :], pos, cfg.rope_theta)[:, :, 0]
    return c_kv, k_rope


def mla_queries(p: dict, x: torch.Tensor, cfg: ModelConfig,
                pos: torch.Tensor):
    """x -> (q_nope (B, S, H, dn), q_rope (B, S, H, dr))."""
    dn = cfg.head_dim
    q_a = rmsnorm(torch.einsum("bsd,dr->bsr", x, p["wq_a"]), p["norm_q"],
                  cfg.norm_eps)
    q = torch.einsum("bsr,rhk->bshk", q_a, p["wq_b"])         # (B,S,H,dn+dr)
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    return q_nope, apply_rope(q_rope, pos, cfg.rope_theta)


def mla_block(p: dict, x: torch.Tensor, cfg: ModelConfig, *,
              compressed: tuple | None = None,
              causal_skip: bool = True) -> torch.Tensor:
    """MLA for prefill: expand the compressed KV per head and run the flash
    kernel at (D, Dv) = (qk_head_dim, v_head_dim).  ``compressed`` takes
    ``mla_compress``'s (c_kv, k_rope) where the caller has them already
    (prefill stores them in the cache)."""
    B, S, _ = x.shape
    pos = torch.arange(S, device=x.device)
    c_kv, k_rope = compressed or mla_compress(p, x, cfg, pos)
    q_nope, q_rope = mla_queries(p, x, cfg, pos)
    k_nope = torch.einsum("bsr,rhk->bshk", c_kv, p["wk_b"])
    v = torch.einsum("bsr,rhk->bshk", c_kv, p["wv_b"]).contiguous()
    q = torch.cat([q_nope, q_rope], dim=-1)
    # The shared k_rope broadcast to every head; cat makes k contiguous,
    # as the kernel requires.
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(
        B, S, cfg.num_heads, cfg.rope_head_dim)], dim=-1)
    out = flash_attention(q, k, v, causal=True,
                          scale=1.0 / math.sqrt(cfg.qk_head_dim),
                          causal_skip=causal_skip)
    return residual(torch.einsum("bshk,hkd->bsd", out, p["wo"]))


# ---------------------------------------------------------------------------
# MoE (shared + routed experts, capacity-based top-k dispatch)
# ---------------------------------------------------------------------------

def top_k(x: torch.Tensor, k: int):
    """``jax.lax.top_k`` over the last dim: the k largest values and their
    indices, largest first and, among equal values, the lower index first.
    ``torch.topk`` promises no order among ties, and the MoE's second top-k
    runs mostly over zeros, so ties decide which tokens an expert takes: a
    stable descending sort keeps lax's order."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_capacity(cfg: ModelConfig, rows: int) -> int:
    """Tokens an expert takes from a row of ``rows`` tokens:
    C = min(Sr, max(1, int(Sr * K * capacity_factor / E)))."""
    return min(rows, max(1, int(rows * cfg.moe_top_k * cfg.capacity_factor
                                / cfg.num_experts)))


def init_moe(gen: torch.Generator, cfg: ModelConfig, dtype, *,
             lead: tuple = ()) -> dict:
    d, ff, E = cfg.d_model, cfg.d_ff, cfg.num_experts
    p = {
        # The router stays float32 in a bf16 model, as the reference's.
        "router": init_dense(gen, d, E, torch.float32, lead=lead),
        "wi": init_dense(gen, d, ff, dtype, lead=lead + (E,)),
        "wg": init_dense(gen, d, ff, dtype, lead=lead + (E,)),
        "wo": init_dense(gen, ff, d, dtype, lead=lead + (E,)),
    }
    if cfg.num_shared_experts:
        p["shared"] = init_mlp(gen, d, ff * cfg.num_shared_experts, dtype,
                               lead=lead)
    return p


def moe_route(p: dict, xr: torch.Tensor, cfg: ModelConfig):
    """The router and the dispatch over rows xr (R, Sr, d): (probs (R, Sr,
    E), topk_idx (R, Sr, K), gate (R, Sr, E) — each token's top-k probs,
    zero elsewhere —, gval and gidx (R, E, C) — each expert's C tokens of
    the largest gate and their gates).  Logits in float32."""
    logits = torch.einsum("rsd,de->rse", xr.float(), p["router"].float())
    probs = torch.softmax(logits, dim=-1)
    topk_val, topk_idx = top_k(probs, cfg.moe_top_k)
    gate = torch.zeros(probs.shape, dtype=torch.float32, device=xr.device)
    gate.scatter_(-1, topk_idx, topk_val)
    gval, gidx = top_k(gate.transpose(1, 2),
                       moe_capacity(cfg, xr.shape[1]))
    return probs, topk_idx, gate, gval, gidx


def _moe_experts(p: dict, xr: torch.Tensor, cfg: ModelConfig,
                e0: int = 0):
    """The routing of rows xr (R, Sr, d) over all E experts, then the
    experts e0 .. e0 + El of ``p``'s stacks (El = their length) on their
    tokens and the gated combine: (out (R, Sr, d) in the experts' type,
    probs, gate)."""
    R, Sr, d = xr.shape
    probs, _, gate, gval, gidx = moe_route(p, xr, cfg)
    El = p["wi"].shape[0]
    gval, gidx = gval[:, e0:e0 + El], gidx[:, e0:e0 + El]
    C = gidx.shape[-1]
    rows = torch.arange(R, device=xr.device)[None, :, None]
    xe = xr[rows, gidx.transpose(0, 1)].reshape(El, R * C, d)  # (El, R·C, d)
    h = torch.nn.functional.silu(torch.bmm(xe, p["wg"])) * torch.bmm(
        xe, p["wi"])
    ye = torch.bmm(h, p["wo"])                               # (El, R·C, d)
    ye = ye * gval.transpose(0, 1).reshape(El, R * C, 1).to(ye.dtype)
    dest = (rows * Sr + gidx.transpose(0, 1)).reshape(-1)    # e, r, c order
    out = torch.zeros((R * Sr, d), dtype=ye.dtype, device=xr.device)
    out.index_add_(0, dest, ye.reshape(-1, d))
    return out.reshape(R, Sr, d), probs, gate


def moe_block(p: dict, x: torch.Tensor, cfg: ModelConfig):
    """Capacity-based top-k MoE.  Returns (out, aux_loss).

    Dispatch is per row (a batch row for prefill; the whole decode batch
    becomes one row when S == 1): each expert takes the C tokens of the
    row with the largest gate, C = ``moe_capacity``, so a token routed to
    an expert that is full is dropped there.  A decode step's output thus
    depends on the rest of its batch, as the reference's does.  The
    experts' tokens are gathered by index into an (E, R·C, d) batch, never
    through a broadcast over every (row, expert, token) triple.  The
    combine scales each expert's output by its gate in the activation
    type and adds it into the (R, Sr, d) output in that type (in bf16
    the sum rounds in bf16, as the reference's scatter-add).  On
    DTensors see ``_moe_block_sharded``.
    """
    from torch.distributed.tensor import DTensor
    if isinstance(x, DTensor):
        return _moe_block_sharded(p, x, cfg)
    B, S, d = x.shape
    E = cfg.num_experts
    xr = x.reshape(1, B, d) if S == 1 else x                 # (R, Sr, d)
    out, probs, gate = _moe_experts(p, xr, cfg)
    # Load-balance aux loss (Switch-style).
    me = probs.mean(dim=(0, 1))
    ce = (gate > 0).float().mean(dim=(0, 1))
    aux = E * torch.sum(me * ce)
    if cfg.num_shared_experts:
        out = out + mlp_block(p["shared"], xr).to(out.dtype)
    return out.reshape(B, S, d).to(x.dtype), aux


def _moe_block_sharded(p: dict, x: torch.Tensor, cfg: ModelConfig):
    """``moe_block`` on DTensors over the active mesh, the reference's
    expert-parallel layout (rows over the data axes, experts over
    "model"): each rank routes its own rows over all E experts (the
    router replicated), runs its experts on their tokens and combines
    them into a partial sum over "model", which DTensor reduces where it
    is next used.  Rows that do not divide the data axes (one decode
    row) are replicated; experts that do not divide "model", or a
    "model" axis the rows use, are replicated.  The aux loss comes from
    the summed router probabilities and expert loads."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    from repro_torch.dist.mesh import axis_rank, axis_size, dim_names
    from repro_torch.dist.sharding import _norm, batch_axes, placements
    mesh = x.device_mesh
    B, S, d = x.shape
    E = cfg.num_experts
    xr = x.reshape(1, B, d) if S == 1 else x
    R, Sr, _ = xr.shape
    bax = batch_axes(mesh, R, SET.scheme()) or ()
    row_pl = placements(mesh, (_norm(bax), None, None))
    names = dim_names(mesh)
    ep = ("model" in names and "model" not in bax
          and E % axis_size(mesh, "model") == 0)
    exp_pl = placements(mesh, ("model" if ep else None, None, None))
    e0 = axis_rank(mesh, "model") * (E // axis_size(mesh, "model")) \
        if ep else 0
    rep = [Replicate()] * len(names)
    sum_pl = [Partial() if isinstance(q, Shard) else Replicate()
              for q in row_pl]
    out_pl = [Partial() if isinstance(w, Shard) else r
              for r, w in zip(row_pl, exp_pl)]

    def local(xr_l, router, wi, wg, wo):
        out, probs, gate = _moe_experts(
            {"router": router, "wi": wi, "wg": wg, "wo": wo}, xr_l, cfg, e0)
        return (out, probs.sum(dim=(0, 1)),
                (gate > 0).float().sum(dim=(0, 1)))

    out, psum, csum = local_map(
        local, out_placements=(out_pl, sum_pl, sum_pl),
        in_placements=(row_pl, rep, exp_pl, exp_pl, exp_pl),
        device_mesh=mesh, redistribute_inputs=True)(
            xr, p["router"], p["wi"], p["wg"], p["wo"])
    n = R * Sr
    aux = E * torch.sum((psum / n) * (csum / n))
    if cfg.num_shared_experts:
        out = out + mlp_block(p["shared"], xr).to(out.dtype)
    return out.reshape(B, S, d).to(x.dtype), aux
