"""Mamba2 blocks (SSD, state-space duality, arXiv:2405.21060): port of
``repro.models.ssm``.

Chunked SSD: within a chunk the quadratic, attention-like form masked by
the decay kernel; across chunks the linear recurrence of the state.
ngroups = 1 (B and C shared across heads).  Decode is the O(1) recurrent
update of one token.  The reference writes no Pallas kernel for any of
this (it is plain jnp), so the port's is plain PyTorch too.

Types follow the reference site by site: ``A_log``, ``D`` and
``dt_bias`` are float32 in a bf16 model; the projections, the causal
conv and its SiLU run in the activation type; ``dt`` (softplus), the
log-decay and the whole chunked computation run in float32; ``y`` goes
back to the activation type before the gate ``* silu(z)``, the norm and
``wo``.

Memory: at B = 4, S = 2 048 and chunk 256 the within-chunk weights
(B, nc, nh, Q, Q) are the largest float32 tensor (0.54 GB for
mamba2-1.3b, 0.94 GB for zamba2-7b).  The three-operand contractions are
written as a scale and a batched matrix product, so no broadcast over
(B, nc, Q, nh, hd, ds) is ever built (17 GB for mamba2-1.3b).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import settings as SET
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import init_dense, rmsnorm


def init_mamba2(gen: torch.Generator, cfg: ModelConfig, dtype, *,
                lead: tuple = ()) -> dict:
    """One Mamba2 block's parameters (a stack of them under ``lead``),
    drawn from ``gen`` a matrix at a time: the projections N(0, 1/d_in),
    the depthwise conv N(0, 1/W) (the reference's normal / sqrt(W));
    A_log 0 (A = -1), D 1 and dt_bias 0, all float32."""
    d, di, ds, nh = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    dev = gen.device
    dense = lambda a, b: init_dense(gen, a, b, dtype, lead=lead)  # noqa: E731
    f32 = dict(dtype=torch.float32, device=dev)
    return {
        "wz": dense(d, di),
        "wx": dense(d, di),
        "wB": dense(d, ds),
        "wC": dense(d, ds),
        "wdt": dense(d, nh),
        "conv_w": dense(cfg.conv_width, di + 2 * ds),
        "A_log": torch.zeros(lead + (nh,), **f32),   # A = -exp(A_log)
        "D": torch.ones(lead + (nh,), **f32),
        "dt_bias": torch.zeros(lead + (nh,), **f32),
        "norm": torch.ones(lead + (di,), dtype=dtype, device=dev),
        "wo": dense(di, d),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv, x (B, S, C), w (W, C), in x's type."""
    W, S = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, W - 1, 0))
    return sum(xp[:, i:i + S] * w[i] for i in range(W))


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """Lower-triangular pairwise decay: out[..., i, j] = sum_{k=j+1..i}
    a_k for i >= j, -inf otherwise.  a (..., L).

    Each entry is summed over its own segment (a cumulative sum down the
    column of a_k, k > j), not taken as cum[i] - cum[j] as the reference
    takes it: at chunk 256 the running sum reaches ~-180, where a float32
    ulp is 1.5e-5, so the difference of two running sums carries that
    absolute error into every weight exp(out), while decode's recurrence
    multiplies exact per-token decays.  The same function, rounded as the
    recurrence rounds it.  The upper triangle is masked to -inf before
    any ``exp`` (there the difference form would read ~+180, whose exp
    overflows to inf, and inf · 0 is NaN)."""
    L = a.shape[-1]
    ones = torch.ones((L, L), dtype=torch.bool, device=a.device)
    seg = a[..., :, None] * ones.tril(-1)              # (..., k, j): k > j
    seg.cumsum_(dim=-2)                                # (..., i, j)
    return seg.masked_fill_(~ones.tril(), float("-inf"))


def _in_proj(p: dict, x: torch.Tensor):
    """z, the conv input [x | B | C] (pre-conv) and dt (float32) of x."""
    z = x @ p["wz"]
    xBC = torch.cat([x @ p["wx"], x @ p["wB"], x @ p["wC"]], dim=-1)
    dt = F.softplus((x @ p["wdt"]).float() + p["dt_bias"])
    return z, xBC, dt


def _out_proj(p: dict, y: torch.Tensor, z: torch.Tensor,
              cfg: ModelConfig) -> torch.Tensor:
    """y (float32, flattened heads) back to z's type, gated, normed and
    projected."""
    # Under a mesh the norm takes whole channel rows (gathered over
    # "model"), and the normed channels go back to their "model" shards
    # for the projection (a norm over sharded channels may leave them
    # sharded by position, and its gradient too).
    y = SET.constrain(y.to(z.dtype) * F.silu(z), "data", None, None)
    return SET.constrain(rmsnorm(y, p["norm"], cfg.norm_eps), "data", None,
                         "model") @ p["wo"]


def ssd_forward(p: dict, x: torch.Tensor, cfg: ModelConfig,
                init_state: torch.Tensor | None = None):
    """Mamba2 block forward.  x (B, S, d) -> (y (B, S, d), final_state
    (B, nh, hd, ds) float32, the state after the last position).

    S is padded with zeros to a multiple of the chunk and the outputs cut
    back to S: the real tokens' outputs are exact (causal), but
    final_state then carries the padding's extra decay, as the
    reference's does; prefill passes chunk-aligned prompts where that
    matters."""
    B, S, _ = x.shape
    di, ds, nh, hd = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, \
        cfg.ssm_head_dim
    Q = min(cfg.ssm_chunk, S)
    S_orig = S
    if S % Q:
        x = F.pad(x, (0, 0, 0, Q - S % Q))
        S = x.shape[1]
    nc = S // Q

    z, xBC, dt = _in_proj(p, x)                        # dt (B, S, nh)
    xBC = F.silu(_causal_conv(xBC, p["conv_w"]))
    xin, Bm, Cm = xBC.split([di, ds, ds], dim=-1)
    scan = _scan_sharded if _is_dtensor(x) else _ssd_scan
    y, state = scan(xin, Bm, Cm, dt, p["A_log"], p["D"], Q, init_state)
    return _out_proj(p, y[:, :S_orig], z[:, :S_orig], cfg), state


def _ssd_scan(xin: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor,
              dt: torch.Tensor, A_log: torch.Tensor, Dp: torch.Tensor,
              Q: int, init_state: torch.Tensor | None):
    """The chunked scan of ``ssd_forward`` over chunks of Q positions:
    xin (B, S, nh·hd), B and C (B, S, ds), dt (B, S, nh) float32, A_log
    and D (nh,).  Returns (y (B, S, nh·hd) float32 with the D skip,
    the final state (B, nh, hd, ds) float32).  Every (batch, head) is
    independent, so a rank computes its own heads (``_scan_sharded``)."""
    B, S, nh = dt.shape
    hd, ds = xin.shape[-1] // nh, Bm.shape[-1]
    nc = S // Q
    a = dt * -torch.exp(A_log)                         # (B, S, nh) log-decay
    xh = xin.reshape(B, S, nh, hd).float()
    xdt = xh * dt[..., None]                           # dt folded into x
    ac = a.reshape(B, nc, Q, nh)
    xc = xdt.reshape(B, nc, Q, nh, hd)
    Bc = Bm.float().reshape(B, nc, Q, ds)
    Cc = Cm.float().reshape(B, nc, Q, ds)

    # Within a chunk: Y[l] = sum_{m<=l} (C[l]·B[m]) L[l, m] x[m].  Lmat
    # is exponentiated in the segment sums' storage; the weights Wt =
    # scores · Lmat take a tensor of their own (autograd keeps Lmat).
    Wt = torch.exp_(_segsum(ac.transpose(2, 3)))       # (B, nc, nh, Q, Q)
    Wt = Wt * torch.einsum("bcln,bcmn->bclm", Cc, Bc)[:, :, None]
    y = torch.matmul(Wt, xc.permute(0, 1, 3, 2, 4))    # (B, nc, nh, Q, hd)
    del Wt
    y = y.permute(0, 1, 3, 2, 4)                       # (B, nc, Q, nh, hd)

    # Each chunk's contribution to the state: sum_m B[m] x[m]
    # exp(total - cum[m]), as (B, nc, nh, hd, ds).  total - cum[m] is the
    # sum of a over the chunk's tail k > m, summed as such (a reverse
    # cumulative sum, shifted by one) for the reason _segsum gives.
    cum = torch.cumsum(ac, dim=2)                      # (B, nc, Q, nh)
    total = cum[:, :, -1]                              # (B, nc, nh)
    tail = ac.flip(2).cumsum(2).flip(2)                # sum over k >= m
    decay_in = torch.exp(F.pad(tail[:, :, 1:], (0, 0, 0, 1)))
    xw = (xc * decay_in[..., None]).reshape(B, nc, Q, nh * hd)
    s_in = torch.matmul(xw.transpose(2, 3), Bc)        # (B, nc, nh·hd, ds)
    s_in = s_in.reshape(B, nc, nh, hd, ds)

    # Across chunks: y_inter[l] = (C[l] · state) exp(cum[l]), then the
    # state decays by the chunk's total and takes the chunk's input.
    state = (torch.zeros((B, nh, hd, ds), dtype=torch.float32,
                         device=xin.device)
             if init_state is None else init_state.float())
    for c in range(nc):
        y_int = torch.einsum("bln,bhpn->blhp", Cc[:, c], state)
        y[:, c] += y_int * torch.exp(cum[:, c])[..., None]
        state = state * torch.exp(total[:, c])[..., None, None] + s_in[:, c]

    y = y.reshape(B, S, nh, hd) + Dp[:, None] * xh
    return y.reshape(B, S, nh * hd), state


def _is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def _scan_sharded(xin, Bm, Cm, dt, A_log, Dp, Q, init_state):
    """``_ssd_scan`` on DTensors: each rank scans its batch rows and,
    where the heads divide "model" (and the batch does not use it), its
    own heads, with B and C replicated across "model"."""
    from torch.distributed.tensor.experimental import local_map

    from repro_torch.dist.mesh import axis_size, dim_names
    from repro_torch.dist.sharding import _norm, batch_axes, placements
    mesh = xin.device_mesh
    bax = batch_axes(mesh, dt.shape[0], SET.scheme()) or ()
    hp = ("model" in dim_names(mesh) and "model" not in bax
          and dt.shape[-1] % axis_size(mesh, "model") == 0)
    b, h = _norm(bax), "model" if hp else None
    x_pl = placements(mesh, (b, None, h))
    bc_pl = placements(mesh, (b, None, None))
    head_pl = placements(mesh, (h,))
    st_pl = placements(mesh, (b, h, None, None))

    def local(xin, Bm, Cm, dt, A_log, Dp, *init):
        return _ssd_scan(xin, Bm, Cm, dt, A_log, Dp, Q,
                         init[0] if init else None)

    ins = (xin, Bm, Cm, dt, A_log, Dp) + (
        () if init_state is None else (init_state,))
    in_pl = (x_pl, bc_pl, bc_pl, x_pl, head_pl, head_pl) + (
        () if init_state is None else (st_pl,))
    return local_map(local, out_placements=(x_pl, st_pl), in_placements=in_pl,
                     device_mesh=mesh, redistribute_inputs=True)(*ins)


def ssd_decode_step(p: dict, x: torch.Tensor, conv_state: torch.Tensor,
                    ssm_state: torch.Tensor, cfg: ModelConfig):
    """One token.  x (B, d); conv_state (B, W-1, di + 2 ds), the previous
    W-1 tokens' pre-conv inputs; ssm_state (B, nh, hd, ds) float32.
    Returns (y (B, d), conv_state, ssm_state), both new tensors."""
    B = x.shape[0]
    di, ds, nh, hd = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, \
        cfg.ssm_head_dim
    z, xBC, dt = _in_proj(p, x)                        # dt (B, nh)
    hist = torch.cat([conv_state, xBC[:, None]], dim=1)  # (B, W, C)
    conv_out = torch.einsum("bwc,wc->bc", hist, p["conv_w"])
    xin, Bm, Cm = F.silu(conv_out).split([di, ds, ds], dim=-1)

    dA = torch.exp(dt * -torch.exp(p["A_log"]))        # (B, nh)
    xh = xin.reshape(B, nh, hd).float()
    ssm_state = ssm_state * dA[..., None, None] + torch.einsum(
        "bn,bhp,bh->bhpn", Bm.float(), xh, dt)
    y = torch.einsum("bn,bhpn->bhp", Cm.float(), ssm_state)
    y = y + p["D"][:, None] * xh
    return _out_proj(p, y.reshape(B, di), z, cfg), hist[:, 1:], ssm_state


def ssd_reference(p: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The oracle: the token-by-token recurrence (slow, exact)."""
    B, S, _ = x.shape
    conv_state = torch.zeros(
        (B, cfg.conv_width - 1, cfg.d_inner + 2 * cfg.ssm_state),
        dtype=x.dtype, device=x.device)
    ssm_state = torch.zeros((B, cfg.ssm_heads, cfg.ssm_head_dim,
                             cfg.ssm_state), dtype=torch.float32,
                            device=x.device)
    ys = []
    for t in range(S):
        y, conv_state, ssm_state = ssd_decode_step(p, x[:, t], conv_state,
                                                   ssm_state, cfg)
        ys.append(y)
    return torch.stack(ys, dim=1)
