"""Online-softmax (flash) attention: the kernel and its plain version.

Port of ``repro.kernels.flash_attention`` (the Pallas TPU kernel
``_flash_kernel``) and of the function it implements,
``repro.models.layers.flash_attention``.  ``flash_attention`` launches
a hand-written CUDA kernel for CUDA tensors and computes
``flash_attention_plain`` for CPU tensors; nothing falls back from one to
the other.  Each dtype has one kernel:

- bfloat16: ``csrc/flash_attention_sm90.cu``, both products on Hopper's
  tensor cores (``wgmma``), K/V tiles by TMA into a ring in shared
  memory, a producer warp and two consumer warpgroups;
- float32: ``csrc/flash_attention.cu``, scalar float32 FMAs, the
  exactness path (TF32 tensor cores would not hold its 2e-5 bar).

Both take D (q/k head dim) a multiple of 8 up to 192 and Dv up to 128:
the dense models' head dims and MLA's (D, Dv) = (192, 128) (deepseek-v3's
128 + 64 of decoupled RoPE).  The bf16 kernel pads them to one of the
instances in ``SM90_INSTANCES`` and counts its launches per instance.

The plain version transliterates ``layers.flash_attention``: the same
``_divisor_chunk`` chunking, the same ``causal_skip`` pair list and the
same cast of the probabilities to v's type before the PV product, which
the bf16 kernel rounds the same way; the kernels sum in another order,
so they are held to a tolerance, not to bits.

Training differentiates the wrapper through ``_FlashAttention``, a
``torch.autograd.Function``: its forward is the kernel (the plain
version on CPU tensors), its backward recomputes the plain version under
autograd on the saved q, k and v and returns that vector-Jacobian
product — the function the reference differentiates, since its Pallas
kernel has no backward either.  A hand-written backward kernel is later
performance work.

The forward is the custom operator ``repro_torch::flash_attention``
(``torch.library.custom_op``), so that the dry-run can trace it
(``launch.dryrun``): its one implementation for every device runs the
kernel on CUDA tensors and the plain version on CPU tensors, as the
wrapper did; ``register_fake`` gives its output (B, Sq, H, Dv) on fake
and meta tensors; its FLOP formula (``torch.utils.flop_counter``)
counts the two products of exactly the (q chunk, kv chunk) pairs the
plain version visits at the chunk sizes in force (``chunks``,
``use_chunks``; the model's ``settings.analysis_mode`` coarsens them),
whatever tiles the kernel runs; and its DTensor sharding rule
(``register_dtensor_rule``) keeps q, k, v and the output sharded alike
on batch and/or heads.  With GQA, heads shard only where the KV heads
divide the mesh dim too (local query head h then reads local KV head h
// G); elsewhere the wrapper first redistributes q, k and v to one
common layout (``_align``), so that the kernel never sees mismatched
shards.  Under DTensor the backward runs the plain version's VJP on
each rank's shards (``local_map``).
"""
from __future__ import annotations

import contextlib
import contextvars
import math

import torch

from repro_torch.kernels import _build

# The plain version's default chunk sizes (the reference's settings).
Q_CHUNK = 512
KV_CHUNK = 1024
_CHUNKS = contextvars.ContextVar("repro_torch_flash_chunks",
                                 default=(Q_CHUNK, KV_CHUNK))


def chunks() -> tuple[int, int]:
    """(q_chunk, kv_chunk) in force: the plain version's chunking and
    the FLOP formula's."""
    return _CHUNKS.get()


@contextlib.contextmanager
def use_chunks(q_chunk: int, kv_chunk: int):
    t = _CHUNKS.set((int(q_chunk), int(kv_chunk)))
    try:
        yield
    finally:
        _CHUNKS.reset(t)


def _divisor_chunk(s: int, target: int) -> int:
    """Largest divisor of s that is <= target (e.g. whisper's 1500 frames
    -> 500 for a 512 target)."""
    c = min(target, s)
    while s % c:
        c -= 1
    return c


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor, *, causal: bool = True,
                          q_chunk: int = Q_CHUNK,
                          kv_chunk: int = KV_CHUNK,
                          causal_skip: bool = True, q_offset: int = 0,
                          scale: float | None = None) -> torch.Tensor:
    """Chunked online-softmax attention in plain PyTorch.

    q: (B, Sq, H, Dk); k: (B, Sk, KVH, Dk); v: (B, Sk, KVH, Dv); GQA via
    KVH | H.  ``causal_skip`` visits only the (q chunk, kv chunk) pairs
    that meet the causal triangle; ``q_offset`` is the global position of
    q[0].  Returns (B, Sq, H, Dv) in q's type.
    """
    B, Sq, H, Dk = q.shape
    _, Sk, KVH, _ = k.shape
    Dv = v.shape[-1]
    G = H // KVH
    if scale is None:
        scale = 1.0 / math.sqrt(Dk)
    cq = _divisor_chunk(Sq, q_chunk)
    ck = _divisor_chunk(Sk, kv_chunk)
    nq, nk = Sq // cq, Sk // ck
    dev = q.device

    qr = q.reshape(B, nq, cq, H, Dk)
    kr = k.reshape(B, nk, ck, KVH, Dk)
    vr = v.reshape(B, nk, ck, KVH, Dv)
    # Each q chunk's running (acc, m, l), replaced rather than written in
    # place, so that autograd can differentiate the loop.
    acc = [torch.zeros((B, cq, H, Dv), dtype=torch.float32, device=dev)] * nq
    m = [torch.full((B, cq, H), float("-inf"), dtype=torch.float32,
                    device=dev)] * nq
    l = [torch.zeros((B, cq, H), dtype=torch.float32, device=dev)] * nq

    for i, j in _pairs(nq, nk, cq, ck, causal, causal_skip, q_offset):
        qi = qr[:, i]
        kj_h = kr[:, j].repeat_interleave(G, dim=2)   # (B, ck, H, Dk)
        vj_h = vr[:, j].repeat_interleave(G, dim=2)
        # (B, cq, H, ck); the reference asks for float32 products.
        s = torch.einsum("bqhd,bkhd->bqhk", qi.float(), kj_h.float()) * scale
        if causal:
            qpos = q_offset + i * cq + torch.arange(cq, device=dev)
            kpos = j * ck + torch.arange(ck, device=dev)
            mask = qpos[:, None] >= kpos[None, :]
            s = torch.where(mask[None, :, None, :], s,
                            torch.full_like(s, float("-inf")))
        mi, li, ai = m[i], l[i], acc[i]
        m_new = torch.maximum(mi, s.amax(dim=-1))
        # guard fully-masked rows
        m_safe = torch.where(torch.isneginf(m_new),
                             torch.zeros_like(m_new), m_new)
        p = torch.exp(s - m_safe[..., None])
        corr = torch.where(torch.isneginf(mi), torch.zeros_like(mi),
                           torch.exp(mi - m_safe))
        l[i] = li * corr + p.sum(dim=-1)
        acc[i] = ai * corr[..., None] + torch.einsum(
            "bqhk,bkhd->bqhd", p.to(v.dtype).float(), vj_h.float())
        m[i] = m_new
    out = torch.stack(acc, 1) / torch.clamp_min(
        torch.stack(l, 1)[..., None], 1e-30)
    return out.reshape(B, Sq, H, Dv).to(q.dtype)


def _pairs(nq: int, nk: int, cq: int, ck: int, causal: bool,
           causal_skip: bool, q_offset: int) -> list:
    """The (q chunk, kv chunk) pairs the plain version visits: with
    ``causal_skip`` only those that meet the causal triangle."""
    if causal and causal_skip:
        return [(i, j) for i in range(nq) for j in range(nk)
                if (q_offset + (i + 1) * cq - 1) >= j * ck]
    return [(i, j) for i in range(nq) for j in range(nk)]


def flash_flops(B: int, Sq: int, Sk: int, H: int, D: int, Dv: int, *,
                causal: bool = True, q_offset: int = 0,
                q_chunk: int = Q_CHUNK, kv_chunk: int = KV_CHUNK,
                causal_skip: bool = True) -> int:
    """FLOPs of the plain version: per visited pair the score product
    (2·cq·ck·D) and the PV product (2·cq·ck·Dv) for every (batch, head),
    as ``torch.utils.flop_counter`` counts its two einsums."""
    cq, ck = _divisor_chunk(Sq, q_chunk), _divisor_chunk(Sk, kv_chunk)
    n = len(_pairs(Sq // cq, Sk // ck, cq, ck, causal, causal_skip,
                   int(q_offset)))
    return n * B * H * 2 * cq * ck * (D + Dv)


_DTYPES = (torch.float32, torch.bfloat16)
MAX_D, MAX_DV = 192, 128
# The bf16 kernel's (DK, DV) instances (flash_attention_sm90.cu).
SM90_INSTANCES = ((64, 64), (128, 128), (192, 128))


def sm90_instance(D: int, Dv: int) -> tuple[int, int]:
    """The (DK, DV) instance the bf16 kernel runs for head dims (D, Dv):
    the smallest that holds both (the launcher's dispatch)."""
    return next(i for i in SM90_INSTANCES if D <= i[0] and Dv <= i[1])


def _check(q, k, v, q_offset, scale):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention: q, k, v must be 4-D "
                         "(B, S, heads, head_dim)")
    B, Sq, H, D = q.shape
    Bk, Sk, KVH, Dk = k.shape
    Dv = v.shape[-1]
    if (Bk, Sk, KVH) != tuple(v.shape[:3]) or Bk != B or Dk != D:
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} disagree")
    if KVH == 0 or H % KVH:
        raise ValueError(f"flash_attention: {H} query heads are not a "
                         f"multiple of {KVH} KV heads")
    for name, d, top in (("head_dim", D, MAX_D), ("v head_dim", Dv, MAX_DV)):
        if not (0 < d <= top and d % 8 == 0):
            raise ValueError(f"flash_attention: the kernels take a {name} "
                             f"that is a multiple of 8 up to {top} (D up to "
                             f"{MAX_D}, Dv up to {MAX_DV}), got {d}")
    if Sk == 0:
        raise ValueError("flash_attention: the kernel needs at least one key")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention: q, k, v must all be float32 or "
                         f"all bfloat16, got {q.dtype}, {k.dtype}, "
                         f"{v.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"flash_attention: {name} on {t.device}, q on "
                             f"{q.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"flash_attention: {name} must be contiguous "
                             "and 16-byte aligned")
    if int(q_offset) < 0:
        raise ValueError("flash_attention: q_offset must be >= 0")
    if q.dtype == torch.bfloat16 and not scale > 0:
        raise ValueError(f"flash_attention: the bf16 kernel takes a "
                         f"positive scale, got {scale}")
    if q.dtype == torch.float32 and B * H > 65535:
        raise ValueError(f"flash_attention: B*H = {B * H} exceeds the "
                         "float32 kernel's grid of 65535")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, q_offset: int = 0,
                    scale: float | None = None,
                    causal_skip: bool = True) -> torch.Tensor:
    """softmax(q·kᵀ·scale [causal]) · v over GQA heads.

    q (B, Sq, H, D), k (B, Sk, KVH, D), v (B, Sk, KVH, Dv); returns
    (B, Sq, H, Dv) in q's type.  On CUDA tensors a kernel runs (D and
    Dv multiples of 8, D up to 192 and Dv up to 128, contiguous): the
    tensor-core kernel for bfloat16 (a positive scale), the SIMT kernel
    for float32.  On CPU tensors the plain version runs at the chunks in
    force (``chunks``), visiting only the pairs that meet the causal
    triangle unless ``causal_skip`` is off (the kernels always skip; the
    output is the same).  When autograd records (grad enabled and an
    input that requires grad) the same forward runs inside
    ``_FlashAttention``, whose backward is the plain version's
    vector-Jacobian product.  DTensors are first aligned (``_align``).
    """
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    q, k, v = _align(q, k, v)
    args = (bool(causal), int(q_offset), float(scale), bool(causal_skip))
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or
                                    v.requires_grad):
        return _FlashAttention.apply(q, k, v, *args)
    return _op(q, k, v, *args)


def _op(q, k, v, causal, q_offset, scale, causal_skip):
    qc, kc = chunks()
    return torch.ops.repro_torch.flash_attention(
        q, k, v, causal, q_offset, scale, qc, kc, causal_skip)


class _FlashAttention(torch.autograd.Function):
    """The flash forward (kernel on the card) with the plain version's
    gradient: the backward recomputes ``flash_attention_plain`` under
    autograd from the saved q, k, v and returns its VJP (on DTensors,
    on each rank's shards)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, q_offset, scale, causal_skip):
        ctx.save_for_backward(q, k, v)
        ctx.args = (causal, q_offset, scale, causal_skip, chunks())
        return _op(q, k, v, causal, q_offset, scale, causal_skip)

    @staticmethod
    def backward(ctx, grad_out):
        q, k, v = ctx.saved_tensors
        need = ctx.needs_input_grad[:3]
        vjp = _vjp(need, *ctx.args)
        from torch.distributed.tensor import DTensor
        if isinstance(q, DTensor):
            from torch.distributed.tensor.experimental import local_map
            pl = tuple(q.placements)
            vjp = local_map(vjp, out_placements=(pl, pl, pl),
                            in_placements=(pl, pl, pl, pl),
                            device_mesh=q.device_mesh,
                            redistribute_inputs=True)
        return tuple(vjp(q, k, v, grad_out)) + (None,) * 4


def _vjp(need, causal, q_offset, scale, causal_skip, chunk):
    """The plain version's VJP at the forward's chunks: (dq, dk, dv),
    None where no gradient is needed."""
    def run(q, k, v, grad_out):
        with torch.enable_grad():
            ins = [t.detach().requires_grad_(n)
                   for t, n in zip((q, k, v), need)]
            out = flash_attention_plain(
                *ins, causal=causal, q_offset=q_offset, scale=scale,
                q_chunk=chunk[0], kv_chunk=chunk[1],
                causal_skip=causal_skip)
            got = iter(torch.autograd.grad(
                out, [t for t, n in zip(ins, need) if n], grad_out))
        return tuple(next(got) if n else None for n in need)
    return run


def _align(q, k, v):
    """DTensor inputs redistributed to one layout the kernel takes
    shard by shard: per mesh dim, q's placement where it is a shard of
    the batch (dim 0) or of the heads (dim 2) that divides evenly for q,
    k and v — the heads only where the KV heads divide too —, else
    replicated.  Plain tensors pass as they are."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    if not isinstance(q, DTensor):
        return q, k, v
    mesh = q.device_mesh
    want = []
    for md, p in enumerate(q.placements):
        n = mesh.size(md)
        ok = isinstance(p, Shard) and p.dim in (0, 2) and all(
            t.shape[p.dim] % n == 0 for t in (q, k, v))
        want.append(p if ok else Replicate())
    want = tuple(want)
    return tuple(t if tuple(t.placements) == want else
                 t.redistribute(mesh, want) for t in (q, k, v))


@torch.library.custom_op("repro_torch::flash_attention", mutates_args=())
def _flash_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool, q_offset: int, scale: float, q_chunk: int,
              kv_chunk: int, causal_skip: bool) -> torch.Tensor:
    """The forward on q's device: the plain version on the CPU, a kernel
    on the card (counted)."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal,
                                     q_offset=q_offset, scale=scale,
                                     q_chunk=q_chunk, kv_chunk=kv_chunk,
                                     causal_skip=causal_skip)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    _check(q, k, v, q_offset, scale)
    B, Sq, H, D = q.shape
    _, Sk, KVH, Dv = v.shape
    out = q.new_empty((B, Sq, H, Dv))
    lib = _build.load()
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, Sq,
            Sk, H, KVH, D, Dv, int(bool(causal)), int(q_offset),
            float(scale), torch.cuda.current_stream(q.device).cuda_stream)
    if q.dtype == torch.bfloat16:
        _build.check(lib.flash_attention_sm90_launch(*args),
                     "flash_attention (bf16)")
        flash_attention.sm90_launches += 1
        flash_attention.sm90_instances[sm90_instance(D, Dv)] += 1
    else:
        _build.check(lib.flash_attention_launch(*args),
                     "flash_attention (float32)")
    flash_attention.launches += 1
    return out


@_flash_op.register_fake
def _flash_fake(q, k, v, causal, q_offset, scale, q_chunk, kv_chunk,
                causal_skip):
    return q.new_empty(tuple(q.shape[:3]) + (v.shape[-1],))


def _register_flop_formula() -> None:
    from torch.utils.flop_counter import register_flop_formula

    @register_flop_formula(torch.ops.repro_torch.flash_attention)
    def _formula(q_shape, k_shape, v_shape, causal, q_offset, scale,
                 q_chunk, kv_chunk, causal_skip, *args, out_shape=None,
                 **kwargs) -> int:
        B, Sq, H, D = q_shape
        return flash_flops(B, Sq, k_shape[1], H, D, v_shape[-1],
                           causal=causal, q_offset=q_offset,
                           q_chunk=q_chunk, kv_chunk=kv_chunk,
                           causal_skip=causal_skip)


_register_flop_formula()


def register_dtensor_rule() -> None:
    """The op's DTensor sharding rule (once per process): per mesh dim q,
    k, v and the output all replicated, all sharded on the batch (dim
    0), or all sharded on the heads (dim 2); DTensor drops a choice whose
    shards would be uneven for any of them (GQA's KV heads), so local
    query heads always read their own KV heads."""
    if getattr(register_dtensor_rule, "done", False):
        return
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import register_sharding

    @register_sharding(torch.ops.repro_torch.flash_attention.default)
    def _rule(q, k, v, *args):
        rest = [None] * len(args)
        return [([p], [p, p, p] + rest)
                for p in (Replicate(), Shard(0), Shard(2))]

    register_dtensor_rule.done = True


# Launches of either kernel, of the bf16 tensor-core kernel alone, and of
# the bf16 kernel by (DK, DV) instance.
flash_attention.launches = 0
flash_attention.sm90_launches = 0
flash_attention.sm90_instances = dict.fromkeys(SM90_INSTANCES, 0)


def wgmma_probe(a: torch.Tensor, b: torch.Tensor,
                v: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Run the bf16 kernel's building blocks on two small products
    (``csrc/flash_attention_sm90.cu``): a, b, v are (64, 128) bf16 on the
    card; returns C = a · bᵀ (64, 64) and E = bf16(C) · v (64, 128),
    both float32.  The plain version is ``torch.matmul`` of the same
    tiles."""
    for name, t in (("a", a), ("b", b), ("v", v)):
        if t.device.type != "cuda":
            raise ValueError(f"wgmma_probe runs on a CUDA device ({name} on "
                             f"{t.device})")
        if (t.shape != (64, 128) or t.dtype != torch.bfloat16
                or not t.is_contiguous()):
            raise ValueError(f"wgmma_probe: {name} must be a contiguous "
                             "(64, 128) bfloat16 tensor")
    c = torch.empty((64, 64), dtype=torch.float32, device=a.device)
    e = torch.empty((64, 128), dtype=torch.float32, device=a.device)
    _build.check(_build.load().wgmma_probe_launch(
        a.data_ptr(), b.data_ptr(), v.data_ptr(), c.data_ptr(), e.data_ptr(),
        torch.cuda.current_stream(a.device).cuda_stream), "wgmma_probe")
    return c, e
