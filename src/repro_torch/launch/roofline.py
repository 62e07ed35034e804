"""Roofline terms with depth extrapolation (port of
``repro.launch.roofline``).

The reference lowers each cell in analysis mode (every scan unrolled,
chunks coarsened) at two reduced depths L1 < L2 and extrapolates
linearly to the real depth, because XLA's cost analysis counts a loop
body once.  The port's trace runs every layer, so a full-depth trace
needs no extrapolation; but tracing every layer of every cell through
DTensor takes minutes, so ``roofline_cell`` keeps the reference's
method: two traces under ``settings.analysis_mode`` at depths L1 < L2,

    term(L) = term(L1) + (L - L1)/(L2 - L1) · (term(L2) - term(L1)),

which is exact for FLOPs, bytes and collective bytes, since layers are
identical (the intercept holds the embeddings, the LM head and the
loss).  zamba2's depths are multiples of ``hybrid_attn_every`` so that
each delta holds one shared-block application; whisper varies encoder
and decoder depth together.

``engine_block_intensity`` is the CEP block kernel's analytic
arithmetic intensity, a copy of the reference's model.
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs.shapes import ShapeSpec
from repro_torch.launch import hlo_analysis as HA
from repro_torch.models import settings as SET
from repro_torch.models.config import ModelConfig


def engine_block_intensity(engine_cfg) -> dict:
    """Arithmetic-intensity estimate for the CEP per-event step: the
    unfused per-event scan vs the fused event-block kernel
    (``kernels/block_step.py``), the reference's analytic model:

      * the store is P·N slots; per event the operator runs ~14
        elementwise ops per slot (expire, advance lookup + selects,
        completion detect, spawn compaction, activity reductions);
      * the unfused step streams the five (P, N) store arrays (+ the
        (P, N, A) idset for ANY-capable pattern sets) from memory ~6
        times per event;
      * the fused kernel loads and stores the same arrays ONCE per
        W-event block, plus per-event row IO (StepOut columns and the
        classified event).
    """
    P, N, A = (engine_cfg.num_patterns, engine_cfg.max_pms,
               engine_cfg.max_any_ids)
    W = engine_cfg.block_events
    any_capable = engine_cfg.kinds != "seq"
    store_bytes = P * N * (4 * 4 + 1)          # state/open/bind ×i32 + mask
    if any_capable:
        store_bytes += P * N * A * 4
    row_bytes = 4 * 4 + 8 * P * 4              # StepOut row + event columns
    ops_per_slot = 14.0
    flops_per_event = ops_per_slot * P * N
    unfused_passes = 6.0
    bytes_unfused = unfused_passes * store_bytes + row_bytes
    bytes_fused = 2.0 * store_bytes / W + row_bytes
    return {
        "store_bytes": store_bytes,
        "flops_per_event": flops_per_event,
        "bytes_per_event_unfused": bytes_unfused,
        "bytes_per_event_fused": bytes_fused,
        "intensity_unfused": flops_per_event / bytes_unfused,
        "intensity_fused": flops_per_event / bytes_fused,
        "traffic_ratio": bytes_unfused / bytes_fused,
        "block_events": W,
    }


def analysis_depths(cfg: ModelConfig) -> tuple[ModelConfig, ModelConfig,
                                               int, int, int]:
    """(cfg_L1, cfg_L2, L1, L2, L_target)."""
    if cfg.hybrid_attn_every:
        e = cfg.hybrid_attn_every
        l1, l2 = e, 2 * e
        c1 = dataclasses.replace(cfg, num_layers=l1)
        c2 = dataclasses.replace(cfg, num_layers=l2)
    elif cfg.enc_dec:
        l1, l2 = 2, 3
        c1 = dataclasses.replace(cfg, num_layers=l1, enc_layers=l1)
        c2 = dataclasses.replace(cfg, num_layers=l2, enc_layers=l2)
    else:
        l1, l2 = 2, 3
        c1 = dataclasses.replace(cfg, num_layers=l1)
        c2 = dataclasses.replace(cfg, num_layers=l2)
    return c1, c2, l1, l2, cfg.num_layers


def extrapolate(a: float, b: float, r: float) -> float:
    return a + r * (b - a)


def extrapolated(cfg: ModelConfig, shape: ShapeSpec, chips: int, t1, t2,
                 per_device_mem: float = 0.0) -> HA.Roofline:
    """The roofline at full depth from the counts of the two depths'
    traces (each with ``flops``, ``bytes``, ``coll``)."""
    from repro_torch.launch.dryrun import model_flops
    c1, c2, l1, l2, lt = analysis_depths(cfg)
    get = (lambda t, k: t[k]) if isinstance(t1, dict) else getattr
    r = (lt - l1) / (l2 - l1)
    c = get(t1, "coll")
    return HA.roofline(extrapolate(get(t1, "flops"), get(t2, "flops"), r),
                       extrapolate(get(t1, "bytes"), get(t2, "bytes"), r),
                       c.plus(get(t2, "coll").minus(c).scaled(r)), chips,
                       model_flops(cfg, shape), per_device_mem)


def roofline_cell(cfg: ModelConfig, shape: ShapeSpec, mesh, chips: int, *,
                  device: str = "cuda", causal_skip: bool = True,
                  scheme: str = "tp", attn_flip: bool = False,
                  remat: bool = True) -> HA.Roofline:
    """The cell's roofline: two traces under analysis mode, extrapolated
    to the real depth (per-device memory is not part of it: 0)."""
    from repro_torch.launch import dryrun as DR
    c1, c2 = analysis_depths(cfg)[:2]
    kw = dict(device=device, causal_skip=causal_skip, scheme=scheme,
              attn_flip=attn_flip, remat=remat)
    with SET.analysis_mode():
        r1 = DR.trace_step(c1, shape, mesh, **kw)
        r2 = DR.trace_step(c2, shape, mesh, **kw)
    return extrapolated(cfg, shape, chips, r1, r2)
