"""Architecture registry: ``--arch <id>`` resolution and
``input_specs`` (port of ``repro.configs.registry``).  The config
modules beside it are copies of the reference's, which are data.

``input_specs`` returns meta tensors standing in for every model input
of an (arch × shape) cell — shapes and dtypes, no allocation — which
the dry-run (``launch.dryrun``) lays out and traces against.
"""
from __future__ import annotations

import importlib

import torch

from repro_torch.configs.shapes import SHAPES, ShapeSpec, applicable  # noqa: F401
from repro_torch.models.config import ModelConfig

_MODULES = {
    "zamba2-7b": "repro_torch.configs.zamba2_7b",
    "starcoder2-15b": "repro_torch.configs.starcoder2_15b",
    "qwen1.5-110b": "repro_torch.configs.qwen15_110b",
    "internlm2-1.8b": "repro_torch.configs.internlm2_1_8b",
    "minitron-4b": "repro_torch.configs.minitron_4b",
    "deepseek-v3-671b": "repro_torch.configs.deepseek_v3_671b",
    "deepseek-moe-16b": "repro_torch.configs.deepseek_moe_16b",
    "internvl2-76b": "repro_torch.configs.internvl2_76b",
    "mamba2-1.3b": "repro_torch.configs.mamba2_1_3b",
    "whisper-small": "repro_torch.configs.whisper_small",
}

ARCH_IDS = tuple(_MODULES)


def get_config(arch: str) -> ModelConfig:
    return importlib.import_module(_MODULES[arch]).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return importlib.import_module(_MODULES[arch]).smoke_config()


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, shape: ShapeSpec) -> dict:
    """Meta-tensor inputs for one (arch × shape) cell.

    train:   {tokens, labels [, patches | frames]}
    prefill: {tokens [, patches | frames]}
    decode:  {tokens (B,), cache: ``decode.init_cache``'s structures}
    """
    B, S = shape.global_batch, shape.seq_len
    dt = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
    if shape.kind in ("train", "prefill"):
        batch: dict = {}
        s_text = S
        if cfg.vlm_patches:
            s_text = S - cfg.vlm_patches
            batch["patches"] = _meta((B, cfg.vlm_patches, cfg.d_model), dt)
        if cfg.enc_dec:
            batch["frames"] = _meta((B, cfg.enc_frames, cfg.d_model), dt)
        batch["tokens"] = _meta((B, s_text), torch.int32)
        if shape.kind == "train":
            batch["labels"] = _meta((B, s_text), torch.int32)
        return batch
    from repro_torch.models import decode as D
    return {"tokens": _meta((B,), torch.int32),
            "cache": D.cache_structs(cfg, B, S)}
