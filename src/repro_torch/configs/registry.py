"""Architecture registry: ``--arch <id>`` resolution (port of
``repro.configs.registry``).  The config modules beside it are copies of
the reference's, which are data.  ``input_specs`` waits for the dry-run
slice (ROADMAP queue 1 item 6f)."""
from __future__ import annotations

import importlib

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
