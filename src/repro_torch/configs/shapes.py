"""Assigned input shapes (the × axis of the 40-cell matrix) and
applicability rules: a copy of ``repro.configs.shapes``, which is data."""
from __future__ import annotations

import dataclasses

from repro_torch.models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str          # 'train' | 'prefill' | 'decode'
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524288, 1),
}


def applicable(cfg: ModelConfig, shape: ShapeSpec) -> tuple[bool, str]:
    """(runs?, reason-if-skipped).  long_500k requires sub-quadratic
    sequence mixing (SSM/hybrid); full-attention archs skip it.  All
    assigned archs are decoder-capable, so decode shapes run
    everywhere."""
    if shape.name == "long_500k" and not cfg.ssm:
        return False, "full-attention arch — long_500k needs sub-quadratic"
    return True, ""
