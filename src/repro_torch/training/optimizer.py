"""AdamW with global-norm clipping (port of ``repro.training.optimizer``).

The moments are float32 whatever the parameters' type; each parameter is
updated in float32 and rounded back to its own type, with no float32
master copy, as the reference does.  Every function is pure: it returns
new trees and leaves its inputs as they were (the training loop keeps the
old state until it has judged the step's loss).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.training.tree import leaves, tree_map, unflatten


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100


def init_opt_state(params) -> dict:
    """Zero float32 moments beside ``params`` and the step count (int32)."""
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,  # noqa: E731
                                  device=p.device)
    dev = leaves(params)[0].device
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves (in the reference's leaf order) of each
    leaf's float32 sum of squares."""
    total = 0
    for x in leaves(tree):
        total = total + torch.sum(torch.square(x.float()))
    return torch.sqrt(total)


def clip_by_global_norm(grads, max_norm: float):
    """grads scaled by min(1, max_norm / norm); returns (grads, norm)."""
    norm = global_norm(grads)
    scale = torch.clamp_max(max_norm / torch.clamp_min(norm, 1e-9), 1.0)
    return tree_map(lambda g: g * scale.to(g.dtype), grads), norm


def lr_schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warm-up over ``warmup_steps``, then ``lr`` (float32)."""
    warm = torch.clamp_max((step + 1).float() / max(cfg.warmup_steps, 1),
                           1.0)
    return cfg.lr * warm


def adamw_update(cfg: AdamWConfig, params, grads, opt_state):
    """One AdamW step with decoupled weight decay.  Returns (new params,
    new opt state)."""
    step = opt_state["step"] + 1
    lr = lr_schedule(cfg, step)
    b1c = 1.0 - cfg.b1 ** step.float()
    b2c = 1.0 - cfg.b2 ** step.float()

    def upd(p, g, m, v):
        g32 = g.float()
        m = cfg.b1 * m + (1 - cfg.b1) * g32
        v = cfg.b2 * v + (1 - cfg.b2) * g32 * g32
        mh = m / b1c
        vh = v / b2c
        delta = mh / (torch.sqrt(vh) + cfg.eps) \
            + cfg.weight_decay * p.float()
        return (p.float() - lr * delta).to(p.dtype), m, v

    out = [upd(*x) for x in zip(leaves(params), leaves(grads),
                                leaves(opt_state["m"]),
                                leaves(opt_state["v"]))]
    part = lambda i: unflatten(params, [o[i] for o in out])  # noqa: E731
    return part(0), {"m": part(1), "v": part(2), "step": step}
