"""The training step: loss -> grads -> clip -> AdamW (port of
``repro.training.train_step``).  Gradients come from autograd (through
the flash kernel, whose backward is its plain version's); a parameter
the loss does not reach gets a zero gradient, as ``jax.grad`` gives it."""
from __future__ import annotations

import torch

from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.training import optimizer as O
from repro_torch.training.tree import leaves, tree_map, unflatten


def loss_and_grads(cfg: ModelConfig, params, batch: dict, *,
                   remat: bool = True, causal_skip: bool = True):
    """(loss, metrics, grads) of ``forward_train`` at ``params`` (each
    layer rematerialised under ``remat``); the loss and metrics
    detached, grads a tree like params."""
    p = tree_map(lambda t: t.detach().requires_grad_(), params)
    loss, metrics = T.forward_train(cfg, p, batch, remat=remat,
                                    causal_skip=causal_skip)
    flat = leaves(p)
    got = torch.autograd.grad(loss, flat, allow_unused=True)
    grads = unflatten(p, [torch.zeros_like(t) if g is None else g
                          for g, t in zip(got, flat)])
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads


def on_param_layouts(grads, params):
    """Each DTensor gradient laid out as its parameter, the counterpart
    of the reference's ``out_shardings``: a parameter replicated over
    the batch's axis gets its gradient's all-reduce there (its partial
    sums), an FSDP shard its reduce-scatter; clipping and AdamW then run
    on each rank's own shards, and every rank holds the same bits of a
    replicated parameter.  Plain tensors pass as they are."""
    from torch.distributed.tensor import DTensor

    def one(g, p):
        if not isinstance(g, DTensor) or g.placements == p.placements:
            return g
        return g.redistribute(p.device_mesh, p.placements)
    return unflatten(params, [one(g, p) for g, p in
                              zip(leaves(grads), leaves(params))])


def make_train_step(cfg: ModelConfig, opt_cfg: O.AdamWConfig | None = None,
                    remat: bool = True, causal_skip: bool = True):
    opt_cfg = opt_cfg or O.AdamWConfig()

    def train_step(params, opt_state, batch: dict):
        """Returns (new params, new opt state, metrics); the inputs are
        left as they were.  On DTensors each gradient first takes its
        parameter's layout (``on_param_layouts``)."""
        loss, metrics, grads = loss_and_grads(cfg, params, batch,
                                              remat=remat,
                                              causal_skip=causal_skip)
        grads = on_param_layouts(grads, params)
        grads, gnorm = O.clip_by_global_norm(grads, opt_cfg.clip_norm)
        params, opt_state = O.adamw_update(opt_cfg, params, grads,
                                           opt_state)
        metrics = dict(metrics, loss=loss, grad_norm=gnorm,
                       step=opt_state["step"])
        return params, opt_state, metrics

    return train_step


def make_eval_step(cfg: ModelConfig, remat: bool = False):
    def eval_step(params, batch: dict):
        with torch.no_grad():
            return T.forward_train(cfg, params, batch, remat=remat)[1]["ce"]

    return eval_step
