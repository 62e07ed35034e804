"""Latency-bounded serving driver: real decode_step + pSPICE scheduler
(port of ``repro.launch.serve``).

Runs a model with genuine decode compute while the pSPICE scheduler
(``repro_torch/serving/scheduler.py``) makes admission/eviction decisions
from its online-learned Markov utility model.  The step cost fed to the
scheduler is the MEASURED wall-clock of ``decode_step`` (synchronised on
the card), so this is the paper's architecture end to end: operator
(decode batch) + overload detector + model builder + load shedder.  The
reference's mesh and sharding specs drop out: the port serves on one card.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch internlm2-1.8b \\
      --requests 64 --rate 50 --policy pspice [--device cpu]
"""
from __future__ import annotations

import argparse
import contextlib
import time

import torch

from repro_torch.configs import registry
from repro_torch.device import resolve_device
from repro_torch.dist import sharding as SH
from repro_torch.dist.mesh import AbstractMesh, broadcast_object, mesh_rank
from repro_torch.launch import mesh as M
from repro_torch.models import decode as D
from repro_torch.models import settings as SET
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.serving.scheduler import (PSpiceScheduler, SchedulerConfig,
                                           synth_workload)


class Decoder:
    """``decode_step`` of ``cfg`` on ``params`` at batch ``slots``: in one
    process, or over ``mesh`` (a DeviceMesh) with the params laid out by
    ``param_specs``, the cache by ``cache_specs`` and the tokens by
    ``decode_specs``, the step under ``settings.use_mesh``."""

    def __init__(self, cfg: ModelConfig, params: dict, slots: int, dev,
                 mesh=None):
        self.cfg, self.mesh, self.dev, self.slots = cfg, mesh, dev, slots
        if mesh is not None:
            params = SH.distribute_tree(mesh, params,
                                        SH.param_specs(mesh, cfg, params))
        self.params = params

    def on_mesh(self):
        return contextlib.nullcontext() if self.mesh is None else \
            SET.use_mesh(self.mesh)

    def tokens(self, toks: torch.Tensor) -> torch.Tensor:
        """A global (slots,) token batch as the step takes it."""
        if self.mesh is None:
            return toks
        tok_spec, _ = SH.decode_specs(self.mesh, self.cfg, self.slots)
        return SH.distribute_tree(self.mesh, toks, tok_spec)

    def cache(self, max_len: int) -> dict:
        with self.on_mesh():
            return D.init_cache(self.cfg, self.slots, max_len,
                                device=self.dev)

    def step(self, cache: dict, toks: torch.Tensor):
        """(logits, cache): one decode step (the cache written in place)."""
        with self.on_mesh():
            return D.decode_step(self.cfg, self.params, cache, toks)


def serve(cfg: ModelConfig, params: dict, *, requests: int = 64,
          rate: float = 50.0, policy: str = "pspice", slots: int = 16,
          slo: float = 1.0, max_len: int = 96, device=None,
          step_cost: float | None = None, log=print, mesh=None) -> dict:
    """Serve ``requests`` synthetic requests with ``slots`` KV slots.

    The scheduler's clock advances by ``step_cost`` seconds per decode
    step at batch ``slots``; None measures it here.  Runs that compare
    policies pass one cost to all of them, so that each schedules the
    same virtual workload.  ``mesh`` (a DeviceMesh; every rank calls
    ``serve`` alike) decodes over it (``Decoder``) and runs every rank's
    scheduler on rank 0's measured cost.  Returns {"metrics": the
    scheduler's metrics, "step_cost": the seconds used, "measured": this
    rank's own measurement (None where a cost was given),
    "decode_steps": the real decode steps run, "finished": requests
    finished (completed or evicted)}."""
    dev = resolve_device(device)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    B = slots
    dec = Decoder(cfg, params, B, dev, mesh)
    toks = dec.tokens(torch.zeros((B,), dtype=torch.int32, device=dev))
    measured = None
    if step_cost is None:
        # Warm up + measure the real step cost on a cache of its own:
        # decode writes its cache in place, and the live loop starts from
        # an empty one.
        _, cache_w = dec.step(dec.cache(max_len), toks)
        sync()
        t0 = time.perf_counter()
        for _ in range(5):
            _, cache_w = dec.step(cache_w, toks)
        sync()
        measured = (time.perf_counter() - t0) / 5
        del cache_w
        step_cost = measured if mesh is None else \
            broadcast_object(measured, mesh)
        log(f"[serve] measured decode_step cost (B={B}): "
            f"{step_cost*1e3:.2f}ms")

    scfg = SchedulerConfig(max_slots=B, slo=slo, policy=policy,
                           step_cost_base=step_cost * 0.5,
                           step_cost_per_seq=step_cost * 0.5 / max(B, 1))
    sched = PSpiceScheduler(scfg, device=dev)
    reqs = synth_workload(requests, rate=rate, cfg=scfg)
    i = 0
    cache_live = dec.cache(max_len)
    n_steps = 0
    while len(sched.finished) < len(reqs):
        while i < len(reqs) and reqs[i].arrival <= sched.time:
            sched.submit(reqs[i])
            i += 1
        if i >= len(reqs) // 3 and sched.ut is None:
            sched.build_model()
            log("[serve] pSPICE utility model built")
        if not sched.active and not sched.queue and i < len(reqs):
            sched.time = max(sched.time, reqs[i].arrival)
            continue
        sched.run_step()
        if sched.active and n_steps < max_len - 1:
            _, cache_live = dec.step(cache_live, toks)  # real compute
            n_steps += 1
    sync()
    m = sched.metrics()
    log(f"[serve] policy={policy} completed={m['completed']} "
        f"evicted={m['evicted']} in_slo={m['in_slo']} "
        f"goodput={m['goodput']:.3f}")
    return {"metrics": m, "step_cost": step_cost, "measured": measured,
            "decode_steps": n_steps, "finished": len(sched.finished)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="internlm2-1.8b",
                    choices=registry.ARCH_IDS)
    ap.add_argument("--requests", type=int, default=64)
    ap.add_argument("--rate", type=float, default=50.0)
    ap.add_argument("--policy", default="pspice",
                    choices=("pspice", "random", "admission"))
    ap.add_argument("--slots", type=int, default=16)
    ap.add_argument("--slo", type=float, default=1.0)
    ap.add_argument("--max-len", type=int, default=96)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    cfg = registry.get_smoke_config(args.arch)
    dev = resolve_device(args.device)
    mesh = M.make_host_mesh(dev.type)
    if isinstance(mesh, AbstractMesh):
        mesh = None                    # a world of one: one process
    params = T.init_params(cfg, seed=0, device=dev)
    serve(cfg, params, requests=args.requests, rate=args.rate,
          policy=args.policy, slots=args.slots, slo=args.slo,
          max_len=args.max_len, device=dev, mesh=mesh,
          log=print if mesh is None or mesh_rank(mesh) == 0 else
          (lambda s: None))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
