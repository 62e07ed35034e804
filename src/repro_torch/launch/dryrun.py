"""Production dry-run: trace every (arch × shape × mesh) cell on DTensors
over a fake mesh (port of ``repro.launch.dryrun``).

For each cell the step (train, prefill or decode) runs once per trace on
DTensors laid out by ``dist.sharding``'s specs over the production mesh
— (data 32, model 8) = 256 H100s, or (pod 2, data 32, model 8) = 512 —
whose process group is fake, under ``FakeTensorMode``: nothing is
allocated, launched or sent, and one rank's local ops are recorded
(``launch.hlo_analysis.TraceRecorder``).  A failure here (a layout
DTensor cannot run, a shape that does not shard) is a bug in the system.

Where each term of a row comes from:
  memory_analysis.argument_gb  exact: the sum of one device's shard bytes
                               of the full-depth params (+ AdamW state),
                               inputs and cache, from their structures
                               (no trace);
  memory_analysis.peak_gb      the live bytes at their most, from traces
                               at the roofline's two depths extrapolated
                               phase by phase to the full depth (layers
                               are identical; ``extrapolated_peak``);
  flops, bytes, coll_bytes     traces under ``settings.analysis_mode`` at
                               the two depths, extrapolated
                               (``launch.roofline``), as the reference's.
Multi-pod rows carry memory only, as in the reference.

The target device is the card (``cuda``) unless ``--device cpu``: then
the trace runs the plain path's device type (fake CPU tensors on a CPU
mesh), which a machine without CUDA can trace.  The flash attention is
the custom op ``repro_torch::flash_attention``, traced through its fake
implementation, FLOP formula and DTensor rule.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch internlm2-1.8b \\
      --shape train_4k [--multi-pod] [--json out.jsonl] [--device cpu]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--device cpu]
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import sys
import time
import traceback

import torch

from repro_torch.configs import registry
from repro_torch.configs.shapes import SHAPES, ShapeSpec, applicable
from repro_torch.dist import sharding as SH
from repro_torch.launch import hlo_analysis as HA
from repro_torch.launch import mesh as M
from repro_torch.launch import roofline as RF
from repro_torch.models import decode as D
from repro_torch.models import settings as SET
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.training import optimizer as O
from repro_torch.training.train_step import make_train_step


def model_flops(cfg: ModelConfig, shape: ShapeSpec) -> float:
    """MODEL_FLOPS = 6·N·D (train) / 2·N·D (inference), N = active params."""
    n = cfg.active_param_count()
    if shape.kind == "train":
        return 6.0 * n * shape.seq_len * shape.global_batch
    if shape.kind == "prefill":
        return 2.0 * n * shape.seq_len * shape.global_batch
    return 2.0 * n * shape.global_batch  # decode: one token per sequence


def step_inputs(cfg: ModelConfig, shape: ShapeSpec, mesh,
                scheme: str = "tp") -> tuple[dict, dict]:
    """(structures, specs) of the step's arguments, as meta tensors:
    train {params, opt, batch}, prefill {params, batch}, decode {params,
    cache, tokens} (decode's params: those it reads,
    ``decode.decode_weights``)."""
    params = T.param_structs(cfg)
    pspecs = SH.param_specs(mesh, cfg, params, scheme=scheme)
    batch = registry.input_specs(cfg, shape)
    if shape.kind == "train":
        opt = O.init_opt_state(params)
        pspecs, ospecs, bspecs = SH.train_specs(mesh, cfg, params, batch,
                                                scheme=scheme, pspecs=pspecs)
        return ({"params": params, "opt": opt, "batch": batch},
                {"params": pspecs, "opt": ospecs, "batch": bspecs})
    if shape.kind == "prefill":
        return ({"params": params, "batch": batch},
                {"params": pspecs,
                 "batch": SH.batch_specs(mesh, cfg, batch, scheme=scheme)})
    tok_spec, _ = SH.decode_specs(mesh, cfg, shape.global_batch)
    params = D.decode_weights(cfg, params)
    pspecs = SH.param_specs(mesh, cfg, params, scheme=scheme)
    return ({"params": params, "cache": batch["cache"],
             "tokens": batch["tokens"]},
            {"params": pspecs,
             "cache": SH.cache_specs(mesh, cfg, batch["cache"]),
             "tokens": tok_spec})


def argument_bytes(cfg: ModelConfig, shape: ShapeSpec, mesh,
                   scheme: str = "tp") -> int:
    """One device's bytes of the step's arguments (exact, full depth)."""
    structs, specs = step_inputs(cfg, shape, mesh, scheme)
    return SH.local_bytes(mesh, structs, specs)


def run_step(cfg: ModelConfig, shape: ShapeSpec, args: dict, *,
             causal_skip: bool = True, remat: bool = True):
    """The cell's step on ``args`` (``step_inputs``' tree, of DTensors or
    of plain tensors alike)."""
    if shape.kind == "train":
        step = make_train_step(cfg, remat=remat, causal_skip=causal_skip)
        return step(args["params"], args["opt"], args["batch"])
    with torch.no_grad():
        if shape.kind == "prefill":
            return D.prefill(cfg, args["params"], args["batch"],
                             max_len=shape.seq_len, remat=remat,
                             causal_skip=causal_skip)
        return D.decode_step(cfg, args["params"], args["cache"],
                             args["tokens"])


# The model's DTensor rules (kept under this name for the dry-run's
# callers; ``settings.use_mesh`` registers them too).
register_rules = SET.register_rules


def trace_step(cfg: ModelConfig, shape: ShapeSpec, mesh, *,
               device: str = "cuda", causal_skip: bool = True,
               scheme: str = "tp", attn_flip: bool = False,
               remat: bool = True) -> HA.TraceRecorder:
    """One trace of the cell's step on ``mesh`` (a DeviceMesh over a fake
    world) under ``FakeTensorMode``; returns the recorder that watched
    it (FLOPs, bytes, collectives, peak live bytes of one rank)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    register_rules()
    structs, specs = step_inputs(cfg, shape, mesh, scheme)
    rec = HA.TraceRecorder(device)
    # Without the cyclic collector the trace frees a tensor when its last
    # reference goes, every run alike; the collector runs at moments that
    # depend on the whole process, and a tensor held by a cycle counts
    # until the step ends.
    gc.collect()
    gc.disable()
    try:
        with FakeTensorMode():
            args = SH.distribute_tree(mesh, structs, specs, device=device)
            rec.hold(args)
            with rec, SET.use_mesh(mesh), SET.use_scheme(scheme, attn_flip):
                out = run_step(cfg, shape, args, causal_skip=causal_skip,
                               remat=remat)
                del args, out
    finally:
        gc.enable()
    return rec


@dataclasses.dataclass(frozen=True)
class Job:
    """One trace of a step: ``arch`` at full depth (``depth`` None) or at
    one of the roofline's two depths (0, 1), on a fake mesh of
    ``mesh_shape`` × ``mesh_names``, under analysis mode or not.  Jobs
    run alone or in a pool of processes (``run_jobs``)."""
    arch: str
    shape: ShapeSpec
    mesh_shape: tuple
    mesh_names: tuple
    depth: int | None = None
    analysis: bool = False
    device: str = "cuda"
    causal_skip: bool = True
    scheme: str = "tp"
    attn_flip: bool = False
    remat: bool = True

    def config(self) -> ModelConfig:
        cfg = registry.get_config(self.arch)
        return cfg if self.depth is None else \
            RF.analysis_depths(cfg)[self.depth]


def run_job(job: Job) -> dict:
    """The trace's counts: {"flops", "bytes", "coll", "peak",
    "timeline"} (see ``TraceRecorder``), or {"error"}."""
    t0 = time.perf_counter()
    try:
        mesh = M.make_mesh(job.mesh_shape, job.mesh_names, job.device)
        mode = SET.analysis_mode() if job.analysis else contextlib.nullcontext()
        with mode:
            rec = trace_step(job.config(), job.shape, mesh, device=job.device,
                             causal_skip=job.causal_skip, scheme=job.scheme,
                             attn_flip=job.attn_flip, remat=job.remat)
    except Exception as e:  # noqa: BLE001 — the cell reports it
        where = traceback.extract_tb(e.__traceback__)[-4:]
        return {"error": repr(e)[:300] + " at " + "; ".join(
            f"{f.filename.rsplit('/', 1)[-1]}:{f.lineno} {f.name}"
            for f in where)}
    return {"flops": rec.flops, "bytes": rec.bytes, "coll": rec.coll,
            "peak": rec.peak, "timeline": rec.timeline,
            "wall_s": time.perf_counter() - t0}


def run_jobs(jobs: list, workers: int = 1) -> list:
    """``run_job`` over ``jobs``, in order; with ``workers`` > 1 in a pool
    of that many processes (spawned: each makes its own fake worlds)."""
    if workers <= 1:
        return [run_job(j) for j in jobs]
    import multiprocessing
    with multiprocessing.get_context("spawn").Pool(workers) as pool:
        return pool.map(run_job, jobs, chunksize=1)


def extrapolated_peak(t1: dict, t2: dict, r: float) -> float:
    """Peak live bytes at full depth from the timelines of the two
    depths' traces (``r`` = (L - L1) / (L2 - L1)).  A phase that runs the
    same ops at both depths (the update, which walks the stacked leaves)
    is extrapolated op by op, any other (forward and backward, whose ops
    grow with the layers) by its peak; the largest is taken.  A phase's
    live bytes grow with depth at rates of their own, so the op that
    holds the peak can move between a shallow and the full depth."""
    peaks = []
    for phase, a in t1.items():
        b = t2[phase]
        if not a:
            continue
        if len(a) == len(b):
            peaks.append(max(RF.extrapolate(x, y, r) for x, y in zip(a, b)))
        else:
            peaks.append(RF.extrapolate(max(a), max(b), r))
    return max(peaks)


def _ratio(cfg: ModelConfig) -> float:
    _, _, l1, l2, lt = RF.analysis_depths(cfg)
    return (lt - l1) / (l2 - l1)


def cell_jobs(arch: str, shape: ShapeSpec, mesh_shape, mesh_names, *,
              roofline: bool = True, **kw) -> list:
    """A row's traces: its memory (default chunks) and, with
    ``roofline``, its roofline (analysis mode), each at the two depths."""
    jobs = [Job(arch, shape, tuple(mesh_shape), tuple(mesh_names), d, False,
                **kw) for d in (0, 1)]
    if roofline:
        jobs += [Job(arch, shape, tuple(mesh_shape), tuple(mesh_names), d,
                     True, **kw) for d in (0, 1)]
    return jobs


def assemble_row(row: dict, cfg: ModelConfig, shape: ShapeSpec, mesh,
                 results: list, scheme: str = "tp") -> dict:
    """A cell's row from ``cell_jobs``' results: exact argument bytes,
    the extrapolated peak and, where traced, the roofline."""
    bad = [r["error"] for r in results if "error" in r]
    if bad:
        return dict(row, status="FAILED", error=bad[0])
    arg = argument_bytes(cfg, shape, mesh, scheme)
    r = _ratio(cfg)
    peak = extrapolated_peak(results[0]["timeline"], results[1]["timeline"],
                             r)
    row = dict(row, chips=mesh.size(), status="ok", memory_analysis={
        "argument_gb": arg / 1e9, "temp_gb": (peak - arg) / 1e9,
        "peak_gb": peak / 1e9})
    if len(results) == 4:
        row.update(**RF.extrapolated(cfg, shape, mesh.size(), results[2],
                                     results[3], peak).row())
    row["trace_s"] = round(sum(x["wall_s"] for x in results), 2)
    return row


def lower_cells(cells: list, *, workers: int = 1, causal_skip: bool = True,
                scheme: str = "tp", attn_flip: bool = False,
                remat: bool = True, device: str = "cuda") -> list:
    """Rows of ``cells`` ((arch, shape name, multi_pod) each; roofline
    terms on the single mesh only, as the reference's), their traces
    run by ``run_jobs`` with ``workers`` processes."""
    kw = dict(device=device, causal_skip=causal_skip, scheme=scheme,
              attn_flip=attn_flip, remat=remat)
    plan, jobs = [], []
    for arch, shape_name, mp in cells:
        cfg, shape = registry.get_config(arch), SHAPES[shape_name]
        row = {"arch": arch, "shape": shape_name,
               "mesh": "multi" if mp else "single"}
        ok, why = applicable(cfg, shape)
        if not ok:
            plan.append((dict(row, status="skipped", reason=why), None))
            continue
        js = cell_jobs(arch, shape, *M.production_topology(multi_pod=mp),
                       roofline=not mp, **kw)
        plan.append((row, (cfg, shape, mp, len(jobs), len(js))))
        jobs += js
    results = run_jobs(jobs, workers)
    rows = []
    for row, p in plan:
        if p is not None:
            cfg, shape, mp, i, n = p
            mesh = M.make_abstract_production_mesh(multi_pod=mp)
            row = assemble_row(dict(row, device=device), cfg, shape, mesh,
                               results[i:i + n], scheme)
        rows.append(row)
    return rows


def lower_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
               **kw) -> dict:
    """One cell's row (its traces in this process)."""
    return lower_cells([(arch, shape_name, multi_pod)], **kw)[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=registry.ARCH_IDS)
    ap.add_argument("--shape", choices=tuple(SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--no-causal-skip", action="store_true",
                    help="baseline flash schedule (full S² masked)")
    ap.add_argument("--scheme", default="tp",
                    choices=("tp", "fsdp", "moe2d"),
                    help="parallelism scheme")
    ap.add_argument("--no-remat", action="store_true",
                    help="disable activation checkpointing (train cells)")
    ap.add_argument("--flip-attn", action="store_true",
                    help="batch-over-(data×model) attention for archs whose "
                         "heads don't divide the model axis")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="the target the trace's tensors claim (cuda, the "
                         "default, needs a CUDA build of torch)")
    ap.add_argument("--workers", type=int, default=1,
                    help="processes that run the traces")
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)

    archs = registry.ARCH_IDS if args.all or not args.arch else (args.arch,)
    shapes = tuple(SHAPES) if args.all or not args.shape else (args.shape,)
    meshes = ((False, True) if args.both_meshes or args.all
              else (args.multi_pod,))
    out = open(args.json, "a") if args.json else None
    failures = 0
    try:
        # Mesh by mesh: a process holds one fake world at a time.
        for mp in meshes:
            rows = lower_cells(
                [(a, s, mp) for a in archs for s in shapes],
                workers=args.workers, causal_skip=not args.no_causal_skip,
                scheme=args.scheme, attn_flip=args.flip_attn,
                remat=not args.no_remat, device=args.device)
            for row in rows:
                if row["status"] == "ok":
                    row.update(scheme=args.scheme, remat=not args.no_remat,
                               attn_flip=args.flip_attn,
                               causal_skip=not args.no_causal_skip)
                failures += row["status"] == "FAILED"
                print(json.dumps(row), flush=True)
                if out:
                    out.write(json.dumps(row) + "\n")
                    out.flush()
    finally:
        if out:
            out.close()
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
