"""Probe of what a gloo world of ranks sharing one card can do (run on the
card; not a test, never collected):

    python3 tests/_mesh_probe.py [collectives] [cold]

collectives  each collective of a world of 2 ranks on CUDA tensors over
             gloo, through c10d's API and through the functional ops
             DTensor issues (each in a world of its own: a rank that
             dies by a signal fails only its world), and an all-reduce
             of 64, 256 and 1 024 MiB of float32 timed;
cold         where a fresh rank's first seconds go: the public switch of
             deterministic algorithms (which imports torch._inductor),
             the card's context, a first matmul, then internlm2-1.8b's
             decode step on DTensors over a "data" mesh of 2 ranks (the
             first and later steps, and the host ops of one under the
             autograd profiler) against the same step in one process.

Prints one line per case.  Ranks start from ``repro_torch.dist.spawn``.
"""
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "..", "src"))

import torch  # noqa: E402

COLLECTIVES = ("c10d all_reduce", "c10d all_gather_into_tensor",
               "c10d reduce_scatter_tensor", "c10d broadcast",
               "c10d all_to_all_single", "funcol all_reduce",
               "funcol reduce_scatter_tensor", "funcol all_gather_tensor",
               "DTensor full_tensor of Shard(0)")


def collective_rank(name: str, dtype: str):
    import faulthandler

    import torch.distributed as dist
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Shard, distribute_tensor

    faulthandler.enable()
    torch.cuda.set_device(0)
    mesh = init_device_mesh("cuda", (2,), mesh_dim_names=("data",))
    dt = getattr(torch, dtype)
    x = torch.arange(16 * 6, device="cuda").reshape(16, 6).to(dt)
    x = x + dist.get_rank()
    api, op = name.split(" ", 1)
    if api == "c10d":
        out = {"all_reduce": lambda: dist.all_reduce(x.clone()),
               "all_gather_into_tensor": lambda: dist.all_gather_into_tensor(
                   x.new_empty((32, 6)), x),
               "reduce_scatter_tensor": lambda: dist.reduce_scatter_tensor(
                   x.new_empty((8, 6)), x),
               "broadcast": lambda: dist.broadcast(x.clone(), 0),
               "all_to_all_single": lambda: dist.all_to_all_single(
                   torch.empty_like(x), x)}[op]()
    elif api == "funcol":
        y = {"all_reduce": lambda: funcol.all_reduce(x, "sum", mesh),
             "reduce_scatter_tensor": lambda: funcol.reduce_scatter_tensor(
                 x, "sum", 0, mesh),
             "all_gather_tensor": lambda: funcol.all_gather_tensor(
                 x, 0, mesh)}[op]()
        out = funcol.wait_tensor(y)
    else:
        out = distribute_tensor(x, mesh, [Shard(0)],
                                src_data_rank=None).full_tensor()
    torch.cuda.synchronize()
    del out
    return "ok"


def all_reduce_rank(mib: tuple) -> dict:
    import torch.distributed as dist
    torch.cuda.set_device(0)
    out = {}
    for m in mib:
        x = torch.ones(m << 18, device="cuda")
        dist.all_reduce(x)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dist.all_reduce(x)
        torch.cuda.synchronize()
        out[m] = time.perf_counter() - t0
    return out


def cold_rank(decode: bool) -> dict:
    import torch.distributed as dist
    out = {}
    t0 = time.perf_counter()
    torch.use_deterministic_algorithms(True, warn_only=True)
    out["use_deterministic_algorithms"] = time.perf_counter() - t0
    torch.use_deterministic_algorithms(False)
    t0 = time.perf_counter()
    torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    out["the card's context"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    a = torch.randn(64, 64, device="cuda")
    float((a @ a).sum())
    out["a first matmul"] = time.perf_counter() - t0
    if not decode:
        return out
    from repro_torch import dist as D
    from repro_torch.configs import registry
    from repro_torch.launch import serve as LS
    from repro_torch.models import transformer as T

    mesh = D.init_mesh((dist.get_world_size(),), ("data",))
    cfg = registry.get_config("internlm2-1.8b")
    params = T.init_params(cfg, seed=0, device="cuda")
    for name, m in (("mesh", mesh), ("one process", None)):
        dec = LS.Decoder(cfg, params, 16, torch.device("cuda"), m)
        cache = dec.cache(96)
        toks = dec.tokens(torch.zeros(16, dtype=torch.int32,
                                      device="cuda"))
        for i in range(4):
            t0 = time.perf_counter()
            _, cache = dec.step(cache, toks)
            torch.cuda.synchronize()
            out[f"decode step {i} ({name})"] = time.perf_counter() - t0
        if m is not None:
            with torch.autograd.profiler.profile() as prof:
                _, cache = dec.step(cache, toks)
                torch.cuda.synchronize()
            rows = sorted(prof.key_averages(),
                          key=lambda r: -r.self_cpu_time_total)
            total = sum(r.self_cpu_time_total for r in rows)
            out["host us of a mesh step"] = total
            out["top host ops"] = [(r.key, r.count, r.self_cpu_time_total)
                                   for r in rows[:4]]
    return out


def main(argv) -> int:
    from repro_torch import dist as D
    parts = argv or ["collectives", "cold"]
    print(torch.__version__, torch.cuda.get_device_name(0), flush=True)
    torch.zeros(1, device="cuda")
    if "collectives" in parts:
        for name in COLLECTIVES:
            for dtype in ("float32", "bfloat16"):
                try:
                    got = D.spawn(collective_rank, 2, args=(name, dtype),
                                  timeout=120)[0]
                except D.RankError as e:
                    got = f"FAILED: {str(e).splitlines()[0][:120]}"
                print(f"collectives: {name} {dtype} on CUDA over gloo: "
                      f"{got}", flush=True)
        secs = D.spawn(all_reduce_rank, 2, args=((64, 256, 1024),),
                       timeout=300)[0]
        for m, t in secs.items():
            print(f"collectives: all_reduce of {m} MiB float32 on CUDA "
                  f"over gloo, 2 ranks: {t:.4f} s", flush=True)
    if "cold" in parts:
        for decode in (False, True):
            for r, got in enumerate(D.spawn(cold_rank, 2, args=(decode,),
                                            timeout=300)):
                print(f"cold: rank {r}: {got}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
