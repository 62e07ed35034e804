"""Rank functions of the port's dist tests (tests/test_torch_dist*.py).

Each runs on every rank of a world that ``repro_torch.dist.spawn``
starts, so this module imports torch and the port only (the ranks never
load jax).  Inputs arrive as the NumPy trees of
``repro_torch.cep.convert.tree_to_numpy``; results leave as flat
``{path: array}`` dicts (``flat``), which the tests compare with the
reference's, stored the same way.
"""
import os
import pathlib
import subprocess
import sys
import time

import numpy as np

from repro_torch.cep import convert
from repro_torch.cep import engine as eng


HERE = pathlib.Path(__file__).resolve().parent
WORLD_TIMEOUT = 120.0      # seconds: every world and reference subprocess


def reference_process(part: str, out: pathlib.Path) -> subprocess.Popen:
    """The reference's truth in a subprocess (its device count must be
    forced before jax starts)."""
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([str(HERE.parent / "src"),
                                           str(HERE)]))
    return subprocess.Popen(
        [sys.executable, str(HERE / "_dist_reference.py"), part, str(out)],
        env=env, cwd=HERE, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)


def reference_result(proc: subprocess.Popen, out: pathlib.Path) -> dict:
    log, _ = proc.communicate(timeout=WORLD_TIMEOUT)
    assert proc.returncode == 0, log[-4000:]
    with np.load(out) as z:
        return dict(z)


def flat(tree, path=""):
    """``{path: array}`` of a tree's leaves; a uint32 key as its int32
    bits."""
    out = {}

    def walk(x, p):
        if isinstance(x, dict):
            for k, v in x.items():
                walk(v, f"{p}.{k}")
        elif isinstance(x, list):
            for i, v in enumerate(x):
                walk(v, f"{p}[{i}]")
        else:
            a = np.asarray(x)
            out[p] = a.view(np.int32) if a.dtype == np.uint32 else a
    walk(convert.tree_to_numpy(tree), path)
    return out


def result(carry, outs) -> dict:
    return {**flat(carry, "carry"), **flat(outs, "outs")}


def port_inputs(model, events, carry, device="cpu"):
    return (convert.model_from_numpy(model, device),
            convert.events_from_numpy(events, device),
            convert.carry_from_numpy(carry, device))


def world(jobs, device="cpu"):
    """Every job on this rank: ``jobs`` holds (kind, mesh shape, dim
    names, cases) with kind "engine", "lanes" or "runtime"; returns
    {case name: result} of them all."""
    from repro_torch import dist as D
    out = {}
    for kind, shape, names, cases in jobs:
        mesh = D.init_mesh(shape, names)
        out.update(KINDS[kind](mesh, cases, device))
    return out


def engine_cases(mesh, cases, device):
    """``run_engine_sharded`` of each (name, port cfg, axis, model,
    events, carry) with NumPy inputs."""
    from repro_torch import dist as D
    return {name: result(*D.run_engine_sharded(
        cfg, *port_inputs(*inputs, device), mesh=mesh, axis=axis,
        device=device)) for name, cfg, axis, *inputs in cases}


def lanes_cases(mesh, cases, device):
    """``run_chunk_lanes_sharded`` chunk by chunk: each case is (name,
    port cfg, chunk, model, events, carry) with lane-stacked NumPy
    inputs; every chunk's result is kept."""
    from repro_torch import dist as D
    out = {}
    for name, cfg, chunk, *inputs in cases:
        model, events, carry = port_inputs(*inputs, device)
        n = events.ev_class.shape[1]
        for k, s in enumerate(range(0, n, chunk)):
            piece = eng.EventBatch(*(x[:, s:s + chunk] for x in events))
            carry, o = D.run_chunk_lanes_sharded(cfg, model, piece, carry,
                                                 s, mesh=mesh, device=device)
            out[f"{name}/chunk{k}"] = result(carry, o)
    return out


def runtime_cases(mesh, cases, device):
    """``MultiTenantRuntime(mesh)``: each case is (name, port cfg, chunk,
    push, seed, model, events) with lane-stacked NumPy inputs; the events
    are pushed ``push`` at a time, then flushed.  Keeps the final carry
    and the per-chunk telemetry (``TELEMETRY``)."""
    from repro_torch import runtime as RT
    out = {}
    for name, cfg, chunk, push, seed, model, events in cases:
        model = convert.model_from_numpy(model, device)
        events = convert.events_from_numpy(events, device)
        srt = RT.MultiTenantRuntime(
            cfg, model, events.ev_class.shape[0],
            rt=RT.RuntimeConfig(chunk_size=chunk), seed=seed, mesh=mesh,
            device=device)
        n = events.ev_class.shape[1]
        for s in range(0, n, push):
            srt.push(RT.slice_events(events, s, min(s + push, n), 1))
        srt.flush()
        rows = srt.telemetry.rows()
        out[name] = {**flat(srt.carry, "carry"),
                     **{f"telemetry.{k}": np.array([r[k] for r in rows])
                        for k in TELEMETRY}}
    return out


def persist_cases(mesh, cases, device):
    """A mesh runtime with persistence: each case is (name, port cfg,
    chunk, directory, model, events); one chunk runs, then the writer
    takes a snapshot.  Keeps whether this rank writes (its runtime's
    config keeps persistence) and what it wrote."""
    from repro_torch import runtime as RT
    out = {}
    for name, cfg, chunk, d, model, events in cases:
        model = convert.model_from_numpy(model, device)
        events = convert.events_from_numpy(events, device)
        srt = RT.MultiTenantRuntime(
            cfg, model, events.ev_class.shape[0],
            rt=RT.RuntimeConfig(chunk_size=chunk,
                                persist=RT.PersistConfig(dir=d)),
            mesh=mesh, device=device)
        srt.push(RT.slice_events(events, 0, chunk, 1))
        writer = srt.persist is not None
        out[name] = {"writer": writer, "rt_persist": srt.rt.persist is not None,
                     "snapshot": srt.snapshot_now() if writer else None}
    return out


def chunk_runtime_cases(mesh, cases, device):
    """``MultiTenantRuntime(mesh)`` fed one chunk a push: each case is
    (name, port cfg, chunk, seed, model, events) with lane-stacked NumPy
    inputs.  Keeps the carry (a NumPy tree) before the first chunk and
    after every chunk, and the telemetry's per-chunk counter deltas."""
    from repro_torch import runtime as RT
    out = {}
    for name, cfg, chunk, seed, model, events in cases:
        model = convert.model_from_numpy(model, device)
        events = convert.events_from_numpy(events, device)
        srt = RT.MultiTenantRuntime(
            cfg, model, events.ev_class.shape[0],
            rt=RT.RuntimeConfig(chunk_size=chunk), seed=seed, mesh=mesh,
            device=device)
        carries = [convert.tree_to_numpy(srt.carry)]
        for s in range(0, events.ev_class.shape[1], chunk):
            srt.push(RT.slice_events(events, s, s + chunk, 1))
            carries.append(convert.tree_to_numpy(srt.carry))
        rows = srt.telemetry.rows()
        out[name] = {"carries": carries, "telemetry": {
            k: np.array([r[k] for r in rows]) for k in COUNTERS}}
    return out


def mixed_specs(p: int):
    """The port's copy of ``_dist_reference._mixed(p)``: the lane
    fixture's patterns, for the refresh of a rank that loads no jax."""
    from repro_torch.cep import patterns as pat
    out = []
    for k in range(p // 2):
        out += [pat.make_q1(window_size=300 + 100 * k, num_symbols=4),
                pat.make_q4(any_n=3, window_size=100 + 20 * k, slide=40)]
    return out


def durable_config(RT, d, chunk, refresh_every, snapshot_every):
    """The durable runtime's config in either package (``RT`` is
    ``repro.runtime`` or ``repro_torch.runtime``): chunks of ``chunk``,
    refresh and a snapshot on their cadences, persistence under ``d``
    (none when ``d`` is None)."""
    return RT.RuntimeConfig(
        chunk_size=chunk,
        refresh=RT.RefreshConfig(every_chunks=refresh_every,
                                 min_observations=64.0),
        persist=None if d is None else RT.PersistConfig(
            dir=str(d), snapshot_every_chunks=snapshot_every))


def durable_run(srt, events, push: int, recover: bool = True) -> dict:
    """One lifetime of a durable lane runtime, as the supervisor's child
    runs one stream: recover from disk (a no-op on an empty directory),
    push the lane-stacked ``events`` from the report's next push, flush.
    Returns the carry's sha256, the telemetry's semantic counters, the
    events processed and the recovery report (its wall apart)."""
    from repro_torch.runtime import chunker
    from repro_torch.runtime import supervisor as SV
    rep = srt.recover_from_disk() if recover else None
    wall = None if rep is None else rep.pop("recovery_wall_s")
    n = events.ev_class.shape[1]
    first = 0 if rep is None else rep["next_record"] * push
    for s in range(first, n, push):
        srt.push(chunker.slice_events(events, s, min(s + push, n), 1))
    srt.flush()
    return {"carry_sha": SV.carry_sha(srt),
            "counters": SV.semantic_counters(srt),
            "events_processed": int(srt.events_processed),
            "recovery": rep, "recovery_wall_s": wall,
            "carry": flat(srt.carry, "carry")}


def durable_world(shape, names, cells, kill=None, device="cpu"):
    """Every rank of a world: each cell (name, port cfg, chunk, push,
    refresh_every, snapshot_every, directory, model, events) with
    lane-stacked NumPy inputs through ``MultiTenantRuntime(mesh)`` with
    persistence under its directory (rank 0 writes), ``durable_run``.
    ``kill`` = (rank, "site:after") arms the kill switch in that rank
    alone, so it dies by SIGKILL at that hit and the world with it.
    Returns {cell name: ``durable_run``'s report}."""
    import torch.distributed as dist

    from repro_torch import dist as D
    from repro_torch import runtime as RT
    from repro_torch.runtime import faults as FT
    mesh = D.init_mesh(shape, names)
    if kill is not None and dist.get_rank() == kill[0]:
        FT.install_kill_from_env({FT.KILL_ENV: kill[1]})
    out = {}
    for name, cfg, chunk, push, every, snap, d, model, events in cells:
        model = convert.model_from_numpy(model, device)
        events = convert.events_from_numpy(events, device)
        srt = RT.MultiTenantRuntime(
            cfg, model, events.ev_class.shape[0],
            rt=durable_config(RT, d, chunk, every, snap),
            specs=mixed_specs(cfg.num_patterns), seed=5, mesh=mesh,
            device=device)
        out[name] = durable_run(srt, events, push)
    return out


def killed_rank(stamp: str):
    """Rank 1 notes the time and dies by SIGKILL; rank 0 waits in a
    collective with it."""
    import signal

    import torch
    import torch.distributed as dist
    if dist.get_rank() == 1:
        time.sleep(0.5)
        pathlib.Path(stamp).write_text(repr(time.time()))
        os.kill(os.getpid(), signal.SIGKILL)
    dist.all_reduce(torch.zeros(1))
    return dist.get_rank()


KINDS = {"engine": engine_cases, "lanes": lanes_cases,
         "runtime": runtime_cases, "persist": persist_cases,
         "chunks": chunk_runtime_cases}

# The carry's float32 counters, which the merge sums over pattern shards.
COUNTERS = ("pms_shed", "shed_calls", "overflow", "ebl_dropped")


# Per-chunk telemetry the mesh runtime must report as the reference's.
TELEMETRY = ("n_events", "l_e_max", "n_pm_end", "shed_events",
             "dropped_events", "completions")


def failing_world(bad_rank: int, delay: float):
    """Rank ``bad_rank`` raises; every other rank waits in a collective
    that can never complete."""
    import torch
    import torch.distributed as dist
    if dist.get_rank() == bad_rank:
        time.sleep(delay)
        raise ValueError(f"rank {bad_rank} fails on purpose")
    dist.all_reduce(torch.zeros(1))
    return dist.get_rank()


def hanging_world(sleep: float):
    """Rank 0 waits in a collective while rank 1 sleeps ``sleep`` s."""
    import torch
    import torch.distributed as dist
    if dist.get_rank() == 1:
        time.sleep(sleep)
    dist.all_reduce(torch.zeros(1))
    return dist.get_rank()


def stats_world(shape, names, cfg, model, events, carry):
    """The collective counts of one ``run_engine_sharded``."""
    import dataclasses

    from repro_torch import dist as D
    mesh = D.init_mesh(shape, names)
    D.stats.reset()
    D.run_engine_sharded(cfg, *port_inputs(model, events, carry), mesh=mesh,
                         device="cpu")
    return dataclasses.asdict(D.stats)


def compressed_sync_rank(grads, err):
    """One rank of the compressed all-reduce world
    (tests/test_torch_training.py): rounds of ``compression.sync_tree``
    over the world on this rank's rows of ``grads`` (a list of rounds)
    with the error state carried, from ``err``'s rows.  Returns
    ``{"round{i}.mean.<path>", "round{i}.err.<path>"}`` of this rank."""
    import torch
    import torch.distributed as dist

    from repro_torch.training import compression as C

    r = dist.get_rank()

    def row(tree):
        if isinstance(tree, dict):
            return {k: row(v) for k, v in tree.items()}
        return torch.from_numpy(np.array(tree[r]))

    def flat_np(tree, path):
        if isinstance(tree, dict):
            out = {}
            for k, v in tree.items():
                out.update(flat_np(v, f"{path}.{k}"))
            return out
        return {path: tree.numpy()}

    e, out = row(err), {}
    for i, g in enumerate(grads):
        mean, e = C.sync_tree(row(g), e)
        out.update(flat_np(mean, f"round{i}.mean"))
        out.update(flat_np(e, f"round{i}.err"))
    return out


# ---------------------------------------------------------------------------
# launch.train and launch.serve over a "data" mesh of the world
# (tests/test_torch_launch_mesh.py)
# ---------------------------------------------------------------------------

def _model_cfg(arch: str, fsdp: bool):
    import dataclasses

    from repro_torch.configs import registry
    cfg = registry.get_smoke_config(arch)
    return dataclasses.replace(cfg, fsdp=True) if fsdp else cfg


def _whole_np(tree) -> dict:
    """``{path: array}`` of a tree of tensors or DTensors, each leaf whole
    (a DTensor gathered: every rank calls it)."""
    from repro_torch.launch.train import replicated
    from repro_torch.training.tree import items
    return {"/".join(map(str, p)): replicated(t).detach().numpy()
            for p, t in items(tree)}


def _local_bits_equal(a, b) -> bool:
    """Whether two trees of DTensors hold the same bits on this rank."""
    import torch

    from repro_torch.training.tree import items
    return all(torch.equal(x.to_local(), y.to_local()) for (_, x), (_, y)
               in zip(items(a), items(b)))


def train_world(arch, fsdp, np_params, steps, batch, seq, opt):
    """``launch.train``'s loop on this world's "data" mesh, one step a
    call: per step the loss, the gradient norm and the whole params; the
    local shape and placements of each param."""
    import torch.distributed as dist

    from repro_torch import dist as D
    from repro_torch.launch import train as LT
    from repro_torch.models import convert as MC
    from repro_torch.training import optimizer as O
    from repro_torch.training.tree import items

    cfg = _model_cfg(arch, fsdp)
    mesh = D.init_mesh((dist.get_world_size(),), ("data",))
    params = MC.params_from_numpy(np_params, "cpu")
    state = {"params": params, "opt": O.init_opt_state(params)}
    out = {"losses": [], "grad_norms": [], "params": []}
    for step in range(steps):
        run = LT.train_loop(cfg, state["params"], state["opt"],
                            steps=step + 1, start=step, batch=batch,
                            seq=seq, opt_cfg=O.AdamWConfig(**opt),
                            device="cpu", log=lambda s: None, mesh=mesh)
        state = {"params": run["params"], "opt": run["opt"]}
        out["losses"] += run["losses"]
        out["grad_norms"] += run["grad_norms"]
        out["params"].append(_whole_np(state["params"]))
    out["local"] = {"/".join(map(str, p)): (tuple(t.to_local().shape),
                                            [str(x) for x in t.placements])
                    for p, t in items(state["params"])}
    return out


def nan_resume_world(arch, fsdp, ckpt_dir, batch, seq, opt):
    """On this world's mesh: 6 steps with a checkpoint every 2 and a NaN
    at step 3 (the step-2 checkpoint restored, batches 2 and 3 skipped),
    held bit for bit to the uninterrupted run of batches 0, 1, 4, 5; then
    2 steps on from memory held to 2 steps resumed from the step-6
    checkpoint.  Returns the checks, the whole step-6 state and the
    number of checkpoint generations this rank wrote."""
    import torch.distributed as dist

    from repro_torch import dist as D
    from repro_torch.launch import train as LT
    from repro_torch.models import transformer as T
    from repro_torch.training import checkpoint as CK
    from repro_torch.training import optimizer as O
    from repro_torch.training.tree import tree_map

    cfg = _model_cfg(arch, fsdp)
    mesh = D.init_mesh((dist.get_world_size(),), ("data",))
    writes = []
    save = CK._save

    def counted(*a, **k):
        writes.append(a[1])
        return save(*a, **k)
    CK._save = counted
    kw = dict(batch=batch, seq=seq, opt_cfg=O.AdamWConfig(**opt),
              device="cpu", log=lambda s: None, mesh=mesh)
    params = T.init_params(cfg, seed=0, device="cpu")
    saved, restores = {}, []

    def on_checkpoint(kind, step, state):
        if kind == "save":
            saved[step] = tree_map(lambda t: t.clone(), state)
        else:
            restores.append((step, _local_bits_equal(state, saved[step])))
    run = LT.train_loop(cfg, params, O.init_opt_state(params), steps=6,
                        ckpt_dir=ckpt_dir, ckpt_every=2, inject_nan_at=3,
                        on_checkpoint=on_checkpoint, **kw)
    clean = LT.train_loop(cfg, params, O.init_opt_state(params), steps=2,
                          **kw)
    clean = LT.train_loop(cfg, clean["params"], clean["opt"], steps=6,
                          start=4, **kw)
    state6 = _whole_np({"params": run["params"], "opt": run["opt"]})
    on = LT.train_loop(cfg, run["params"], run["opt"], steps=8, start=6,
                       **kw)
    like = LT.Layout(mesh, cfg, params, batch, seq).state(
        params, O.init_opt_state(params))
    p, o, start = LT.resume(ckpt_dir, *like, log=lambda s: None)
    resumed = LT.train_loop(cfg, p, o, steps=8, start=start, **kw)
    return {
        "kept": [s for s, _ in run["losses"]], "saved": run["saved"],
        "restores": restores,
        "nan_equals_clean": _local_bits_equal(
            {"p": run["params"], "o": run["opt"]},
            {"p": clean["params"], "o": clean["opt"]}) and
        [x for s, x in run["losses"] if s >= 4] ==
        [x for _, x in clean["losses"]],
        "resume_step": start,
        "resume_equals_memory": _local_bits_equal(
            {"p": on["params"], "o": on["opt"]},
            {"p": resumed["params"], "o": resumed["opt"]}) and
        on["losses"] == resumed["losses"],
        "state6": state6, "writes": writes}


def serve_world(arch, np_params, step_cost, requests, token_seed, steps):
    """``launch.serve`` on this world's "data" mesh: its result at a given
    step cost and with the cost measured, and the logits (gathered) of
    ``steps`` decode steps of seeded tokens from an empty cache."""
    import torch
    import torch.distributed as dist

    from repro_torch import dist as D
    from repro_torch.configs import registry
    from repro_torch.launch import serve as LS
    from repro_torch.models import convert as MC

    cfg = registry.get_smoke_config(arch)
    mesh = D.init_mesh((dist.get_world_size(),), ("data",))
    params = MC.params_from_numpy(np_params, "cpu")
    fixed = LS.serve(cfg, params, requests=requests, step_cost=step_cost,
                     device="cpu", mesh=mesh, log=lambda s: None)
    measured = LS.serve(cfg, params, requests=requests, device="cpu",
                        mesh=mesh, log=lambda s: None)
    return {"fixed": fixed, "measured": measured,
            "logits": decode_logits(cfg, params, token_seed, steps, mesh)}


def decode_logits(cfg, params, token_seed, steps, mesh=None, slots=16,
                  max_len=32):
    """The whole logits of the last of ``steps`` decode steps of seeded
    tokens from an empty cache (``launch.serve.Decoder``)."""
    import torch

    from repro_torch.launch import serve as LS
    from repro_torch.launch.train import replicated
    dec = LS.Decoder(cfg, params, slots, torch.device("cpu"), mesh)
    cache = dec.cache(max_len)
    g = torch.Generator().manual_seed(token_seed)
    for _ in range(steps):
        toks = torch.randint(0, cfg.vocab_size, (slots,), generator=g,
                             dtype=torch.int32)
        logits, cache = dec.step(cache, dec.tokens(toks))
    return replicated(logits).numpy()
