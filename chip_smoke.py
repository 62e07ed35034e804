#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py                 # every phase, as on the H100
    python3 chip_smoke.py --phases card,build,kernels

Phases (one line each; any failure raises and exits non-zero):
  card     the GPU's name and power limit, torch/CUDA versions; TF32 off
  build    compiles repro_torch/csrc with nvcc (sm_90a) and loads it
  analysis the contract checker (repro_torch.analysis.check_all) on the
           card: the small grid (every backend x shedder on the fired
           workload, the fired-heavy block cells, chunks, two lanes, the
           rebuild and recovery sweeps), stock's main path at full width
           on "cuda_block" for each shedder and one donated chunk of 128
           stock lanes, each cell's rules (no sort, no sync — under
           set_sync_debug_mode("error") where the budget is none — no
           float64, launches per block, in place, temp and gather bytes,
           coverage) and the kernels' (registers, spills, SASS, shared
           memory, the lane grid); any FAIL fails the phase
  kernels  each per-event CUDA kernel against its plain PyTorch version,
           bitwise, at the stock shapes (P=3, N=256), at N=2048 and at a
           ragged N=1000, plus an all-inactive and a NaN-laden case; the
           shed kernels also on repro_torch.kernels.shed_cases (edge-equal,
           ±inf, collapsed and narrow-range edges, refinement levels,
           N = 1 003, the histogram's cluster path at n = 6 144 and 2**20,
           a 100 KB lookup table), each shed call timed as the sum of every
           device operation it issues and gated to issue its kernel alone
           (no memset); the
           block kernel against its plain version, bitwise, on W=32
           blocks that fire Algorithm 2 (stock SEQ/at-open at N=256 and
           N=2048, bus ANY/in-windows, soccer ANY/at-open with E-BL, all
           with the store in shared memory; soccer at N=2048 under PM-BL
           with the store in device memory; two of them again with the
           event rows, model tables and stats counts in device memory;
           the PM-BL cases again in jax's original threefry layout, and
           the kernel's threefry against repro_torch.prng in both
           layouts); its lane instance (one CTA per lane) at L = 3 on
           every block case, each lane equal to the plain version and to
           the one-lane kernel on that lane; times against the memory
           bound, and the launch path's host time per launch; the
           histogram's lane instance at L = 1, 3, 128 against its plain
           version and the one-lane kernel row by row (the hard cases
           too), the lookup over 128 lanes' pattern rows (and at
           N = 1 003), and the launch floor (an empty kernel launched
           back to back)
  parity   the engine on stock specs, N=2048, 3000 events, all four
           shedders with fires: backends "cuda" and "cuda_block" on the
           card == backend "torch" on the card == backend "torch" on the
           CPU, whole carry and every StepOut, bitwise
  main     run_experiment on the stock scenario (30000 events on the
           block path, 12000 on the per-event path) and on soccer and
           bus at 6000, first through the per-event kernels (backend
           "cuda"), then through the block kernel (backend
           "cuda_block"), with the launch counts of each path's kernels;
           the headline FN ordering, stock's pspice and E-BL cells
           exactly the committed BENCH_quality.json values (both are
           independent of the threefry layout), and FN, fires and
           compliance equal across the two paths on the same events
  quality  in jax's original threefry layout (the committed results'):
           the oracle's overload fixture and a layout-sensitive stream
           through "cuda" and "cuda_block" == the NumPy oracle, in both
           layouts; the paper's grid ({stock, soccer, bus} x {1.2, 1.4,
           1.6} x 3 shedders at 30000 events) on "cuda_block", gated by
           check_headline, with stock at 1.2 exactly the committed file
           and every other cell within 0.05 of it; "cuda" == "cuda_block"
           at the headline level on stock and bus (12000 events each;
           QUALITY_CUDA_DATASETS);
           the wall of stock's run_experiment split by layer
  runtime  the multi-tenant streaming runtime: 128 lanes of the stock
           configuration (30000 events each, rates 1.2..1.4 x max_rate,
           one model from lane 0's warm-up) through MultiTenantRuntime on
           "cuda_block" (one launch of the block kernel's lane instance,
           128 CTAs, per 32-event block, no host sync) against 128
           sequential run_engine calls, every lane's carry bitwise equal;
           events/s, speedup, launches, peak memory; the lane grid's time
           per launch at L = 1, 8, 128 against its byte bound; the refresh
           demo (8 drifting lanes, refresh every 4 chunks), each lane
           equal to StreamRuntime on that lane alone
  resilience  the runtime's resilience layer (bench_faults' counterpart):
           the fault matrix (clean, each stream and state fault alone,
           all faults) through StreamRuntime on "cuda_block" with ingest,
           ladder, guard and refresh on stock's configuration, 30000
           events, gated as bench_faults (no exception, finite state, a
           clean guard sweep, every decision mirrored in telemetry,
           completions >= 2 % of clean), clean and all faults on the
           first 12000 events also on "cuda" with a carry sha256 and
           counters equal to cuda_block's on them; resilience off
           == one monolithic run_engine on both paths ("cuda": the first
           12000 events), configured and
           never triggered == off (one stream, and 128 lanes with both
           runs' events/s); 128 lanes under lane faults (only the
           poisoned lanes restored, every other lane bitwise its run
           without faults) and under a ladder that trims (the trim over
           lanes: one lookup launch and one launch of the histogram's lane
           instance per level, equal to its plain version and to one-lane
           trims, lane by lane; its time against lane by lane)
  recovery durable recovery (bench_recovery's counterpart): the
           supervisor's children on the card (the five cells side by
           side) (N = 256, W = 32, 30000
           events, 12000 on cuda, chunk 1024, snapshot every 4 chunks)
           SIGKILLed at the
           reference grid's kill sites on cuda_block x {none, pspice,
           pmbl, ebl} and cuda/pspice, relaunched, and bitwise equal to
           the uninterrupted run (carry sha256, matches, counters,
           events; a torn snapshot rejected where the kill tore one);
           then 128 stock lanes snapshot, abandoned mid-push and
           recovered in process, every lane equal to the uninterrupted
           run, with snapshot bytes, write and recovery times, WAL
           records replayed and WAL append time per push
  dist     the scale-out (repro_torch.dist): a world of one rank over
           NCCL in process — stock's run_experiment (12000 events) with
           the PM store sharded on "cuda_block" (pspice, pmbl, ebl) and "cuda"
           (pspice) equal to the serial "cuda_block" run in FN, fires
           and compliance,
           and the runtime phase's 128 stock lanes through
           MultiTenantRuntime(mesh) equal to the meshless runtime lane by
           lane; then gloo worlds of ranks sharing the one card: soccer's
           8 patterns (6000 events) in 2 and 4 pattern shards (block
           kernel, every shedder; the per-event kernels at 2 ranks for
           pspice), every rank's global carry and StepOut equal to
           merge_shards_plain over the per-slice runs in this process
           (pspice's on the kernels' plain versions on the CPU), and 8
           soccer lanes on a (data 2, model 2) mesh through
           MultiTenantRuntime(mesh) with persistence on (rank 0 writes a
           snapshot every 4 chunks) equal to the plain emulation chunk
           by chunk (the first chunk also on the plain versions on the
           CPU); then that world killed twice — rank 0 in its second
           snapshot write, rank 3 after its sixth chunk — each armed
           rank dying by SIGKILL (spawn names it, exit code -9), each
           world restarted on the same directory, recovered on every
           rank (rank 0 reads the snapshot and WAL tail and broadcasts
           them) and finished, every rank equal to the uninterrupted run
           in every carry leaf, counters and events; recovery ms per
           rank, records replayed, the sub-cell's seconds against its
           45 s budget; walls, launches per rank and collective ms and
           bytes (ranks sharing one card measure no scale-out)
  profile  torch.profiler over one stock pspice run per path: device
           busy time by kernel and the device's idle share; on the block
           path also the host's time per launch (the enqueue alone)
  model    the model zoo's serving path at internlm2-1.8b's full width
           and depth (bf16, random weights from a seeded generator):
           prefill of 4 prompts of 2048 tokens (the flash kernel in each
           of the 24 layers) and 32 greedy decode steps, checked against
           the plain flash and the full forward, with a planted fault
           that the float32 bound must catch; then the port's serve()
           with the reference CLI's defaults under each policy, all at
           the step cost the first run measures
  moe      the MoE family at full width (bf16, random weights from a
           seeded generator): deepseek-moe-16b at its full 28 layers and
           deepseek-v3 at 2 of its 61 layers (MLA attention), each
           prefilling 4 prompts of 2048 tokens (the flash kernel once per
           layer: its (128, 128) instance for deepseek-moe-16b, the
           (192, 128) instance for deepseek-v3) and taking greedy decode
           steps (32 and 8); prefill logits of the kernel against the
           plain flash, and decode against the full forward on a no-drop
           copy of the config (capacity_factor = E / K), each with a
           decode step one slot off that must read beyond the bound, in
           bf16 (5e-2, with one run's MoE routing replayed in the other;
           the unpinned readings and the routing choices that differ are
           logged) and on a float32 cut (1e-4, unpinned: the first 4
           layers of deepseek-moe-16b, 1 layer of deepseek-v3); serve()
           once with the reference CLI's defaults (pspice); the phase's
           seconds against its 180 s budget
  ssm      the SSM and hybrid families at full width and depth (bf16,
           random weights from a seeded generator): mamba2-1.3b (48
           Mamba2 layers) and zamba2-7b (81 layers, one shared attention
           + MLP block at 13 points, head_dim 112), each prefilling 4
           prompts of 2048 tokens (zamba2: the bf16 flash kernel once per
           application, on its (128, 128) instance) and taking 32 greedy
           decode steps, with a profile of one prefill and one decode
           step; serve() once (pspice); on the first 12 layers zamba2's
           prefill logits of the kernel against the plain flash in bf16
           (5e-2) and, on a float32 copy (1e-4), the kernel against plain
           and decode against the full forward, with a decode from a conv
           window rolled by one token that must read beyond the bound
           (also at full depth); at full depth each flash launch of the
           prefill against plain on its own inputs, the same logits
           readings logged beside the chunking floor (the full forward at
           chunk 128 against 256), and mamba2's chunked SSD against its
           recurrence on one layer (2e-4); the bf16 decode against the
           full forward logged, not gated; the phase's seconds against
           its 90 s budget
  encdec   whisper-small at full width and depth (bf16, random weights
           from a seeded generator): prefill of 16 utterances (the
           encoder over 1500 seeded frames, a 224-token decoder prompt:
           36 launches of the flash kernel's (64, 64) instance, 12
           non-causal encoder, 12 causal self, 12 cross) and 64 greedy
           decode steps into a cache of 448, a profile of each, serve()
           once (pspice); the kernel against the plain flash in bf16
           (5e-2) and, on a float32 copy (1e-4), the kernel against
           plain, decode against the full forward and a decode from the
           cross cache rolled by one utterance that must read beyond the
           bound; each launch against plain on its own inputs; the
           phase's seconds against its 45 s budget
  train    the training path: internlm2-1.8b at full width and 4 of its
           24 layers (bf16, float32 moments, B = 4 x S = 2048) through
           launch.train's loop (each layer rematerialised, so the flash
           kernel runs in the forward and again in the backward's
           recomputation): 6 steps, a checkpoint of the whole state
           every 2, a NaN at step 3 that restores step 2 (bit for bit,
           by fingerprint) and skips; one step run on from memory
           (profiled) equal to one step resumed from the latest
           checkpoint; on a float32 cut of 2 layers every gradient leaf
           through the flash kernel's autograd.Function within 1e-4 of
           the plain flash under autograd; one AdamW step on the card
           within 1e-6 of the CPU's; then whisper-small 4 steps at B = 8
           (the kernel in all three modes under autograd); step ms,
           tokens/s, peak memory; the phase's seconds against its 90 s
           budget
  mesh     launch.train and launch.serve as SPMD ranks: two gloo worlds
           of 2 rank processes sharing the card (dist.spawn), each
           rank's DTensors on the card on a "data" mesh, laid out by
           dist.sharding's train_specs, cache_specs and decode_specs.
           Training: the train phase's configuration and schedule on a
           global batch of 4 x 2048 (2 x 2048 a rank), params
           replicated, each gradient all-reduced; every rank's state
           bitwise rank 0's after every step (fingerprints); rank 0
           writes the checkpoints; the NaN restore and a resume bit for
           bit; each flash launch (forward and recomputation, on each
           rank's (2, 2048, 16, 128) shard) against the plain version on
           the same shard; each kept loss within 1e-4 of the train
           phase's one process; step ms, collective ms and bytes a step,
           peak memory a rank.  Serving: internlm2-1.8b at full width
           and depth, params replicated, 16 slots over the 2 ranks, the
           reference CLI's defaults: one step cost (rank 0's) on every
           rank, every rank's decisions those of one process's serve()
           at that cost, a decode step's gathered logits within 5e-2 of
           one process's; the phase's seconds against its 60 s budget
  dryrun   the dry-run (repro_torch.launch.dryrun) on the card's software
           in a child process whose pool of 7 processes runs the traces:
           the production mesh's rows (data 32, model 8; target cuda) of
           internlm2-1.8b's three shapes and every architecture's
           decode_32k, and internlm2-1.8b's train_4k on the multi-pod
           mesh, each "ok"; a world of one (mesh (1, 1)) against the card
           at the model and train phases' shapes — a prefill of 4 x 2048,
           a decode step into a cache of 2112, a train step with remat on
           and off, run for real meanwhile — with argument bytes and
           FLOPs (the full-depth trace against FlopCounterMode) equal,
           the predicted peak within 10 % of max_memory_allocated, the
           analysis mode's two-depth extrapolation equal to its full-depth
           trace, 24 flash launches a prefill, the roofline's terms
           beside the measured step; the CEP block's analytic bytes per
           event beside the kernels phase's; the phase's seconds against
           its 90 s budget
  examples the port's four examples (examples/torch_*.py) in this
           process at their default sizes on the card: the quickstart
           (stock Q1 over 10 symbols, 50000 events, the block kernel),
           the multi-tenant runtime (4 drifting tenants x 16384 events,
           refresh every 4 chunks, the block kernel's lane instance), the
           serving scheduler under three policies, and the training
           example (internlm2's smoke config through launch.train, 60
           steps with a NaN at step 35, then a resume to 80; the float32
           flash kernel through its autograd.Function); each one's
           table, seconds and launches; the phase's seconds against its
           30 s budget
The build phase reports ptxas's registers and spills of the block
kernel's two instantiations and of the bf16 flash kernel (a spill in the
flash kernel fails it).  The kernels phase also runs the wgmma probe
against torch.matmul, holds the flash kernels against their plain version
(float32 on the SIMT kernel, bf16 on the wgmma/TMA kernel; GQA/MQA,
ragged, Dv != D, decode-style, a fully masked KV tile, and MLA's
(D, Dv) = (192, 128) and zamba2's head_dim 112 in the same kinds of
case, whisper's non-causal shapes over 1500 keys; bf16 also row by row,
scaled to the output, with planted faults that this bar must catch) and
times the bf16 kernel at internlm2's, deepseek-v3's and zamba2's prefill
shapes and whisper's encoder and cross shapes in turns with
scaled_dot_product_attention (where it takes the shape).
The last lines are the kernels' JSON record, the nvidia-smi line and the
contract line.  The script needs CUDA and the repository around it.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
PHASES = ("card", "build", "analysis", "kernels", "parity", "main", "quality",
          "runtime", "resilience", "recovery", "dist", "profile", "model",
          "moe", "ssm", "encdec", "train", "mesh", "dryrun", "examples")

# The committed quality grid (made by the reference in jax's original
# threefry layout), read as data.  Stock at the headline level must be
# met exactly; every other cell within GRID_TOL of its match-set FN: the
# port's max_rate equals the reference's run on the CPU (jax 0.9.0), but
# there the reference's soccer and bus max_rate differ from the file's
# (made with jax 0.4.37), and a max_rate that differs in its last bits
# shifts a whole cell's arrivals.
COMMITTED_QUALITY = ROOT / "BENCH_quality.json"
GRID_TOL = 0.05
HBM_BYTES_PER_S = 3.35e12          # H100 SXM device-memory rate
# H100 SXM dense peaks: bf16 tensor cores, float32 outside them.
PEAK_OPS_PER_S = {"bfloat16": 989e12, "float32": 67e12}

KERNEL_META = {
    "nfa_advance": ("src/repro_torch/csrc/nfa_transition.cu",
                    "src/repro/kernels/nfa_transition.py:26"),
    "utility_lookup": ("src/repro_torch/csrc/shed_select.cu",
                       "src/repro/kernels/shed_select.py:38"),
    "utility_histogram": ("src/repro_torch/csrc/shed_select.cu",
                          "src/repro/kernels/shed_select.py:115"),
    # Its lane instance: the histogram vmapped over tenant lanes by the
    # ladder's PM trim (src/repro/runtime/guard.py:116), grid y = lane.
    "utility_histogram_lanes": ("src/repro_torch/csrc/shed_select.cu",
                                "src/repro/kernels/shed_select.py:115"),
    "block_step": ("src/repro_torch/csrc/block_step.cu",
                   "src/repro/kernels/block_step.py:87"),
    # The lane instance: the same kernel vmapped over tenant lanes
    # (src/repro/cep/engine.py:877), one CTA per lane.
    "block_step_lanes": ("src/repro_torch/csrc/block_step.cu",
                         "src/repro/kernels/block_step.py:87"),
    "flash_attention": ("src/repro_torch/csrc/flash_attention_sm90.cu",
                        "src/repro/kernels/flash_attention.py:29"),
    # The same kernel's (D, Dv) = (192, 128) instance: MLA's prefill.
    "flash_attention_mla": ("src/repro_torch/csrc/flash_attention_sm90.cu",
                            "src/repro/kernels/flash_attention.py:29"),
    # The same kernel at head_dim 112 on its (128, 128) instance: zamba2's
    # shared attention block in prefill.
    "flash_attention_hd112": ("src/repro_torch/csrc/flash_attention_sm90.cu",
                              "src/repro/kernels/flash_attention.py:29"),
    # The same kernel's (64, 64) instance, non-causal over whisper's 1 500
    # frames: the encoder and the decoder's cross-attention.
    "flash_attention_encdec": ("src/repro_torch/csrc/flash_attention_sm90.cu",
                               "src/repro/kernels/flash_attention.py:29"),
}
# The path whose run counts each kernel's launches: an engine backend of
# the main phase, or the model phase's prefill and decode.
KERNEL_PATH = {"nfa_advance": "cuda", "utility_lookup": "cuda",
               "utility_histogram": "cuda", "block_step": "cuda_block",
               "block_step_lanes": "runtime",
               "utility_histogram_lanes": "resilience",
               "flash_attention": "model", "flash_attention_mla": "moe",
               "flash_attention_hd112": "ssm",
               "flash_attention_encdec": "encdec"}
W_BLOCK = 32                       # block_events on the block path


def paper_cost() -> dict:
    """The paper's simulated-time costs (the port's pspice_paper)."""
    from repro_torch.configs.pspice_paper import COST
    return COST


def committed_quality() -> dict:
    return json.loads(COMMITTED_QUALITY.read_text())


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, iters: int = 200) -> float:
    """Mean device time of ``fn`` (CUDA events around ``iters`` calls)."""
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_us(torch, fn, kernel: str, iters: int = 100):
    """Device time per call of the CUDA kernel whose name contains
    ``kernel`` (torch.profiler), or None if the profiler saw none."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total = sum(getattr(k, "self_device_time_total",
                        getattr(k, "self_cuda_time_total", 0))
                for k in prof.key_averages() if kernel in k.key)
    return total / iters if total else None


def call_device_us(torch, fn, kernel: str, iters: int = 100):
    """Device time per call of ``fn`` as the profiler sees it: every
    device operation the call issues (kernels, memsets, copies) summed,
    the kernel whose name contains ``kernel`` alone, and the device
    operations per call; None where the profiler saw none."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    rows = device_rows(prof)
    if not rows:
        return None
    return dict(all_us=sum(r[0] for r in rows) / iters,
                kernel_us=sum(r[0] for r in rows if kernel in r[2]) / iters,
                ops=sum(r[1] for r in rows) / iters,
                others=[r[2] for r in rows if kernel not in r[2]])


def one_call(name: str, d) -> str:
    """The log text of a ``call_device_us`` reading; a shed call must
    issue its kernel and no other device operation (no memset, no
    copy)."""
    if d is None:
        return "device not measured"
    if d["others"]:
        raise AssertionError(f"{name}: device operations besides its "
                             f"kernel: {d['others']}")
    return (f"device {d['all_us']:.3f} us per call over {d['ops']:g} "
            f"device operations, its kernel alone "
            f"{d['kernel_us']:.3f} us")


def device_rows(prof) -> list:
    """(device us, calls, name) of every device-side event of a profile
    (kernels, copies, memsets), heaviest first.  The host ops that
    launched them are left out: their device time is their kernels'
    time, and counting both would count it twice."""
    from torch.autograd import DeviceType
    rows = [(getattr(k, "self_device_time_total",
                     getattr(k, "self_cuda_time_total", 0)), k.count, k.key)
            for k in prof.key_averages() if k.device_type != DeviceType.CPU]
    return sorted((r for r in rows if r[0] > 0), reverse=True)


def same(torch, a, b) -> bool:
    """Bitwise equality, NaN equal to NaN (payloads may differ)."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.is_floating_point():
        na, nb = torch.isnan(a), torch.isnan(b)
        return bool(torch.equal(na, nb)) and bool(
            torch.equal(a[~na], b[~nb]))
    return bool(torch.equal(a, b))


def max_abs_err(torch, a, b) -> float:
    """max |a - b| over all elements: NaN against NaN counts 0, NaN
    against a number counts inf."""
    a, b = a.double(), b.double()
    na, nb = torch.isnan(a), torch.isnan(b)
    if not torch.equal(na, nb):
        return float("inf")
    d = torch.where(a == b, 0.0, (a - b).abs())[~na]
    return float(d.max()) if d.numel() else 0.0


def bound_bytes(torch, c, nbins: int) -> dict:
    """Bytes each kernel must move on the inputs ``c``: each element it
    reads counted once, each output once.  What it reads depends on the
    data, so it is counted from this data, not the most it could read."""
    state, active, uses = c["state"], c["active"], c["uses"]
    P, N = state.shape
    _, M, C1 = c["trans"].shape
    B = c["tables"].shape[1]
    pidx = torch.arange(P, device=state.device)[:, None].expand(P, N)
    n_pm, n_bind = P * N, int(uses.sum())
    # nfa_advance: state and active in, next state and completion flag out
    # for every PM; bind only for the PMs of binding patterns; one table
    # entry per distinct (pattern, state) that a live, binding-matched PM
    # gathers; per pattern its class, final state, binding flag and, for
    # binding patterns, the event's binding.
    cls = c["ev_class"][:, None]
    gathers = active & (~uses[:, None] | (c["bind"] == c["ev_bind"][:, None])
                        ) & (state >= 0) & (state < M) & (cls >= 0) & \
        (cls < C1)
    n_col = int(torch.unique(pidx[gathers] * M + state[gathers]).numel())
    nfa = n_pm * (4 + 1 + 4 + 1) + n_bind * N * 4 + n_col * 4 + \
        P * (4 + 4 + 1) + n_bind * 4
    # utility_lookup: active in and utility out for every PM; state and r_w
    # only for active PMs; the distinct table entries (j0 and j1 rows) the
    # active PMs read; each pattern's bin size.
    bs = c["bins"].float()[:, None].expand(P, N)
    pos = (c["r_w"].float() / bs - 1.0).clamp(0.0, float(B - 1))
    j0 = pos.floor().long()
    j1 = (j0 + 1).clamp(max=B - 1)
    live = active & (state >= 0) & (state < M)
    entries = torch.cat([(pidx[live] * B + j[live]) * M + state[live]
                         for j in (j0, j1)])
    n_act = int(active.sum())
    lookup = n_pm * (1 + 4) + n_act * (4 + 4) + \
        int(torch.unique(entries).numel()) * 4 + P * 4
    # utility_histogram: every utility in, the edges in, the counts out.
    hist = c["u"].numel() * 4 + (nbins + 1) * 4 + nbins * 4
    return {"nfa_advance": nfa, "utility_lookup": lookup,
            "utility_histogram": hist}


# ---------------------------------------------------------------------------
# Kernels against their plain versions
# ---------------------------------------------------------------------------

def kernel_cases(np, P, N, M, C1, B, seed):
    """Seeded inputs of the three kernels at one (P, N)."""
    rng = np.random.default_rng(seed)
    state = rng.integers(0, M, (P, N)).astype(np.int32)
    bind = rng.integers(-1, 3, (P, N)).astype(np.int32)
    active = rng.random((P, N)) < 0.6
    trans = rng.integers(0, M, (P, M, C1)).astype(np.int32)
    ev_class = rng.integers(0, C1, P).astype(np.int32)
    ev_bind = rng.integers(-1, 3, P).astype(np.int32)
    final = np.full(P, M - 1, np.int32)
    uses = np.arange(P) % 2 == 0
    tables = rng.random((P, B, M)).astype(np.float32)
    bins = np.full(P, 64, np.int32)
    r_w = rng.integers(-64, B * 64 + 64, (P, N)).astype(np.int32)
    u = np.where(active.reshape(-1), rng.random(P * N), np.nan
                 ).astype(np.float32)
    return dict(state=state, bind=bind, active=active, trans=trans,
                ev_class=ev_class, ev_bind=ev_bind, final=final, uses=uses,
                tables=tables, bins=bins, r_w=r_w, u=u)


def phase_kernels(torch, np) -> dict:
    from repro_torch.core.shedder import bucket_edges
    from repro_torch.kernels import nfa_transition as kn
    from repro_torch.kernels import shed_select as ks

    dev = torch.device("cuda")
    torch.manual_seed(0)
    P, M, C1, B = 3, 11, 11, 38          # the stock scenario's shapes
    record = {}
    errs = dict.fromkeys(("nfa_advance", "utility_lookup",
                          "utility_histogram"), 0.0)
    for N in (256, 2048, 1000):
        d = {k: torch.from_numpy(v).to(dev)
             for k, v in kernel_cases(np, P, N, M, C1, B, N).items()}
        cases = {"random": d,
                 "all_inactive": dict(d, active=torch.zeros_like(d["active"]),
                                      u=torch.full_like(d["u"], float("nan"))),
                 "nan_laden": dict(d, tables=torch.where(
                     torch.rand_like(d["tables"]) < 0.3,
                     torch.full_like(d["tables"], float("nan")), d["tables"]),
                     u=torch.where(torch.rand_like(d["u"]) < 0.5,
                                   torch.full_like(d["u"], float("nan")),
                                   d["u"]))}
        for case, c in cases.items():
            nfa_args = (c["state"], c["bind"], c["active"], c["trans"],
                        c["ev_class"], c["ev_bind"], c["final"], c["uses"])
            got = kn.nfa_advance(*nfa_args)
            want = kn.nfa_advance_plain(*nfa_args)
            lk_args = (c["state"], c["r_w"], c["active"], c["tables"],
                       c["bins"])
            u_k = ks.utility_lookup(*lk_args)
            u_p = ks.utility_lookup_plain(*lk_args)
            uu = c["u"]
            fin = uu[~torch.isnan(uu)]
            lo = fin.min() if fin.numel() else torch.tensor(0.0, device=dev)
            hi = fin.max() if fin.numel() else torch.tensor(1.0, device=dev)
            hi = torch.where(hi > lo, hi, lo + 1.0)
            edges = bucket_edges(lo, hi, 128)
            h_k = ks.utility_histogram_edges(uu, edges)
            h_p = ks.utility_histogram_plain(uu, edges)
            torch.cuda.synchronize()
            ok = {"nfa_advance": same(torch, got[0], want[0]) and
                  same(torch, got[1], want[1]),
                  "utility_lookup": same(torch, u_k, u_p),
                  "utility_histogram": same(torch, h_k, h_p)}
            if not all(ok.values()):
                raise AssertionError(f"kernel != plain at N={N} {case}: {ok}")
            for name, pairs in (
                    ("nfa_advance", ((got[0], want[0]), (got[1], want[1]))),
                    ("utility_lookup", ((u_k, u_p),)),
                    ("utility_histogram", ((h_k, h_p),))):
                for a, b in pairs:
                    errs[name] = max(errs[name], max_abs_err(torch, a, b))
            if case == "random":
                bytes_ = bound_bytes(torch, c, 128)
                times = {
                    "nfa_advance": (cuda_ms(torch, lambda: kn.nfa_advance(
                        *nfa_args)), cuda_ms(torch, lambda: kn.
                                             nfa_advance_plain(*nfa_args))),
                    "utility_lookup": (cuda_ms(torch, lambda: ks.
                                               utility_lookup(*lk_args)),
                                       cuda_ms(torch, lambda: ks.
                                               utility_lookup_plain(
                                                   *lk_args))),
                    "utility_histogram": (
                        cuda_ms(torch, lambda: ks.utility_histogram_edges(
                            uu, edges)),
                        cuda_ms(torch, lambda: ks.utility_histogram_plain(
                            uu, edges))),
                }
                # The shed calls: every device operation each issues.
                calls = {
                    "utility_lookup": call_device_us(
                        torch, lambda: ks.utility_lookup(*lk_args),
                        "utility_lookup_kernel"),
                    "utility_histogram": call_device_us(
                        torch, lambda: ks.utility_histogram_edges(uu, edges),
                        "utility_histogram_kernel")}
                dev_us = {name: None if d is None else d["all_us"]
                          for name, d in calls.items()}
                dev_us["nfa_advance"] = device_us(
                    torch, lambda: kn.nfa_advance(*nfa_args),
                    "nfa_advance_kernel")
                for name, (k_ms, p_ms) in times.items():
                    bound = bytes_[name] / HBM_BYTES_PER_S * 1e3
                    if name in calls:
                        d_us = one_call(name, calls[name])
                    else:
                        d_us = "device-only not measured" if \
                            dev_us[name] is None else \
                            f"device-only {dev_us[name]:.3f} us"
                    log("kernels", f"{name} P={P} N={N}: bitwise ok "
                        f"(random, all_inactive, nan_laden); kernel "
                        f"{k_ms:.6f} ms per call ({d_us}), "
                        f"plain {p_ms:.6f} ms, library none, bound "
                        f"{bound:.6f} ms ({bytes_[name]} B at 3.35 TB/s)")
                    if N == 256:     # the stock main path's shape
                        record[name] = dict(ms=k_ms, plain_ms=p_ms,
                                            bound_ms=bound,
                                            device_us=dev_us[name])
                        if calls.get(name):
                            record[name]["kernel_device_us"] = \
                                calls[name]["kernel_us"]
    for name, err in shed_hard_cases(torch, np).items():
        errs[name] = max(errs[name], err)
    for name, err in errs.items():
        record[name]["max_abs_err"] = err
        log("kernels", f"{name}: max |kernel - plain| {err!r} over every "
            "case and N")
    record["utility_histogram_lanes"] = phase_hist_lanes(torch, np)
    record["utility_lookup"].update(lookup_over_lanes(torch, np))
    record["nfa_advance"].update(launch_floor(torch))
    record["block_step"] = phase_block_kernel(torch, np)
    record["block_step_lanes"] = phase_block_lanes(torch, np)
    record.update(phase_flash_kernel(torch, np))
    return record


def shed_hard_cases(torch, np) -> dict:
    """The shed kernels' hard inputs (``kernels.shed_cases``), each
    bitwise against the plain version: the one-lane histogram on
    edge-equal, ±inf, collapsed and narrow-range edges, a refinement
    level and all-NaN utilities at n = 768 and 1 003 (a ragged last
    warp), and past one CTA a lane (the cluster path: n = 6 144 and
    2**20); the lookup on random, all-inactive and NaN-laden
    stores and a 100 KB table a row, at stock's (3, 256), at N = 1 003
    and over the trim's 384 rows.  Returns max |kernel - plain| by
    kernel."""
    from repro_torch.kernels import shed_cases as sc
    from repro_torch.kernels import shed_select as ks

    dev = torch.device("cuda")
    errs = {"utility_histogram": 0.0, "utility_lookup": 0.0}
    hist = [(case, n) for case in sc.HIST_CASES for n in (768, 1003)] + \
        [("refinement", 6144), ("random", 1 << 20)]
    for case, n in hist:
        u, _, _, e = sc.hist_case(case, 1, n, 128, seed=n)
        u, e = torch.from_numpy(u[0]).to(dev), torch.from_numpy(e[0]).to(dev)
        got = ks.utility_histogram_edges(u, e)
        want = ks.utility_histogram_plain(u, e)
        torch.cuda.synchronize()
        if not same(torch, got, want):
            raise AssertionError(f"utility_histogram {case} n={n} "
                                 f"({ks.hist_ctas(n)} CTAs) != plain")
        errs["utility_histogram"] = max(errs["utility_histogram"],
                                        max_abs_err(torch, got, want))
    for case in sc.LOOKUP_CASES:
        for P, N in ((3, 256), (3, 1003), (3 * RT_LANES, 256)):
            args = tuple(torch.from_numpy(a).to(dev)
                         for a in sc.lookup_case(case, P, N, seed=P + N))
            got = ks.utility_lookup(*args)
            want = ks.utility_lookup_plain(*args)
            torch.cuda.synchronize()
            if not same(torch, got, want):
                raise AssertionError(f"utility_lookup {case} P={P} N={N} "
                                     "!= plain")
            errs["utility_lookup"] = max(errs["utility_lookup"],
                                         max_abs_err(torch, got, want))
    log("kernels", f"shed kernels on their hard cases: histogram "
        f"{list(sc.HIST_CASES)} at n = 768, 1 003, and past one CTA "
        f"(n = 6 144, 2**20: clusters of {ks.hist_ctas(6144)}, "
        f"{ks.hist_ctas(1 << 20)}); lookup {list(sc.LOOKUP_CASES)} at (3, "
        f"256), (3, 1 003), ({3 * RT_LANES}, 256): bitwise ok, max |kernel "
        f"- plain| {errs}")
    return errs


def phase_hist_lanes(torch, np) -> dict:
    """The histogram's lane instance against its plain version and, row
    by row, the one-lane kernel, at L = 1, 3 and 128 on the ladder's trim
    shape (P·N = 3 x 256 utilities per lane, 128 bins, a third of them
    NaN) and on every hard case of ``kernels.shed_cases`` (n = 1 003 at
    L = 3: lanes off a 16-byte boundary); timed at L = 128, every device
    operation of a call summed."""
    from repro_torch.core.shedder import bucket_edges
    from repro_torch.kernels import shed_cases as sc
    from repro_torch.kernels import shed_select as ks

    dev = torch.device("cuda")
    n, nbins = 3 * 256, 128
    err, out = 0.0, {}

    def check(u, edges, what):
        nonlocal err
        L = u.shape[0]
        got = ks.utility_histogram_lanes(u, edges)
        want = ks.utility_histogram_lanes_plain(u, edges)
        rows = torch.stack([ks.utility_histogram_edges(u[k], edges[k])
                            for k in range(L)])
        torch.cuda.synchronize()
        if not (same(torch, got, want) and same(torch, got, rows)):
            raise AssertionError(f"utility_histogram_lanes {what} != plain "
                                 "or the one-lane kernel")
        err = max(err, max_abs_err(torch, got, want))

    for L in (1, 3, RT_LANES):
        for case in sc.HIST_CASES:
            for m in ((n, 1003) if L == 3 else (n,)):
                u, _, _, e = sc.hist_case(case, L, m, nbins, seed=L + m)
                check(torch.from_numpy(u).to(dev),
                      torch.from_numpy(e).to(dev), f"L={L} n={m} {case}")
        rng = np.random.default_rng(L)
        u = rng.random((L, n)).astype(np.float32)
        u[rng.random((L, n)) < 1 / 3] = np.nan
        u = torch.from_numpy(u).to(dev)
        lo = torch.nan_to_num(u, nan=2.0).amin(1)
        hi = torch.nan_to_num(u, nan=-1.0).amax(1)
        edges = bucket_edges(lo, torch.where(hi > lo, hi, lo + 1.0), nbins)
        check(u, edges, f"L={L}")
        if L == RT_LANES:
            k_ms = cuda_ms(torch, lambda: ks.utility_histogram_lanes(
                u, edges))
            p_ms = cuda_ms(torch, lambda: ks.utility_histogram_lanes_plain(
                u, edges), iters=20)
            d = call_device_us(torch, lambda: ks.utility_histogram_lanes(
                u, edges), "utility_histogram_kernel")
            nbytes = L * n * 4 + L * (nbins + 1) * 4 + L * nbins * 4
            bound = nbytes / HBM_BYTES_PER_S * 1e3
            log("kernels", f"utility_histogram_lanes L={L} n={n} "
                f"nbins={nbins}: kernel {k_ms:.6f} ms per call "
                f"({one_call('utility_histogram_lanes', d)}), plain "
                f"{p_ms:.6f} ms, library none, bound {bound:.6f} ms "
                f"({nbytes} B at 3.35 TB/s)")
            out = dict(ms=k_ms, plain_ms=p_ms, bound_ms=bound,
                       device_us=None if d is None else d["all_us"],
                       kernel_device_us=None if d is None else
                       d["kernel_us"], lanes=L)
    log("kernels", f"utility_histogram_lanes at L = 1, 3, {RT_LANES} on "
        f"{list(sc.HIST_CASES)} and the trim's shape: equal to its plain "
        f"version and to the one-lane kernel row by row, max |kernel - "
        f"plain| {err!r}")
    out["max_abs_err"] = err
    return out


def lookup_over_lanes(torch, np) -> dict:
    """The lookup over L·P pattern rows laid end to end (the trim over
    128 stock lanes: 384 rows of N = 256), one launch, against its plain
    version, and at N = 1 003 on every lookup case of
    ``kernels.shed_cases``; timed at N = 256, every device operation of a
    call summed."""
    from repro_torch.kernels import shed_cases as sc
    from repro_torch.kernels import shed_select as ks

    dev = torch.device("cuda")
    P, N, M, C1, B = 3 * RT_LANES, 256, 11, 11, 38
    for case in sc.LOOKUP_CASES:
        a = tuple(torch.from_numpy(x).to(dev)
                  for x in sc.lookup_case(case, P, 1003, seed=5))
        if not same(torch, ks.utility_lookup(*a), ks.utility_lookup_plain(*a)):
            raise AssertionError(f"utility_lookup over L·P rows, N = 1 003, "
                                 f"{case} != plain")
    c = {k: torch.from_numpy(v).to(dev)
         for k, v in kernel_cases(np, P, N, M, C1, B, 7).items()}
    args = (c["state"], c["r_w"], c["active"], c["tables"], c["bins"])
    got, want = ks.utility_lookup(*args), ks.utility_lookup_plain(*args)
    torch.cuda.synchronize()
    if not same(torch, got, want):
        raise AssertionError("utility_lookup over L·P rows != plain")
    k_ms = cuda_ms(torch, lambda: ks.utility_lookup(*args))
    p_ms = cuda_ms(torch, lambda: ks.utility_lookup_plain(*args), iters=20)
    d = call_device_us(torch, lambda: ks.utility_lookup(*args),
                       "utility_lookup_kernel")
    nbytes = bound_bytes(torch, c, 128)["utility_lookup"]
    bound = nbytes / HBM_BYTES_PER_S * 1e3
    log("kernels", f"utility_lookup over {RT_LANES} lanes' pattern rows "
        f"(P={P}, N={N}; and N = 1 003 on {list(sc.LOOKUP_CASES)}): "
        f"bitwise ok; kernel {k_ms:.6f} ms per call "
        f"({one_call('utility_lookup', d)}), plain {p_ms:.6f} ms, bound "
        f"{bound:.6f} ms ({nbytes} B at 3.35 TB/s)")
    return dict(lanes_ms=k_ms, lanes_plain_ms=p_ms, lanes_bound_ms=bound,
                lanes_device_us=None if d is None else d["all_us"],
                lanes_kernel_device_us=None if d is None else d["kernel_us"])


def launch_floor(torch) -> dict:
    """The card's launch floor: an empty kernel launched back to back
    (10 x 1 000 launches from one host loop), as CUDA events per launch
    and as the profiler's device time per launch."""
    from repro_torch.kernels import nfa_transition as kn

    dev = torch.device("cuda")
    per = 1000
    ms = cuda_ms(torch, lambda: kn.empty_kernels(per, dev), iters=10) / per
    d_us = device_us(torch, lambda: kn.empty_kernels(100, dev),
                     "empty_kernel", iters=10)
    d_us = None if d_us is None else d_us / 100
    d_txt = "not measured" if d_us is None else f"{d_us:.3f} us"
    log("kernels", f"launch floor: an empty kernel launched back to back "
        f"takes {ms * 1e3:.3f} us per launch (CUDA events) and {d_txt} of "
        "device time per launch (profiler)")
    return dict(launch_floor_us=ms * 1e3, launch_floor_device_us=d_us)


# ---------------------------------------------------------------------------
# The block kernel against its plain version
# ---------------------------------------------------------------------------

def carry_leaves(carry):
    return list(carry.pms) + [v for k, v in carry._asdict().items()
                              if k != "pms"]


def block_bytes(torch, cfg, model, carry, blk, i0: int) -> int:
    """Bytes one block step must move on this block: each element it reads
    counted once, each output once.  What it reads depends on the data, so
    ``carry`` (a copy; it is advanced) is stepped one event at a time
    through the plain version and the reads are counted from the store
    each event meets, not the most the kernel could read:
    - every slot's active flag; the event rows; the per-pattern model
      columns, counters and scalars; the ring when patterns spawn in
      windows;
    - open_idx of the slots active at the block's start (the first
      event's expiry test), and state, bind (patterns that bind or spawn
      in windows) and the idset (ANY patterns) of those still live after
      that event's expiries.  Every other store value the block reads was
      written by the block itself.  A PM that a PM-BL fire in the first
      event drops is counted as read;
    - each distinct transition-table entry that a live, binding-matched
      SEQ PM gathers, and each distinct utility-table entry (rows j0 and
      j1) that a pSPICE fire reads for a live PM;
    - the observation cells the stats add into.
    Outputs: the whole store, ring, counters and scalars, the W rows and
    latency-ring entries, the match tiles and the observation matrices."""
    from repro_torch.cep import patterns as pat
    from repro_torch.kernels import block_step as kb

    P, N, M, A, K = (cfg.num_patterns, cfg.max_pms, cfg.max_states,
                     cfg.max_any_ids, cfg.ring_size)
    W, C1, B = (cfg.block_events, model.trans.shape[2],
                model.ut_tables.shape[1])
    in_win = cfg.spawn_modes != "at_open"
    pms = carry.pms
    pidx = torch.arange(P, device=pms.state.device)[:, None]
    ws = model.window_size[:, None]
    seq = (model.kind == pat.KIND_SEQ)[:, None]
    uses = model.uses_binding[:, None]
    bins = model.ut_bins.float()[:, None]
    obs0 = carry.obs_counts.clone()
    rows = kb.new_rows(cfg, W, pms.state.device)
    gathers, entries = [], []
    for j in range(W):
        i = ((i0 + j + 2 ** 31) % 2 ** 32) - 2 ** 31
        active, state = pms.active.clone(), pms.state.clone()
        open_idx, bind = pms.open_idx.clone(), pms.bind.clone()
        live = active & ((i - open_idx) < ws)
        if j == 0:
            n_open = int(active.sum())
            n_state = int(live.sum())
            n_bind = int((live & (uses | in_win)).sum())
            n_ids = int((live & ~seq).sum()) if cfg.kinds != "seq" else 0
        calls = float(carry.shed_calls)
        kb.block_step_plain(cfg, model, carry, blk, i0, j, j + 1, rows)
        ec, eb = blk.ev_class[j][:, None], blk.ev_bind[j][:, None]
        ok = live & (state >= 0) & (state < M)
        if cfg.kinds != "any" and not bool(rows["dropped"][j]):
            go = ok & seq & (~uses | (bind == eb)) & (ec >= 0) & (ec < C1)
            gathers.append(((pidx * M + state) * C1 + ec)[go])
        if cfg.shedder == "pspice" and float(carry.shed_calls) > calls:
            pos = ((ws - (i - open_idx)).float() / bins - 1.0).clamp(
                0.0, float(B - 1))
            j0 = pos.floor().long()
            for jj in (j0, (j0 + 1).clamp(max=B - 1)):
                entries.append(((pidx * B + jj) * M + state)[ok])
    n_trans = int(torch.cat(gathers).unique().numel()) if gathers else 0
    n_table = int(torch.cat(entries).unique().numel()) if entries else 0
    n_obs = int((carry.obs_counts != obs0).sum()) if cfg.gather_stats else 0
    scalars = 2 * P * 4 + 12 * 4 + 2 * 4     # counters, scalars, key
    ring = (P * K * 4 + P * 4) if in_win else 0
    reads = (P * N + n_open * 4 + n_state * 4 + n_bind * 4 + n_ids * A * 4 +
             ring + n_trans * 4 + n_table * 4 + W * (P * (4 + 4 + 1) + 4 * 4)
             + P * 22 + scalars + 2 * n_obs * 4)
    store = P * N * (1 + 4 * 3) + (P * N * A * 4 if cfg.kinds != "seq"
                                   else 0)
    writes = store + ring + scalars + W * (4 + 4 + 1 + 1) + W * 2 * 4
    if cfg.emit_matches:
        writes += 2 * W * P * N * 4
    if cfg.gather_stats:
        writes += 2 * P * M * M * 4
    return reads + writes


def launch_ms(torch, setup, launch, iters: int = 50) -> float:
    """Median device time of one ``launch()``: CUDA events recorded just
    before and after it, with ``setup()`` (not timed) before each."""
    times = []
    for k in range(iters + 5):
        setup()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        launch()
        end.record()
        torch.cuda.synchronize()
        if k >= 5:
            times.append(start.elapsed_time(end))
    return statistics.median(times)


def host_us_per_launch(torch, launch, n: int) -> float:
    """Host microseconds per call of ``launch(k)`` for k < n: the enqueue
    alone, host-clocked without a sync (the queue holds far more than n
    launches, so no call waits for the card)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for k in range(n):
        launch(k)
    us = (time.perf_counter() - t0) / n * 1e6
    torch.cuda.synchronize()
    return us


def block_vs_plain(torch, cfg, model, saved, blk, i0, what: str):
    """The block kernel and its plain version from the same carry (numpy
    ``saved``) on the W-event block ``blk``: the (kernel, plain) pairs of
    every carry leaf, row and status, the plain carry and status.  Raises
    unless every pair is equal bit for bit."""
    from repro_torch.cep import convert
    from repro_torch.kernels import block_step as kb

    dev = torch.device("cuda")
    work = {}
    for label, fn in (("kernel", kb.block_step),
                      ("plain", kb.block_step_plain)):
        c = convert.carry_from_numpy(saved, dev)
        rows = kb.new_rows(cfg, W_BLOCK, dev)
        c, rows, status = fn(cfg, model, c, blk, i0, 0, W_BLOCK, rows)
        torch.cuda.synchronize()
        work[label] = (c, rows, status)
    (ck, rk, sk), (cp_, rp, sp) = work["kernel"], work["plain"]
    names = [f"carry[{n}]" for n in range(len(carry_leaves(ck)))] + \
        list(rk) + ["status"]
    pairs = list(zip(carry_leaves(ck), carry_leaves(cp_))) + \
        [(rk[k], rp[k]) for k in rk] + [(sk, sp)]
    bad = [n for n, (a, b) in zip(names, pairs) if not same(torch, a, b)]
    if bad:
        raise AssertionError(f"block_step != plain on {what}: {bad}")
    return pairs, cp_, sp


def phase_block_kernel(torch, np) -> dict:
    from repro_torch.cep import block_cases, convert
    from repro_torch.kernels import block_step as kb

    dev = torch.device("cuda")
    record, err, seen = {}, 0.0, set()
    for name, N, shedder in block_cases.CASES:
        cfg, model, carry, blk, i0 = block_cases.firing_block(
            name, N, shedder, dev, W=W_BLOCK, **paper_cost())
        lay = kb.plan_layout(cfg, model.trans.shape[2],
                             model.ut_tables.shape[1])
        seen.add(lay.store)
        saved = convert.tree_to_numpy(carry)
        pairs, cp_, sp = block_vs_plain(torch, cfg, model, saved, blk, i0,
                                        f"{name} N={N} {shedder} "
                                        f"({lay.store} store)")
        err = max([err] + [max_abs_err(torch, a, b) for a, b in pairs])
        fires = int(sp[0])
        if shedder in ("pspice", "pmbl") and fires < 1:
            raise AssertionError(f"block {name} N={N} {shedder}: no fire")
        # Times: each launch starts from the same carry, restored by
        # copies that are timed alone and subtracted.  The launches go
        # through the main path's launcher (one argument block per scan).
        base = convert.carry_from_numpy(saved, dev)
        c = convert.carry_from_numpy(saved, dev)
        rows = kb.new_rows(cfg, W_BLOCK, dev)
        scan = kb.BlockScan(cfg, model, c, blk, rows)

        def restore():
            for dst, src in zip(carry_leaves(c), carry_leaves(base)):
                dst.copy_(src)

        def launch():
            restore()
            scan.launch(0, i0, 0, W_BLOCK)

        def plain():
            restore()
            kb.block_step_plain(cfg, model, c, blk, i0, 0, W_BLOCK, rows)

        # Device time in the profiler; per call = the median of CUDA events
        # recorded around each launch alone (the restore outside them); the
        # host's enqueue alone; the plain version host-clocked, less the
        # restore.
        t_restore = cuda_ms(torch, restore, iters=100)
        d_us = device_us(torch, launch, "block_step_kernel", iters=20)
        call_ms = launch_ms(torch, restore,
                            lambda: scan.launch(0, i0, 0, W_BLOCK))
        host_us = host_us_per_launch(
            torch, lambda k: scan.launch(0, i0, 0, W_BLOCK), 200)
        k_ms = d_us / 1e3 if d_us is not None else call_ms
        p_ms = cuda_ms(torch, plain, iters=3) - t_restore
        stepped = convert.carry_from_numpy(saved, dev)
        nbytes = block_bytes(torch, cfg, model, stepped, blk, i0)
        if not all(same(torch, a, b) for a, b in zip(
                carry_leaves(stepped), carry_leaves(cp_))):
            raise AssertionError(f"block {name} N={N} {shedder}: the "
                                 "event-by-event count left another carry")
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        src = "device time" if d_us is not None else \
            "host clock, device time not measured"
        log("kernels", f"block_step {name} P={cfg.num_patterns} N={N} "
            f"W={W_BLOCK} {shedder} ({cfg.kinds}/{cfg.spawn_modes}, "
            f"{fires} fires in the block): bitwise ok; {lay.store} store "
            f"({lay.store_bytes} B store + scratch), {lay.smem_bytes} B "
            f"dynamic shared memory; kernel {k_ms:.6f} ms per launch "
            f"({k_ms / W_BLOCK * 1e3:.3f} us per event; {src}), per call "
            f"{call_ms:.6f} ms (CUDA events), host {host_us:.3f} us per "
            f"launch (enqueue); plain {p_ms:.6f} ms, library none, bound "
            f"{bound:.6f} ms ({nbytes} B at 3.35 TB/s)")
        if (name, N, shedder) == block_cases.CASES[0]:
            record = dict(ms=k_ms, plain_ms=p_ms, bound_ms=bound,
                          bytes_per_event=nbytes / W_BLOCK,
                          us_per_event=k_ms / W_BLOCK * 1e3,
                          call_ms=call_ms, host_us_per_launch=host_us,
                          store=lay.store, smem_bytes=lay.smem_bytes)
    if seen != {"shared", "global"}:
        raise AssertionError(f"block cases took only the {seen} store")
    # The event rows, the model tables and the stats counts left in device
    # memory (their shares set to 0 B): the same bits, both instantiations.
    shares = {k: getattr(kb, k) for k in ("ROWS_SMEM_MAX", "MODEL_SMEM_MAX",
                                          "STATS_SMEM_MAX")}
    try:
        for k in shares:
            setattr(kb, k, 0)
        for name, N, shedder in (block_cases.CASES[0],
                                 block_cases.CASES[-1]):
            cfg, model, carry, blk, i0 = block_cases.firing_block(
                name, N, shedder, dev, W=W_BLOCK, **paper_cost())
            lay = kb.plan_layout(cfg, model.trans.shape[2],
                                 model.ut_tables.shape[1])
            if lay.rows_smem or lay.model_smem or lay.stats_smem:
                raise AssertionError(f"planner kept a piece on chip: {lay}")
            pairs, _, _ = block_vs_plain(
                torch, cfg, model, convert.tree_to_numpy(carry), blk, i0,
                f"{name} N={N} {shedder} ({lay.store} store, rows, model "
                "and stats counts in device memory)")
            err = max([err] + [max_abs_err(torch, a, b) for a, b in pairs])
            log("kernels", f"block_step {name} N={N} {shedder}: bitwise ok "
                f"with the rows, model tables and stats counts in device "
                f"memory ({lay.store} store, {lay.smem_bytes} B dynamic "
                "shared memory)")
    finally:
        for k, v in shares.items():
            setattr(kb, k, v)
    err = max(err, block_original_layout(torch))
    record["max_abs_err"] = err
    log("kernels", f"block_step: max |kernel - plain| {err!r} over every "
        "case (both instantiations, both threefry layouts)")
    return record


def lane_view(tree, k: int):
    """Lane ``k`` of a lane-stacked tree (views)."""
    from repro_torch.cep import engine as eng
    return eng.tree_map(lambda x: x[k], tree)


def lanes_bytes(torch, cfg, model, carry, blk, i0: int) -> int:
    """``block_bytes`` of one lane-grid launch: the sum over its lanes,
    each stepped from a copy of its own carry."""
    from repro_torch.cep import engine as eng
    return sum(block_bytes(torch, cfg, lane_view(model, k),
                           eng.tree_map(lambda x: x[k].clone(), carry),
                           lane_view(blk, k), i0)
               for k in range(blk.ev_id.shape[0]))


def lane_grid_timing(torch, cfg, model, carry, blk, i0: int,
                     plain: bool = False) -> dict:
    """One launch of the lane instance over every lane of ``blk``, from
    the same carry each time (restored by copies timed apart): device
    time (profiler), per call (CUDA events), the host's enqueue, the
    bound over this launch's data, and with ``plain`` the plain version
    lane by lane."""
    from repro_torch.cep import engine as eng
    from repro_torch.kernels import block_step as kb

    L = blk.ev_id.shape[0]
    base = eng.tree_map(lambda x: x.clone(), carry)
    c = eng.tree_map(lambda x: x.clone(), carry)
    rows = kb.new_rows(cfg, W_BLOCK, blk.ev_id.device, lanes=L)
    scan = kb.BlockScan(cfg, model, c, blk, rows, lanes=L)

    def restore():
        for dst, src in zip(carry_leaves(c), carry_leaves(base)):
            dst.copy_(src)

    def launch():
        restore()
        scan.launch(0, i0, 0, W_BLOCK)

    t_restore = cuda_ms(torch, restore, iters=50)
    d_us = device_us(torch, launch, "block_step_kernel", iters=20)
    call_ms = launch_ms(torch, restore, lambda: scan.launch(0, i0, 0,
                                                             W_BLOCK))
    host_us = host_us_per_launch(
        torch, lambda k: scan.launch(0, i0, 0, W_BLOCK), 100)
    out = dict(ms=d_us / 1e3 if d_us is not None else call_ms,
               call_ms=call_ms, host_us_per_launch=host_us,
               device_measured=d_us is not None)
    if plain:
        def run_plain():
            restore()
            for k in range(L):
                kb.block_step_plain(
                    cfg, lane_view(model, k), lane_view(c, k),
                    lane_view(blk, k), i0, 0, W_BLOCK,
                    {n: v[k] for n, v in rows.items()})
        out["plain_ms"] = cuda_ms(torch, run_plain, iters=2) - t_restore
    nbytes = lanes_bytes(torch, cfg, model, base, blk, i0)
    out.update(bytes=nbytes, bound_ms=nbytes / HBM_BYTES_PER_S * 1e3)
    return out


def phase_block_lanes(torch, np) -> dict:
    """The block kernel's lane instance (one CTA per lane) at L = 3 on
    every block case, each lane with its own stream, model and carry:
    equal, lane by lane, to block_step_plain and to the one-lane kernel
    on that lane alone, bit for bit, in both instantiations.  Times the
    first case's launch."""
    from repro_torch.cep import block_cases, convert
    from repro_torch.cep import engine as eng
    from repro_torch.kernels import block_step as kb

    dev = torch.device("cuda")
    record, err, seen = {}, 0.0, set()
    for name, N, shedder in block_cases.CASES:
        cfg, model, carry, blk, i0 = block_cases.firing_lanes(
            name, N, shedder, dev, W=W_BLOCK, **paper_cost())
        L = blk.ev_id.shape[0]
        lay = kb.plan_layout(cfg, model.trans.shape[-1],
                             model.ut_tables.shape[-2])
        seen.add(lay.store)
        saved = convert.tree_to_numpy(carry)
        c = convert.carry_from_numpy(saved, dev)
        _, rows, status = kb.block_step_lanes(cfg, model, c, blk, i0, 0,
                                              W_BLOCK)
        torch.cuda.synchronize()
        fired = 0
        for k in range(L):
            got = carry_leaves(lane_view(c, k)) + \
                [rows[n][k] for n in rows] + [status[k]]
            for label, fn in (("plain", kb.block_step_plain),
                              ("one-lane kernel", kb.block_step)):
                ck = eng.tree_map(lambda x: x[k].clone(),
                                  convert.carry_from_numpy(saved, dev))
                rk = kb.new_rows(cfg, W_BLOCK, dev)
                ck, rk, sk = fn(cfg, lane_view(model, k), ck,
                                lane_view(blk, k), i0, 0, W_BLOCK, rk)
                torch.cuda.synchronize()
                want = carry_leaves(ck) + [rk[n] for n in rows] + [sk]
                bad = [i for i, (a, b) in enumerate(zip(got, want))
                       if not same(torch, a, b)]
                if bad:
                    raise AssertionError(
                        f"lane grid {name} N={N} {shedder}: lane {k} != "
                        f"{label} in leaves {bad}")
                err = max([err] + [max_abs_err(torch, a, b)
                                   for a, b in zip(got, want)])
            fired += int(status[k, 0]) > 0
        if shedder in ("pspice", "pmbl") and fired < 2:
            raise AssertionError(f"lane grid {name} N={N} {shedder}: "
                                 f"{fired} lanes fired, need 2")
        log("kernels", f"block_step_lanes {name} P={cfg.num_patterns} "
            f"N={N} W={W_BLOCK} {shedder}, L={L} lanes ({lay.store} store, "
            f"fires per lane {status[:, 0].tolist()}): every lane bitwise "
            "equal to block_step_plain and to the one-lane kernel")
        if (name, N, shedder) == block_cases.CASES[0]:
            t = lane_grid_timing(torch, cfg, model, carry, blk, i0,
                                 plain=True)
            src = "device time" if t["device_measured"] else \
                "CUDA events, device time not measured"
            log("kernels", f"block_step_lanes {name} N={N} L={L}: kernel "
                f"{t['ms']:.6f} ms per launch ({src}), per call "
                f"{t['call_ms']:.6f} ms, host {t['host_us_per_launch']:.3f}"
                f" us per launch; plain (lane by lane) {t['plain_ms']:.6f} "
                f"ms, library none, bound {t['bound_ms']:.6f} ms "
                f"({t['bytes']} B at 3.35 TB/s)")
            record = dict(ms=t["ms"], plain_ms=t["plain_ms"],
                          bound_ms=t["bound_ms"], call_ms=t["call_ms"],
                          host_us_per_launch=t["host_us_per_launch"],
                          lanes=L, store=lay.store,
                          smem_bytes=lay.smem_bytes)
    if seen != {"shared", "global"}:
        raise AssertionError(f"lane-grid cases took only the {seen} store")
    record["max_abs_err"] = err
    log("kernels", f"block_step_lanes: max |kernel - plain|, |kernel - "
        f"one-lane kernel| {err!r} over every case and lane")
    return record


# ---------------------------------------------------------------------------
# The multi-tenant streaming runtime
# ---------------------------------------------------------------------------

RT_LANES, RT_EVENTS, RT_CHUNK = 128, 30000, 1024
# The refresh demo's simulated-time costs (examples/runtime_multitenant.py).
DEMO_COST = dict(c_base=3e-4, c_match=6e-5, c_shed_base=1.5e-4,
                 c_shed_pm=1.5e-6, c_ebl=6e-5)


def _cut(raw, a: int, b: int):
    import dataclasses
    return dataclasses.replace(raw, n=b - a, type_id=raw.type_id[a:b],
                               attr=raw.attr[a:b], group=raw.group[a:b])


def phase_runtime(torch, np) -> dict:
    """The streaming runtime on the card: 128 tenant lanes of the stock
    configuration through MultiTenantRuntime against 128 sequential
    single-lane runs (every lane's carry equal), the lane grid's time
    per launch at L = 1, 8 and 128, and the refresh demo at L = 8.
    Returns the lane instance's launches on the 128-lane run and its
    time and bound per launch at each L."""
    launches = runtime_throughput(torch, np)
    runtime_refresh(torch, np)
    return launches


def runtime_throughput(torch, np) -> dict:
    from repro_torch import runtime as RT
    from repro_torch.cep import engine as eng, patterns as pat, runner
    from repro_torch.data import streams
    from repro_torch.kernels import ops as kops

    dev = torch.device("cuda")
    L, n = RT_LANES, RT_EVENTS
    sc = streams.get_scenario("stock")
    specs = sc.specs()
    cp = pat.compile_patterns(specs)
    cfg = runner.default_config(
        cp, max_pms=sc.max_pms, latency_bound=sc.latency_bound,
        shedder="pspice", backend="cuda_block", block_events=W_BLOCK,
        **paper_cost())
    t0 = time.perf_counter()
    raws = [sc.raw(n=n, seed=sc.seed + k) for k in range(L)]
    warm = streams.classify(specs, _cut(raws[0], 0, int(n * 0.3)),
                            rate=1.0, seed=sc.seed, device=dev)
    built = runner.build_model(specs, cfg, warm, bin_size=sc.bin_size,
                               seed=sc.seed, device=dev)
    rates = [built.max_rate * (1.2 + 0.2 * k / (L - 1)) for k in range(L)]
    evs = [streams.classify(specs, raws[k], rate=rates[k], seed=sc.seed + k,
                            device=dev) for k in range(L)]
    model = eng.make_model(
        cp, cfg, ut_tables=built.ut_stacked, ut_bins=built.ut_bins,
        f_model=built.f_model, g_model=built.g_model,
        ebl_raw_mean=float(evs[0].ebl_raw.mean()), device=dev)
    log("runtime", f"{L} lanes x {n} stock events (3 x Q1, N={sc.max_pms}, "
        f"W={W_BLOCK}, pspice, LB {sc.latency_bound} s), rates "
        f"{rates[0]:.1f}..{rates[-1]:.1f} events/s (max_rate "
        f"{built.max_rate!r} x 1.2..1.4); set-up "
        f"{time.perf_counter() - t0:.2f} s")

    # -- the sequential baseline: one run_engine per lane ---------------
    eng.run_engine(cfg, model, evs[0], eng.init_carry(cfg, device=dev),
                   device=dev)
    carries = [eng.init_carry(cfg, seed=k, device=dev) for k in range(L)]
    torch.cuda.synchronize()
    kops.reset_launch_counts()
    t0 = time.perf_counter()
    seq = []
    for k in range(L):
        c, _ = eng.run_engine(cfg, model, evs[k], carries[k], device=dev)
        torch.cuda.synchronize()
        seq.append(c)
    wall_seq = time.perf_counter() - t0
    seq_launches = kops.launch_counts()["block_step"]

    # -- the lane-parallel runtime ---------------------------------------
    mL, evL = RT.broadcast_model(model, L), RT.stack(evs)
    rt = RT.RuntimeConfig(chunk_size=RT_CHUNK)
    walls = []
    for rep in range(2):                 # the first run warms the path
        mt = RT.MultiTenantRuntime(cfg, mL, L, rt=rt, device=dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        mem0 = torch.cuda.memory_allocated()
        kops.reset_launch_counts()
        eng.host_syncs = 0
        t0 = time.perf_counter()
        stats = mt.push(evL, flush=True)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        counts, syncs = kops.launch_counts(), eng.host_syncs
        peak = torch.cuda.max_memory_allocated()
    wall_mt = walls[-1]
    want = sum(-(-s.n_events // (L * W_BLOCK)) for s in stats)
    if counts["block_step_lanes"] != want or counts["block_step"] != 0:
        raise AssertionError(f"runtime launches {counts}, expected {want} "
                             "lane-grid launches and no one-lane launch")
    if syncs:
        raise AssertionError(f"{syncs} engine host syncs on the fused path")
    bad = [k for k in range(L) if not all(
        same(torch, a, b) for a, b in zip(
            carry_leaves(lane_view(mt.carry, k)),
            carry_leaves(seq[k])))]
    if bad:
        raise AssertionError(f"MultiTenantRuntime lanes {bad} != their "
                             "sequential single-lane runs")
    agg = mt.telemetry.aggregate()
    total = L * n
    log("runtime", f"MultiTenantRuntime: {total} events in {wall_mt:.4f} s "
        f"= {total / wall_mt:.1f} events/s (warm-up run {walls[0]:.4f} s); "
        f"sequential ({L} x run_engine, carries made before the clock): "
        f"{wall_seq:.4f} s = {total / wall_seq:.1f} events/s; speedup "
        f"{wall_seq / wall_mt:.2f}x")
    log("runtime", f"lane-grid launches {counts['block_step_lanes']} (grid "
        f"= {L} CTAs each; sequential: {seq_launches} one-lane launches), "
        f"engine host syncs {syncs}, {len(stats)} chunks; peak device "
        f"memory {peak / 2**20:.1f} MiB ({(peak - mem0) / 2**20:.1f} MiB "
        f"above the {mem0 / 2**20:.1f} MiB held before the run); "
        f"telemetry: p99 max {agg['l_e_p99_max']:.6f} s, pms_shed "
        f"{agg['pms_shed']:g}, shed_calls {agg['shed_calls']:g}, "
        f"completions {agg['completions']:g}")
    log("runtime", f"every lane of MultiTenantRuntime == its sequential "
        f"single-lane run in every carry leaf (bitwise, {L} lanes)")

    # -- time per lane-grid launch at L = 1, 8, 128 -----------------------
    half = n // 2 // W_BLOCK * W_BLOCK
    by_lanes = {}
    at = RT.MultiTenantRuntime(cfg, mL, L, rt=rt, device=dev)
    at.push(eng.EventBatch(*(x[:, :half] for x in evL)), flush=True)
    for lx in (1, 8, L):
        sub = lambda t, lx=lx: eng.tree_map(  # noqa: E731
            lambda x: x[:lx].contiguous(), t)
        blk = eng.EventBatch(*(x[:lx, half:half + W_BLOCK].contiguous()
                               for x in evL))
        tm = lane_grid_timing(torch, cfg, sub(mL), sub(at.carry), blk, half)
        src = "device time" if tm["device_measured"] else \
            "CUDA events, device time not measured"
        log("runtime", f"lane grid L={lx}: {tm['ms']:.6f} ms per launch "
            f"({src}; per call {tm['call_ms']:.6f} ms, host "
            f"{tm['host_us_per_launch']:.3f} us), "
            f"{tm['ms'] / (lx * W_BLOCK) * 1e3:.4f} us per lane-event; "
            f"bound {tm['bound_ms']:.6f} ms ({tm['bytes']} B at 3.35 TB/s),"
            f" {tm['ms'] / tm['bound_ms']:.1f}x the bound")
        by_lanes[str(lx)] = (tm["ms"], tm["bound_ms"])
    return {"block_step_lanes": dict(
        launches=counts["block_step_lanes"],
        ms_by_lanes={k: v[0] for k, v in by_lanes.items()},
        bound_ms_by_lanes={k: v[1] for k, v in by_lanes.items()})}


def runtime_refresh(torch, np) -> None:
    """The refresh demo (examples/runtime_multitenant.py at L = 8): Q1
    over 4 symbols, drifting streams and rates, per-lane refresh every 4
    chunks; every lane equal to the StreamRuntime run on that lane alone."""
    from repro_torch import runtime as RT
    from repro_torch.cep import engine as eng, patterns as pat, runner
    from repro_torch.data import streams

    dev = torch.device("cuda")
    L, n, chunk = 8, 16384, 1024
    specs = [pat.make_q1(window_size=400, num_symbols=4)]
    cp = pat.compile_patterns(specs)
    cfg = runner.default_config(cp, max_pms=128, latency_bound=0.02,
                                gather_stats=True, shedder="pspice",
                                backend="cuda_block", block_events=W_BLOCK,
                                **DEMO_COST)
    model = eng.make_model(cp, cfg, device=dev)
    rate = 1.0 / (cfg.c_base + cfg.c_match * 0.3 * cfg.max_pms)
    evs = [streams.classify(
        specs, streams.gen_stock_drift(n, num_symbols=50, pattern_symbols=4,
                                       p_class=0.03, p_class_end=0.10,
                                       seed=100 + k),
        rate=rate * (1 + 0.2 * k), rate_end=4.0 * rate, seed=k, device=dev)
        for k in range(L)]
    rt = RT.RuntimeConfig(chunk_size=chunk, refresh=RT.RefreshConfig(
        every_chunks=4, min_observations=256, decay=0.5))
    mt = RT.MultiTenantRuntime(cfg, RT.broadcast_model(model, L), L, rt=rt,
                               specs=specs, device=dev)
    evL = RT.stack(evs)
    t0 = time.perf_counter()
    for s in range(0, n, 3000):
        mt.push(eng.EventBatch(*(x[:, s:s + 3000] for x in evL)),
                flush=s + 3000 >= n)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    agg = mt.telemetry.aggregate()
    counts = [s.refresh_count for s in mt.refresh_state]
    if agg["refreshes"] < 1 or min(counts) < 1:
        raise AssertionError(f"refresh demo: no refresh ({agg}, {counts})")
    for k in range(L):
        srt = RT.StreamRuntime(cfg, model, rt=rt, specs=specs, seed=k,
                               device=dev)
        srt.push(evs[k], flush=True)
        torch.cuda.synchronize()
        if srt.refresh_state.refresh_count != counts[k] or not all(
                same(torch, a, b) for a, b in zip(
                    carry_leaves(lane_view(mt.carry, k)),
                    carry_leaves(srt.carry))):
            raise AssertionError(f"refresh demo lane {k} != StreamRuntime "
                                 "on that lane alone")
    log("runtime", f"refresh demo: {L} lanes x {n} events, chunk {chunk}, "
        f"{agg['n_chunks']} chunks in {wall:.4f} s ({L * n / wall:.1f} "
        f"events/s host clock); {agg['refreshes']} refresh rounds, per-lane "
        f"refreshes {counts}, host time in refresh "
        f"{agg['refresh_wall_s']:.4f} s; aggregate {json.dumps(agg)}")
    log("runtime", "refresh demo: every lane == StreamRuntime on that lane "
        "alone (carry bitwise, refresh counts equal)")


# ---------------------------------------------------------------------------
# The runtime's resilience layer (counterpart of benchmarks/bench_faults.py)
# ---------------------------------------------------------------------------

RES_EVENTS, RES_CHUNK, RES_PUSH = 30000, 1024, 4096
# The per-event path's checks — resilience off against one monolithic
# run_engine, and the clean and all-faults cells against cuda_block's on
# the same events — take the stream's first 12 000 of its 30 000 events,
# to keep the script within its time (PERF.md §7).
RES_CUDA_EVENTS = 12000
RES_FN_BOUND = 0.98        # bench_faults.FN_BOUND: a liveness bound
RES_POISONED = (3, 64, 127)
DEV = "cuda"               # the card; the phases' functions run there


def sync(torch, dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize()


def stock_setup(torch, dev, backend: str, n: int, lanes: int = 1,
                rates=(1.0, 1.0), gather: bool = False):
    """The stock main path's configuration (3 x Q1, N = 256, W = 32,
    pspice, LB 0.05 s) with the model built on lane 0's warm-up (the
    runtime phase's recipe); lane l's stream is seed 7 + l at max_rate x
    (rates[0] + (rates[1] - rates[0]) l / (lanes - 1)).  Returns (specs,
    cfg, model, [events per lane], max_rate)."""
    from repro_torch.cep import engine as eng, patterns as pat, runner
    from repro_torch.data import streams

    sc = streams.get_scenario("stock")
    specs = sc.specs()
    cp = pat.compile_patterns(specs)
    cfg = runner.default_config(
        cp, max_pms=sc.max_pms, latency_bound=sc.latency_bound,
        shedder="pspice", backend=backend, block_events=W_BLOCK,
        gather_stats=gather, **paper_cost())
    raws = [sc.raw(n=n, seed=sc.seed + k) for k in range(lanes)]
    warm = streams.classify(specs, _cut(raws[0], 0, int(n * 0.3)),
                            rate=1.0, seed=sc.seed, device=dev)
    built = runner.build_model(specs, cfg, warm, bin_size=sc.bin_size,
                               seed=sc.seed, device=dev)
    mult = [rates[0] + (rates[1] - rates[0]) * k / max(lanes - 1, 1)
            for k in range(lanes)]
    evs = [streams.classify(specs, raws[k], rate=built.max_rate * mult[k],
                            seed=sc.seed + k, device=dev)
           for k in range(lanes)]
    model = eng.make_model(
        cp, cfg, ut_tables=built.ut_stacked, ut_bins=built.ut_bins,
        f_model=built.f_model, g_model=built.g_model,
        ebl_raw_mean=float(evs[0].ebl_raw.mean()), device=dev)
    return specs, cfg, model, evs, built.max_rate


def resilience_rt(RT, cfg, **kw):
    """benchmarks/bench_faults.py's resilience_rt values at the stock
    chunk, with the ladder's bound at 2 x LB (as the reference's 0.01 is
    to its 0.005)."""
    return RT.RuntimeConfig(
        chunk_size=RES_CHUNK,
        refresh=RT.RefreshConfig(every_chunks=4, min_observations=64.0),
        ingest=RT.IngestConfig(max_queue_events=1 << 15,
                               high_watermark=1 << 13,
                               low_watermark=1 << 11, seed=5),
        ladder=RT.LadderConfig(escalate_streak=2, deescalate_streak=2,
                               latency_bound=2 * cfg.latency_bound),
        guard=RT.GuardConfig(check_every_chunks=1,
                             checkpoint_every_chunks=4), **kw)


def floats_finite(torch, tree) -> bool:
    from repro_torch.cep import engine as eng
    return all(np_finite(a) for _, a in eng.tree_leaves_with_path(tree))


def np_finite(a) -> bool:
    import numpy as np
    return not np.issubdtype(a.dtype, np.floating) or bool(
        np.isfinite(a).all())


def push_all(RT, srt, ev, axis: int = 0, inj=None, lanes=None) -> None:
    """Push ``ev`` in pieces of RES_PUSH events, then flush.  With an
    injector, state faults strike between pushes (into ``lanes``, or the
    whole state) and stream faults rewrite each push."""
    n = RT.num_events(ev, axis)
    for s in range(0, n, RES_PUSH):
        batch = RT.slice_events(ev, s, min(s + RES_PUSH, n), axis)
        if inj is not None:
            for lane in (lanes or [None]):
                srt.carry = inj.corrupt_carry(srt.carry, lane=lane)
                srt.model = inj.corrupt_model(srt.model, lane=lane)
            batch = inj.corrupt_events(batch, axis=axis)
        srt.push(batch)
    srt.flush()


def fault_cell(torch, dev, specs, cfg, model, ev, kinds) -> tuple:
    """One cell of bench_faults' matrix on the card: the resilient
    StreamRuntime over the stream, state faults between pushes and
    stream faults on each push (seed 3, p 0.35), then the end-of-run
    guard sweep.  Returns (row with its gates, runtime)."""
    from repro_torch import runtime as RT

    inj = RT.FaultInjector(RT.FaultConfig(kinds=kinds, seed=3,
                                          p_fault=0.35)) if kinds else None
    srt = RT.StreamRuntime(cfg, model, resilience_rt(RT, cfg), specs=specs,
                           device=dev)
    t0 = time.perf_counter()
    push_all(RT, srt, ev, inj=inj)
    srt.guard_now()
    sync(torch, dev)
    agg = srt.telemetry.aggregate()
    tel = srt.telemetry
    row = dict(
        wall_s=time.perf_counter() - t0, events=srt.events_processed,
        completions=agg.get("completions", 0.0),
        faults=len(inj.log) if inj else 0, restores=srt.guard.restores,
        violations=srt.guard.violations, max_rung=agg.get("max_rung", 0),
        transitions=len(srt.ladder.transitions),
        admission_shed=srt.ingest.total_shed,
        quarantine_dropped=srt.quarantine_dropped,
        refreshes=agg.get("refreshes", 0))
    row["ok_state_finite"] = floats_finite(torch, srt.carry) and \
        floats_finite(torch, srt.model)
    row["ok_guard_clean"] = srt.guard.check(srt.carry, srt.model) == []
    row["ok_mirrored"] = (
        len(srt.ladder.transitions) == len(tel.events_of("ladder"))
        == agg.get("ladder_transitions", -1)
        and srt.guard.violations == len(tel.events_of("guard_violation"))
        and srt.guard.restores == len(tel.events_of("guard_restore")))
    return row, srt


def phase_resilience(torch, np) -> dict:
    """The resilience layer on the card: bench_faults' matrix on
    cuda_block (clean and all faults also on cuda, equal in carry sha256
    and counters); resilience off and inert cost nothing (one stream on
    both paths, and 128 lanes); 128 lanes under lane faults (a per-lane
    restore) and under a ladder that trims, the trim over lanes on the
    kernels against its plain version and lane by lane.  Returns the lane
    histogram's launches on the trimming run and its trim times."""
    resilience_matrix(torch, np)
    resilience_inert(torch, np)
    return resilience_lanes(torch, np)


def resilience_matrix(torch, np) -> None:
    import dataclasses

    from repro_torch import runtime as RT
    from repro_torch.runtime import supervisor as SV

    dev = torch.device(DEV)
    specs, cfg, model, (ev,), max_rate = stock_setup(
        torch, dev, "cuda_block", RES_EVENTS, gather=True)
    log("resilience", f"fault matrix: stock {RES_EVENTS} events (3 x Q1, "
        f"N={cfg.max_pms}, W={W_BLOCK}, pspice, LB {cfg.latency_bound} s) "
        f"at max_rate {max_rate!r} x 1.0, chunk {RES_CHUNK}, pushes of "
        f"{RES_PUSH}; ingest + ladder (bound {2 * cfg.latency_bound} s) + "
        "guard + refresh every 4 chunks; faults seed 3, p 0.35")
    cells = [("clean", ())] + [(k, (k,)) for k in RT.STREAM_FAULTS +
                               RT.STATE_FAULTS] + \
        [("all_faults", RT.STREAM_FAULTS + RT.STATE_FAULTS)]
    clean = None
    for name, kinds in cells:
        row, srt = fault_cell(torch, dev, specs, cfg, model, ev, kinds)
        if name == "clean":
            clean = row["completions"]
            row["ok_clean_nonempty"] = clean > 0
        else:
            row["fn_vs_clean"] = 1.0 - row["completions"] / clean
            row["ok_fn_bounded"] = row["fn_vs_clean"] <= RES_FN_BOUND
        bad = [k for k, v in row.items() if k.startswith("ok_") and not v]
        log("resilience", f"cell {name} (cuda_block): " + ", ".join(
            f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}"
            for k, v in row.items() if not k.startswith("ok_")) +
            f"; gates {'FAIL ' + '+'.join(bad) if bad else 'pass'}")
        if bad:
            raise AssertionError(f"fault cell {name}: gates {bad} failed")
    cut = RT.slice_events(ev, 0, RES_CUDA_EVENTS)
    for name, kinds in (cells[0], cells[-1]):
        want = cell_digest(SV, fault_cell(torch, dev, specs, cfg, model,
                                          cut, kinds)[1])
        row, srt = fault_cell(torch, dev, specs,
                              dataclasses.replace(cfg, backend="cuda"),
                              model, cut, kinds)
        got = cell_digest(SV, srt)
        if got != want:
            raise AssertionError(f"fault cell {name}: cuda {got} != "
                                 f"cuda_block {want}")
        log("resilience", f"cell {name} on cuda, the first "
            f"{RES_CUDA_EVENTS} events ({row['wall_s']:.2f} s): carry "
            f"sha256 {got[0][:16]}... and semantic counters equal "
            "cuda_block's on the same events")


def cell_digest(SV, srt) -> tuple:
    """(carry sha256, semantic counters as sorted JSON): a poisoned
    chunk's NaN latencies compare equal as text."""
    return SV.carry_sha(srt), json.dumps(SV.semantic_counters(srt),
                                         sort_keys=True)


def resilience_inert(torch, np) -> None:
    """Resilience off: the chunked runtime equals one monolithic
    run_engine (cuda_block and cuda).  Configured but never triggered: it
    equals resilience off (one stream; 128 lanes, with both runs'
    events/s and the guard's host reads per chunk)."""
    import dataclasses

    from repro_torch import runtime as RT
    from repro_torch.cep import engine as eng

    dev = torch.device(DEV)
    specs, cfg, model, (ev,), _ = stock_setup(torch, dev, "cuda_block",
                                              RES_EVENTS)
    inert = dict(ingest=RT.IngestConfig(),
                 ladder=RT.LadderConfig(latency_bound=1e6, max_rung=1),
                 guard=RT.GuardConfig(check_every_chunks=1,
                                      checkpoint_every_chunks=4))
    for backend in ("cuda_block", "cuda"):
        c = dataclasses.replace(cfg, backend=backend)
        n = RES_EVENTS if backend == "cuda_block" else RES_CUDA_EVENTS
        ev_b = RT.slice_events(ev, 0, n)
        mono, _ = eng.run_engine(c, model, ev_b,
                                 eng.init_carry(c, device=dev), device=dev)
        runs = {}
        for label, kw in (("off", {}), ("inert", inert)):
            if backend == "cuda" and label == "inert":
                continue
            srt = RT.StreamRuntime(c, model, RT.RuntimeConfig(
                chunk_size=RES_CHUNK, **kw), device=dev)
            push_all(RT, srt, ev_b)
            sync(torch, dev)
            runs[label] = srt
        for label, srt in runs.items():
            bad = [i for i, (a, b) in enumerate(zip(
                carry_leaves(mono), carry_leaves(srt.carry)))
                if not same(torch, a, b)]
            if bad:
                raise AssertionError(f"resilience {label} on {backend}: "
                                     f"carry leaves {bad} != run_engine")
        log("resilience", f"{backend}: resilience off == one monolithic "
            f"run_engine" + (" == resilience configured and never "
                             "triggered" if "inert" in runs else "") +
            f" (every carry leaf, {n} events, pushes of "
            f"{RES_PUSH}, chunk {RES_CHUNK})")

    # -- 128 lanes, the runtime phase's cell --------------------------------
    specs, cfg, model, evs, _ = stock_setup(torch, dev, "cuda_block",
                                            RES_EVENTS, lanes=RT_LANES,
                                            rates=(1.2, 1.4))
    mL, evL = RT.broadcast_model(model, RT_LANES), RT.stack(evs)
    out = {}
    for label, kw in (("off", {}), ("inert", inert), ("off", {}),
                      ("inert", inert)):
        mt = RT.MultiTenantRuntime(cfg, mL, RT_LANES, rt=RT.RuntimeConfig(
            chunk_size=RES_CHUNK, **kw), device=dev)
        sync(torch, dev)
        t0 = time.perf_counter()
        push_all(RT, mt, evL, axis=1)
        sync(torch, dev)
        out[label] = (time.perf_counter() - t0, mt)   # the second run kept
    (w_off, off), (w_in, inr) = out["off"], out["inert"]
    bad = [k for k in range(RT_LANES) if not all(
        same(torch, a, b) for a, b in zip(
            carry_leaves(lane_view(off.carry, k)),
            carry_leaves(lane_view(inr.carry, k))))]
    if bad:
        raise AssertionError(f"inert resilience changed lanes {bad}")
    total = RT_LANES * RES_EVENTS
    n_chunks = inr.telemetry.aggregate()["n_chunks"]
    g = inr.guard
    log("resilience", f"{RT_LANES} lanes x {RES_EVENTS} events, pushes of "
        f"{RES_PUSH}: resilience off {w_off:.4f} s = {total / w_off:.1f} "
        f"events/s; inert (ingest + ladder + guard) {w_in:.4f} s = "
        f"{total / w_in:.1f} events/s ({w_in / w_off:.2f}x the time); every "
        f"lane's carry equal; guard: {g.checks_run} checks (one host read "
        f"each, at the end of each group of chunks) over {n_chunks} chunks "
        f"= {g.checks_run / n_chunks:.3f} host reads per chunk, "
        f"{g.checkpoints} host-copy checkpoints")


def resilience_lanes(torch, np) -> dict:
    """128 lanes under lane faults (lane_poison and table_corrupt into
    lanes 3, 64 and 127 at one push, ladder off) and under a ladder whose
    bound forces the PM-trim rung (trim_store_lanes on the kernels)."""
    from repro_torch import runtime as RT
    from repro_torch.cep import engine as eng
    from repro_torch.kernels import ops as kops
    from repro_torch.runtime import guard as GD

    dev = torch.device(DEV)
    specs, cfg, model, evs, _ = stock_setup(torch, dev, "cuda_block",
                                            RES_EVENTS, lanes=RT_LANES,
                                            rates=(1.2, 1.4))
    mL, evL = RT.broadcast_model(model, RT_LANES), RT.stack(evs)

    # -- (a) per-lane restore -------------------------------------------------
    rt = RT.RuntimeConfig(chunk_size=RES_CHUNK, guard=RT.GuardConfig(
        check_every_chunks=1, checkpoint_every_chunks=4))
    clean = RT.MultiTenantRuntime(cfg, mL, RT_LANES, rt=rt, device=dev)
    push_all(RT, clean, evL, axis=1)
    hit = RT.MultiTenantRuntime(cfg, mL, RT_LANES, rt=rt, device=dev)
    inj = RT.FaultInjector(RT.FaultConfig(
        kinds=("lane_poison", "table_corrupt"), seed=3, p_fault=1.0))
    n = RES_EVENTS
    for k, s in enumerate(range(0, n, RES_PUSH)):
        if k == 3:
            for lane in RES_POISONED:
                hit.carry = inj.corrupt_carry(hit.carry, lane=lane)
                hit.model = inj.corrupt_model(hit.model, lane=lane)
        hit.push(RT.slice_events(evL, s, min(s + RES_PUSH, n), 1))
    hit.flush()
    sync(torch, dev)
    restored = [e.detail["lanes"] for e in
                hit.telemetry.events_of("guard_restore")]
    if restored != [list(RES_POISONED)]:
        raise AssertionError(f"lane faults: restores {restored}, expected "
                             f"one of lanes {list(RES_POISONED)}")
    bad = [k for k in range(RT_LANES) if k not in RES_POISONED and not all(
        same(torch, a, b) for a, b in zip(
            carry_leaves(lane_view(clean.carry, k)),
            carry_leaves(lane_view(hit.carry, k))))]
    if bad or not floats_finite(torch, hit.carry) or \
            not floats_finite(torch, hit.model):
        raise AssertionError(f"lane faults: lanes {bad} differ from the run "
                             "without faults, or state not finite")
    log("resilience", f"lane faults into lanes {list(RES_POISONED)} of "
        f"{RT_LANES} at push 4 ({len(inj.log)} faults): the guard restored "
        f"exactly those lanes ({hit.guard.violations} violations, "
        f"{hit.guard.restores} restore); the other {RT_LANES - 3} lanes "
        "equal the run without faults in every carry leaf")

    # -- (b) the PM-trim rung over lanes --------------------------------------
    trims = []

    class Capturing(RT.MultiTenantRuntime):
        def _trim_call(self, i, frac):
            keep = len(trims) < 2
            if keep:
                before = (GD.host_copy(self.carry), GD.host_copy(self.model))
            out = super()._trim_call(i, frac)
            if keep:
                trims.append((before, i, frac, GD.host_copy(out)))
            return out

    rt = RT.RuntimeConfig(chunk_size=RES_CHUNK, group_chunks=1,
                          ladder=RT.LadderConfig(
                              escalate_streak=1, deescalate_streak=2,
                              latency_bound=cfg.latency_bound / 2,
                              max_rung=RT.RUNG_PM_TRIM, trim_frac=0.25))
    mt = Capturing(cfg, mL, RT_LANES, rt=rt, device=dev)
    sync(torch, dev)
    kops.reset_launch_counts()
    t0 = time.perf_counter()
    push_all(RT, mt, evL, axis=1)
    sync(torch, dev)
    wall = time.perf_counter() - t0
    counts = kops.launch_counts()
    n_trims = sum(1 for s in mt.telemetry.chunks if s.rung >= 1)
    if not trims or counts["utility_histogram_lanes"] != 3 * n_trims or \
            counts["utility_lookup"] != n_trims:
        raise AssertionError(f"trim rung: {n_trims} trims, launches "
                             f"{counts}: expected 1 lookup and 3 lane "
                             "histograms per trim")
    err = 0.0
    on_card = lambda t: eng.tree_map(lambda x: x.to(dev), t)  # noqa: E731
    for (carry0, model0), i, frac, out in trims:
        plain = GD.trim_store_lanes(cfg, model0, carry0, i, frac)
        c_card, m_card = on_card(carry0), on_card(model0)
        for k in range(RT_LANES):
            one = GD.trim_store(cfg, lane_view(m_card, k),
                                lane_view(c_card, k), i, frac)
            got = carry_leaves(lane_view(out, k))
            for label, want in (("plain", carry_leaves(lane_view(plain, k))),
                                ("lane by lane", carry_leaves(one))):
                if not all(same(torch, a, b.cpu())
                           for a, b in zip(got, want)):
                    raise AssertionError(f"trim lanes != {label} at lane "
                                         f"{k}")
                err = max([err] + [max_abs_err(torch, a, b.cpu())
                                   for a, b in zip(got, want)])
    # Time one trim over 128 lanes against 128 one-lane trims.
    (carry0, model0), i, frac, _ = trims[0]
    c_card, m_card = on_card(carry0), on_card(model0)
    kops.reset_launch_counts()
    GD.trim_store_lanes(cfg, m_card, c_card, i, frac)
    per_lanes = sum(kops.launch_counts().values())
    kops.reset_launch_counts()
    views = [(lane_view(m_card, k), lane_view(c_card, k))
             for k in range(RT_LANES)]
    for m1, c1 in views:
        GD.trim_store(cfg, m1, c1, i, frac)
    per_lane = sum(kops.launch_counts().values())
    ms_lanes = cuda_ms(torch, lambda: GD.trim_store_lanes(
        cfg, m_card, c_card, i, frac), iters=20)
    ms_one = cuda_ms(torch, lambda: [GD.trim_store(cfg, m1, c1, i, frac)
                                     for m1, c1 in views], iters=3)
    n_active = int(c_card.pms.active.sum())
    hist_bytes = RT_LANES * cfg.num_patterns * cfg.max_pms * 4 + \
        RT_LANES * (2 * 128 + 1) * 4
    log("resilience", f"trim rung at L={RT_LANES}: {n_trims} trims in "
        f"{len(mt.telemetry.chunks)} chunks ({wall:.3f} s), launches "
        f"{ {k: v for k, v in counts.items() if v} }; the first two trims "
        f"equal the plain version (CPU) and {RT_LANES} one-lane trims on the "
        f"card, "
        f"lane by lane, max |d| {err!r}")
    log("resilience", f"one trim over {RT_LANES} lanes ({n_active} active "
        f"PMs): {ms_lanes:.4f} ms, {per_lanes} launches; lane by lane "
        f"{ms_one:.4f} ms, {per_lane} launches ({ms_one / ms_lanes:.1f}x)")
    return {"utility_histogram_lanes": dict(
        launches=counts["utility_histogram_lanes"], trim_ms=ms_lanes,
        trim_lane_by_lane_ms=ms_one, trim_launches=per_lanes,
        trim_lane_by_lane_launches=per_lane, trim_hist_bytes=hist_bytes)}


# ---------------------------------------------------------------------------
# Durable recovery (counterpart of benchmarks/bench_recovery.py)
# ---------------------------------------------------------------------------

# bench_recovery's kill draws per site (the snapshot site strikes the
# SECOND write, so a previous generation exists to fall back to) and its
# grid's cells for pallas_block and pallas, with the site and seed that
# grid's cycling gives them (cell i: site KILL_SITES[i % 3], seed 100 + i).
REC_KILL_RANGES = {"chunk": (2, 10), "refresh": (1, 2), "snapshot": (2, 2)}
REC_CELLS = (("cuda_block", "none", 8), ("cuda_block", "pspice", 9),
             ("cuda_block", "pmbl", 10), ("cuda_block", "ebl", 11),
             ("cuda", "pspice", 5))
# The host-bound per-event path's cell runs 12 000 events (12 chunks: its
# kill at the second snapshot, chunk 8, still falls inside), to keep the
# script within its time (PERF.md §7).
REC_CUDA_EVENTS = 12000


def rec_spec(backend: str, shedder: str) -> dict:
    """The supervisor's workload at full width: N = 256, W = 32, 30 000
    events (REC_CUDA_EVENTS on "cuda"), chunk 1 024, pushes of 4 096,
    snapshot every 4 chunks."""
    n = REC_CUDA_EVENTS if backend == "cuda" else RES_EVENTS
    return {"backend": backend, "shedder": shedder, "n": n,
            "push": RES_PUSH, "chunk": RES_CHUNK, "max_pms": 256,
            "block_events": W_BLOCK, "rate_mult": 3.0, "refresh_every": 4,
            "snapshot_every": 4, "min_observations": 64.0, "device": DEV}


def phase_recovery(torch, np) -> None:
    """SIGKILL recovery on the card: the supervisor's children run on the
    card, die at a seeded kill site, and the relaunched child must end
    bitwise equal to the uninterrupted run; then an in-process snapshot +
    recovery of 128 stock lanes.  The five supervised cells run side by
    side (a child's start, not its work, takes most of a cell's time), so
    their times share the host's cores."""
    import concurrent.futures
    import shutil
    import tempfile

    from repro_torch import runtime as RT
    from repro_torch.runtime import supervisor as SV

    work = pathlib.Path(tempfile.mkdtemp(prefix="smoke-persist-",
                                         dir=ROOT / "build"))

    def supervised(d, spec, kill):
        t0 = time.perf_counter()
        res = SV.Supervisor(str(d)).run(spec, kill=kill)
        return res, time.perf_counter() - t0

    try:
        cells = []
        for backend, shedder, i in REC_CELLS:
            site = RT.KILL_SITES[i % len(RT.KILL_SITES)]
            inj = RT.FaultInjector(RT.FaultConfig(kinds=RT.PROCESS_FAULTS,
                                                  seed=100 + i))
            ks = inj.plan_kill(site, *REC_KILL_RANGES[site])
            spec = rec_spec(backend, shedder)
            t0 = time.perf_counter()
            ref = SV.run_service(spec)
            t_ref = time.perf_counter() - t0
            d = work / f"{backend}-{shedder}"
            d.mkdir()
            cells.append((backend, shedder, site, ks, spec, ref, t_ref, d))
        t0 = time.perf_counter()
        with concurrent.futures.ThreadPoolExecutor(len(cells)) as pool:
            futs = [pool.submit(supervised, c[7], c[4], c[3].spec())
                    for c in cells]
            done = [f.result() for f in futs]
        log("recovery", f"{len(cells)} supervised cells side by side: "
            f"{time.perf_counter() - t0:.2f} s")
        for (backend, shedder, site, ks, spec, ref, t_ref, d), \
                (res, t_sup) in zip(cells, done):
            rep, rec = res["report"], res["report"]["recovery"]
            gates = {
                "ok_killed": res["killed"] and res["attempts"][0][
                    "returncode"] == -9,
                "ok_recovered": res["recovered"],
                "ok_bitwise": all(rep[k] == ref[k] for k in (
                    "carry_sha", "matches", "counters",
                    "events_processed"))}
            if site == "snapshot":
                gates["ok_torn_rejected"] = len(rec["rejected_snapshots"]) \
                    >= 1
            snaps = sorted((d / "persist").glob("snap-*.ckpt"))
            log("recovery", f"{backend}/{shedder} kill {ks.spec()}: "
                f"attempts {[a['returncode'] for a in res['attempts']]}, "
                f"snapshot chunk {rec['snapshot_chunk']}, replayed "
                f"{rec['replayed_records']} WAL records, rejected "
                f"{len(rec['rejected_snapshots'])}, recovery "
                f"{rec['recovery_wall_s'] * 1e3:.1f} ms in the child, "
                f"snapshot {snaps[-1].stat().st_size if snaps else 0} B; "
                f"{sum(len(m) for m in rep['matches'])} matches, "
                f"{rep['events_processed']} events; uninterrupted run "
                f"{t_ref:.2f} s, supervised {t_sup:.2f} s (side by side); "
                "gates " +
                ", ".join(f"{k} {v}" for k, v in gates.items()))
            if not all(gates.values()):
                raise AssertionError(f"recovery {backend}/{shedder}: "
                                     f"{gates}")
        recovery_lanes(torch, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def recovery_lanes(torch, work) -> None:
    """128 stock lanes with the guard and persistence: snapshot, abandon
    the runtime mid-stream (what a SIGKILL leaves on disk), recover into
    a fresh MultiTenantRuntime and finish; every lane equals the
    uninterrupted run."""
    from repro_torch import runtime as RT

    dev = torch.device(DEV)
    specs, cfg, model, evs, _ = stock_setup(torch, dev, "cuda_block",
                                            RES_EVENTS, lanes=RT_LANES,
                                            rates=(1.2, 1.4))
    mL, evL = RT.broadcast_model(model, RT_LANES), RT.stack(evs)
    d = work / "lanes"

    def rt(persist):
        return RT.RuntimeConfig(
            chunk_size=RES_CHUNK, guard=RT.GuardConfig(
                check_every_chunks=1, checkpoint_every_chunks=4),
            persist=RT.PersistConfig(dir=str(d), snapshot_every_chunks=4)
            if persist else None)

    clean = RT.MultiTenantRuntime(cfg, mL, RT_LANES, rt=rt(False),
                                  device=dev)
    push_all(RT, clean, evL, axis=1)
    a = RT.MultiTenantRuntime(cfg, mL, RT_LANES, rt=rt(True), device=dev)
    append_s = []
    wal_append = a.persist.wal.append

    def timed(ev):
        t0 = time.perf_counter()
        rid = wal_append(ev)
        append_s.append(time.perf_counter() - t0)
        return rid

    a.persist.wal.append = timed
    cut = 3 * RES_PUSH + RES_CHUNK + RES_CHUNK // 2   # a buffered tail
    for s in range(0, 3 * RES_PUSH, RES_PUSH):
        a.push(RT.slice_events(evL, s, s + RES_PUSH, 1))
    t0 = time.perf_counter()
    path = a.snapshot_now()
    write_ms = (time.perf_counter() - t0) * 1e3
    snap_bytes = pathlib.Path(path).stat().st_size   # rotated away later
    a.push(RT.slice_events(evL, 3 * RES_PUSH, cut, 1))
    a.persist.wal.close()
    del a
    b = RT.MultiTenantRuntime(cfg, mL, RT_LANES, rt=rt(True), device=dev)
    t0 = time.perf_counter()
    rec = b.recover_from_disk()
    sync(torch, dev)
    rec_ms = (time.perf_counter() - t0) * 1e3
    for s in range(cut, RES_EVENTS, RES_PUSH):
        b.push(RT.slice_events(evL, s, min(s + RES_PUSH, RES_EVENTS), 1))
    b.flush()
    sync(torch, dev)
    bad = [k for k in range(RT_LANES) if not all(
        same(torch, x, y) for x, y in zip(
            carry_leaves(lane_view(clean.carry, k)),
            carry_leaves(lane_view(b.carry, k))))]
    if bad or rec["replayed_records"] != 1:
        raise AssertionError(f"128-lane recovery: lanes {bad} differ, "
                             f"{rec['replayed_records']} records replayed")
    log("recovery", f"{RT_LANES} lanes in process: snapshot "
        f"{snap_bytes} B written in {write_ms:.2f} "
        f"ms (fsync included), recovery {rec_ms:.2f} ms replaying "
        f"{rec['replayed_records']} WAL record, WAL append "
        f"{statistics.mean(append_s) * 1e6:.1f} us per push of "
        f"{RT_LANES} x {RES_PUSH} events (mean of {len(append_s)}); every "
        "lane equals the uninterrupted run in every carry leaf")


# ---------------------------------------------------------------------------
# The scale-out: pattern and lane shards over torch.distributed
# ---------------------------------------------------------------------------

DIST_TIMEOUT = 120.0       # seconds: each spawned world, each collective
# Stock events of the world of one: 12 000 of the main path's 30 000, to
# keep the script within its time (PERF.md §7); both paths and the serial
# run take the same stream, whose pspice run still fires (42 shed calls).
DIST_STOCK = 12000
DIST_SOCCER = 12000        # soccer events (30 % warm-up, the rest run)
# The pattern-shard worlds' soccer stream: 6 000 events (4 200 run), to
# keep the script within its time (PERF.md §7).
DIST_SHARD_SOCCER = 6000
DIST_LANES = 8             # soccer lanes on the (data 2, model 2) mesh
# The lanes world's durable state: a snapshot every 4 chunks (rank 0
# writes), and the two worlds killed from it — (rank, "site:after"): rank
# 0 in its second snapshot write (a torn generation), rank 3, which writes
# nothing, after its sixth chunk.
DIST_SNAPSHOT_EVERY = 4
DIST_KILLS = ((0, "snapshot:2"), (3, "chunk:6"))
DIST_RECOVERY_BUDGET_S = 45.0
DIST_PLAIN_CHUNKS = 1      # lane chunks also run on the plain versions
DIST_BACKEND = "nccl"      # the world of one's (its rank owns the card)


def tree_digests(tree, path: str = "") -> dict:
    """{leaf path: sha256 of its bytes, dtype and shape} of a tree of
    tensors (NamedTuples), read to the host."""
    import hashlib
    if hasattr(tree, "_fields"):
        out = {}
        for k, v in zip(tree._fields, tree):
            out.update(tree_digests(v, f"{path}.{k}"))
        return out
    a = tree.detach().cpu().contiguous().numpy()
    h = hashlib.sha256(a.tobytes())
    h.update(f"{a.dtype}{a.shape}".encode())
    return {path: h.hexdigest()}


def phase_dist(torch, np) -> dict:
    """repro_torch.dist on the card: a world of one rank over NCCL in
    this process (stock's run_experiment with the PM store sharded, and
    the 128-lane runtime on a one-rank mesh), then gloo worlds of ranks
    that share the one card: soccer's eight patterns in 2 and 4 pattern
    shards, and 8 soccer lanes on a (data 2, model 2) mesh.  Ranks on one
    card share its SMs: the walls here measure no scale-out.  Returns
    each kernel's launches in the phase's driven runs (every rank's)."""
    from repro_torch.kernels import _build

    _build.load()          # the ranks open the library this build made
    launches: dict = {}

    def add(counts):
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v

    dist_world_of_one(torch, np, add)
    dist_soccer_shards(torch, np, add)
    dist_soccer_lanes(torch, np, add)
    return {k: {"dist_launches": v} for k, v in launches.items() if v}


def dist_world_of_one(torch, np, add) -> None:
    import shutil
    import tempfile

    import torch.distributed as tdist
    from repro_torch import dist as D
    from repro_torch import runtime as RT
    from repro_torch.cep import runner
    from repro_torch.data import streams
    from repro_torch.kernels import ops as kops

    dev = torch.device(DEV)
    if dev.type == "cuda":
        torch.cuda.set_device(0)          # the world's one rank, its card
    store = tempfile.mkdtemp(prefix="smoke-store-", dir=ROOT / "build")
    mesh = D.init_mesh((1,), ("data",), backend=DIST_BACKEND,
                       init_method=f"file://{store}/store", rank=0,
                       timeout=DIST_TIMEOUT)
    try:
        sc = streams.get_scenario("stock")
        raw = sc.raw(n=DIST_STOCK)
        kw = dict(rate_multiplier=1.2, max_pms=sc.max_pms,
                  bin_size=sc.bin_size, latency_bound=sc.latency_bound,
                  seed=sc.seed, block_events=W_BLOCK, device=DEV,
                  **paper_cost())
        # One serial run, on the block path: the main and quality phases
        # hold "cuda" to "cuda_block" in FN, fires and compliance exactly.
        serial = runner.run_experiment(sc.specs(), raw,
                                       shedders=("pspice", "pmbl", "ebl"),
                                       backend="cuda_block", **kw)
        for backend, shedders in (("cuda_block", ("pspice", "pmbl", "ebl")),
                                  ("cuda", ("pspice",))):
            sync(torch, dev)
            kops.reset_launch_counts()
            D.stats.reset()
            t0 = time.perf_counter()
            par = runner.run_experiment(sc.specs(), raw, shedders=shedders,
                                        backend=backend, pattern_parallel=True,
                                        mesh=mesh, **kw)
            sync(torch, dev)
            wall = time.perf_counter() - t0
            counts = kops.launch_counts()
            add(counts)
            for k in (k for k, b in KERNEL_PATH.items() if b == backend):
                if counts[k] <= 0:
                    raise AssertionError(f"dist: kernel {k} never launched "
                                         f"on the sharded {backend} path")
            for sh in shedders:
                a, b = serial[sh], par[sh]
                want = (a.fn, a.fn_match, a.result.shed_calls,
                        a.lb_compliance)
                got = (b.fn, b.fn_match, b.result.shed_calls,
                       b.lb_compliance)
                if got != want:
                    raise AssertionError(f"dist stock {backend}/{sh}: "
                                         f"pattern-parallel {got} != serial "
                                         f"{want}")
            log("dist", f"{DIST_BACKEND} world of one, stock {DIST_STOCK} "
                f"events x1.2, "
                f"{backend}: run_experiment(pattern_parallel=True) == the "
                "serial cuda_block run in FN, fires and compliance for "
                f"{', '.join(shedders)}; "
                f"wall {wall:.2f} s; launches {counts}; collectives "
                f"{D.stats.calls} calls, {D.stats.bytes_out} B, "
                f"{D.stats.seconds * 1e3:.2f} ms")

        specs, cfg, model, evs, _ = stock_setup(torch, dev, "cuda_block",
                                                RT_EVENTS, lanes=RT_LANES,
                                                rates=(1.2, 1.4))
        mL, evL = RT.broadcast_model(model, RT_LANES), RT.stack(evs)
        rt = RT.RuntimeConfig(chunk_size=RT_CHUNK)
        total = RT_LANES * RT_EVENTS
        walls, runs = {}, {}
        for name, m in (("meshless", None), ("mesh", mesh)):
            mt = RT.MultiTenantRuntime(cfg, mL, RT_LANES, rt=rt, mesh=m,
                                       device=dev)
            sync(torch, dev)
            kops.reset_launch_counts()
            D.stats.reset()
            t0 = time.perf_counter()
            mt.push(evL, flush=True)
            sync(torch, dev)
            walls[name] = time.perf_counter() - t0
            runs[name] = (mt, kops.launch_counts(), D.stats.seconds,
                          D.stats.bytes_out, D.stats.calls)
        add(runs["mesh"][1])
        if runs["mesh"][1]["block_step_lanes"] <= 0:
            raise AssertionError("dist: the lane grid never launched on the "
                                 "one-rank mesh")
        a, b = runs["meshless"][0].carry, runs["mesh"][0].carry
        if not all(same(torch, x, y) for x, y in zip(carry_leaves(a),
                                                      carry_leaves(b))):
            raise AssertionError("dist: the 128 lanes on a one-rank mesh "
                                 "differ from the meshless runtime")
        _, counts, secs, nbytes, calls = runs["mesh"]
        log("dist", f"{DIST_BACKEND} world of one, {RT_LANES} stock lanes x "
            f"{RT_EVENTS} events: MultiTenantRuntime(mesh) == meshless in "
            f"every lane's carry, bitwise; mesh {walls['mesh']:.4f} s = "
            f"{total / walls['mesh']:.1f} events/s (chunk at a time, "
            f"{counts['block_step_lanes']} lane-grid launches; collectives "
            f"{calls} calls, {nbytes} B, {secs * 1e3:.2f} ms), meshless "
            f"{walls['meshless']:.4f} s = {total / walls['meshless']:.1f} "
            "events/s")
    finally:
        tdist.destroy_process_group()
        shutil.rmtree(store, ignore_errors=True)


def soccer_setup(torch, dev, lanes: int = 1, rates=(1.2, 1.2),
                 emit: bool = True, shedder: str = "none",
                 n: int = DIST_SOCCER):
    """Soccer (8 x Q3, N = 256, W = 32) with the paper's costs over ``n``
    events: the model built on lane 0's first 30 % (run_experiment's
    warm-up), lane l's stream (seed 7 + l, the rest of its events) at
    max_rate x (rates[0] + (rates[1] - rates[0]) l / (lanes - 1)).
    Returns (cfg, model, [events per lane])."""
    from repro_torch.cep import engine as eng, patterns as pat, runner
    from repro_torch.data import streams

    sc = streams.get_scenario("soccer")
    specs = sc.specs()
    cp = pat.compile_patterns(specs)
    cfg = runner.default_config(
        cp, max_pms=sc.max_pms, latency_bound=sc.latency_bound,
        backend="cuda_block", block_events=W_BLOCK, emit_matches=emit,
        shedder=shedder, **paper_cost())
    n_warm = int(n * 0.3)
    raws = [sc.raw(n=n, seed=sc.seed + k) for k in range(lanes)]
    warm = streams.classify(specs, _cut(raws[0], 0, n_warm), rate=1.0,
                            seed=sc.seed, device=dev)
    built = runner.build_model(specs, cfg, warm, bin_size=sc.bin_size,
                               seed=sc.seed, device=dev)
    mult = [rates[0] + (rates[1] - rates[0]) * k / max(lanes - 1, 1)
            for k in range(lanes)]
    evs = [streams.classify(specs, _cut(raws[k], n_warm, n),
                            rate=built.max_rate * mult[k], seed=sc.seed + k,
                            device=dev) for k in range(lanes)]
    model = eng.make_model(
        cp, cfg, ut_tables=built.ut_stacked, ut_bins=built.ut_bins,
        f_model=built.f_model, g_model=built.g_model,
        ebl_raw_mean=float(evs[0].ebl_raw.mean()), device=dev)
    return cfg, model, evs


def dist_rank_shards(device, shape, cases, model, events, carry) -> dict:
    """One rank of a soccer pattern-shard world: each (name, cfg) case
    through run_engine_sharded on the card; per case the digests of the
    global carry and StepOut, the wall, this rank's launches and its
    collectives."""
    import torch
    from repro_torch import dist as D
    from repro_torch.cep import convert
    from repro_torch.kernels import ops as kops

    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(0)          # every rank on the one card
    # The CEP merge stages its collectives through host memory.
    mesh = D.init_mesh(shape, ("data",), device_type="cpu")
    model = convert.model_from_numpy(model, dev)
    events = convert.events_from_numpy(events, dev)
    carry = convert.carry_from_numpy(carry, dev)
    out = {}
    for name, cfg in cases:
        sync(torch, dev)
        kops.reset_launch_counts()
        D.stats.reset()
        t0 = time.perf_counter()
        c, o = D.run_engine_sharded(cfg, model, events, carry, mesh=mesh,
                                    device=dev)
        sync(torch, dev)
        wall = time.perf_counter() - t0
        out[name] = dict(
            digests={**tree_digests(c, "carry"), **tree_digests(o, "outs")},
            wall=wall, launches=kops.launch_counts(),
            coll_ms=D.stats.seconds * 1e3, coll_bytes=D.stats.bytes_out,
            coll_calls=D.stats.calls, shed_calls=float(c.shed_calls),
            ebl_dropped=float(c.ebl_dropped),
            completions=float(c.complex_count.sum()))
    return out


def dist_soccer_shards(torch, np, add) -> None:
    import dataclasses

    from repro_torch import dist as D
    from repro_torch.cep import convert, engine as eng

    dev = torch.device(DEV)
    t0 = time.perf_counter()
    cfg, model, (events,) = soccer_setup(torch, dev, n=DIST_SHARD_SOCCER)
    carry = eng.init_carry(cfg, seed=7, device=dev)
    npy = [convert.tree_to_numpy(x) for x in (model, events, carry)]
    n_run = events.ev_class.shape[0]
    cpu = [f(x, "cpu") for f, x in zip((convert.model_from_numpy,
                                        convert.events_from_numpy,
                                        convert.carry_from_numpy), npy)]
    log("dist", f"soccer: 8 x Q3, N={cfg.max_pms}, {n_run} events at 1.2 x "
        f"max_rate, match tiles on; set-up {time.perf_counter() - t0:.2f} s")
    for n in (2, 4):
        cases = [(f"cuda_block/{sh}", dataclasses.replace(
            cfg, shedder=sh)) for sh in ("none", "pspice", "pmbl", "ebl")]
        if n == 2:
            cases.append(("cuda/pspice", dataclasses.replace(
                cfg, shedder="pspice", backend="cuda")))
        t0 = time.perf_counter()
        ranks = D.spawn(dist_rank_shards, n, args=(DEV, (n,), cases, *npy),
                        timeout=DIST_TIMEOUT, workdir=str(ROOT / "build"))
        world_wall = time.perf_counter() - t0
        # The kernels' plain versions at this path's shapes: pspice's
        # per-slice runs on "torch" on the CPU, merged in process; every
        # rank's sharded pspice run (the block kernel, and at 2 ranks the
        # per-event kernels) is held to it.  The other shedders' ranks
        # are held to the per-slice runs of the same kernels.
        t0 = time.perf_counter()
        c, o = D.run_engine_shards_plain(
            dataclasses.replace(cfg, shedder="pspice", backend="torch"),
            *cpu, mesh=D.abstract_mesh((n,), ("data",)), device="cpu")
        plain = {**tree_digests(c, "carry"), **tree_digests(o, "outs")}
        cpu_wall = time.perf_counter() - t0
        for name, ccfg in cases:
            if name.endswith("/pspice"):
                want, plain_wall = plain, cpu_wall
                how = "the kernels' plain versions (\"torch\" on the CPU)"
            else:                         # the same kernels, in process
                t0 = time.perf_counter()
                c, o = D.run_engine_shards_plain(
                    ccfg, model, events, carry,
                    mesh=D.abstract_mesh((n,), ("data",)), device=dev)
                sync(torch, dev)
                plain_wall = time.perf_counter() - t0
                want = {**tree_digests(c, "carry"),
                        **tree_digests(o, "outs")}
                how = "the same kernels in process"
            for r, res in enumerate(ranks):
                bad = [k for k in want if res[name]["digests"].get(k)
                       != want[k]]
                if bad:
                    raise AssertionError(f"dist soccer {n} ranks {name}: "
                                         f"rank {r} != merge_shards_plain "
                                         f"over {how} in {bad}")
                add(res[name]["launches"])
            if ccfg.backend == "cuda_block":
                per = -(-n_run // W_BLOCK)
                got = [res[name]["launches"]["block_step"] for res in ranks]
                if got != [per] * n:
                    raise AssertionError(f"dist soccer {name}: block "
                                         f"launches per rank {got}, "
                                         f"expected {per} each")
            r0 = ranks[0][name]
            log("dist", f"soccer {n} ranks (gloo, one card) {name}: every "
                "rank's global carry and StepOut == merge_shards_plain over "
                f"the per-slice runs on {how}, bitwise; fires "
                f"{r0['shed_calls']:g}, E-BL drops "
                f"{r0['ebl_dropped']:g}, completions {r0['completions']:g}; "
                "wall per rank " + ", ".join(
                    f"{res[name]['wall']:.3f}" for res in ranks) +
                " s; block launches per rank " + ", ".join(
                    str(res[name]["launches"]["block_step"])
                    for res in ranks) + "; kernel launches rank 0 "
                f"{r0['launches']}; collectives per rank {r0['coll_calls']} "
                f"calls, {r0['coll_bytes']} B, " + ", ".join(
                    f"{res[name]['coll_ms']:.2f}" for res in ranks) +
                f" ms; per-slice runs {plain_wall:.3f} s")
        log("dist", f"soccer {n} ranks: world wall {world_wall:.2f} s (rank "
            "start included)")


def dist_rank_lanes(device, shape, names, cfg, model, events, chunk,
                    seed, persist_dir, kill=None) -> dict:
    """One rank of the lanes x patterns world: MultiTenantRuntime on the
    mesh with persistence under ``persist_dir`` (rank 0 writes a snapshot
    every DIST_SNAPSHOT_EVERY chunks), recovered from it (a no-op on an
    empty directory), then fed a chunk at a time from the report's next
    push.  ``kill`` = (rank, "site:after") arms the kill switch in that
    rank alone.  Returns the carry's digests after every chunk run here,
    the wall, this rank's launches and collectives, the recovery report
    and milliseconds, the telemetry's counters and the events."""
    import torch
    import torch.distributed as tdist
    from repro_torch import dist as D
    from repro_torch import runtime as RT
    from repro_torch.cep import convert
    from repro_torch.kernels import ops as kops
    from repro_torch.runtime import faults as FT
    from repro_torch.runtime import supervisor as SV

    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(0)          # every rank on the one card
    mesh = D.init_mesh(shape, names, device_type="cpu")   # as above
    if kill is not None and tdist.get_rank() == kill[0]:
        FT.install_kill_from_env({FT.KILL_ENV: kill[1]})
    model = convert.model_from_numpy(model, dev)
    events = convert.events_from_numpy(events, dev)
    n = events.ev_class.shape[1]
    rt = RT.RuntimeConfig(chunk_size=chunk, persist=RT.PersistConfig(
        dir=persist_dir, snapshot_every_chunks=DIST_SNAPSHOT_EVERY))
    mt = RT.MultiTenantRuntime(cfg, model, events.ev_class.shape[0], rt=rt,
                               seed=seed, mesh=mesh, device=dev)
    sync(torch, dev)
    kops.reset_launch_counts()
    D.stats.reset()
    t0 = time.perf_counter()
    rep = mt.recover_from_disk()
    sync(torch, dev)
    rec_ms = (time.perf_counter() - t0) * 1e3
    rep.pop("recovery_wall_s")
    digests, wall = [], 0.0
    for s in range(rep["next_record"] * chunk, n, chunk):
        t0 = time.perf_counter()
        mt.push(RT.slice_events(events, s, min(s + chunk, n), 1),
                flush=s + chunk >= n)
        sync(torch, dev)
        wall += time.perf_counter() - t0
        digests.append(tree_digests(mt.carry, "carry"))
    return dict(digests=digests, wall=wall, launches=kops.launch_counts(),
                coll_ms=D.stats.seconds * 1e3, coll_bytes=D.stats.bytes_out,
                coll_calls=D.stats.calls, chunks=len(mt.telemetry.rows()),
                recovery=rep, recovery_ms=rec_ms,
                counters=SV.semantic_counters(mt),
                events=int(mt.events_processed))


def dist_soccer_lanes(torch, np, add) -> None:
    """The lanes x patterns world (persistence on) against the plain
    emulation, then killed and recovered (``dist_mesh_recovery``), its
    durable state under one directory of build/ removed at the end."""
    import shutil
    import tempfile

    from repro_torch import dist as D
    from repro_torch import runtime as RT
    from repro_torch.cep import convert

    dev = torch.device(DEV)
    shape, names, seed = (2, 2), ("data", "model"), 7
    cfg, model, evs = soccer_setup(torch, dev, lanes=DIST_LANES,
                                   rates=(1.2, 1.4), emit=False,
                                   shedder="pspice")
    mL, evL = RT.broadcast_model(model, DIST_LANES), RT.stack(evs)
    mesh = D.abstract_mesh(shape, names)
    args = (DEV, shape, names, cfg, convert.tree_to_numpy(mL),
            convert.tree_to_numpy(evL), RT_CHUNK, seed)

    work = tempfile.mkdtemp(prefix="smoke-lanes-", dir=ROOT / "build")
    try:
        dist_lanes_worlds(torch, np, add, work, cfg, mL, evL, mesh, seed,
                          args)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def dist_lanes_worlds(torch, np, add, work, cfg, mL, evL, mesh, seed,
                      args) -> None:
    import dataclasses

    from repro_torch import dist as D
    from repro_torch import runtime as RT
    from repro_torch.cep import convert

    dev = torch.device(DEV)
    n = evL.ev_class.shape[1]

    def world(d, kill=None):
        return D.spawn(dist_rank_lanes, 4, args=args + (d, kill),
                       timeout=DIST_TIMEOUT, workdir=str(ROOT / "build"))

    t0 = time.perf_counter()
    ranks = world(os.path.join(work, "uninterrupted"))
    world_wall = time.perf_counter() - t0
    carry = RT.init_lane_carries(cfg, DIST_LANES, seed=seed, device=dev)
    t0 = time.perf_counter()
    want = []
    for s in range(0, n, RT_CHUNK):
        piece = RT.slice_events(evL, s, min(s + RT_CHUNK, n), 1)
        carry, _ = D.run_chunk_lanes_plain(cfg, mL, piece, carry, s,
                                           mesh=mesh, device=dev)
        want.append(tree_digests(carry, "carry"))
    sync(torch, dev)
    plain_wall = time.perf_counter() - t0
    # The kernels' plain versions: the first DIST_PLAIN_CHUNKS chunks on
    # "torch" on the CPU, merged in process after every chunk.
    t0 = time.perf_counter()
    cpu_cfg = dataclasses.replace(cfg, backend="torch")
    mC, evC = (f(convert.tree_to_numpy(x), "cpu") for f, x in (
        (convert.model_from_numpy, mL), (convert.events_from_numpy, evL)))
    carry = RT.init_lane_carries(cfg, DIST_LANES, seed=seed, device="cpu")
    for k, s in enumerate(range(0, DIST_PLAIN_CHUNKS * RT_CHUNK, RT_CHUNK)):
        piece = RT.slice_events(evC, s, min(s + RT_CHUNK, n), 1)
        carry, _ = D.run_chunk_lanes_plain(cpu_cfg, mC, piece, carry, s,
                                           mesh=mesh, device="cpu")
        exp = tree_digests(carry, "carry")
        for r, res in enumerate(ranks):
            bad = [key for key in exp if res["digests"][k].get(key)
                   != exp[key]]
            if bad:
                raise AssertionError(f"dist lanes: rank {r} chunk {k} != the "
                                     "plain versions' emulation on the CPU "
                                     f"in {bad}")
    cpu_wall = time.perf_counter() - t0
    for r, res in enumerate(ranks):
        if len(res["digests"]) != len(want):
            raise AssertionError(f"dist lanes: rank {r} ran "
                                 f"{len(res['digests'])} chunks, the "
                                 f"emulation {len(want)}")
        for k, (got, exp) in enumerate(zip(res["digests"], want)):
            bad = [key for key in exp if got.get(key) != exp[key]]
            if bad:
                raise AssertionError(f"dist lanes: rank {r} chunk {k} != "
                                     f"the plain emulation in {bad}")
        if res["launches"]["block_step_lanes"] <= 0:
            raise AssertionError(f"dist lanes: rank {r} never launched the "
                                 "lane grid")
        add(res["launches"])
    log("dist", f"{DIST_LANES} soccer lanes x {n} events on a (data 2, "
        f"model 2) mesh, gloo, 4 ranks on one card, chunk {RT_CHUNK}, a "
        f"snapshot every {DIST_SNAPSHOT_EVERY} chunks (rank 0 writes): "
        f"MultiTenantRuntime(mesh) == the plain emulation (per-chunk merge)"
        f" after each of {len(want)} chunks, every rank, bitwise; wall per "
        "rank " + ", ".join(f"{res['wall']:.3f}" for res in ranks) +
        " s; lane-grid launches per rank " + ", ".join(
            str(res["launches"]["block_step_lanes"]) for res in ranks) +
        f"; collectives per rank {ranks[0]['coll_calls']} calls, "
        f"{ranks[0]['coll_bytes']} B, " + ", ".join(
            f"{res['coll_ms']:.2f}" for res in ranks) + " ms; emulation "
        f"in process {plain_wall:.3f} s; the first {DIST_PLAIN_CHUNKS} "
        "chunk(s) == the emulation on \"torch\" on the CPU (the kernels' "
        f"plain versions), bitwise, {cpu_wall:.2f} s; world wall "
        f"{world_wall:.2f} s")
    dist_mesh_recovery(world, ranks[0], add, work)


def dist_mesh_recovery(world, clean: dict, add, work: str) -> None:
    """The lanes world killed and recovered: for each of DIST_KILLS a
    world with the kill switch armed in one rank (which must die by
    SIGKILL, named by spawn with exit code -9), then a fresh world on the
    same directory that recovers on every rank (rank 0 reads the snapshot
    and WAL tail and broadcasts them) and finishes the stream; every rank
    must end equal to the uninterrupted world's rank 0 (``clean``) in
    every carry leaf, the telemetry's counters and the events."""
    from repro_torch import dist as D

    t_cell = time.perf_counter()
    final = clean["digests"][-1]
    for rank, spec in DIST_KILLS:
        d = os.path.join(work, f"killed-rank{rank}")
        t0 = time.perf_counter()
        try:
            world(d, (rank, spec))
        except D.RankError as e:
            died = (e.rank, e.exitcode)
        else:
            raise AssertionError(f"dist recovery: the world armed with "
                                 f"{spec} on rank {rank} did not die")
        crash_s = time.perf_counter() - t0
        if died != (rank, -9):
            raise AssertionError(f"dist recovery: armed rank {rank} "
                                 f"({spec}), but spawn reports rank "
                                 f"{died[0]} exit code {died[1]}")
        t0 = time.perf_counter()
        ranks = world(d)
        rec_s = time.perf_counter() - t0
        for r, res in enumerate(ranks):
            got = (res["digests"][-1], res["counters"], res["events"],
                   res["chunks"])
            exp = (final, clean["counters"], clean["events"],
                   clean["chunks"])
            if got != exp:
                bad = [k for k in final if res["digests"][-1].get(k)
                       != final[k]]
                raise AssertionError(f"dist recovery ({spec} on rank "
                                     f"{rank}): rank {r} != the "
                                     f"uninterrupted run (leaves {bad}; "
                                     f"counters, events, chunks "
                                     f"{got[1:]} vs {exp[1:]})")
            if res["recovery"] != ranks[0]["recovery"]:
                raise AssertionError(f"dist recovery: rank {r}'s report "
                                     f"{res['recovery']} != rank 0's")
            add(res["launches"])
        rep = ranks[0]["recovery"]
        torn = (len(rep["rejected_snapshots"]) == 1) == spec.startswith(
            "snapshot")
        if rep["snapshot_chunk"] is None or not rep["replayed_records"] \
                or not torn:
            raise AssertionError(f"dist recovery ({spec}): report {rep}")
        log("dist", f"recovery: rank {rank} killed at {spec} (exit code "
            f"{died[1]}, named by spawn in {crash_s:.2f} s of world wall); "
            f"attempts [{died[1]}, 0]; restarted world: snapshot chunk "
            f"{rep['snapshot_chunk']}, {len(rep['rejected_snapshots'])} "
            f"torn generation(s) rejected, {rep['replayed_records']} WAL "
            f"records replayed (from record {rep['wal_start_record']}), "
            f"next push {rep['next_record']}; recovery ms per rank " +
            ", ".join(f"{res['recovery_ms']:.1f}" for res in ranks) +
            "; lane-grid launches per rank " + ", ".join(
                str(res["launches"]["block_step_lanes"]) for res in ranks) +
            f"; every rank == the uninterrupted run (every carry leaf, "
            f"counters, {clean['events']} events, {clean['chunks']} "
            f"chunks), bitwise; restarted world wall {rec_s:.2f} s")
    secs = time.perf_counter() - t_cell
    log("dist", f"recovery sub-cell: {secs:.2f} s of its "
        f"{DIST_RECOVERY_BUDGET_S:.0f} s budget "
        f"({'within' if secs <= DIST_RECOVERY_BUDGET_S else 'OVER'} it)")


def block_original_layout(torch) -> float:
    """The block kernel in jax's original threefry layout (the committed
    quality results'), bit for bit against its plain version on the
    PM-BL cases: the store in shared memory (stock, bus) and in device
    memory (soccer N=2048); then the kernel's generator alone against
    repro_torch.prng in both layouts, at an odd n (the original layout's
    padded pair) and at soccer's P·N.  Returns the largest |Δ|."""
    from repro_torch import prng
    from repro_torch.cep import block_cases, convert
    from repro_torch.kernels import block_step as kb

    dev = torch.device("cuda")
    err, seen = 0.0, set()
    with prng.layout(False):
        for name, N, shedder in block_cases.CASES:
            if shedder != "pmbl":
                continue
            cfg, model, carry, blk, i0 = block_cases.firing_block(
                name, N, shedder, dev, W=W_BLOCK, **paper_cost())
            lay = kb.plan_layout(cfg, model.trans.shape[2],
                                 model.ut_tables.shape[1])
            seen.add(lay.store)
            pairs, _, sp = block_vs_plain(
                torch, cfg, model, convert.tree_to_numpy(carry), blk, i0,
                f"{name} N={N} pmbl, original threefry layout")
            if int(sp[0]) < 1:
                raise AssertionError(f"block {name} N={N} pmbl: no fire")
            err = max([err] + [max_abs_err(torch, a, b) for a, b in pairs])
            log("kernels", f"block_step {name} N={N} pmbl in the original "
                f"threefry layout ({int(sp[0])} fires, {lay.store} store): "
                "bitwise ok")
    if seen != {"shared", "global"}:
        raise AssertionError(f"original-layout cases took only {seen}")
    for part in (True, False):
        for n in (4097, 8 * 2048):
            key = prng.PRNGKey(n, device=dev)
            keys, u = kb.threefry_probe(key, n, partitionable=part)
            want = prng.split(key, partitionable=part)
            want_u = prng.uniform(want[1], (n,), partitionable=part)
            torch.cuda.synchronize()
            if not (same(torch, keys, want) and same(torch, u, want_u)):
                raise AssertionError(f"threefry_probe != prng (partitionable"
                                     f"={part}, n={n})")
            err = max(err, max_abs_err(torch, u, want_u))
        log("kernels", f"threefry on the card == repro_torch.prng in the "
            f"{'partitionable' if part else 'original'} layout (split and "
            "uniform, n = 4097 and 16384): bitwise ok")
    return err


# ---------------------------------------------------------------------------
# Engine parity: cuda on the card == torch on the card == torch on the CPU
# ---------------------------------------------------------------------------

def phase_parity(torch, np, runs=(("cuda@gpu", "cuda", "cuda"),
                                   ("cuda_block@gpu", "cuda_block", "cuda"),
                                   ("torch@gpu", "torch", "cuda"),
                                   ("torch@cpu", "torch", "cpu")),
                 n: int = 3000, N: int = 2048) -> None:
    import dataclasses

    from repro_torch.cep import convert, engine as eng, patterns as pat
    from repro_torch.cep import runner
    from repro_torch.data import streams

    sc = streams.get_scenario("stock")
    specs = sc.specs()
    cp = pat.compile_patterns(specs)
    cfg = runner.default_config(cp, max_pms=N, latency_bound=0.02,
                                emit_matches=True, gather_stats=True,
                                **paper_cost())
    raw = sc.raw(n=n + 1000)
    cut = lambda a, b: dataclasses.replace(  # noqa: E731
        raw, n=b - a, type_id=raw.type_id[a:b], attr=raw.attr[a:b],
        group=raw.group[a:b])
    cpu = torch.device("cpu")
    built = runner.build_model(
        specs, cfg, streams.classify(specs, cut(0, 1000), rate=1.0, seed=7,
                                     device=cpu), device=cpu)
    # The built utility tables with a LINEAR f (the engine's cost model).
    tree = dict(convert.tree_to_numpy(built), f_model=dict(
        a=np.float32(cfg.c_match), b=np.float32(cfg.c_base),
        kind=np.int32(0)))
    rate = 6.0 / (cfg.c_base + cfg.c_match * 60)
    for shedder in ("none", "pspice", "pmbl", "ebl"):
        results = {}
        for label, backend, dev in runs:
            rcfg = dataclasses.replace(cfg, backend=backend, shedder=shedder)
            b = convert.built_from_numpy(tree, dev)
            ev = streams.classify(specs, cut(1000, n + 1000), rate=rate,
                                  seed=7, device=dev)
            model = eng.make_model(cp, rcfg, ut_tables=b.ut_stacked,
                                   ut_bins=b.ut_bins, f_model=b.f_model,
                                   g_model=b.g_model, ebl_raw_mean=0.5,
                                   device=dev)
            t0 = time.perf_counter()
            carry, outs = eng.run_engine(
                rcfg, model, ev, eng.init_carry(rcfg, seed=7, device=dev),
                device=dev)
            results[label] = (convert.tree_to_numpy((carry, outs)),
                              time.perf_counter() - t0)
        ref, _ = results[runs[-1][0]]
        for label, (got, _) in results.items():
            bad = [k for k, a, b in _leaves(got, ref)
                   if not np.array_equal(a, b, equal_nan=a.dtype.kind == "f")]
            if bad:
                raise AssertionError(f"{shedder}: {label} != {runs[-1][0]} "
                                     f"in {bad}")
        fires = float(ref[0]["shed_calls"])
        drops = float(ref[0]["ebl_dropped"])
        if shedder in ("pspice", "pmbl") and fires < 5:
            raise AssertionError(f"{shedder}: only {fires:g} fires")
        if shedder == "ebl" and drops < 5:
            raise AssertionError(f"ebl: only {drops:g} dropped events")
        secs = ", ".join(f"{k} {s:.2f} s" for k, (_, s) in results.items())
        log("parity", f"stock N={N} {n} events shedder={shedder}: carry + "
            f"StepOut bitwise across {', '.join(r[0] for r in runs)} "
            f"(fires {fires:g}, E-BL drops {drops:g}; {secs})")


def _leaves(a, b, path=""):
    if isinstance(a, dict):
        for k in a:
            yield from _leaves(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, list):
        for i, (x, y) in enumerate(zip(a, b)):
            yield from _leaves(x, y, f"{path}[{i}]")
    else:
        yield path, a, b


# ---------------------------------------------------------------------------
# The main path: run_experiment on the card
# ---------------------------------------------------------------------------

def run_scenario(torch, name: str, n: int, backend: str,
                 device: str = "cuda") -> tuple[dict, dict, float, int]:
    """run_experiment on one scenario through one engine path, with the
    launch counts and host syncs set to 0 just before and read after."""
    from repro_torch.cep import engine as eng, runner
    from repro_torch.data import streams
    from repro_torch.kernels import ops as kops

    sc = streams.get_scenario(name)
    raw = sc.raw(n=n)
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    sync()
    kops.reset_launch_counts()
    eng.host_syncs = 0
    t0 = time.perf_counter()
    res = runner.run_experiment(
        sc.specs(), raw, shedders=("pspice", "pmbl", "ebl"),
        rate_multiplier=1.2, max_pms=sc.max_pms, bin_size=sc.bin_size,
        latency_bound=sc.latency_bound, seed=sc.seed, backend=backend,
        block_events=W_BLOCK, device=device, **paper_cost())
    sync()
    wall = time.perf_counter() - t0
    counts = kops.launch_counts()
    syncs = eng.host_syncs
    n_run = raw.n - int(raw.n * 0.3)
    for sh, er in res.items():
        log("main", f"{name} n={n} {backend} {sh}: fn {er.fn:.6f} fn_match "
            f"{er.fn_match:.6f} lb_compliance {er.lb_compliance:.6f} "
            f"shed_calls {er.result.shed_calls:g} run {er.seconds:.2f} s "
            f"({n_run / er.seconds:.1f} events/s)")
    fn = {sh: er.fn_match for sh, er in res.items()}
    if not (fn["pspice"] <= fn["pmbl"] + 1e-9 and
            fn["pspice"] <= fn["ebl"] + 1e-9):
        raise AssertionError(f"{name}: headline ordering violated: {fn}")
    events = n_run * 4 + int(raw.n * 0.3)
    built = res["pspice"].built
    log("main", f"{name} {backend}: wall {wall:.2f} s for {events} engine "
        f"events ({events / wall:.1f} events/s, {wall / events * 1e6:.2f} "
        f"us/event); launches {counts}; host syncs {syncs} "
        f"({syncs / events:.3f} per event); f kind "
        f"{int(built.f_model.kind)} g kind {int(built.g_model.kind)} "
        f"(0 = LINEAR); ordering ok {fn}")
    return res, counts, wall, events


# Soccer's and bus's events in the main phase (stock runs its full
# 30 000 on the block path): the per-event path is host-bound (~1 000-
# 2 000 events/s), and 6 000 keep the script within its time (PERF.md
# §7); stock's per-event run takes 12 000, held to a block-path run of
# the same 12 000.
MAIN_EVENTS = 6000
MAIN_CUDA_STOCK = 12000


def phase_main(torch) -> dict:
    """Both engine paths on every scenario.  Returns each kernel's
    launches from the run of its own path on the stock scenario."""
    launches = {}
    for name, n in (("stock", 30000), ("soccer", MAIN_EVENTS),
                    ("bus", MAIN_EVENTS)):
        runs = {}
        for backend in ("cuda", "cuda_block"):
            n_b = MAIN_CUDA_STOCK if (name, backend) == ("stock", "cuda") \
                else n
            res, counts, wall, events = run_scenario(torch, name, n_b,
                                                     backend)
            runs[backend] = res
            path = [k for k, b in KERNEL_PATH.items() if b == backend]
            if name == "stock":      # stock runs every kernel of its path
                for k in path:
                    if counts[k] <= 0:
                        raise AssertionError(f"kernel {k} never launched on "
                                             f"the {backend} path")
                launches.update({k: counts[k] for k in path})
            if backend == "cuda_block":
                want = sum(-(-e // W_BLOCK) for e in (
                    int(n * 0.3),) + (n - int(n * 0.3),) * 4)
                log("main", f"{name} cuda_block: {counts['block_step']} "
                    f"block launches (ceil(n/W) per run: {want}); "
                    f"{wall / counts['block_step'] * 1e3:.4f} ms of wall "
                    "per launch")
                if counts["block_step"] != want:
                    raise AssertionError(f"{name}: {counts['block_step']} "
                                         f"block launches, expected {want}")
        same = runs["cuda_block"]
        if name == "stock":       # the block path on the per-event's cut
            same = run_scenario(torch, name, MAIN_CUDA_STOCK,
                                "cuda_block")[0]
        for sh in runs["cuda"]:
            a, b = runs["cuda"][sh], same[sh]
            got = (b.fn, b.fn_match, b.result.shed_calls, b.lb_compliance)
            want = (a.fn, a.fn_match, a.result.shed_calls, a.lb_compliance)
            if got != want:
                raise AssertionError(f"{name} {sh}: cuda_block {got} != "
                                     f"cuda {want}")
        log("main", f"{name}: cuda_block == cuda in FN, fires and LB "
            "compliance for every shedder"
            + (f" ({MAIN_CUDA_STOCK} events)" if name == "stock" else ""))
        if name == "stock":
            # pspice and E-BL draw nothing from threefry: in the port's
            # default layout they must meet the committed cells exactly
            # (PM-BL's cell is held in its own layout by phase_quality).
            cells = committed_quality()["datasets"]["stock"]["levels"]["1.2"]
            for sh in ("pspice", "ebl"):
                er = runs["cuda_block"][sh]
                got = (er.fn_match, er.result.shed_calls)
                want = (cells[sh]["fn"], cells[sh]["shed_calls"])
                if got != want:
                    raise AssertionError(f"stock {sh} (FN, fires) {got} != "
                                         f"committed {want}")
            log("main", "stock pspice and ebl: FN and fires exactly the "
                "committed BENCH_quality.json cells (" + ", ".join(
                    f"{sh} {cells[sh]['fn']!r} / {cells[sh]['shed_calls']:g}"
                    for sh in ("pspice", "ebl")) + ")")
    return launches


# ---------------------------------------------------------------------------
# The quality evaluation at the paper's grid, in the committed layout
# ---------------------------------------------------------------------------

def phase_quality(torch, np) -> dict:
    """The oracle, the paper's grid on both engine paths and the layer
    split, with repro_torch.prng in jax's original threefry layout (the
    committed BENCH_quality.json's) for the phase.  Returns each CEP
    kernel's launches on the grid's runs (counts from 0 before each
    path)."""
    from repro_torch import prng

    with prng.layout(False):
        quality_oracle(torch, np)
        launches = quality_grid(torch)
        layer_split(torch, np)
    return launches


def quality_oracle(torch, np) -> None:
    """The NumPy oracle against both engine paths on the card, in both
    layouts: the oracle's overload fixture (Q1, N=48, 300 events at
    x1.2/1.4/1.6) and a stock stream whose PM-BL fires keep some of the
    live PMs (so the layout decides which), every shedder, the literal
    sort-based Algorithm 2."""
    from repro_torch import prng

    dev = torch.device("cuda")
    pmbl_matches = {}
    for part in (True, False):
        for shedder in ("none", "pspice", "pmbl", "ebl"):
            with prng.layout(part):
                fires, matches = oracle_cases_on_card(torch, np, dev,
                                                      shedder, part)
            if shedder == "pmbl":
                pmbl_matches[part] = matches
            if shedder in ("pspice", "pmbl") and min(fires[:3]) < 8:
                raise AssertionError(f"{shedder}: the overload fixture "
                                     f"fired only {fires}")
            log("quality", f"oracle == cuda == cuda_block (matches, "
                f"counters, l_e, shed, dropped), {shedder}, "
                f"{'partitionable' if part else 'original'} layout: "
                f"fires {[int(f) for f in fires]} (x1.2/1.4/1.6, stock)")
    if pmbl_matches[True] == pmbl_matches[False]:
        raise AssertionError("the stock stream's PM-BL matches do not "
                             "depend on the layout: the check is blind")


def oracle_cases_on_card(torch, np, dev, shedder: str, part: bool):
    """The oracle's cases under one shedder through both engine paths on
    the card; raises on a difference.  Returns the oracle's fires per
    case and its matches on the stock stream."""
    import dataclasses

    from repro_torch.cep import engine as eng
    from repro_torch.eval import oracle, oracle_cases

    cases = [(f"overload x{m}", oracle_cases.overload_case(shedder, m, dev))
             for m in oracle_cases.OVERLOAD_LEVELS]
    cases.append(("stock", oracle_cases.layout_case(shedder, dev)))
    fires = []
    for label, (cfg, model, ev) in cases:
        o = oracle.run_oracle(cfg, model, ev, seed=0)
        for backend in ("cuda", "cuda_block"):
            c = dataclasses.replace(cfg, backend=backend)
            carry, outs = eng.run_engine(
                c, model, ev, eng.init_carry(c, seed=0, device=dev),
                device=dev)
            bad = oracle_diff(np, eng, carry, outs, o)
            if bad:
                raise AssertionError(f"{label} {shedder} {backend} "
                                     f"partitionable={part}: != oracle in "
                                     f"{bad}")
        fires.append(o.shed_calls)
    return fires, o.matches


def oracle_diff(np, eng, carry, outs, o) -> list:
    """The fields where an engine run differs from the oracle's."""
    bad = []
    if eng.match_sets(outs) != o.matches:
        bad.append("matches")
    for f in ("complex_count", "pms_created"):
        if not np.array_equal(getattr(carry, f).cpu().numpy(),
                              getattr(o, f)):
            bad.append(f)
    for f in ("pms_shed", "shed_calls", "overflow", "ebl_dropped"):
        if float(getattr(carry, f)) != getattr(o, f):
            bad.append(f)
    for f in ("l_e", "n_pm", "shed", "dropped"):
        want = getattr(o, f)
        got = getattr(outs, f).cpu().numpy().astype(want.dtype)
        if not np.array_equal(got, want):
            bad.append(f)
    return bad


# The datasets whose headline level runs again on the per-event path.
# Soccer's (108 s of the script's 1 111 s in PR 21's first proof run) is
# left out to keep the script within its time limit: the main phase
# holds soccer's "cuda" run to "cuda_block" (12 000 events, FN, fires and
# compliance), and the oracle cases hold "cuda" in this layout.
# Stock and bus run the per-event path's check at their quick length
# (12 000 events), each held to a cuda_block run of the same stream, to
# keep the script within its time (PERF.md §7; the main phase holds both
# on both paths too).
QUALITY_CUDA_DATASETS = (("stock", True), ("bus", True))


def quality_grid(torch) -> dict:
    """run_quality_sweep on cuda_block (W=32) at n_default, held to the
    committed grid; then cuda at the headline level on
    QUALITY_CUDA_DATASETS, held to cuda_block.  Launch counts from 0 before each path."""
    from repro_torch.cep import engine as eng
    from repro_torch.eval import sweep
    from repro_torch.kernels import ops as kops

    committed = committed_quality()
    torch.cuda.synchronize()
    kops.reset_launch_counts()
    eng.host_syncs = 0
    t0 = time.perf_counter()
    bench = sweep.run_quality_sweep(backend="cuda_block",
                                    block_events=W_BLOCK)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kops.launch_counts()
    if counts["block_step"] <= 0:
        raise AssertionError("the grid never launched the block kernel")
    log("quality", f"grid on cuda_block: {wall:.2f} s, block launches "
        f"{counts['block_step']}, host syncs {eng.host_syncs}; "
        f"threefry_partitionable "
        f"{bench['config']['threefry_partitionable']}; check_headline "
        f"violations {bench['violations']}")
    if bench["violations"] or bench["config"]["threefry_partitionable"]:
        raise AssertionError(f"grid: {bench['violations']}")
    exact, total, rate_diff = 0, 0, []
    for ds, grid in bench["datasets"].items():
        ref = committed["datasets"][ds]
        if grid["n_events"] != ref["n_events"]:
            raise AssertionError(f"{ds}: {grid['n_events']} events, the "
                                 f"committed grid {ref['n_events']}")
        for lv, cells in grid["levels"].items():
            for sh, cell in cells.items():
                want = ref["levels"][lv][sh]
                is_exact = (cell["fn"], cell["shed_calls"]) == \
                    (want["fn"], want["shed_calls"])
                rate_same = cell["max_rate"] == want["max_rate"]
                total += 1
                exact += is_exact
                if not is_exact and not rate_same:
                    rate_diff.append(f"{ds}/{lv}/{sh}")
                log("quality", f"{ds} x{lv} {sh}: fn {cell['fn']!r} "
                    f"(committed {want['fn']!r}, delta "
                    f"{cell['fn'] - want['fn']:+.6f}), fires "
                    f"{cell['shed_calls']:g} ({want['shed_calls']:g}), "
                    f"max_rate {cell['max_rate']!r} ({want['max_rate']!r}"
                    f"{', equal' if rate_same else ', differs'}), "
                    f"lb_compliance {cell['lb_compliance']:.6f}; "
                    f"{'exact' if is_exact else 'not exact'}")
                if ds == "stock" and lv == "1.2" and not is_exact:
                    raise AssertionError(f"stock x1.2 {sh} is not the "
                                         "committed cell")
                if abs(cell["fn"] - want["fn"]) > GRID_TOL:
                    raise AssertionError(f"{ds} x{lv} {sh}: FN beyond "
                                         f"{GRID_TOL} of the committed")
    log("quality", f"{exact} of {total} cells exact (FN and fires); of the "
        f"others, max_rate differs in {len(rate_diff)} {rate_diff} and is "
        f"equal in {total - exact - len(rate_diff)}")
    # The per-event kernels' path at the headline level.
    level = sweep.HEADLINE_LEVEL
    blocks = {ds: sweep.run_dataset(ds, levels=(level,), quick=True,
                                    backend="cuda_block",
                                    block_events=W_BLOCK)
              if quick else bench["datasets"][ds]
              for ds, quick in QUALITY_CUDA_DATASETS}
    torch.cuda.synchronize()
    kops.reset_launch_counts()
    t0 = time.perf_counter()
    for ds, quick in QUALITY_CUDA_DATASETS:
        t1 = time.perf_counter()
        grid = sweep.run_dataset(ds, levels=(level,), quick=quick,
                                 backend="cuda")
        cells = grid["levels"][f"{level:g}"]
        for sh, cell in cells.items():
            blk = blocks[ds]["levels"][f"{level:g}"][sh]
            keys = ("fn", "fn_count", "shed_calls", "lb_compliance")
            if any(cell[k] != blk[k] for k in keys):
                raise AssertionError(f"{ds} {sh}: cuda "
                                     f"{[cell[k] for k in keys]} != "
                                     f"cuda_block {[blk[k] for k in keys]}")
        log("quality", f"{ds} x{level:g} on cuda ({grid['n_events']} "
            f"events): == cuda_block in FN, count FN, fires and LB "
            f"compliance for every shedder "
            f"({time.perf_counter() - t1:.2f} s)")
    torch.cuda.synchronize()
    cuda_counts = kops.launch_counts()
    for k in ("nfa_advance", "utility_lookup", "utility_histogram"):
        if cuda_counts[k] <= 0:
            raise AssertionError(f"kernel {k} never launched on cuda")
    log("quality", f"cuda at the headline level: "
        f"{time.perf_counter() - t0:.2f} s, launches {cuda_counts}")
    return dict(cuda_counts, block_step=counts["block_step"])


def layer_split(torch, np) -> None:
    """The wall of stock's run_experiment (x1.2, cuda_block) by layer:
    its stages composed as run_experiment composes them, with a sync at
    every boundary, checked to give the same FN."""
    import collections
    import dataclasses

    from repro_torch.cep import engine as eng, patterns as pat, runner
    from repro_torch.data import streams
    from repro_torch.eval import quality as Q

    dev = torch.device("cuda")
    sc = streams.get_scenario("stock")
    specs, raw, cost = sc.specs(), sc.raw(), paper_cost()
    kw = dict(max_pms=sc.max_pms, latency_bound=sc.latency_bound,
              backend="cuda_block", block_events=W_BLOCK, **cost)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = runner.run_experiment(specs, raw, rate_multiplier=1.2,
                                bin_size=sc.bin_size, seed=sc.seed, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0

    secs = collections.defaultdict(float)

    def timed(layer, fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        secs[layer] += time.perf_counter() - t
        return out

    def cut(a, b):
        return dataclasses.replace(raw, n=b - a, type_id=raw.type_id[a:b],
                                   attr=raw.attr[a:b], group=raw.group[a:b])

    t_all = time.perf_counter()
    cp = timed("patterns and config", lambda: pat.compile_patterns(specs))
    cfg = timed("patterns and config", lambda: runner.default_config(
        cp, emit_matches=True, **kw))
    n_warm = int(raw.n * 0.3)
    warm = timed("classification", lambda: streams.classify(
        specs, cut(0, n_warm), rate=1.0, seed=sc.seed, device=dev))
    built = timed("build_model (warm-up run + model)",
                  lambda: runner.build_model(specs, cfg, warm,
                                             bin_size=sc.bin_size,
                                             seed=sc.seed, device=dev))
    rate = built.max_rate * 1.2
    weights = np.array([s.weight for s in specs])
    runs = {}
    for sh in ("none", "pspice", "pmbl", "ebl"):
        run_cfg = dataclasses.replace(cfg, gather_stats=False, shedder=sh)
        ev = timed("classification", lambda: streams.classify(
            specs, cut(n_warm, raw.n), rate=rate, seed=sc.seed, device=dev))
        model = timed("run setup (make_model, init_carry)",
                      lambda: eng.make_model(
                          cp, run_cfg, ut_tables=built.ut_stacked,
                          ut_bins=built.ut_bins, f_model=built.f_model,
                          g_model=built.g_model, ebl_raw_mean=float(
                              ev.ebl_raw.cpu().numpy().mean()), device=dev))
        carry0 = timed("run setup (make_model, init_carry)",
                       lambda: eng.init_carry(run_cfg, seed=sc.seed,
                                              device=dev))
        carry, outs = timed("engine runs", lambda: eng.run_engine(
            run_cfg, model, ev, carry0, device=dev))
        matches = timed("match-set decoding", lambda: eng.match_sets(outs))
        empty = outs._replace(match_open=outs.match_open[..., :0],
                              match_bind=outs.match_bind[..., :0])
        runs[sh] = timed("results to the host",
                         lambda: eng.summarize(carry, empty))
        runs[sh].matches = matches
    for sh in ("pspice", "pmbl", "ebl"):
        rep = timed("match-set comparison", lambda: Q.compare_match_sets(
            runs[sh].matches, runs["none"].matches, weights))
        if rep.fn_ratio != res[sh].fn_match:
            raise AssertionError(f"layer split: {sh} FN {rep.fn_ratio!r} != "
                                 f"run_experiment's {res[sh].fn_match!r}")
    composed = time.perf_counter() - t_all
    warm_cfg = dataclasses.replace(cfg, gather_stats=True,
                                   shedder=eng.SHED_NONE, emit_matches=False)
    warm_model = eng.make_model(cp, warm_cfg, device=dev)
    timed("(warm-up run alone)", lambda: eng.run_engine(
        warm_cfg, warm_model, warm,
        eng.init_carry(warm_cfg, seed=sc.seed, device=dev), device=dev))
    n_engine = n_warm + 4 * (raw.n - n_warm)
    log("quality", f"layer split, stock x1.2 cuda_block ({raw.n} events; "
        f"{n_engine} engine events): run_experiment {wall:.3f} s; the same "
        f"stages composed with a sync at each boundary {composed:.3f} s "
        f"(same FN for every shedder)")
    for layer, t in sorted(secs.items(), key=lambda kv: -kv[1]):
        share = "" if layer.startswith("(") else \
            f" ({t / composed:.1%} of the composed wall)"
        log("quality", f"  {layer}: {t:.3f} s{share}")
    engine_s = secs["engine runs"] + secs["(warm-up run alone)"]
    log("quality", f"  engine (4 runs + the warm-up run) {engine_s:.3f} s = "
        f"{n_engine / engine_s:.1f} events/s; everything else "
        f"{composed - engine_s:.3f} s ({1 - engine_s / composed:.1%})")


# ---------------------------------------------------------------------------
# Where the time goes: one engine run under torch.profiler
# ---------------------------------------------------------------------------

def phase_profile(torch, backend: str, n: int = 3000,
                  device: str = "cuda") -> None:
    import dataclasses

    from torch.profiler import ProfilerActivity, profile

    from repro_torch.cep import engine as eng, patterns as pat, runner
    from repro_torch.data import streams

    sc = streams.get_scenario("stock")
    specs = sc.specs()
    cp = pat.compile_patterns(specs)
    cfg = runner.default_config(cp, max_pms=sc.max_pms,
                                latency_bound=sc.latency_bound,
                                emit_matches=True, backend=backend,
                                block_events=W_BLOCK, **paper_cost())
    raw = sc.raw(n=n + 3000)
    cut = lambda a, b: dataclasses.replace(  # noqa: E731
        raw, n=b - a, type_id=raw.type_id[a:b], attr=raw.attr[a:b],
        group=raw.group[a:b])
    built = runner.build_model(
        specs, cfg, streams.classify(specs, cut(0, 3000), rate=1.0,
                                     seed=sc.seed, device=device),
        bin_size=sc.bin_size, seed=sc.seed, device=device)
    rcfg = dataclasses.replace(cfg, shedder="pspice")
    ev = streams.classify(specs, cut(3000, n + 3000),
                          rate=built.max_rate * 1.2, seed=sc.seed,
                          device=device)
    model = eng.make_model(cp, rcfg, ut_tables=built.ut_stacked,
                           ut_bins=built.ut_bins, f_model=built.f_model,
                           g_model=built.g_model, device=device)

    def run():
        c, o = eng.run_engine(rcfg, model, ev,
                              eng.init_carry(rcfg, seed=sc.seed,
                                             device=device), device=device)
        if device == "cuda":
            torch.cuda.synchronize()
        return c

    run()
    t0 = time.perf_counter()
    carry = run()
    wall = time.perf_counter() - t0
    acts = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if device == "cuda" else [])
    with profile(activities=acts) as prof:
        run()
    rows = device_rows(prof)
    busy = sum(r[0] for r in rows) / 1e6
    if not rows:
        log("profile", "device time not measured (the profiler saw no CUDA "
            "activity)")
        return
    log("profile", f"stock pspice N={sc.max_pms} {n} events, backend "
        f"{backend}: "
        f"wall {wall:.3f} s unprofiled ({n / wall:.1f} events/s, "
        f"{wall / n * 1e3:.4f} ms/event), fires "
        f"{float(carry.shed_calls):g}; device busy {busy:.4f} s "
        f"({busy / wall:.4%} of wall; idle {1 - busy / wall:.4%})")
    for dev_us, count, key in rows[:8]:
        log("profile", f"  {dev_us / 1e3:.3f} ms device, {count} calls, "
            f"{dev_us / max(count, 1):.3f} us/call: {key[:90]}")
    if backend == "cuda_block":
        from repro_torch.kernels import block_step as kb
        blocks, nb = eng._pad_event_blocks(ev, n, W_BLOCK)
        scan = kb.BlockScan(rcfg, model, eng.init_carry(
            rcfg, seed=sc.seed, device=device), blocks,
            kb.new_rows(rcfg, nb * W_BLOCK, device))
        host_us = host_us_per_launch(torch, lambda b: scan.launch(
            b, b * W_BLOCK, 0, min(n - b * W_BLOCK, W_BLOCK)), nb)
        log("profile", f"block launch path: host {host_us:.3f} us per "
            f"launch (enqueue alone, {nb} launches of one scan)")
    for dev_us, count, key in rows:
        if "block_step_kernel" in key:
            log("profile", f"block kernel: {dev_us / count:.3f} us per "
                f"launch, {dev_us / n:.3f} us per event ({count} launches "
                f"for {n} events); {dev_us / 1e6 / wall:.4%} of wall")


# ---------------------------------------------------------------------------
# The flash kernel against its plain version
# ---------------------------------------------------------------------------

# (label, B, Sq, Sk, H, KVH, D, Dv, causal, q_offset): the prefill shape of
# the model phase (timed in bf16, held in both types), the shapes of
# tests/test_kernels.py:17-22, ragged S with D in {8, 16, 64, 128} (Sq and
# Sk not multiples of the bf16 kernel's 128-row tiles), Dv != D, a
# decode-style block (Sq < Sk at q_offset = Sk - Sq), and a block at
# q_offset 100 whose rows 0..27 meet a KV tile (keys 128..191) where every
# key is masked.
FLASH_PREFILL = ("prefill", 4, 2048, 2048, 16, 8, 128, 128, True, 0)
# deepseek-v3's MLA prefill (the moe phase's): the bf16 kernel's (192, 128)
# instance at 128 heads, q/k head dim 128 + 64, v head dim 128.
FLASH_MLA_PREFILL = ("mla_prefill", 4, 2048, 2048, 128, 128, 192, 128, True,
                     0)
# zamba2-7b's shared attention block in prefill (the ssm phase's): head_dim
# 112 on the (128, 128) instance, whose second 64-column box of Q, K and V
# holds 48 real columns and 16 that TMA fills with zeros.
FLASH_ZAMBA_PREFILL = ("zamba2_prefill", 4, 2048, 2048, 32, 32, 112, 112,
                       True, 0)
# whisper-small (the encdec phase's, at its B = 16): the encoder's
# non-causal attention over 1 500 frames (11 KV tiles of 128 and a
# ragged 92) and the decoder's cross-attention of a 224-token prompt over
# them, both on the (64, 64) instance.  The cross shape is the first
# bytes-bound one on a main path: 16 x 12 x 2 CTAs of 128 query rows.
FLASH_WHISPER_ENCODER = ("whisper_encoder", 16, 1500, 1500, 12, 12, 64, 64,
                         False, 0)
FLASH_WHISPER_CROSS = ("whisper_cross", 16, 224, 1500, 12, 12, 64, 64, False,
                       0)
# Each timed shape and its kernel name in the JSON line (whisper's cross
# shape joins the encoder's record with its keys prefixed "cross_").
FLASH_TIMED = {"prefill": "flash_attention",
               "mla_prefill": "flash_attention_mla",
               "zamba2_prefill": "flash_attention_hd112",
               "whisper_encoder": "flash_attention_encdec",
               "whisper_cross": "flash_attention_encdec"}
# The timed shapes that take the planted faults (causal, 2 048 rows).
FLASH_FAULTED = ("prefill", "mla_prefill", "zamba2_prefill")
FLASH_CASES = (
    ("kernels_test", 1, 128, 128, 2, 2, 32, 32, True, 0),
    ("kernels_test", 1, 128, 128, 2, 2, 32, 32, False, 0),
    ("kernels_test", 2, 256, 256, 4, 2, 64, 64, True, 0),
    ("mqa", 1, 256, 256, 8, 1, 64, 64, True, 0),
    ("mqa", 1, 256, 256, 8, 1, 64, 64, False, 0),
    ("sq_ne_sk", 2, 128, 256, 4, 4, 128, 128, False, 0),
    ("ragged", 1, 2047, 2047, 4, 2, 8, 8, True, 0),
    ("ragged", 2, 48, 48, 4, 2, 16, 16, True, 0),
    ("ragged", 1, 2047, 2047, 2, 1, 64, 64, True, 0),
    ("ragged", 2, 300, 300, 4, 2, 128, 128, True, 0),
    ("ragged", 1, 130, 383, 2, 2, 128, 128, False, 0),
    ("dv_ne_d", 2, 256, 256, 4, 2, 64, 128, True, 0),
    ("decode_style", 2, 200, 328, 4, 2, 128, 128, True, 128),
    ("masked_tile", 2, 64, 192, 4, 2, 32, 32, True, 100),
    # MLA's (D, Dv) = (192, 128): G = 1 and G = 4, causal and not, ragged
    # Sq/Sk, q_offset > 0, a fully masked KV tile.
    ("mla", 1, 256, 256, 4, 4, 192, 128, True, 0),
    ("mla", 1, 256, 256, 4, 4, 192, 128, False, 0),
    ("mla", 2, 256, 256, 8, 2, 192, 128, True, 0),
    ("mla_ragged", 2, 300, 300, 4, 2, 192, 128, True, 0),
    ("mla_ragged", 1, 130, 383, 2, 2, 192, 128, False, 0),
    ("mla_decode_style", 2, 200, 328, 4, 2, 192, 128, True, 128),
    ("mla_masked_tile", 2, 64, 192, 4, 2, 192, 128, True, 100),
    # zamba2's head_dim 112 (the (128, 128) instance, a partial second box):
    # G = 1 causal and not, ragged Sq/Sk, q_offset > 0, a fully masked KV
    # tile.
    ("hd112", 1, 256, 256, 4, 4, 112, 112, True, 0),
    ("hd112", 1, 256, 256, 4, 4, 112, 112, False, 0),
    ("hd112_ragged", 2, 300, 300, 4, 2, 112, 112, True, 0),
    ("hd112_ragged", 1, 130, 383, 2, 2, 112, 112, False, 0),
    ("hd112_decode_style", 2, 200, 328, 4, 2, 112, 112, True, 128),
    ("hd112_masked_tile", 2, 64, 192, 4, 2, 112, 112, True, 100),
    # whisper-small's shapes at B = 1 and 2: the encoder, the
    # cross-attention of a 224-token prompt and of a 4-token one.
    ("whisper_enc", 1, 1500, 1500, 12, 12, 64, 64, False, 0),
    ("whisper_xattn", 2, 224, 1500, 12, 12, 64, 64, False, 0),
    ("whisper_xattn", 2, 4, 1500, 12, 12, 64, 64, False, 0),
)
FLASH_TOL = {"float32": 2e-5, "bfloat16": 3e-2}
# The bf16 kernel's second bar, scaled to the output: the largest
# ‖kernel − plain‖ / ‖plain‖ over the Dv columns of one (b, i, h) row.
# A causal row that sees i keys of unit-normal K and V has outputs of
# about sqrt(e / i) (0.05 at i = 1 024), so the absolute 3e-2 alone is
# about a late row's size.  A sound kernel differs from the plain version
# by the bf16 rounding of P (taken against another running max) and of
# the output: ~4e-3 of a row (up to ~7e-3 at D = 8, whose rows have 8
# columns).  The faults that flash_faults plants, confined to the rows
# from FLASH_FAULT_ROW0 on, must read above this bar.
FLASH_ROW_TOL = 2e-2
FLASH_FAULT_ROW0 = 1024
# The bf16 kernel is timed in turns with scaled_dot_product_attention in
# this order, each turn FLASH_WINDOWS windows of FLASH_CALLS calls.
FLASH_ORDER = ("kernel", "sdpa", "sdpa", "kernel")
FLASH_WINDOWS, FLASH_CALLS = 5, 20


def flash_name(kfa, label: str, D: int, Dv: int) -> str:
    """The JSON line's name of the flash case ``label`` at head dims (D,
    Dv)."""
    if label.startswith("whisper"):
        return "flash_attention_encdec"
    if kfa.sm90_instance(D, Dv) == (192, 128):
        return "flash_attention_mla"
    return "flash_attention_hd112" if D == 112 else "flash_attention"


def _reset_flash_counts(kfa) -> None:
    """Set the flash kernels' launch counts to 0 (before a counted run)."""
    kfa.flash_attention.launches = 0
    kfa.flash_attention.sm90_launches = 0
    kfa.flash_attention.sm90_instances = dict.fromkeys(kfa.SM90_INSTANCES, 0)


def flash_work(B, Sq, Sk, H, KVH, D, Dv, causal, q_offset, esize):
    """(bytes, operations) the attention needs: Q, K and V read once and O
    written once; 2·(D + Dv) operations per visible (query, key) pair,
    counted from this case's mask."""
    if causal:
        pairs = sum(min(Sk, q_offset + i + 1) for i in range(Sq))
    else:
        pairs = Sq * Sk
    nbytes = (B * Sq * H * D + B * Sk * KVH * (D + Dv) +
              B * Sq * H * Dv) * esize
    return nbytes, B * H * pairs * 2 * (D + Dv)


def row_rel_err(torch, got, want) -> float:
    """The largest ‖got − want‖ / ‖want‖ over the last dim of one row."""
    diff = (got.float() - want.float()).norm(dim=-1)
    return float((diff / want.float().norm(dim=-1).clamp_min(1e-30)).max())


def flash_faults(torch, kfa, q, k, v, want) -> None:
    """Faults planted through the bf16 kernel's inputs at the prefill
    shape, each held against the plain version on the true inputs over
    the rows from FLASH_FAULT_ROW0 on, where it must exceed FLASH_ROW_TOL:
    the softmax temperature 5 % off; the keys of one 128-key tile read
    from the previous lap of its stage of the 2-stage ring (a stale
    stage); the causal mask one key late."""
    import math
    r0, n = FLASH_FAULT_ROW0, 128
    stale_k, stale_v = k.clone(), v.clone()
    stale_k[:, r0:r0 + n] = k[:, r0 - 2 * n:r0 - n]
    stale_v[:, r0:r0 + n] = v[:, r0 - 2 * n:r0 - n]
    faults = {
        "softmax scale x 1.05": lambda: kfa.flash_attention(
            q, k, v, scale=1.05 / math.sqrt(q.shape[-1])),
        f"keys {r0}..{r0 + n - 1} read from a stale ring stage": lambda:
            kfa.flash_attention(q, stale_k, stale_v),
        "causal mask one key late": lambda: kfa.flash_attention(
            q, k, v, q_offset=1),
    }
    for name, run in faults.items():
        got = run()
        torch.cuda.synchronize()
        row = row_rel_err(torch, got[:, r0:], want[:, r0:])
        err = max_abs_err(torch, got[:, r0:], want[:, r0:])
        log("kernels", f"flash_attention planted fault ({name}), rows >= "
            f"{r0}: row-relative {row:.3e} (bar {FLASH_ROW_TOL}), max "
            f"|kernel - plain| {err:.3e}")
        if not row > FLASH_ROW_TOL:
            raise AssertionError(f"planted fault {name!r} reads {row!r}, "
                                 f"inside the bar {FLASH_ROW_TOL}")


def windows_ms(torch, fns: dict, order, windows: int, calls: int) -> dict:
    """Per name, the per-call device times (CUDA events) of its windows of
    ``calls`` back-to-back calls; the names take turns in ``order``, each
    turn ``windows`` windows, so that both see the same card state."""
    for fn in fns.values():
        fn()
    torch.cuda.synchronize()
    out = {name: [] for name in fns}
    for name in order:
        for _ in range(windows):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(calls):
                fns[name]()
            end.record()
            torch.cuda.synchronize()
            out[name].append(start.elapsed_time(end) / calls)
    return out


# The probe's bar: C = A·Bᵀ sums 128 products of N(0, 1) bf16 values
# (|C| up to ~50) and E = bf16(C)·V sums 64 of about 11 (|E| up to
# ~400), both in float32 in another order than torch.matmul, which moves
# an entry by ~1e-5 of its size.  A fault of the descriptors, the swizzle
# or the fragment layout moves entries by their own size.
PROBE_TOL = 1e-2


def phase_probe(torch, np) -> None:
    """The bf16 flash kernel's building blocks (TMA with the 128-byte
    swizzle, wgmma from shared memory and from registers, the transposed
    V operand) against torch.matmul of the same tiles."""
    from repro_torch.kernels import flash_attention as kfa

    rng = np.random.default_rng(14)
    a, b, v = (torch.from_numpy(rng.standard_normal((64, 128)).astype(
        np.float32)).to("cuda", torch.bfloat16) for _ in range(3))
    c, e = kfa.wgmma_probe(a, b, v)
    want_c = torch.matmul(a.float(), b.float().t())
    want_e = torch.matmul(c.to(torch.bfloat16).float(), v.float())
    torch.cuda.synchronize()
    err_c = max_abs_err(torch, c, want_c)
    err_e = max_abs_err(torch, e, want_e)
    log("kernels", f"wgmma probe: C = A·Bᵀ (8 x m64n64k16, K-major "
        f"operands) max |probe - matmul| {err_c:.3e} of max |C| "
        f"{float(want_c.abs().max()):.3e}; E = bf16(C)·V (4 x m64n128k16, "
        f"A from registers, V transposed) {err_e:.3e} of max |E| "
        f"{float(want_e.abs().max()):.3e} (tol {PROBE_TOL})")
    if not (err_c <= PROBE_TOL and err_e <= PROBE_TOL):
        raise AssertionError(f"wgmma probe beyond {PROBE_TOL}: C {err_c!r}, "
                             f"E {err_e!r}")


def phase_flash_kernel(torch, np) -> dict:
    """The probe, then every flash case in both dtypes against the plain
    version; the planted faults at each causal prefill shape and the
    timing at each shape of FLASH_TIMED.  Returns the records of
    flash_attention (the (64, 64) and (128, 128) instances),
    flash_attention_mla (the (192, 128) instance), flash_attention_hd112
    (head_dim 112 on the (128, 128) instance) and flash_attention_encdec
    (whisper's shapes on the (64, 64) instance), each with its max
    |kernel - plain| over its cases."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as kfa

    dev = torch.device("cuda")
    phase_probe(torch, np)
    errs = {name: dict.fromkeys(FLASH_TOL, 0.0)
            for name in FLASH_TIMED.values()}
    row_max = 0.0
    record = {}
    for case in (FLASH_PREFILL, FLASH_MLA_PREFILL, FLASH_ZAMBA_PREFILL,
                 FLASH_WHISPER_ENCODER, FLASH_WHISPER_CROSS) + FLASH_CASES:
        label, B, Sq, Sk, H, KVH, D, Dv, causal, q_off = case
        name = flash_name(kfa, label, D, Dv)
        # Inputs drawn on the card (the MLA prefill's are 0.5 G values).
        gen = torch.Generator(device=dev)
        gen.manual_seed(B * Sq + H * D + Dv + q_off)
        base = [torch.randn(s, generator=gen, device=dev) for s in
                ((B, Sq, H, D), (B, Sk, KVH, D), (B, Sk, KVH, Dv))]
        for dt in FLASH_TOL:
            q, k, v = (a.to(getattr(torch, dt)) for a in base)
            n0 = kfa.flash_attention.launches
            n0_tc = kfa.flash_attention.sm90_launches
            inst = kfa.sm90_instance(D, Dv)
            n0_inst = kfa.flash_attention.sm90_instances[inst]
            got = kfa.flash_attention(q, k, v, causal=causal, q_offset=q_off)
            want = kfa.flash_attention_plain(q, k, v, causal=causal,
                                             q_offset=q_off)
            torch.cuda.synchronize()
            tc = int(dt == "bfloat16")
            if (kfa.flash_attention.launches != n0 + 1 or
                    kfa.flash_attention.sm90_launches != n0_tc + tc or
                    kfa.flash_attention.sm90_instances[inst] !=
                    n0_inst + tc):
                raise AssertionError(f"flash_attention {dt} did not count "
                                     "its launch on its own kernel and "
                                     f"instance {inst}")
            err = max_abs_err(torch, got, want)
            errs[name][dt] = max(errs[name][dt], err)
            row = row_rel_err(torch, got, want) if tc else 0.0
            row_max = max(row_max, row)
            if (not bool(torch.isfinite(got).all()) or err > FLASH_TOL[dt]
                    or row > FLASH_ROW_TOL):
                raise AssertionError(f"flash {label} {case[1:]} {dt}: max "
                                     f"|kernel - plain| {err!r} beyond "
                                     f"{FLASH_TOL[dt]}, or row-relative "
                                     f"{row!r} beyond {FLASH_ROW_TOL}")
            row_txt = (f"; row-relative {row:.3e} (bar {FLASH_ROW_TOL})"
                       if tc else "")
            kind = f"wgmma <{inst[0]}, {inst[1]}>" if tc else "SIMT"
            log("kernels", f"flash_attention {label} B={B} Sq={Sq} Sk={Sk} "
                f"H={H} KVH={KVH} D={D} Dv={Dv} causal={causal} "
                f"q_offset={q_off} {dt} ({kind} kernel): max |kernel - "
                f"plain| {err:.3e} (tol {FLASH_TOL[dt]}){row_txt}")
            if label not in FLASH_TIMED or dt != "bfloat16":
                continue
            if label in FLASH_FAULTED:
                flash_faults(torch, kfa, q, k, v, want)
            timed = flash_timing(torch, F, kfa, q, k, v, got, case)
            if label == "whisper_cross":
                timed = {f"cross_{k}": x for k, x in timed.items()}
            record.setdefault(name, {}).update(timed)
            del q, k, v, got, want
        del base
    for name, e in errs.items():
        record[name]["max_abs_err"] = max(e.values())
        log("kernels", f"{name}: max |kernel - plain| {e} over its cases")
    log("kernels", f"flash_attention: bf16 row-relative {row_max:.3e} over "
        f"every case (bar {FLASH_ROW_TOL})")
    return record


def flash_timing(torch, F, kfa, q, k, v, got, case) -> dict:
    """The bf16 kernel at the prefill shape in turns with
    scaled_dot_product_attention (the yardstick; the port never calls
    it), its device-only time, the plain version's time and the bound."""
    label, B, Sq, Sk, H, KVH, D, Dv, causal, q_off = case
    nbytes, ops = flash_work(B, Sq, Sk, H, KVH, D, Dv, causal, q_off,
                             q.element_size())
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S["bfloat16"] * 1e3
    bound = max(t_bytes, t_ops)
    by = "operations" if t_ops >= t_bytes else "bytes"
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
        qt, kt, vt, is_causal=causal, enable_gqa=True)
    kernel = lambda: kfa.flash_attention(  # noqa: E731
        q, k, v, causal=causal, q_offset=q_off)
    fns = {"kernel": kernel, "sdpa": sdpa}
    try:
        lib_err = max_abs_err(torch, sdpa().transpose(1, 2), got)
    except RuntimeError as e:   # the yardstick refuses this shape
        log("kernels", f"flash_attention {label}: scaled_dot_product_"
            f"attention refuses (D, Dv) = ({D}, {Dv}): {str(e)[:160]}")
        fns.pop("sdpa")
    times = windows_ms(torch, fns, [n for n in FLASH_ORDER if n in fns],
                       FLASH_WINDOWS, FLASH_CALLS)
    med = {n: statistics.median(t) for n, t in times.items()}
    spread = {n: (min(t), max(t)) for n, t in times.items()}
    d_us = device_us(torch, kernel, "flash_attention_sm90_kernel", iters=20)
    # Host time per call: the wrapper's checks, three tensor-map encodes,
    # the shared-memory opt-in and the launch, with the card still busy
    # with earlier calls (the launch queue does not fill in 20 calls).
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(FLASH_CALLS):
        kernel()
    host_us = (time.perf_counter() - t0) / FLASH_CALLS * 1e6
    torch.cuda.synchronize()
    p_ms = cuda_ms(torch, lambda: kfa.flash_attention_plain(
        q, k, v, causal=causal, q_offset=q_off), iters=5)
    k_ms, lib_ms = med["kernel"], med.get("sdpa")
    d_txt = "not measured" if d_us is None else f"{d_us:.3f} us"
    what = (f"flash_attention {label} shape (B={B} S={Sq} H={H} KVH={KVH} "
            f"D={D} Dv={Dv}) bfloat16")
    lib_txt = ("scaled_dot_product_attention: none (it refused the shape)"
               if lib_ms is None else
               f"scaled_dot_product_attention (enable_gqa; max |sdpa - "
               f"kernel| {lib_err:.3e}) median {lib_ms:.6f} ms (windows "
               f"{spread['sdpa'][0]:.6f}-{spread['sdpa'][1]:.6f}); kernel / "
               f"sdpa {k_ms / lib_ms:.3f}")
    log("kernels", f"{what}, in turns {'/'.join(FLASH_ORDER)} "
        f"({FLASH_WINDOWS} windows of {FLASH_CALLS} calls per turn): kernel "
        f"median {k_ms:.6f} ms per call (windows {spread['kernel'][0]:.6f}-"
        f"{spread['kernel'][1]:.6f}; device-only {d_txt}), {lib_txt}")
    sdpa_rate = ("" if lib_ms is None else
                 f"; sdpa {ops / lib_ms / 1e9:.1f} TFLOP/s")
    log("kernels", f"{what}: plain {p_ms:.6f} ms; bound {bound:.6f} ms by "
        f"{by} ({nbytes} B at 3.35 TB/s = {t_bytes:.6f} ms; {ops} "
        f"operations at 989e12/s = {t_ops:.6f} ms); kernel "
        f"{ops / k_ms / 1e9:.1f} TFLOP/s, {k_ms / bound:.2f}x its bound "
        f"({bound / k_ms:.1%} of it){sdpa_rate}; host time per kernel call "
        f"{host_us:.3f} us (wrapper, tensor-map encodes, launch)")
    return dict(ms=k_ms, plain_ms=p_ms, bound_ms=bound, bound_by=by,
                library_ms=lib_ms, device_us=d_us,
                tflops=ops / k_ms / 1e9)


# ---------------------------------------------------------------------------
# The model zoo's serving path at internlm2-1.8b's full width
# ---------------------------------------------------------------------------

MODEL_ARCH = "internlm2-1.8b"
MODEL_B, MODEL_S, MODEL_MAX_LEN, MODEL_DECODE = 4, 2048, 2112, 32
# max|d| / max|logits|.  EXACT_TOL is the float32 logit bound of the
# port's CPU tests, held on a float32 copy of the weights for the kernel
# against its plain version and for decode against the full forward.  In
# bf16 this 24-layer random-weight model's own rounding noise is ~2e-2
# (the plain flash lands ~1.6e-2 from the float32 forward, PERF.md), so
# the bf16 logits are held to NOISE_TOL, against each other and against
# the float32 forward.  A planted fault (the decode step written one slot
# off) must exceed EXACT_TOL in float32 and NOISE_TOL in bf16.
EXACT_TOL = 1e-4
NOISE_TOL = 5e-2


def rel_err(torch, a, b) -> float:
    a, b = a.float(), b.float()
    return float((a - b).abs().max()) / (float(b.abs().max()) + 1e-9)


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _tensors(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    else:
        yield tree


def _one_slot_off(cache):
    """The planted fault of a K/V cache: the decode step written one slot
    off (the tensors shared)."""
    return dict(cache, pos=cache["pos"] + 1)


def _answer(torch, cfg, params, toks, flash, max_len=MODEL_MAX_LEN,
            tok=None, fault=_one_slot_off):
    """prefill -> one decode step of ``tok`` (None: the greedy first
    token), the full forward over S + 1 tokens, and the same decode step
    from ``fault`` of the prefill's cache (a planted fault); ``flash`` is
    the attention prefill uses."""
    from repro_torch.models import decode as D
    from repro_torch.models import layers as L

    kernel_flash = L.flash_attention
    L.flash_attention = flash
    try:
        cache, logits = D.prefill(cfg, params, {"tokens": toks}, max_len)
        if tok is None:
            tok = logits.argmax(-1).to(torch.int32)
        faulty = fault(cache)        # before the step writes the cache
        step, _ = D.decode_step(cfg, params, cache, tok)
        bad, _ = D.decode_step(cfg, params, faulty, tok)
        del cache, faulty
        want = _full_logits(torch, cfg, params, toks, tok)
    finally:
        L.flash_attention = kernel_flash
    return logits, step, want, bad


def _full_logits(torch, cfg, params, toks, tok):
    """The full forward over toks (B, S) and tok (B,): the logits of the
    last position."""
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T
    full = torch.cat([toks, tok[:, None]], dim=1)
    h, _ = T.backbone(cfg, params, T.embed_inputs(cfg, params,
                                                  {"tokens": full}))
    h = L.rmsnorm(h, params["final_norm"], cfg.norm_eps)
    return T.lm_head_logits(cfg, params, h[:, -1:, :])[:, 0]


def _profile(torch, fn, label: str, phase: str = "model") -> dict:
    """Device busy share of ``fn`` and its heaviest kernels; returns the
    wall and device busy seconds (empty if the profiler saw no device
    time)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    rows = device_rows(prof)
    if not rows:
        log(phase, f"{label}: device time not measured (the profiler saw "
            "no CUDA activity)")
        return {}
    busy = sum(r[0] for r in rows) / 1e6
    log(phase, f"{label} under the profiler: wall {wall * 1e3:.2f} ms, "
        f"device busy {busy * 1e3:.2f} ms ({busy / wall:.2%}; idle "
        f"{1 - busy / wall:.2%})")
    for dev_us, count, key in rows[:6]:
        share = dev_us / 1e6 / busy
        log(phase, f"  {dev_us / 1e3:.3f} ms device ({share:.1%} of busy),"
            f" {count} calls: {key[:80]}")
    return {"wall": wall, "busy": busy}


def phase_model(torch, np) -> dict:
    """Answer a few requests at full width, check them, then serve() under
    each policy.  Returns the flash kernel's launches of the counted run."""
    from repro_torch.configs import registry
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.launch import serve as srv
    from repro_torch.models import decode as D
    from repro_torch.models import transformer as T

    import dataclasses

    dev = torch.device("cuda")
    cfg = registry.get_config(MODEL_ARCH)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = T.init_params(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    n_par = sum(t.numel() for t in _tensors(params))
    log("model", f"{cfg.name}: {cfg.num_layers} layers, d_model "
        f"{cfg.d_model}, {cfg.num_heads} heads / {cfg.num_kv_heads} KV, "
        f"head_dim {cfg.head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, "
        f"{cfg.dtype}; {n_par} parameters drawn in "
        f"{time.perf_counter() - t0:.2f} s")
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (MODEL_B, MODEL_S)).astype(np.int32)).to(dev)
    B, S, n_layers = MODEL_B, MODEL_S, cfg.num_layers

    # The path's run: prefill + greedy decode, launch count from 0.
    torch.cuda.synchronize()
    _reset_flash_counts(kfa)
    t0 = time.perf_counter()
    cache, logits = D.prefill(cfg, params, {"tokens": toks}, MODEL_MAX_LEN)
    torch.cuda.synchronize()
    t_first = time.perf_counter() - t0
    n_prefill = kfa.flash_attention.launches
    n_tc = kfa.flash_attention.sm90_launches
    tok = logits.argmax(-1).to(torch.int32)
    step_logits = []
    t0 = time.perf_counter()
    for _ in range(MODEL_DECODE):
        lg, cache = D.decode_step(cfg, params, cache, tok)
        step_logits.append(lg)
        tok = lg.argmax(-1).to(torch.int32)
    torch.cuda.synchronize()
    t_dec = time.perf_counter() - t0
    launches = kfa.flash_attention.launches
    if n_prefill != n_layers or launches != n_layers or n_tc != n_layers:
        raise AssertionError(f"flash launches: {n_prefill} in prefill "
                             f"({n_tc} on the bf16 tensor-core kernel), "
                             f"{launches} after decode; expected {n_layers}")
    finite = bool(torch.isfinite(logits).all()) and all(
        bool(torch.isfinite(x).all()) for x in step_logits)
    if not finite:
        raise AssertionError("non-finite logits")
    if int(cache["pos"]) != S + MODEL_DECODE:
        raise AssertionError(f"cache pos {int(cache['pos'])}")
    peak = torch.cuda.max_memory_allocated()

    # A second prefill, warm, for the rate (and 24 more launches).
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    D.prefill(cfg, params, {"tokens": toks}, MODEL_MAX_LEN)
    torch.cuda.synchronize()
    t_pre = time.perf_counter() - t0
    if kfa.flash_attention.launches != 2 * n_layers:
        raise AssertionError("the second prefill did not launch the flash "
                             "kernel once per layer")
    log("model", f"prefill B={B} S={S} max_len {MODEL_MAX_LEN}: "
        f"{t_pre * 1e3:.2f} ms warm ({B * S / t_pre:.1f} tokens/s; first "
        f"call {t_first * 1e3:.2f} ms), flash launches {n_prefill} per "
        f"prefill, all {n_tc} on the bf16 wgmma kernel; {MODEL_DECODE} greedy decode steps {t_dec * 1e3:.2f} ms "
        f"({t_dec / MODEL_DECODE * 1e3:.3f} ms per step, "
        f"{B * MODEL_DECODE / t_dec:.1f} tokens/s); every logit finite; "
        f"max_memory_allocated {peak} B ({peak / 2**30:.3f} GiB)")
    _profile(torch, lambda: D.prefill(cfg, params, {"tokens": toks},
                                      MODEL_MAX_LEN), "one prefill")

    def steps():
        c, t = cache, tok
        for _ in range(8):
            _, c = D.decode_step(cfg, params, c, t)
    _profile(torch, steps, "8 decode steps")
    del cache

    # Exactness on a float32 copy of the weights (TF32 is off), then the
    # bf16 path against that float32 forward.
    errs, faults = {}, {}
    cfg32 = dataclasses.replace(cfg, dtype="float32")   # a float32 cache
    for label, c, p in (("bf16", cfg, params),
                        ("f32", cfg32, _tree_map(lambda t: t.float(),
                                                 params))):
        k_out = _answer(torch, c, p, toks, kfa.flash_attention)
        p_out = _answer(torch, c, p, toks, kfa.flash_attention_plain)
        errs[label] = dict(kernel_vs_plain=rel_err(torch, k_out[0], p_out[0]),
                           decode_vs_full=rel_err(torch, k_out[1], k_out[2]),
                           plain_decode_vs_full=rel_err(torch, p_out[1],
                                                        p_out[2]))
        faults[label] = rel_err(torch, k_out[3], k_out[2])
        if label == "bf16":
            bf16 = (k_out, p_out)
        else:
            f32 = k_out
            del p
    (kb, pb), ref = bf16, f32
    errs["bf16_vs_f32"] = dict(
        kernel_prefill=rel_err(torch, kb[0], ref[0]),
        plain_prefill=rel_err(torch, pb[0], ref[0]),
        kernel_decode=rel_err(torch, kb[1], ref[1]),
        fault_decode=rel_err(torch, kb[3], ref[1]))
    for label, e in errs.items():
        log("model", f"logits max|d|/max|logits|, {label}: " + ", ".join(
            f"{k} {v:.3e}" for k, v in e.items()))
    log("model", f"planted fault (decode one slot off) vs the full forward: "
        f"f32 {faults['f32']:.3e} (bound {EXACT_TOL}), bf16 "
        f"{faults['bf16']:.3e} (bf16 bound {NOISE_TOL}; against the "
        f"float32 forward {errs['bf16_vs_f32']['fault_decode']:.3e})")
    bad = [f"f32 {k}" for k, v in errs["f32"].items() if v > EXACT_TOL] + \
        [f"bf16 {k}" for k, v in errs["bf16"].items() if v > NOISE_TOL] + \
        [f"bf16 vs f32 {k}" for k, v in errs["bf16_vs_f32"].items()
         if v > NOISE_TOL and k != "fault_decode"]
    for label, tol in (("f32", EXACT_TOL), ("bf16", NOISE_TOL)):
        if not faults[label] > tol:
            bad.append(f"the planted fault passed the {label} bound "
                       f"({faults[label]!r})")
    if bad:
        raise AssertionError(f"model logits beyond bounds: {bad} {errs}")
    log("model", f"float32: kernel == plain and decode == full forward "
        f"within {EXACT_TOL}; bf16 within {NOISE_TOL} of each other and of "
        "the float32 forward; the planted fault beyond both bounds")
    del bf16, f32, kb, pb, ref

    # The port's serve() at full width with the reference CLI's defaults.
    # The first run measures the decode step; the others reuse its cost,
    # so that the three policies schedule the same virtual workload.
    cost = None
    for policy in ("pspice", "random", "admission"):
        t0 = time.perf_counter()
        out = srv.serve(cfg, params, requests=64, rate=50.0, policy=policy,
                        slots=16, slo=1.0, max_len=96, device=dev,
                        step_cost=cost, log=lambda s: log("model", s))
        cost = out["step_cost"]
        m = out["metrics"]
        log("model", f"serve {policy}: decode_step "
            f"{cost * 1e3:.3f} ms at B=16 (measured in the pspice run), "
            f"{out['decode_steps']} real decode steps, metrics {m}, wall "
            f"{time.perf_counter() - t0:.2f} s")
        if out["finished"] != 64 or m["completed"] + m["evicted"] != 64:
            raise AssertionError(f"serve {policy}: {out['finished']} of 64 "
                                 "requests finished")
    return {"flash_attention": launches}


# ---------------------------------------------------------------------------
# The MoE family at full width: deepseek-moe-16b, and deepseek-v3 with MLA
# ---------------------------------------------------------------------------

# (arch, layers kept (None: all), greedy decode steps, layers of the
# float32 cut).  deepseek-v3 keeps 2 of its 61 layers at full width: one
# layer is 11.50 B parameters (23.0 GB in bf16), so 2 layers and the
# embeddings (49.7 GB) fit the card's 80 GB beside the activations and 61
# would not.  The float32 cuts: deepseek-moe-16b's first 4 layers, a copy
# of its bf16 weights (9.4 GB + the embeddings' 1.7 GB); deepseek-v3 1
# layer drawn anew after the bf16 weights are freed (53 GB).
MOE_RUNS = (("deepseek-moe-16b", None, 32, 4),
            ("deepseek-v3-671b", 2, 8, 1))
MOE_B, MOE_S, MOE_MAX_LEN = 4, 2048, 2112
# The prompt (B, S) of decode against the full forward, made on a no-drop
# copy of the config (capacity_factor = E / K, so C = Sr): at the
# reference's capacity a decode step, whose batch is one dispatch row,
# drops other tokens than the full forward's rows, so the two differ by
# design.  deepseek-v3's full-capacity dispatch at 1 x 512 is (256, 512,
# 7168) bf16, 1.9 GB.
MOE_NODROP_PROMPT = {"deepseek-moe-16b": (4, 2048),
                     "deepseek-v3-671b": (1, 512)}
MOE_BUDGET_S = 180.0


def _prefill_logits(cfg, params, toks, flash, max_len=MOE_MAX_LEN):
    """The last position's logits of a prefill whose attention is
    ``flash``."""
    from repro_torch.models import decode as D
    from repro_torch.models import layers as L
    kernel_flash = L.flash_attention
    L.flash_attention = flash
    try:
        return D.prefill(cfg, params, {"tokens": toks}, max_len)[1]
    finally:
        L.flash_attention = kernel_flash


def _no_drop(cfg):
    import dataclasses
    return dataclasses.replace(
        cfg, capacity_factor=cfg.num_experts / cfg.moe_top_k)


class _Routing:
    """Records the MoE routing decisions of one run (each moe_route call's
    topk_idx and gidx), or replays recorded decisions in another run with
    that run's own probabilities as the gates, through layers.moe_route.

    In bf16 two correct paths round the hidden state apart, and where two
    experts' probabilities (or two tokens' gates at an expert's capacity)
    lie closer than that rounding, top-k picks differently: the output
    then jumps by a gate times the difference of two experts' outputs.
    Replaying one run's decisions in the other compares the paths under
    test (the flash kernel, the cache) without that discontinuity; the
    routing itself is held exactly in float32 (the float32 cut here, the
    CPU tests against the reference)."""

    def __init__(self, L):
        self.L, self.orig = L, L.moe_route

    def record(self, fn):
        calls = []

        def route(p, xr, cfg):
            out = self.orig(p, xr, cfg)
            calls.append((out[1], out[4]))
            return out
        return self._run(route, fn), calls

    def replay(self, calls, fn):
        """``calls``: (topk_idx, gidx or None) per moe_route call; None
        recomputes each expert's tokens from the gates (no-drop)."""
        it = iter(calls)

        def route(p, xr, cfg):
            probs = self.orig(p, xr, cfg)[0]
            topk_idx, gidx = next(it)
            gate = probs.new_zeros(probs.shape).scatter_(
                -1, topk_idx, probs.gather(-1, topk_idx))
            if gidx is None:
                gval, gidx = self.L.top_k(gate.transpose(1, 2),
                                          self.L.moe_capacity(
                                              cfg, xr.shape[1]))
            else:
                gval = gate.transpose(1, 2).gather(-1, gidx)
            return probs, topk_idx, gate, gval, gidx
        out = self._run(route, fn)
        if next(it, None) is not None:
            raise AssertionError("the replay left recorded calls unused")
        return out

    def _run(self, route, fn):
        self.L.moe_route = route
        try:
            return fn()
        finally:
            self.L.moe_route = self.orig


def _flips(a_calls, b_calls, last_only: bool) -> tuple:
    """(token decisions whose top-k expert sets differ, decisions) between
    two runs' recorded routes; with ``last_only`` the first run is a
    decode step (one row of the batch's tokens) and the second the full
    forward, compared at its last position."""
    n = tot = 0
    for (a, _), (b, _) in zip(a_calls, b_calls):
        if last_only:
            a, b = a[0], b[:, -1]
        d = (a.sort(-1).values != b.sort(-1).values).any(-1)
        n, tot = n + int(d.sum()), tot + d.numel()
    return n, tot


def phase_moe(torch, np) -> dict:
    """The MoE family's serving path at full width (MOE_RUNS).  Returns
    the flash kernel's launches per instance of each config's counted
    run."""
    t0 = time.perf_counter()
    out = {}
    for run in MOE_RUNS:
        for name, rec in moe_config(torch, np, *run).items():
            out.setdefault(name, {}).update(rec)
    secs = time.perf_counter() - t0
    log("moe", f"the phase took {secs:.2f} s of its {MOE_BUDGET_S:.0f} s "
        f"budget ({'within' if secs <= MOE_BUDGET_S else 'OVER'} it)")
    return out


def moe_config(torch, np, arch, layers, n_dec, f32_layers) -> dict:
    """One MoE config on the card: random bf16 weights from a seeded
    generator, prefill of MOE_B prompts of MOE_S tokens (the bf16 flash
    kernel once per layer, on the config's instance) and ``n_dec`` greedy
    decode steps (the path's counted run); prefill tokens/s, ms per decode
    step, peak memory and a profile; kernel against plain on the prefill
    logits and decode against the full forward on the no-drop copy, each
    with a planted fault, in bf16 and on the float32 cut; serve() once
    with the reference CLI's defaults (pspice)."""
    import dataclasses
    import gc

    from repro_torch.configs import registry
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.launch import serve as srv
    from repro_torch.models import decode as D
    from repro_torch.models import transformer as T

    t_cfg = time.perf_counter()
    dev = torch.device("cuda")
    full = registry.get_config(arch)
    cfg = dataclasses.replace(full, num_layers=layers or full.num_layers)
    n_layers = cfg.num_layers
    dv = cfg.v_head_dim if cfg.use_mla else cfg.head_dim
    inst = kfa.sm90_instance(cfg.qk_head_dim, dv)
    name = ("flash_attention_mla" if inst == (192, 128) else
            "flash_attention")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = T.init_params(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    n_par = sum(t.numel() for t in _tensors(params))
    n_bytes = sum(t.numel() * t.element_size() for t in _tensors(params))
    attn = (f"MLA (q_lora {cfg.q_lora_rank}, kv_lora {cfg.kv_lora_rank}, "
            f"q/k head dim {cfg.qk_head_dim}, v head dim {dv})"
            if cfg.use_mla else f"GQA head_dim {cfg.head_dim}")
    cut = ("" if n_layers == full.num_layers else
           f" (depth cut from {full.num_layers}; full width)")
    log("moe", f"{cfg.name}: {n_layers} layers{cut}, d_model {cfg.d_model}"
        f", {cfg.num_heads} heads, {attn}, {cfg.num_experts} experts top-"
        f"{cfg.moe_top_k} + {cfg.num_shared_experts} shared, d_ff "
        f"{cfg.d_ff}, vocab {cfg.vocab_size}, {cfg.dtype}; {n_par} "
        f"parameters ({n_bytes} B) drawn in {t_init:.2f} s")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    toks = torch.randint(0, cfg.vocab_size, (MOE_B, MOE_S), generator=gen,
                         device=dev, dtype=torch.int32)

    # The path's run: prefill + greedy decode, launch counts from 0.
    torch.cuda.synchronize()
    _reset_flash_counts(kfa)
    t0 = time.perf_counter()
    cache, logits = D.prefill(cfg, params, {"tokens": toks}, MOE_MAX_LEN)
    torch.cuda.synchronize()
    t_first = time.perf_counter() - t0
    n_prefill = kfa.flash_attention.sm90_instances[inst]
    tok = logits.argmax(-1).to(torch.int32)
    step_logits = []
    t0 = time.perf_counter()
    for _ in range(n_dec):
        lg, cache = D.decode_step(cfg, params, cache, tok)
        step_logits.append(lg)
        tok = lg.argmax(-1).to(torch.int32)
    torch.cuda.synchronize()
    t_dec = time.perf_counter() - t0
    counts = dict(kfa.flash_attention.sm90_instances)
    total = kfa.flash_attention.launches
    if (n_prefill != n_layers or counts[inst] != n_layers or
            total != n_layers):
        raise AssertionError(f"{cfg.name} flash launches: {n_prefill} on "
                             f"{inst} in prefill, {counts} by instance and "
                             f"{total} in all after decode; expected "
                             f"{n_layers}, all on {inst}")
    if not (bool(torch.isfinite(logits).all()) and all(
            bool(torch.isfinite(x).all()) for x in step_logits)):
        raise AssertionError(f"{cfg.name}: non-finite logits")
    if int(cache["pos"]) != MOE_S + n_dec:
        raise AssertionError(f"{cfg.name}: cache pos {int(cache['pos'])}")
    peak = torch.cuda.max_memory_allocated()
    del step_logits

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    D.prefill(cfg, params, {"tokens": toks}, MOE_MAX_LEN)
    torch.cuda.synchronize()
    t_pre = time.perf_counter() - t0
    log("moe", f"{cfg.name} prefill B={MOE_B} S={MOE_S}: {t_pre * 1e3:.2f} "
        f"ms warm ({MOE_B * MOE_S / t_pre:.1f} tokens/s; first call "
        f"{t_first * 1e3:.2f} ms), flash launches {n_prefill} per prefill, "
        f"all on the bf16 wgmma kernel's <{inst[0]}, {inst[1]}> instance "
        f"({counts}); {n_dec} greedy decode steps {t_dec * 1e3:.2f} ms "
        f"({t_dec / n_dec * 1e3:.3f} ms per step, "
        f"{MOE_B * n_dec / t_dec:.1f} tokens/s); every logit finite, pos "
        f"{int(cache['pos'])}; max_memory_allocated {peak} B "
        f"({peak / 2**30:.3f} GiB)")
    _profile(torch, lambda: D.prefill(cfg, params, {"tokens": toks},
                                      MOE_MAX_LEN),
             f"{cfg.name} one prefill", "moe")

    def steps():
        c, t = cache, tok
        for _ in range(8):
            _, c = D.decode_step(cfg, params, c, t)
    _profile(torch, steps, f"{cfg.name} 8 decode steps", "moe")
    del cache

    # bf16: the kernel against the plain flash on the prefill logits, and
    # decode against the full forward on the no-drop copy, with a decode
    # step written one slot off that must read beyond the bound.
    nb, ns = MOE_NODROP_PROMPT[arch]
    ptoks = toks[:nb, :ns].contiguous()
    errs = {}

    def report(label, c, tol, pinned=""):
        e = errs[label]
        log("moe", f"{cfg.name} {label} ({c.num_layers} layers) logits "
            f"max|d|/max|logits|{pinned}: kernel vs plain (prefill {MOE_B} "
            f"x {MOE_S}) {e['kernel_vs_plain']:.3e}, no-drop decode vs full "
            f"forward ({nb} x {ns} + 1) {e['decode_vs_full']:.3e}, planted "
            f"fault (decode one slot off) {e['fault_decode']:.3e}; bound "
            f"{tol}")

    def check_exact(label, c, p, tol):
        plain = _prefill_logits(c, p, toks, kfa.flash_attention_plain)
        kern = _prefill_logits(c, p, toks, kfa.flash_attention)
        _, step, want, bad = _answer(torch, _no_drop(c), p, ptoks,
                                     kfa.flash_attention, ns + 8)
        errs[label] = dict(kernel_vs_plain=rel_err(torch, kern, plain),
                           decode_vs_full=rel_err(torch, step, want),
                           fault_decode=rel_err(torch, bad, want), tol=tol)
        report(label, c, tol)

    def check_noise(label, c, p, tol):
        """bf16: both comparisons with one run's routing replayed in the
        other (_Routing); the unpinned readings and the decisions that
        differ are logged beside them."""
        from repro_torch.models import layers as L
        rt = _Routing(L)
        plain, r_plain = rt.record(lambda: _prefill_logits(
            c, p, toks, kfa.flash_attention_plain))
        kern, r_kern = rt.record(lambda: _prefill_logits(
            c, p, toks, kfa.flash_attention))
        pinned = rt.replay(r_plain, lambda: _prefill_logits(
            c, p, toks, kfa.flash_attention))
        nd = _no_drop(c)
        cache, lg = D.prefill(nd, p, {"tokens": ptoks}, ns + 8)
        tok = lg.argmax(-1).to(torch.int32)
        step, r_dec = rt.record(
            lambda: D.decode_step(nd, p, cache, tok)[0])
        want, r_full = rt.record(
            lambda: _full_logits(torch, nd, p, ptoks, tok))
        pins = [(ti[:, -1][None], None) for ti, _ in r_full]
        step_p = rt.replay(pins, lambda: D.decode_step(nd, p, cache, tok)[0])
        bad_p = rt.replay(pins, lambda: D.decode_step(
            nd, p, dict(cache, pos=cache["pos"] + 1), tok)[0])
        del cache
        errs[label] = dict(kernel_vs_plain=rel_err(torch, pinned, plain),
                           decode_vs_full=rel_err(torch, step_p, want),
                           fault_decode=rel_err(torch, bad_p, want), tol=tol)
        report(label, c, tol, " with the routing replayed")
        kf, kt = _flips(r_kern, r_plain, last_only=False)
        df, dt = _flips(r_dec, r_full, last_only=True)
        log("moe", f"{cfg.name} {label} unpinned (each run routes by its own"
            f" probabilities): kernel vs plain "
            f"{rel_err(torch, kern, plain):.3e} with {kf} of {kt} "
            f"(layer, token) top-{c.moe_top_k} choices differing; no-drop "
            f"decode vs full {rel_err(torch, step, want):.3e} with {df} of "
            f"{dt} choices of the decoded tokens differing")

    check_noise("bf16", cfg, params, NOISE_TOL)

    # The port's serve() with the reference CLI's defaults.
    t0 = time.perf_counter()
    out = srv.serve(cfg, params, requests=64, rate=50.0, policy="pspice",
                    slots=16, slo=1.0, max_len=96, device=dev,
                    log=lambda s: log("moe", f"{cfg.name} {s}"))
    m = out["metrics"]
    log("moe", f"{cfg.name} serve pspice: decode_step "
        f"{out['step_cost'] * 1e3:.3f} ms at B=16, {out['decode_steps']} "
        f"real decode steps, metrics {m}, wall "
        f"{time.perf_counter() - t0:.2f} s")
    if out["finished"] != 64 or m["completed"] + m["evicted"] != 64:
        raise AssertionError(f"{cfg.name} serve: {out['finished']} of 64 "
                             "requests finished")

    # The float32 cut (TF32 is off): deepseek-moe-16b's first layers as a
    # float32 copy, deepseek-v3 drawn anew once its bf16 weights are gone.
    cfg32 = dataclasses.replace(cfg, dtype="float32", num_layers=f32_layers)
    if arch == "deepseek-moe-16b":
        p32 = {k: v.to(torch.float32, copy=True)
               for k, v in params.items() if k != "layers"}
        p32["layers"] = _tree_map(lambda t: t[:f32_layers].to(
            torch.float32, copy=True), params["layers"])
        del params
    else:
        del params
        gc.collect()
        torch.cuda.empty_cache()
        p32 = T.init_params(cfg32, seed=0, device=dev)
    gc.collect()
    torch.cuda.empty_cache()
    check_exact("f32", cfg32, p32, EXACT_TOL)
    del p32
    bad = [f"{label} {k} {v!r}" for label, e in errs.items()
           for k, v in e.items() if k in ("kernel_vs_plain", "decode_vs_full")
           and not v <= e["tol"]]
    bad += [f"{label}: the planted fault passed the bound "
            f"({e['fault_decode']!r})" for label, e in errs.items()
            if not e["fault_decode"] > e["tol"]]
    if bad:
        raise AssertionError(f"{cfg.name} logits beyond bounds: {bad}")
    log("moe", f"{cfg.name}: bf16 within {NOISE_TOL}, float32 within "
        f"{EXACT_TOL}, each planted fault beyond its bound; the config took "
        f"{time.perf_counter() - t_cfg:.2f} s")
    key = "launches" if name == "flash_attention_mla" else "moe_launches"
    return {name: {key: counts[inst]}}


# ---------------------------------------------------------------------------
# The SSM and hybrid families at full width and depth: mamba2, zamba2
# ---------------------------------------------------------------------------

# Both configs whole (no cut): mamba2-1.3b 1.45 B parameters, zamba2-7b
# 6.75 B (13.5 GB in bf16, 27.0 GB as the float32 copy).
SSM_ARCHS = ("mamba2-1.3b", "zamba2-7b")
SSM_B, SSM_S, SSM_MAX_LEN, SSM_DECODE = 4, 2048, 2112, 32
# The exactness checks' prompt (B, S): 4 chunks of 256.
SSM_EXACT_B, SSM_EXACT_S = 2, 1024
# The reference's own bound for its chunked SSD against its recurrence
# (tests/test_models.py:120-130), max |chunked - recurrent|.
SSM_ORACLE_TOL = 2e-4
# The gated logits checks' depth: the first 12 layers (zamba2: the shared
# block at 2 points, as in its smoke config).  At full depth these
# random-weight models amplify float32 rounding to ~1e-4 of max|logits|
# (PERF.md, PR 22), so there the readings are logged beside the floor.
SSM_CUT_LAYERS = 12
# The chunk of the floor's second full forward (the configs' is 256).
SSM_FLOOR_CHUNK = 128
SSM_BUDGET_S = 90.0


def phase_ssm(torch, np) -> dict:
    """The SSM and hybrid families' serving path at full width and depth
    (SSM_ARCHS).  Returns the flash kernel's launches at head_dim 112
    (zamba2's counted run)."""
    from torch.profiler import ProfilerActivity, profile

    t0 = time.perf_counter()
    # The profiler's first use in a process starts its tracer (seconds,
    # which would read as device idle time); start it here.
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        torch.ones(1, device=torch.device("cuda")).add_(1)
        torch.cuda.synchronize()
    out = {}
    for arch in SSM_ARCHS:
        out.update(ssm_config(torch, np, arch))
    secs = time.perf_counter() - t0
    log("ssm", f"the phase took {secs:.2f} s of its {SSM_BUDGET_S:.0f} s "
        f"budget ({'within' if secs <= SSM_BUDGET_S else 'OVER'} it)")
    return out


def _conv_rolled(cache):
    """The planted fault of an SSM cache: each layer's conv window rolled
    by one token (mamba2 has no position-indexed cache, so its fault must
    touch the recurrent state); a copy, as decode writes the cache."""
    faulty = {k: v.clone() for k, v in cache.items()}
    faulty["conv"] = faulty["conv"].roll(1, dims=2)
    return faulty


def _flash_recorder(torch, kfa, errs: list):
    """The flash kernel's wrapper, each call also held to the plain
    version on the same inputs: appends (max |kernel - plain|,
    row-relative error) to ``errs``."""
    def flash(q, k, v, *, causal=True, q_offset=0, scale=None,
              causal_skip=True):
        got = kfa.flash_attention(q, k, v, causal=causal, q_offset=q_offset,
                                  scale=scale, causal_skip=causal_skip)
        want = kfa.flash_attention_plain(q, k, v, causal=causal,
                                         q_offset=q_offset, scale=scale,
                                         causal_skip=causal_skip)
        errs.append((max_abs_err(torch, got, want),
                     row_rel_err(torch, got, want)))
        return got
    return flash


def ssm_oracle(torch, cfg, params, toks) -> None:
    """ssd_forward (chunked) against ssd_reference (the token-by-token
    recurrence) on layer 0 of ``params`` (float32) at full width, over
    the embedded and normed prompt ``toks``."""
    from repro_torch.models import layers as L
    from repro_torch.models import settings as SET
    from repro_torch.models import ssm as SSM

    lp = SET.tree_index(params["layers"], 0)
    x = L.rmsnorm(params["embed"][toks.long()], lp["norm1"], cfg.norm_eps)
    t0 = time.perf_counter()
    y, _ = SSM.ssd_forward(lp["mamba"], x, cfg)
    want = SSM.ssd_reference(lp["mamba"], x, cfg)
    torch.cuda.synchronize()
    err = float((y - want).abs().max())
    log("ssm", f"{cfg.name} layer 0 (float32, {tuple(x.shape)}): "
        f"ssd_forward (chunk {cfg.ssm_chunk}) vs ssd_reference (the "
        f"recurrence) max |d| {err:.3e} of max |y| "
        f"{float(want.abs().max()):.3e} (bound {SSM_ORACLE_TOL}); "
        f"{time.perf_counter() - t0:.2f} s")
    if not err <= SSM_ORACLE_TOL:
        raise AssertionError(f"{cfg.name}: ssd_forward vs ssd_reference "
                             f"{err!r} beyond {SSM_ORACLE_TOL}")


def ssm_config(torch, np, arch) -> dict:
    """One SSM or hybrid config on the card at full width and depth:
    random bf16 weights from a seeded generator, prefill of SSM_B prompts
    of SSM_S tokens (zamba2: the bf16 flash kernel at each of its 13
    applications of the shared block) and SSM_DECODE greedy decode steps
    (the path's counted run); prefill tokens/s, ms per decode step, peak
    memory and a profile of each; serve() once with the reference CLI's
    defaults (pspice); then the exactness checks, at full depth and on
    the first SSM_CUT_LAYERS layers, in bf16 and on a float32 copy: the
    kernel against plain (zamba2), decode against the full forward, a
    planted fault and the chunking floor; each flash launch of the
    full-depth prefill against plain; (mamba2) ssd_forward against
    ssd_reference."""
    import dataclasses
    import gc

    from repro_torch.configs import registry
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.launch import serve as srv
    from repro_torch.models import decode as D
    from repro_torch.models import transformer as T

    t_cfg = time.perf_counter()
    dev = torch.device("cuda")
    cfg = registry.get_config(arch)
    every = cfg.hybrid_attn_every
    n_attn = cfg.num_layers // every if every else 0
    inst = kfa.sm90_instance(cfg.head_dim, cfg.head_dim) if every else None
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = T.init_params(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    n_par = sum(t.numel() for t in _tensors(params))
    n_bytes = sum(t.numel() * t.element_size() for t in _tensors(params))
    shared = (f"; one shared attention ({cfg.num_heads} x {cfg.head_dim}, "
              f"KV {cfg.num_kv_heads}) + MLP ({cfg.d_ff}) block applied "
              f"once every {every} layers ({n_attn} points)"
              if every else "")
    log("ssm", f"{cfg.name}: {cfg.num_layers} layers (full depth), d_model "
        f"{cfg.d_model}, d_inner {cfg.d_inner}, {cfg.ssm_heads} SSM heads x "
        f"{cfg.ssm_head_dim}, state {cfg.ssm_state}, chunk {cfg.ssm_chunk}, "
        f"conv {cfg.conv_width}{shared}, vocab {cfg.vocab_size}, "
        f"{cfg.dtype}; {n_par} parameters ({n_bytes} B) drawn in "
        f"{t_init:.2f} s")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    toks = torch.randint(0, cfg.vocab_size, (SSM_B, SSM_S), generator=gen,
                         device=dev, dtype=torch.int32)

    # The path's run: prefill + greedy decode, launch counts from 0.
    torch.cuda.synchronize()
    _reset_flash_counts(kfa)
    t0 = time.perf_counter()
    cache, logits = D.prefill(cfg, params, {"tokens": toks}, SSM_MAX_LEN)
    torch.cuda.synchronize()
    t_first = time.perf_counter() - t0
    n_prefill = kfa.flash_attention.launches
    tok = logits.argmax(-1).to(torch.int32)
    step_logits = []
    t0 = time.perf_counter()
    for _ in range(SSM_DECODE):
        lg, cache = D.decode_step(cfg, params, cache, tok)
        step_logits.append(lg)
        tok = lg.argmax(-1).to(torch.int32)
    torch.cuda.synchronize()
    t_dec = time.perf_counter() - t0
    counts = dict(kfa.flash_attention.sm90_instances)
    total = kfa.flash_attention.launches
    on_inst = counts[inst] if every else 0
    if (n_prefill != n_attn or total != n_attn or on_inst != n_attn or
            kfa.flash_attention.sm90_launches != n_attn):
        raise AssertionError(f"{cfg.name} flash launches: {n_prefill} in "
                             f"prefill, {counts} by instance, {total} in all "
                             f"after decode; expected {n_attn} on {inst}")
    if not (bool(torch.isfinite(logits).all()) and all(
            bool(torch.isfinite(x).all()) for x in step_logits)):
        raise AssertionError(f"{cfg.name}: non-finite logits")
    if int(cache["pos"]) != SSM_S + SSM_DECODE:
        raise AssertionError(f"{cfg.name}: cache pos {int(cache['pos'])}")
    peak = torch.cuda.max_memory_allocated()
    del step_logits

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    D.prefill(cfg, params, {"tokens": toks}, SSM_MAX_LEN)
    torch.cuda.synchronize()
    t_pre = time.perf_counter() - t0
    flash_txt = (f"flash launches {n_prefill} per prefill, all on the bf16 "
                 f"wgmma kernel's <{inst[0]}, {inst[1]}> instance at "
                 f"head_dim {cfg.head_dim}" if every else
                 "no attention (no flash launch)")
    log("ssm", f"{cfg.name} prefill B={SSM_B} S={SSM_S}: {t_pre * 1e3:.2f} "
        f"ms warm ({SSM_B * SSM_S / t_pre:.1f} tokens/s; first call "
        f"{t_first * 1e3:.2f} ms), {flash_txt}; {SSM_DECODE} greedy decode "
        f"steps {t_dec * 1e3:.2f} ms ({t_dec / SSM_DECODE * 1e3:.3f} ms per "
        f"step, {SSM_B * SSM_DECODE / t_dec:.1f} tokens/s); every logit "
        f"finite, pos {int(cache['pos'])}; max_memory_allocated {peak} B "
        f"({peak / 2**30:.3f} GiB)")
    _profile(torch, lambda: D.prefill(cfg, params, {"tokens": toks},
                                      SSM_MAX_LEN),
             f"{cfg.name} one prefill", "ssm")
    _profile(torch, lambda: D.decode_step(cfg, params, cache, tok),
             f"{cfg.name} one decode step", "ssm")
    del cache

    # The port's serve() with the reference CLI's defaults.
    t0 = time.perf_counter()
    out = srv.serve(cfg, params, requests=64, rate=50.0, policy="pspice",
                    slots=16, slo=1.0, max_len=96, device=dev,
                    log=lambda s: log("ssm", f"{cfg.name} {s}"))
    m = out["metrics"]
    log("ssm", f"{cfg.name} serve pspice: decode_step "
        f"{out['step_cost'] * 1e3:.3f} ms at B=16, {out['decode_steps']} "
        f"real decode steps, metrics {m}, wall "
        f"{time.perf_counter() - t0:.2f} s")
    if out["finished"] != 64 or m["completed"] + m["evicted"] != 64:
        raise AssertionError(f"{cfg.name} serve: {out['finished']} of 64 "
                             "requests finished")

    # Exactness.  These random-weight models amplify any perturbation with
    # depth (each run's chunking floor reads it: the full forward with
    # chunk SSM_FLOOR_CHUNK against chunk 256, the same function rounded
    # otherwise), so the logits bars are held on the first SSM_CUT_LAYERS
    # layers, and at full depth the same readings are logged beside that
    # floor while each flash launch of the prefill is held to its plain
    # version on the same inputs.  bf16 decode against the full forward
    # is logged, not gated: the chunked prefill and the recurrent step
    # round apart in bf16, more with depth.
    ptoks = toks[:SSM_EXACT_B, :SSM_EXACT_S].contiguous()
    readings, launch_errs, logits = {}, {}, {}
    tok = None
    for dt in ("bf16", "f32"):
        if dt == "f32":   # the float32 copy (TF32 is off), bf16 freed
            cfg = dataclasses.replace(cfg, dtype="float32")
            params = _tree_map(lambda t: t.float(), params)
            gc.collect()
            torch.cuda.empty_cache()
        ktoks = toks if dt == "bf16" else ptoks
        for depth in ("full", "cut"):
            c, p = cfg, params
            if depth == "cut":
                c = dataclasses.replace(cfg, num_layers=SSM_CUT_LAYERS)
                p = dict(params, layers=_tree_map(
                    lambda t: t[:SSM_CUT_LAYERS], params["layers"]))
            r = readings[f"{dt} {depth}"] = {}
            if every:
                flash = kfa.flash_attention
                if depth == "full":
                    flash = _flash_recorder(
                        torch, kfa, launch_errs.setdefault(dt, []))
                r["kernel_vs_plain"] = rel_err(
                    torch, _prefill_logits(c, p, ktoks, flash, SSM_MAX_LEN),
                    _prefill_logits(c, p, ktoks, kfa.flash_attention_plain,
                                    SSM_MAX_LEN))
            out = _answer(torch, c, p, ptoks, kfa.flash_attention,
                          SSM_EXACT_S + 8, tok, _conv_rolled)
            if tok is None:   # the bf16 run's greedy token, in every run
                tok = out[0].argmax(-1).to(torch.int32)
            r["decode_vs_full"] = rel_err(torch, out[1], out[2])
            r["fault_decode"] = rel_err(torch, out[3], out[2])
            r["chunking_floor"] = rel_err(torch, _full_logits(
                torch, dataclasses.replace(c, ssm_chunk=SSM_FLOOR_CHUNK), p,
                ptoks, tok), out[2])
            logits[f"{dt} {depth}"] = out[:3]
    if arch == "mamba2-1.3b":
        ssm_oracle(torch, cfg, params, ptoks)
    del params, p
    # The bf16 path's own distance from the float32 forward (the same
    # tokens: the bf16 run's greedy token decoded in both).
    (b_pre, b_step, b_full), (f_pre, _, f_full) = (logits["bf16 full"],
                                                   logits["f32 full"])
    readings["bf16 vs f32, full"] = dict(
        prefill=rel_err(torch, b_pre, f_pre),
        decode=rel_err(torch, b_step, f_full),
        full=rel_err(torch, b_full, f_full))
    for label, e in readings.items():
        log("ssm", f"{cfg.name} logits max|d|/max|logits|, {label}: " +
            ", ".join(f"{k} {v:.3e}" for k, v in e.items()))
    log("ssm", f"{cfg.name} (\"cut\": the first {SSM_CUT_LAYERS} of "
        f"{cfg.num_layers} layers; prompts: bf16 kernel vs plain {SSM_B} x "
        f"{SSM_S}, every other reading {SSM_EXACT_B} x {SSM_EXACT_S}, then "
        "one decode step against the full forward over one token more; the "
        "fault: that step from a conv window rolled by one token; the "
        f"floor: the full forward at chunk {SSM_FLOOR_CHUNK} against "
        f"{cfg.ssm_chunk})")
    log("ssm", f"{cfg.name} bf16 decode vs full forward "
        f"{readings['bf16 full']['decode_vs_full']:.3e} (full depth), "
        f"{readings['bf16 cut']['decode_vs_full']:.3e} (cut): logged, not "
        "gated (the chunked SSD of prefill and the recurrent step of decode "
        "round apart in bf16, and the gap grows with depth; float32 holds "
        "it)")
    bad = []
    for dt, errs in launch_errs.items():
        abs_max = max(e[0] for e in errs)
        row_max = max(e[1] for e in errs)
        tol = FLASH_TOL["float32" if dt == "f32" else "bfloat16"]
        log("ssm", f"{cfg.name} {dt} full-depth prefill: {len(errs)} flash "
            f"launches each against the plain flash on its own inputs: max "
            f"|kernel - plain| {abs_max:.3e} (tol {tol}), row-relative "
            f"{row_max:.3e} (bar {FLASH_ROW_TOL}, bf16)")
        if (len(errs) != n_attn or not abs_max <= tol or
                (dt == "bf16" and not row_max <= FLASH_ROW_TOL)):
            bad.append(f"{dt} per-launch flash {len(errs)} launches, "
                       f"{abs_max!r}, rows {row_max!r}")
    cut32 = readings["f32 cut"]
    bad += [f"f32 cut {k} {cut32[k]!r}" for k in ("kernel_vs_plain",
                                                  "decode_vs_full")
            if k in cut32 and not cut32[k] <= EXACT_TOL]
    bad += [f"the planted fault passed the float32 bound at {depth} depth "
            f"({readings[f'f32 {depth}']['fault_decode']!r})"
            for depth in ("full", "cut")
            if not readings[f"f32 {depth}"]["fault_decode"] > EXACT_TOL]
    if every and not readings["bf16 cut"]["kernel_vs_plain"] <= NOISE_TOL:
        bad.append(f"bf16 cut kernel_vs_plain "
                   f"{readings['bf16 cut']['kernel_vs_plain']!r}")
    if bad:
        raise AssertionError(f"{cfg.name} beyond bounds: {bad}")
    gated = (f", bf16 kernel vs plain within {NOISE_TOL}; every flash "
             "launch within its bar" if every else "")
    log("ssm", f"{cfg.name}: on the cut float32 within {EXACT_TOL} (the "
        f"planted fault beyond it at both depths){gated}; the config took "
        f"{time.perf_counter() - t_cfg:.2f} s")
    return {"flash_attention_hd112": {"launches": on_inst}} if every else {}


# ---------------------------------------------------------------------------
# The encoder-decoder at full width and depth: whisper-small
# ---------------------------------------------------------------------------

ENCDEC_ARCH = "whisper-small"
# 16 utterances, a 224-token decoder prompt, 64 greedy steps into a cache
# of 448 (whisper's decoder context).  The float32 checks run on the
# first ENCDEC_EXACT_B utterances.
ENCDEC_B, ENCDEC_S, ENCDEC_MAX_LEN, ENCDEC_DECODE = 16, 224, 448, 64
ENCDEC_EXACT_B = 4
ENCDEC_BUDGET_S = 45.0


def _encdec_batch(torch, cfg, B: int, S: int, dev) -> dict:
    """Seeded tokens (B, S) and frames (B, enc_frames, d) in the model's
    type (the reference stubs the conv frontend with frames)."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    toks = torch.randint(0, cfg.vocab_size, (B, S + 1), generator=gen,
                         device=dev, dtype=torch.int32)
    frames = torch.randn((B, cfg.enc_frames, cfg.d_model), generator=gen,
                         device=dev)
    dt = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
    return {"tokens": toks, "frames": frames.to(dt)}


def _cross_rolled(cache):
    """The planted fault of an encoder-decoder cache: each layer's cross
    K/V rolled by one utterance along the batch (every utterance attends
    to another's audio); the self-attention K/V copied, as decode writes
    them."""
    return dict(cache, k=cache["k"].clone(), v=cache["v"].clone(),
                ck=cache["ck"].roll(1, dims=1),
                cv=cache["cv"].roll(1, dims=1))


def _encdec_answer(torch, cfg, params, batch, S: int, flash):
    """prefill of the first S tokens (``flash`` its attention), one
    decode step of token S, the same step from the cross cache rolled by
    one utterance, and the full forward (encoder + decoder) over S + 1
    tokens: (prefill logits, step logits, full logits, faulty step)."""
    from repro_torch.models import decode as D
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T

    kernel_flash = L.flash_attention
    L.flash_attention = flash
    try:
        toks = batch["tokens"]
        cache, logits = D.prefill(cfg, params, {"tokens": toks[:, :S],
                                                "frames": batch["frames"]},
                                  ENCDEC_MAX_LEN)
        faulty = _cross_rolled(cache)
        step, _ = D.decode_step(cfg, params, cache, toks[:, S])
        bad, _ = D.decode_step(cfg, params, faulty, toks[:, S])
        del cache, faulty
        enc = T.encoder(cfg, params, batch["frames"])
        h, _ = T.backbone(cfg, params, T.embed_inputs(
            cfg, params, {"tokens": toks[:, :S + 1]}), enc_out=enc)
        h = L.rmsnorm(h[:, -1:], params["final_norm"], cfg.norm_eps)
        full = T.lm_head_logits(cfg, params, h)[:, 0]
    finally:
        L.flash_attention = kernel_flash
    return logits, step, full, bad


def phase_encdec(torch, np) -> dict:
    """whisper-small at full width and depth (bf16, random weights from a
    seeded generator): prefill of ENCDEC_B utterances (the encoder over
    1 500 frames, the decoder over a ENCDEC_S-token prompt: 36 launches of
    the flash kernel's (64, 64) instance, 12 encoder, 12 causal
    self-attention, 12 cross-attention) and ENCDEC_DECODE greedy decode
    steps (the path's counted run); prefill and decode rates, peak
    memory, a profile of each; serve() once (pspice); then the kernel
    against the plain flash in bf16 (5e-2) and, on a float32 copy (1e-4),
    the kernel against plain, decode against the full forward and a
    decode from a cross cache rolled by one utterance that must read
    beyond the bound; each of the 36 launches of a prefill against plain
    on its own inputs, in both types.  Returns the flash kernel's
    launches of the counted run."""
    import dataclasses
    import gc

    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import registry
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.launch import serve as srv
    from repro_torch.models import decode as D
    from repro_torch.models import transformer as T

    t_phase = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        torch.ones(1, device=torch.device("cuda")).add_(1)
        torch.cuda.synchronize()
    dev = torch.device("cuda")
    cfg = registry.get_config(ENCDEC_ARCH)
    n_attn = cfg.enc_layers + 2 * cfg.num_layers
    inst = kfa.sm90_instance(cfg.head_dim, cfg.head_dim)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = T.init_params(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    n_par = sum(t.numel() for t in _tensors(params))
    n_bytes = sum(t.numel() * t.element_size() for t in _tensors(params))
    log("encdec", f"{cfg.name}: {cfg.enc_layers} encoder + {cfg.num_layers} "
        f"decoder layers (full depth), d_model {cfg.d_model}, "
        f"{cfg.num_heads} heads x {cfg.head_dim} (KV {cfg.num_kv_heads}), "
        f"d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, {cfg.enc_frames} frames, "
        f"{cfg.dtype}; {n_par} parameters ({n_bytes} B) drawn in "
        f"{time.perf_counter() - t0:.2f} s")
    batch = _encdec_batch(torch, cfg, ENCDEC_B, ENCDEC_S, dev)
    prompt = {"tokens": batch["tokens"][:, :ENCDEC_S].contiguous(),
              "frames": batch["frames"]}
    B, S = ENCDEC_B, ENCDEC_S

    # The path's run: prefill + greedy decode, launch counts from 0.
    torch.cuda.synchronize()
    _reset_flash_counts(kfa)
    t0 = time.perf_counter()
    cache, logits = D.prefill(cfg, params, prompt, ENCDEC_MAX_LEN)
    torch.cuda.synchronize()
    t_first = time.perf_counter() - t0
    n_prefill = kfa.flash_attention.launches
    cross_bytes = 2 * cache["ck"].numel() * cache["ck"].element_size()
    tok = logits.argmax(-1).to(torch.int32)
    step_logits = []
    t0 = time.perf_counter()
    for _ in range(ENCDEC_DECODE):
        lg, cache = D.decode_step(cfg, params, cache, tok)
        step_logits.append(lg)
        tok = lg.argmax(-1).to(torch.int32)
    torch.cuda.synchronize()
    t_dec = time.perf_counter() - t0
    launches = kfa.flash_attention.launches
    on_inst = kfa.flash_attention.sm90_instances[inst]
    if n_prefill != n_attn or launches != n_attn or on_inst != n_attn:
        raise AssertionError(f"{cfg.name} flash launches: {n_prefill} in "
                             f"prefill, {launches} after decode, {on_inst} "
                             f"on {inst}; expected {n_attn}")
    if not (bool(torch.isfinite(logits).all()) and all(
            bool(torch.isfinite(x).all()) for x in step_logits)):
        raise AssertionError(f"{cfg.name}: non-finite logits")
    if int(cache["pos"]) != S + ENCDEC_DECODE:
        raise AssertionError(f"{cfg.name}: cache pos {int(cache['pos'])}")
    peak = torch.cuda.max_memory_allocated()
    del step_logits

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    D.prefill(cfg, params, prompt, ENCDEC_MAX_LEN)
    torch.cuda.synchronize()
    t_pre = time.perf_counter() - t0
    log("encdec", f"{cfg.name} prefill B={B} ({cfg.enc_frames} frames, "
        f"prompt {S} tokens, cache {ENCDEC_MAX_LEN}): {t_pre * 1e3:.2f} ms "
        f"warm ({B * cfg.enc_frames / t_pre:.1f} frames/s, "
        f"{B * S / t_pre:.1f} prompt tokens/s; first call "
        f"{t_first * 1e3:.2f} ms), flash launches {n_prefill} per prefill, "
        f"all on the bf16 wgmma kernel's <{inst[0]}, {inst[1]}> instance "
        f"({cfg.enc_layers} encoder non-causal, {cfg.num_layers} causal "
        f"self, {cfg.num_layers} cross); {ENCDEC_DECODE} greedy decode "
        f"steps {t_dec * 1e3:.2f} ms ({t_dec / ENCDEC_DECODE * 1e3:.3f} ms "
        f"per step, {B * ENCDEC_DECODE / t_dec:.1f} tokens/s); cross cache "
        f"{cross_bytes} B; every logit finite, pos {int(cache['pos'])}; "
        f"max_memory_allocated {peak} B ({peak / 2**30:.3f} GiB)")
    _profile(torch, lambda: D.prefill(cfg, params, prompt, ENCDEC_MAX_LEN),
             f"{cfg.name} one prefill", "encdec")
    _profile(torch, lambda: D.decode_step(cfg, params, cache, tok),
             f"{cfg.name} one decode step", "encdec")
    del cache

    # The port's serve() with the reference CLI's defaults (decode over
    # the initial cache, whose cross cache is zero, as the reference's).
    t0 = time.perf_counter()
    out = srv.serve(cfg, params, requests=64, rate=50.0, policy="pspice",
                    slots=16, slo=1.0, max_len=96, device=dev,
                    log=lambda s: log("encdec", f"{cfg.name} {s}"))
    m = out["metrics"]
    log("encdec", f"{cfg.name} serve pspice: decode_step "
        f"{out['step_cost'] * 1e3:.3f} ms at B=16, {out['decode_steps']} "
        f"real decode steps, metrics {m}, wall "
        f"{time.perf_counter() - t0:.2f} s")
    if out["finished"] != 64 or m["completed"] + m["evicted"] != 64:
        raise AssertionError(f"{cfg.name} serve: {out['finished']} of 64 "
                             "requests finished")

    # Exactness: bf16 at B = 16, then a float32 copy (TF32 is off) on the
    # first ENCDEC_EXACT_B utterances.
    readings, launch_errs = {}, {}
    for dt in ("bf16", "f32"):
        if dt == "f32":
            cfg = dataclasses.replace(cfg, dtype="float32")
            params = _tree_map(lambda t: t.float(), params)
            batch = {"tokens": batch["tokens"][:ENCDEC_EXACT_B],
                     "frames": batch["frames"][:ENCDEC_EXACT_B].float()}
            gc.collect()
            torch.cuda.empty_cache()
        errs = launch_errs[dt] = []
        k_out = _encdec_answer(torch, cfg, params, batch, S,
                               _flash_recorder(torch, kfa, errs))
        p_out = _encdec_answer(torch, cfg, params, batch, S,
                               kfa.flash_attention_plain)
        readings[dt] = dict(
            kernel_vs_plain=rel_err(torch, k_out[0], p_out[0]),
            decode_vs_full=rel_err(torch, k_out[1], k_out[2]),
            plain_decode_vs_full=rel_err(torch, p_out[1], p_out[2]),
            fault_decode=rel_err(torch, k_out[3], k_out[2]))
        if dt == "bf16":
            bf16_first = k_out[0][:ENCDEC_EXACT_B]
        else:
            readings["bf16 vs f32"] = dict(
                prefill=rel_err(torch, bf16_first, k_out[0]))
        del k_out, p_out
    del params
    for label, e in readings.items():
        log("encdec", f"{ENCDEC_ARCH} logits max|d|/max|logits|, {label}: "
            + ", ".join(f"{k} {v:.3e}" for k, v in e.items()))
    log("encdec", f"{ENCDEC_ARCH} (bf16: B={B}; f32: B={ENCDEC_EXACT_B}; "
        f"prompt {S}, then one decode step against the full forward over "
        f"{S + 1} tokens; the fault: that step from the cross cache rolled "
        "by one utterance)")
    bad = []
    for dt, errs in launch_errs.items():
        abs_max = max(e[0] for e in errs)
        row_max = max(e[1] for e in errs)
        tol = FLASH_TOL["float32" if dt == "f32" else "bfloat16"]
        # The recorder saw the prefill's launches and the full forward's.
        log("encdec", f"{ENCDEC_ARCH} {dt}: {len(errs)} flash launches "
            f"(the prefill's and the full forward's) each against the plain "
            f"flash on its own inputs: max |kernel - plain| {abs_max:.3e} "
            f"(tol {tol}), row-relative {row_max:.3e} (bar {FLASH_ROW_TOL}, "
            "bf16)")
        if (len(errs) != 2 * n_attn or not abs_max <= tol or
                (dt == "bf16" and not row_max <= FLASH_ROW_TOL)):
            bad.append(f"{dt} per-launch flash {len(errs)} launches, "
                       f"{abs_max!r}, rows {row_max!r}")
    f32 = readings["f32"]
    bad += [f"f32 {k} {f32[k]!r}" for k in ("kernel_vs_plain",
                                            "decode_vs_full")
            if not f32[k] <= EXACT_TOL]
    if not f32["fault_decode"] > EXACT_TOL:
        bad.append(f"the planted fault passed the float32 bound "
                   f"({f32['fault_decode']!r})")
    if not readings["bf16"]["kernel_vs_plain"] <= NOISE_TOL:
        bad.append(f"bf16 kernel_vs_plain "
                   f"{readings['bf16']['kernel_vs_plain']!r}")
    if bad:
        raise AssertionError(f"{ENCDEC_ARCH} beyond bounds: {bad}")
    secs = time.perf_counter() - t_phase
    log("encdec", f"{ENCDEC_ARCH}: float32 kernel == plain and decode == "
        f"full forward within {EXACT_TOL} (the planted fault beyond it); "
        f"bf16 kernel vs plain within {NOISE_TOL}; every flash launch "
        f"within its bar; the phase took {secs:.2f} s of its "
        f"{ENCDEC_BUDGET_S:.0f} s budget "
        f"({'within' if secs <= ENCDEC_BUDGET_S else 'OVER'} it)")
    return {"flash_attention_encdec": {"launches": on_inst}}


# ---------------------------------------------------------------------------
# The training path: internlm2-1.8b at full width, whisper-small
# ---------------------------------------------------------------------------

TRAIN_ARCH = "internlm2-1.8b"
# 4 of its 24 layers at full width (cut from the whole depth to pay for
# the mesh phase: the checkpoints of the 18.9 GB state took 55 s of the
# phase; the dryrun phase still runs a step of the whole depth), the
# mesh phase's training world's configuration and schedule, so that these
# losses are that world's one-process reference.  The model phase's
# prompt shape; 6 steps of the launch.train loop with a checkpoint every
# 2 and a NaN planted at step 3, which restores step 2 (dropping steps 2
# and 3); then one more step run on from memory (profiled) and, again,
# resumed from the latest checkpoint (6).
TRAIN_LAYERS = 4
TRAIN_B, TRAIN_S, TRAIN_STEPS, TRAIN_CKPT_EVERY, TRAIN_NAN_AT = (4, 2048, 6,
                                                                  2, 3)
TRAIN_MORE = 1
TRAIN_CUT_LAYERS = 2       # the float32 cut of the gradient check
TRAIN_CUT_B, TRAIN_CUT_S = 2, 2048
# Each gradient leaf's max|kernel path - plain path| / max|grad| (float32).
GRAD_TOL = 1e-4
# One AdamW step on the card against the CPU: max|d| / max|x| per leaf.
ADAMW_TOL = 1e-6
# whisper-small under autograd: 4 steps at B = 8 (1 500 frames, 448
# decoder tokens: the encoder, causal self- and cross-attention).
TRAIN_WHISPER_B, TRAIN_WHISPER_S, TRAIN_WHISPER_STEPS = 8, 448, 4
TRAIN_BUDGET_S = 90.0


def remove_meanwhile(path):
    """Remove the directory ``path`` in a thread, while the card works on
    (the removal of a checkpoint's gigabytes waits on the file system);
    returns the thread, which the caller joins before it ends."""
    import shutil
    import threading
    th = threading.Thread(target=shutil.rmtree, args=(path,),
                          kwargs={"ignore_errors": True})
    th.start()
    return th


def fingerprint(torch, tree) -> dict:
    """{leaf path: (sum of its bits, sum of its bits · (i mod 65521 + 1))}
    as int64 on the card (wrapping): equal trees give equal prints, and a
    changed element changes the second sum unless its change is a
    multiple of 2^64 / its weight.  States are compared by print: two
    whole-depth states of 18.9 GB never fit the card beside training, and
    the ranks of a world send prints, not states."""
    from repro_torch.training.tree import items

    out = {}
    for path, t in items(tree):
        bits = t.detach().reshape(-1)
        bits = bits.view({2: torch.int16, 4: torch.int32, 8: torch.int64,
                          1: torch.int8}[bits.element_size()]).long()
        w = torch.arange(bits.numel(), device=bits.device) % 65521 + 1
        out["/".join(map(str, path))] = (int(bits.sum()),
                                         int((bits * w).sum()))
        del bits, w
    return out


def train_cfg():
    """internlm2-1.8b at TRAIN_LAYERS layers, full width."""
    import dataclasses

    from repro_torch.configs import registry
    return dataclasses.replace(registry.get_config(TRAIN_ARCH),
                               num_layers=TRAIN_LAYERS)


def train_schedule() -> tuple:
    """(kept steps, saved checkpoints, the checkpoint the NaN restores,
    [(kind, checkpoint step)] in the order they happen) of TRAIN_STEPS
    steps with a checkpoint every TRAIN_CKPT_EVERY and a NaN at
    TRAIN_NAN_AT."""
    kept = [s for s in range(TRAIN_STEPS) if s != TRAIN_NAN_AT]
    saved = [s + 1 for s in kept if (s + 1) % TRAIN_CKPT_EVERY == 0]
    back = max(s for s in saved if s <= TRAIN_NAN_AT)
    # A save after step s - 1, the restore at the NaN step.
    events = [e[1:] for e in sorted([(s - 1, "save", s) for s in saved] +
                                    [(TRAIN_NAN_AT, "restore", back)])]
    return kept, saved, back, events


def phase_train(torch, np, shared: dict) -> dict:
    """The training path on the card (TRAIN_* above): internlm2-1.8b at
    full width and TRAIN_LAYERS layers in bf16 (float32 moments) through
    ``launch.train``'s loop, then whisper-small, each step's attention
    forward on the flash kernel under its autograd.Function.  Gates:
    every kept loss finite; the NaN step restores the last checkpoint
    bit for bit (fingerprints) and skips; the state resumed from the
    latest checkpoint equals the saved one, and a step from it equals the
    step run on in memory; on a float32 cut of the first 2 layers, every
    gradient leaf through the kernel's Function within GRAD_TOL of the
    plain flash under autograd; one AdamW step on the card within
    ADAMW_TOL of the same step on the CPU.  Logged: step ms, tokens/s,
    peak memory, a profiled step's idle share.  The kept losses go to
    ``shared["train_losses"]``: the mesh phase's one-process reference."""
    import dataclasses
    import gc
    import shutil

    from repro_torch.configs import registry
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.launch import train as LT
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T
    from repro_torch.training import optimizer as O
    from repro_torch.training.train_step import loss_and_grads

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    # Bitwise resume needs deterministic kernels (the embedding's
    # gradient sums colliding token rows).
    det = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    ckpt = ROOT / "build" / "train_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    cfg = train_cfg()
    opt_cfg = O.AdamWConfig(lr=1e-3, warmup_steps=10)
    tokens = TRAIN_B * TRAIN_S
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = T.init_params(cfg, seed=0, device=dev)
    opt = O.init_opt_state(params)
    torch.cuda.synchronize()
    n_par = sum(t.numel() for t in _tensors(params))
    state_bytes = sum(t.numel() * t.element_size() for t in
                      list(_tensors(params)) + list(_tensors(opt)))
    log("train", f"{cfg.name}: {cfg.num_layers} layers, d_model "
        f"{cfg.d_model}, {n_par} parameters in bf16, AdamW moments in "
        f"float32: {state_bytes} B of state; B={TRAIN_B} x S={TRAIN_S}")
    prints, events = {}, []

    def on_checkpoint(kind, step, state):
        events.append((kind, step))
        fp = fingerprint(torch, state)
        if kind == "save":
            prints[step] = fp
        elif fp != prints.get(step):
            raise AssertionError(f"the {kind} of step {step} is not bit for "
                                 "bit the saved state")
        log("train", f"checkpoint {kind} step {step}: {len(fp)} leaves, "
            "fingerprints equal to the save's" if kind == "restore" else
            f"checkpoint {kind} step {step}: {len(fp)} leaves fingerprinted")

    def timed(label, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        log("train", f"{label}: {time.perf_counter() - t0:.2f} s")
        return out

    _reset_flash_counts(kfa)
    logs = []
    # The loop takes the state over: this frame keeps no reference to it
    # (at the whole depth a second 18.9 GB state would not fit beside a
    # step).
    given = {"params": params, "opt": opt}
    del params, opt
    run = timed(f"{TRAIN_STEPS} steps of the loop (checkpoints and the NaN "
                "restore included)", lambda: LT.train_loop(
                    cfg, given.pop("params"), given.pop("opt"),
                    steps=TRAIN_STEPS, batch=TRAIN_B, seq=TRAIN_S,
                    opt_cfg=opt_cfg, ckpt_dir=str(ckpt),
                    ckpt_every=TRAIN_CKPT_EVERY, inject_nan_at=TRAIN_NAN_AT,
                    device=dev, on_checkpoint=on_checkpoint,
                    log=logs.append))
    for line in logs:
        log("train", line.removeprefix("[train] "))
    peak = torch.cuda.max_memory_allocated()
    kept = [s for s, _ in run["losses"]]
    shared["train_losses"] = run["losses"]
    want, saved, back, want_events = train_schedule()
    ms = [t * 1e3 for t in run["step_s"]]
    n_flash = kfa.flash_attention.launches
    if (kept != want or run["restored"] != [back] or run["saved"] != saved or
            events != want_events or
            not all(math.isfinite(x) for _, x in run["losses"])):
        raise AssertionError(f"train loop: kept steps {kept}, restored "
                             f"{run['restored']}, saved {run['saved']}, "
                             f"events {events}, losses {run['losses']}")
    # launch.train rematerialises each layer: the forward and the
    # backward's recomputation launch the kernel once a layer each.
    if n_flash != TRAIN_STEPS * cfg.num_layers * 2:
        raise AssertionError(f"{n_flash} flash launches in {TRAIN_STEPS} "
                             f"steps; expected {2 * cfg.num_layers} a step")
    warm = statistics.median(ms[1:])
    log("train", f"{cfg.name} losses {[round(x, 4) for _, x in run['losses']]}"
        f" (steps {kept}; step {TRAIN_NAN_AT}'s NaN restored step {back} and "
        f"skipped); step ms {[round(x, 1) for x in ms]} (first with the "
        f"allocator's warm-up): median {warm:.1f} ms = "
        f"{tokens / warm * 1e3:.1f} tokens/s; flash launches {n_flash} "
        f"({2 * cfg.num_layers} a step, remat on: the forward and its "
        f"recomputation on the kernel; the backward is the plain "
        f"version's VJP); max_memory_allocated {peak} B "
        f"({peak / 2**30:.3f} GiB)")

    # Running on from memory (profiled) and resuming from the latest
    # checkpoint: TRAIN_MORE more steps each, compared by fingerprint.
    state_last = prints[TRAIN_STEPS]
    from torch.profiler import ProfilerActivity, profile
    more = {}

    def on_memory():
        more["on"] = LT.train_loop(
            cfg, run.pop("params"), run.pop("opt"), steps=TRAIN_STEPS +
            TRAIN_MORE, start=TRAIN_STEPS, batch=TRAIN_B, seq=TRAIN_S,
            opt_cfg=opt_cfg, device=dev, log=lambda s: None)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    # Device activity alone: a step's ~10^4 host ops would take the
    # profile's table seconds to build.
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        on_memory()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    rows = timed("the profile's kernel table", lambda: device_rows(prof))
    busy = sum(r[0] for r in rows) / 1e6
    n_more = f"{TRAIN_MORE} step{'s' if TRAIN_MORE > 1 else ''}"
    log("train", f"{n_more} run on from memory under the "
        f"profiler: wall {wall * 1e3:.2f} ms, device busy "
        f"{busy * 1e3:.2f} ms ({busy / wall:.2%}; idle "
        f"{1 - busy / wall:.2%})")
    for dev_us, count, key in rows[:8]:
        log("train", f"  {dev_us / 1e3:.3f} ms device "
            f"({dev_us / 1e6 / busy:.1%} of busy), {count} calls: "
            f"{key[:80]}")
    del prof, rows
    on = more.pop("on")
    fp_on, losses_on = fingerprint(torch, {"params": on["params"],
                                           "opt": on["opt"]}), on["losses"]
    del on
    gc.collect()
    torch.cuda.empty_cache()
    like = T.init_params(cfg, seed=1, device=dev)
    p, o, start = timed("resume from the latest checkpoint", lambda:
                        LT.resume(str(ckpt), like, O.init_opt_state(like),
                                  log=lambda s: log(
                                      "train", s.removeprefix("[train] "))))
    del like
    if start != TRAIN_STEPS or fingerprint(
            torch, {"params": p, "opt": o}) != state_last:
        raise AssertionError(f"resume: step {start}, or the state is not "
                             "the saved one")
    given = {"params": p, "opt": o}
    del p, o
    res = LT.train_loop(cfg, given.pop("params"), given.pop("opt"),
                        steps=TRAIN_STEPS + TRAIN_MORE, start=start,
                        batch=TRAIN_B, seq=TRAIN_S, opt_cfg=opt_cfg,
                        device=dev, log=lambda s: None)
    fp_res = fingerprint(torch, {"params": res["params"],
                                 "opt": res["opt"]})
    if res["losses"] != losses_on or fp_res != fp_on:
        raise AssertionError(f"resumed steps {res['losses']} differ from "
                             f"running on {losses_on} (or the states' "
                             "fingerprints differ)")
    log("train", f"resumed at step {start}: the restored state's "
        f"fingerprints equal the step-{TRAIN_STEPS} save's; {n_more} from it "
        f"equal{'s' if TRAIN_MORE == 1 else ''} {n_more} run on from memory (losses "
        f"{[round(x, 6) for _, x in losses_on]}, every leaf's fingerprint)")
    # The real moments of the first TRAIN_CUT_LAYERS layers for the AdamW
    # check; the rest of the state goes.
    cut = lambda t: t[:TRAIN_CUT_LAYERS].float()  # noqa: E731
    moments = {k: _tree_map(cut, res["opt"][k]["layers"]) for k in "mv"}
    step_now = res["opt"]["step"]
    cut_params = dict(
        {k: res["params"][k].float() for k in ("embed", "lm_head",
                                               "final_norm")},
        layers=_tree_map(cut, res["params"]["layers"]))
    del res
    torch.use_deterministic_algorithms(det)
    gc.collect()
    torch.cuda.empty_cache()

    # The gradient bar on a float32 cut (the kernel's float32 instance
    # under the Function against the plain flash under autograd).
    ccfg = dataclasses.replace(cfg, num_layers=TRAIN_CUT_LAYERS,
                               dtype="float32")
    batch = LT.synthetic_batch(ccfg, TRAIN_CUT_B, TRAIN_CUT_S, 0, device=dev)
    n0 = kfa.flash_attention.launches
    loss_k, _, g_k = timed("float32 cut: loss and grads through the kernel",
                           lambda: loss_and_grads(ccfg, cut_params, batch))
    # Remat: each layer's forward runs the kernel, and so does its
    # recomputation in the backward.
    if kfa.flash_attention.launches != n0 + 2 * TRAIN_CUT_LAYERS:
        raise AssertionError("the float32 cut's forward and its "
                             "recomputation did not run the kernel in each "
                             "layer")
    kernel_flash = L.flash_attention
    L.flash_attention = kfa.flash_attention_plain
    try:
        loss_p, _, g_p = timed("float32 cut: loss and grads through the "
                               "plain flash", lambda: loss_and_grads(
                                   ccfg, cut_params, batch))
    finally:
        L.flash_attention = kernel_flash
    from repro_torch.training.tree import items
    worst, bad = 0.0, []
    flat_p = dict(items(g_p))
    for path, g in items(g_k):
        w = flat_p[path]
        e = float((g - w).abs().max()) / (float(w.abs().max()) + 1e-30)
        worst = max(worst, e)
        if not e <= GRAD_TOL:
            bad.append(("/".join(map(str, path)), e))
    log("train", f"float32 cut ({TRAIN_CUT_LAYERS} layers, B="
        f"{TRAIN_CUT_B} x S={TRAIN_CUT_S}): loss kernel {float(loss_k):.6f}"
        f", plain {float(loss_p):.6f}; {len(flat_p)} gradient leaves, "
        f"worst max|kernel - plain| / max|grad| {worst:.3e} (bar "
        f"{GRAD_TOL})")
    if bad or abs(float(loss_k) - float(loss_p)) > 1e-5 * abs(float(loss_p)):
        raise AssertionError(f"gradients through the kernel beyond "
                             f"{GRAD_TOL}: {bad}")
    del g_p

    # One AdamW step on the card and on the CPU from the same numbers: the
    # cut's layers (float32), their kernel-path gradients and the run's
    # real moments at its step.
    sub_p, sub_g = cut_params["layers"], g_k["layers"]
    sub_o = {"m": moments["m"], "v": moments["v"], "step": step_now}
    got = O.adamw_update(opt_cfg, sub_p, sub_g, sub_o)
    on_cpu = lambda t: _tree_map(lambda x: x.cpu(), t)  # noqa: E731
    want = timed("AdamW on the CPU (copies included)", lambda:
                 O.adamw_update(opt_cfg, on_cpu(sub_p), on_cpu(sub_g),
                                on_cpu(sub_o)))
    worst, bad = 0.0, []
    for what, a, b in (("params", got[0], want[0]),
                       ("m", got[1]["m"], want[1]["m"]),
                       ("v", got[1]["v"], want[1]["v"])):
        flat_b = dict(items(b))
        for path, x in items(a):
            y = flat_b[path]
            e = float((x.cpu() - y).abs().max()) / (float(y.abs().max()) +
                                                    1e-30)
            worst = max(worst, e)
            if not e <= ADAMW_TOL:
                bad.append((what, "/".join(map(str, path)), e))
    log("train", f"one AdamW step (step {int(step_now) + 1}) on "
        f"{len(dict(items(sub_p)))} float32 leaves of {TRAIN_CUT_LAYERS} "
        f"layers: card vs CPU worst max|d| / max|x| {worst:.3e} over "
        f"params and both moments (bar {ADAMW_TOL})")
    if bad:
        raise AssertionError(f"AdamW card vs CPU beyond {ADAMW_TOL}: {bad}")
    del cut_params, g_k, moments, got, want, sub_p, sub_g, sub_o
    gc.collect()
    torch.cuda.empty_cache()
    removal = remove_meanwhile(ckpt)        # joined before the phase ends

    # whisper-small: the kernel in all three modes under autograd.
    wcfg = registry.get_config(ENCDEC_ARCH)
    wp = T.init_params(wcfg, seed=0, device=dev)
    torch.cuda.reset_peak_memory_stats()
    inst = kfa.sm90_instance(wcfg.head_dim, wcfg.head_dim)
    n0 = kfa.flash_attention.sm90_instances[inst]
    wrun = timed(f"{wcfg.name}: {TRAIN_WHISPER_STEPS} steps", lambda:
                 LT.train_loop(wcfg, wp, O.init_opt_state(wp),
                               steps=TRAIN_WHISPER_STEPS,
                               batch=TRAIN_WHISPER_B, seq=TRAIN_WHISPER_S,
                               opt_cfg=opt_cfg, device=dev,
                               log=lambda s: None))
    del wp
    n_w = kfa.flash_attention.sm90_instances[inst] - n0
    # Encoder, causal self and cross attention, each forward run again by
    # the backward's recomputation (remat).
    n_attn = 2 * (wcfg.enc_layers + 2 * wcfg.num_layers)
    wpeak = torch.cuda.max_memory_allocated()
    wms = [t * 1e3 for t in wrun["step_s"]]
    if (len(wrun["losses"]) != TRAIN_WHISPER_STEPS or not all(
            math.isfinite(x) for _, x in wrun["losses"]) or
            n_w != TRAIN_WHISPER_STEPS * n_attn):
        raise AssertionError(f"{wcfg.name} training: losses "
                             f"{wrun['losses']}, {n_w} flash launches on "
                             f"{inst}")
    wwarm = statistics.median(wms[1:])
    log("train", f"{wcfg.name} B={TRAIN_WHISPER_B} ({wcfg.enc_frames} "
        f"frames, {TRAIN_WHISPER_S} tokens): losses "
        f"{[round(x, 4) for _, x in wrun['losses']]}; step ms "
        f"{[round(x, 1) for x in wms]}: median {wwarm:.1f} ms = "
        f"{TRAIN_WHISPER_B * TRAIN_WHISPER_S / wwarm * 1e3:.1f} decoder "
        f"tokens/s; flash launches {n_w} on <{inst[0]}, {inst[1]}> "
        f"({n_attn} a step: encoder, causal self, cross, each twice with "
        f"remat); "
        f"max_memory_allocated {wpeak} B ({wpeak / 2**30:.3f} GiB)")
    del wrun
    timed("the checkpoints' removal, joined", removal.join)
    secs = time.perf_counter() - t_phase
    log("train", f"the phase took {secs:.2f} s of its {TRAIN_BUDGET_S:.0f} "
        f"s budget ({'within' if secs <= TRAIN_BUDGET_S else 'OVER'} it)")
    return {"flash_attention": {"train_launches": n_flash},
            "flash_attention_encdec": {"train_launches": n_w}}


# The mesh phase: launch.train and launch.serve as SPMD ranks of gloo
# worlds of MESH_RANKS processes sharing the one card, each rank's
# DTensors on the card (dist.init_mesh), laid out by
# dist.sharding.train_specs / cache_specs / decode_specs on one "data"
# dim as the reference lays out its jitted steps on its host mesh.
MESH_ARCH = "internlm2-1.8b"
MESH_RANKS = 2
# Training: the train phase's configuration and schedule (TRAIN_*: 4 of
# the 24 layers, as two replicated states of the whole depth do not fit
# one card beside their steps — one process peaks at 50.279 GiB —, the
# global batch 4 x 2048, 2 x 2048 a rank), so that the train phase's
# losses are the world's one-process reference.  Each kept step's loss,
# |world - one process| / |one process|: the world sums its two halves'
# bf16 gradients in the all-reduce, one process the whole batch's in its
# GEMMs; the readings were 0 to 2.785e-5 (PERF.md §6, PR 26), and the bar
# is no tighter than the float32 CPU tests' 1e-5.
MESH_LOSS_TOL = 1e-4
# Serving: the whole model (24 layers, params replicated), the reference
# CLI's defaults (64 requests at rate 50, 16 slots, pspice: 8 slots a
# rank); the logits of the last of MESH_DECODE_STEPS decode steps of
# seeded tokens from an empty cache, gathered, against one process's
# (NOISE_TOL: bf16, the model phase's bar).
MESH_DECODE_STEPS = 4
MESH_TOKEN_SEED = 11
MESH_TIMEOUT = 300.0       # seconds: each world, each collective
MESH_BUDGET_S = 60.0


def _local(torch, tree):
    """Each DTensor of ``tree`` as this rank's shard (plain tensors as
    they are): a fingerprint's input."""
    from torch.distributed.tensor import DTensor
    if isinstance(tree, dict):
        return {k: _local(torch, v) for k, v in tree.items()}
    return tree.to_local() if isinstance(tree, DTensor) else tree


def collective_timer(torch):
    """A dispatch mode that waits for each c10d functional collective
    DTensor issues beneath it and synchronises the card, so that the
    collective's seconds are its own; it adds them and the result bytes
    up by kind ({"all-reduce": [calls, bytes, seconds], ...})."""
    from torch.distributed.tensor import DTensor
    from torch.utils._python_dispatch import TorchDispatchMode

    from repro_torch.launch.hlo_analysis import collective

    class CollectiveTimer(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.by_kind = {}

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if any(issubclass(t, DTensor) for t in types):
                return NotImplemented
            c = collective(func, args)
            t0 = time.perf_counter()
            out = func(*args, **(kwargs or {}))
            if c is not None:
                out = torch.ops._c10d_functional.wait_tensor(out)
                sync(torch, torch.device(DEV))
                row = self.by_kind.setdefault(c[0], [0, 0, 0.0])
                row[0] += 1
                row[1] += c[1]
                row[2] += time.perf_counter() - t0
            return out

    return CollectiveTimer()


def _mesh_flash_recorder(torch, kfa, errs: list):
    """The flash kernel's wrapper on DTensors, each call also held to the
    plain version on the shards the kernel ran on: appends (max |kernel
    - plain|, row-relative error, the local q shape, the check's seconds)
    to ``errs``."""
    def flash(q, k, v, *, causal=True, q_offset=0, scale=None,
              causal_skip=True):
        if not q.placements == k.placements == v.placements:
            raise AssertionError(f"q, k, v laid out apart: {q.placements}, "
                                 f"{k.placements}, {v.placements}")
        got = kfa.flash_attention(q, k, v, causal=causal, q_offset=q_offset,
                                  scale=scale, causal_skip=causal_skip)
        t0 = time.perf_counter()
        with torch.no_grad():
            ql, kl, vl = (t.detach().to_local() for t in (q, k, v))
            want = kfa.flash_attention_plain(
                ql, kl, vl, causal=causal, q_offset=q_offset, scale=scale,
                causal_skip=causal_skip)
            gl = got.detach().to_local()
            errs.append((max_abs_err(torch, gl, want),
                         row_rel_err(torch, gl, want), tuple(ql.shape),
                         time.perf_counter() - t0))
        return got
    return flash


def mesh_train_rank(ckpt: str) -> dict:
    """One rank of the training world (MESH_* above): ``launch.train``'s
    loop on the world's "data" mesh, one step a call, the state
    fingerprinted after each; each flash launch held to the plain version
    on its shards; then one step run on from memory (its collectives
    timed) against one step resumed from the latest checkpoint."""
    import torch
    import torch.distributed as tdist

    from repro_torch import dist as D
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.launch import train as LT
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T
    from repro_torch.training import optimizer as O

    t0 = time.perf_counter()
    # Deterministic kernels (the embedding's gradient sums colliding token
    # rows), for the bitwise resume.  torch.use_deterministic_algorithms
    # would also import torch._inductor to set its flag, which no eager
    # step reads: 3.9-4.9 s in a fresh rank on the card's machine
    # (tests/_mesh_probe.py cold).
    torch._C._set_deterministic_algorithms(True, warn_only=True)
    torch.zeros(1, device=DEV)          # the card's context
    card_s = time.perf_counter() - t0
    mesh = D.init_mesh((tdist.get_world_size(),), ("data",))
    if mesh.device_type != torch.device(DEV).type:
        raise AssertionError(f"the world's mesh is on {mesh.device_type}")
    mesh_s = time.perf_counter() - t0 - card_s
    cfg = train_cfg()
    params = T.init_params(cfg, seed=0, device=DEV)
    state = {"params": params, "opt": O.init_opt_state(params)}
    del params
    sync(torch, torch.device(DEV))
    setup_s = (card_s, mesh_s, time.perf_counter() - t0 - card_s - mesh_s)
    errs, logs, events, saved, prints = [], [], [], {}, []
    kernel_flash = L.flash_attention
    L.flash_attention = _mesh_flash_recorder(torch, kfa, errs)
    _reset_flash_counts(kfa)
    torch.cuda.reset_peak_memory_stats()

    def on_checkpoint(kind, step, st):
        fp = fingerprint(torch, _local(torch, st))
        if kind == "save":
            saved[step] = fp
        events.append((kind, step, fp == saved.get(step)))

    kw = dict(batch=TRAIN_B, seq=TRAIN_S, device=DEV, log=logs.append,
              mesh=mesh, opt_cfg=O.AdamWConfig(lr=1e-3, warmup_steps=10))
    losses, step_s, done = [], [], {"saved": [], "restored": []}
    t1 = time.perf_counter()
    for step in range(TRAIN_STEPS):
        run = LT.train_loop(cfg, state.pop("params"), state.pop("opt"),
                            steps=step + 1, start=step, ckpt_dir=ckpt,
                            ckpt_every=TRAIN_CKPT_EVERY,
                            inject_nan_at=TRAIN_NAN_AT,
                            on_checkpoint=on_checkpoint, **kw)
        state = {"params": run.pop("params"), "opt": run.pop("opt")}
        losses += run["losses"]
        step_s += run["step_s"]
        for k in done:
            done[k] += run[k]
        prints.append(fingerprint(torch, _local(torch, state)))
    loop_s = time.perf_counter() - t1
    n_flash, n_sm90 = (kfa.flash_attention.launches,
                       kfa.flash_attention.sm90_launches)
    peak = torch.cuda.max_memory_allocated()
    L.flash_attention = kernel_flash       # the checks are done
    # One step run on from memory, its collectives timed, against one
    # step resumed from the latest checkpoint (the same state, read back).
    timer = collective_timer(torch)
    sync(torch, torch.device(DEV))
    t1 = time.perf_counter()
    with timer:
        on = LT.train_loop(cfg, state["params"], state["opt"],
                           steps=TRAIN_STEPS + 1, start=TRAIN_STEPS, **kw)
    timed_s = time.perf_counter() - t1
    fp_on, losses_on = fingerprint(torch, _local(
        torch, {"params": on["params"], "opt": on["opt"]})), on["losses"]
    del on
    t1 = time.perf_counter()
    p, o, start = LT.resume(ckpt, state["params"], state["opt"],
                            log=logs.append)
    resume_s = time.perf_counter() - t1
    del state
    fp_resumed = fingerprint(torch, _local(torch, {"params": p, "opt": o}))
    res = LT.train_loop(cfg, p, o, steps=TRAIN_STEPS + 1, start=start, **kw)
    del p, o
    fp_res = fingerprint(torch, _local(
        torch, {"params": res["params"], "opt": res["opt"]}))
    return {"setup_s": setup_s, "loop_s": loop_s, "losses": losses,
            "step_s": step_s, "saved": done["saved"],
            "restored": done["restored"], "events": events,
            "prints": prints, "flash": n_flash, "sm90": n_sm90,
            "flash_errs": errs, "peak": peak, "logs": logs,
            "timed_s": timed_s, "collectives": timer.by_kind,
            "resume_step": start, "resume_s": resume_s,
            "resumed_is_saved": fp_resumed == prints[-1],
            "resume_equals_memory": fp_res == fp_on and
            res["losses"] == losses_on, "losses_on": losses_on}


def mesh_decode_logits(torch, cfg, params, mesh=None):
    """The logits of the last of MESH_DECODE_STEPS decode steps of seeded
    tokens from an empty cache (``launch.serve.Decoder``; on a mesh
    gathered whole), float32 on the host, and the steps' mean ms.  The
    rows are gathered by c10d's ``all_gather_into_tensor``: DTensor's
    gather, the functional all-gather, segfaults on CUDA tensors over
    gloo in torch 2.11, where its all-reduce and reduce-scatter run
    (tests/_mesh_probe.py collectives)."""
    import torch.distributed as tdist
    from torch.distributed.tensor import Shard

    from repro_torch.launch import serve as LS

    dec = LS.Decoder(cfg, params, 16, torch.device(DEV), mesh)
    cache = dec.cache(96)
    g = torch.Generator().manual_seed(MESH_TOKEN_SEED)
    sync(torch, torch.device(DEV))
    t0 = time.perf_counter()
    for _ in range(MESH_DECODE_STEPS):
        toks = torch.randint(0, cfg.vocab_size, (16,), generator=g,
                             dtype=torch.int32).to(DEV)
        logits, cache = dec.step(cache, dec.tokens(toks))
    sync(torch, torch.device(DEV))
    ms = (time.perf_counter() - t0) * 1e3 / MESH_DECODE_STEPS
    if mesh is not None:
        if tuple(logits.placements) != (Shard(0),):
            raise AssertionError(f"logits laid out {logits.placements}")
        rows = logits.to_local().contiguous()
        logits = rows.new_empty((tdist.get_world_size() * rows.shape[0],) +
                                tuple(rows.shape[1:]))
        tdist.all_gather_into_tensor(logits, rows)
    return logits.float().cpu(), ms


def mesh_serve_rank() -> dict:
    """One rank of the serving world: ``serve`` with the reference CLI's
    defaults on the world's "data" mesh (the cost measured here, rank
    0's used), then the decode logits of ``mesh_decode_logits``."""
    import torch
    import torch.distributed as tdist

    from repro_torch import dist as D
    from repro_torch.configs import registry
    from repro_torch.launch import serve as LS
    from repro_torch.models import transformer as T

    t0 = time.perf_counter()
    torch.zeros(1, device=DEV)          # the card's context
    card_s = time.perf_counter() - t0
    mesh = D.init_mesh((tdist.get_world_size(),), ("data",))
    mesh_s = time.perf_counter() - t0 - card_s
    cfg = registry.get_config(MESH_ARCH)
    params = T.init_params(cfg, seed=0, device=DEV)
    sync(torch, torch.device(DEV))
    setup_s = (card_s, mesh_s, time.perf_counter() - t0 - card_s - mesh_s)
    torch.cuda.reset_peak_memory_stats()
    logs = []
    t0 = time.perf_counter()
    out = LS.serve(cfg, params, device=DEV, mesh=mesh, log=lambda s:
                   logs.append(f"{s} (at {time.perf_counter() - t0:.2f} s)"))
    serve_s = time.perf_counter() - t0
    logits, ms = mesh_decode_logits(torch, cfg, params, mesh)
    return {"setup_s": setup_s, "serve_s": serve_s, "serve": out,
            "logits": logits, "decode_ms": ms, "logs": logs,
            "peak": torch.cuda.max_memory_allocated()}


def mesh_one_process_train(torch) -> list:
    """The train phase's kept losses, without its checkpoints: the steps
    up to the checkpoint the NaN restores, the steps from it to the NaN
    (their state dropped, as the restore drops it), then the steps after
    the NaN from the restored state.  The mesh phase's one-process
    reference where the train phase has not run."""
    from repro_torch.launch import train as LT
    from repro_torch.models import transformer as T
    from repro_torch.training import optimizer as O

    _, _, back, _ = train_schedule()
    cfg = train_cfg()
    kw = dict(batch=TRAIN_B, seq=TRAIN_S, device=DEV, log=lambda s: None,
              opt_cfg=O.AdamWConfig(lr=1e-3, warmup_steps=10))
    params = T.init_params(cfg, seed=0, device=DEV)
    a = LT.train_loop(cfg, params, O.init_opt_state(params), steps=back,
                      **kw)
    del params
    dropped = LT.train_loop(cfg, a["params"], a["opt"], steps=TRAIN_NAN_AT,
                            start=back, **kw)["losses"]
    c = LT.train_loop(cfg, a["params"], a["opt"], steps=TRAIN_STEPS,
                      start=TRAIN_NAN_AT + 1, **kw)
    return a["losses"] + dropped + c["losses"]


def phase_mesh(torch, np, one: list | None = None) -> dict:
    """``launch.train`` and ``launch.serve`` over gloo worlds of
    MESH_RANKS ranks sharing the card (MESH_* above).  Gates, training:
    the kept steps, checkpoints and the NaN restore as scheduled; every
    rank's params and moments bitwise rank 0's after every step
    (fingerprints); each save and restore bit for bit the state saved;
    the state resumed from the latest checkpoint the saved one, and a
    step from it equal to a step run on from memory; each flash launch
    (forward and recomputation, on each rank's shards) within the bf16
    kernel's bars of the plain version on the same shards, and
    2 x layers launches a step on every rank; each kept loss within
    MESH_LOSS_TOL of one process's.  Serving: one step cost on every
    rank (rank 0's); every rank's decisions those of one process's
    ``serve`` at that cost; a decode step's gathered logits within
    NOISE_TOL of one process's.  Logged: step ms, collective ms and
    bytes a step, peak memory a rank, flash launches.  ``one``: the
    train phase's kept losses, the one-process reference (None: run
    here, ``mesh_one_process_train``)."""
    import gc
    import shutil

    from repro_torch import dist as D
    from repro_torch.configs import registry
    from repro_torch.launch import serve as LS
    from repro_torch.models import transformer as T

    t_phase = time.perf_counter()
    cfg = train_cfg()
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    where = "the train phase's run"
    if one is None:
        det = torch.are_deterministic_algorithms_enabled()
        torch.use_deterministic_algorithms(True, warn_only=True)
        one = mesh_one_process_train(torch)
        torch.use_deterministic_algorithms(det)
        gc.collect()
        torch.cuda.empty_cache()
        where = f"run here in {time.perf_counter() - t0:.2f} s"
    log("mesh", f"one process, {cfg.name} at {TRAIN_LAYERS} of "
        f"{registry.get_config(MESH_ARCH).num_layers} layers "
        f"(B={TRAIN_B} x S={TRAIN_S}): losses "
        f"{[(s, round(x, 6)) for s, x in one]} ({where})")

    ckpt = ROOT / "build" / "mesh_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    t0 = time.perf_counter()
    ranks = D.spawn(mesh_train_rank, MESH_RANKS, args=(str(ckpt),),
                    timeout=MESH_TIMEOUT, workdir=str(ROOT / "build"))
    world_s = time.perf_counter() - t0
    r0 = ranks[0]
    for line in r0["logs"]:
        log("mesh", "rank 0: " + line.removeprefix("[train] "))
    kept = [s for s, _ in r0["losses"]]
    want_kept, want_saved, back, want_events = train_schedule()
    per_step = 2 * TRAIN_LAYERS
    for r, got in enumerate(ranks):
        if ([s for s, _ in got["losses"]] != want_kept or
                got["saved"] != want_saved or got["restored"] != [back] or
                [e[:2] for e in got["events"]] != want_events or
                not all(ok for *_, ok in got["events"]) or
                not all(math.isfinite(x) for _, x in got["losses"])):
            raise AssertionError(f"rank {r}: losses {got['losses']}, saved "
                                 f"{got['saved']}, restored "
                                 f"{got['restored']}, events "
                                 f"{got['events']}")
        if got["prints"] != r0["prints"] or got["losses"] != r0["losses"]:
            raise AssertionError(f"rank {r}'s state or losses differ from "
                                 "rank 0's")
        # Each kept step runs the kernel in each layer's forward and its
        # recomputation; the NaN step's forward runs too (its result is
        # dropped after the step), so every step counts.
        if got["flash"] != got["sm90"] or \
                got["flash"] != TRAIN_STEPS * per_step:
            raise AssertionError(f"rank {r}: {got['flash']} flash launches "
                                 f"({got['sm90']} bf16) in {TRAIN_STEPS} "
                                 f"steps; expected {per_step} a step")
        bad = [e for e in got["flash_errs"] if not (
            e[0] <= FLASH_TOL["bfloat16"] and e[1] <= FLASH_ROW_TOL)]
        if bad or len(got["flash_errs"]) != got["flash"]:
            raise AssertionError(f"rank {r}: flash launches beyond the bf16 "
                                 f"bars {bad[:4]} (or not every launch "
                                 "checked)")
        if not (got["resume_step"] == TRAIN_STEPS and
                got["resumed_is_saved"] and got["resume_equals_memory"]):
            raise AssertionError(f"rank {r}: resumed at step "
                                 f"{got['resume_step']}; the state equal to "
                                 f"the save: {got['resumed_is_saved']}; a step"
                                 " from it equal to a step from memory: "
                                 f"{got['resume_equals_memory']}")
    errs = [e for got in ranks for e in got["flash_errs"]]
    rel = [abs(x - y) / abs(y) for (_, x), (_, y) in zip(r0["losses"], one)]
    log("mesh", f"train world of {MESH_RANKS} ranks ({world_s:.2f} s of "
        f"wall; rank setup (card, mesh, params) "
        f"{[tuple(round(x, 2) for x in g['setup_s']) for g in ranks]} s, "
        f"loop {[round(g['loop_s'], 2) for g in ranks]} s, of it "
        f"{[round(sum(e[3] for e in g['flash_errs']), 2) for g in ranks]} s"
        f" checking flash launches): losses "
        f"{[(s, round(x, 6)) for s, x in r0['losses']]} (steps {kept}; "
        f"step {TRAIN_NAN_AT}'s NaN restored step {back}, bit for bit); every "
        f"rank's {len(r0['prints'][0])} state leaves bitwise rank 0's after "
        f"each of {TRAIN_STEPS} steps; |world - one process| / |one process| "
        f"per kept step {[f'{x:.3e}' for x in rel]} (bar {MESH_LOSS_TOL})")
    if not all(x <= MESH_LOSS_TOL for x in rel) or \
            [s for s, _ in one] != kept:
        raise AssertionError(f"the world's losses {r0['losses']} differ from "
                             f"one process's {one} beyond {MESH_LOSS_TOL}")
    ms = [t * 1e3 for t in r0["step_s"]]
    coll = r0["collectives"]
    coll_ms = sum(v[2] for v in coll.values()) * 1e3
    coll_bytes = sum(v[1] for v in coll.values())
    by_kind = {k: [v[0], v[1], round(v[2] * 1e3, 2)] for k, v in coll.items()}
    log("mesh", f"step ms (rank 0) {[round(x, 1) for x in ms]}: median of "
        f"the warm {statistics.median(ms[1:]):.1f} ms "
        f"({TRAIN_B * TRAIN_S / statistics.median(ms[1:]) * 1e3:.1f} tokens/s "
        f"over the world); one step run on from memory with its "
        f"collectives waited for: {r0['timed_s'] * 1e3:.1f} ms, of it "
        f"{coll_ms:.1f} ms in {sum(v[0] for v in coll.values())} "
        f"collectives moving {coll_bytes} B of results "
        f"({by_kind} [calls, bytes, ms]); max_memory_allocated a rank "
        f"{[g['peak'] for g in ranks]} B "
        f"({[round(g['peak'] / 2**30, 3) for g in ranks]} GiB)")
    log("mesh", f"flash launches a rank {[g['flash'] for g in ranks]} "
        f"({per_step} a step: each layer's forward and its recomputation, "
        f"on the rank's {errs[0][2]} shard), each against the plain version "
        f"on the same shards: worst max|kernel - plain| "
        f"{max(e[0] for e in errs):.3e} (bar {FLASH_TOL['bfloat16']}), "
        f"row-relative {max(e[1] for e in errs):.3e} (bar {FLASH_ROW_TOL}); "
        f"resumed at step {r0['resume_step']} in {r0['resume_s']:.2f} s: the "
        f"state bit for bit the step-{TRAIN_STEPS} save, a step from it equal "
        f"to a step run on from memory (loss {r0['losses_on']})")
    removal = remove_meanwhile(ckpt)        # joined before the phase ends
    n_flash = sum(g["flash"] for g in ranks)
    del ranks, r0

    # Serving: the whole model, params replicated, slots over "data".
    t0 = time.perf_counter()
    ranks = D.spawn(mesh_serve_rank, MESH_RANKS, timeout=MESH_TIMEOUT,
                    workdir=str(ROOT / "build"))
    world_s = time.perf_counter() - t0
    r0 = ranks[0]
    for line in r0["logs"]:
        log("mesh", "rank 0: " + line)
    cost = r0["serve"]["step_cost"]
    if r0["serve"]["measured"] != cost or any(
            g["serve"]["step_cost"] != cost for g in ranks):
        raise AssertionError(f"step costs {[g['serve'] for g in ranks]}: "
                             "not rank 0's on every rank")
    scfg = registry.get_config(MESH_ARCH)
    params = T.init_params(scfg, seed=0, device=DEV)
    t0 = time.perf_counter()
    alone = LS.serve(scfg, params, device=DEV, step_cost=cost,
                     log=lambda s: None)
    alone_s = time.perf_counter() - t0
    logits, ms_one = mesh_decode_logits(torch, scfg, params)
    del params
    keys = ("metrics", "finished", "decode_steps")
    for r, got in enumerate(ranks):
        if any(got["serve"][k] != alone[k] for k in keys):
            raise AssertionError(f"rank {r} served {got['serve']}; one "
                                 f"process at its cost {alone}")
    errs = [rel_err(torch, g["logits"], logits) for g in ranks]
    log("mesh", f"serve world of {MESH_RANKS} ranks ({world_s:.2f} s of "
        f"wall; rank setup (card, mesh, params) "
        f"{[tuple(round(x, 2) for x in g['setup_s']) for g in ranks]} s, "
        f"serve {[round(g['serve_s'], 2) for g in ranks]} s): "
        f"{scfg.num_layers} layers, 16 slots (8 a rank); step cost "
        f"{cost * 1e3:.3f} ms (rank 0's; rank 1 measured "
        f"{ranks[1]['serve']['measured'] * 1e3:.3f} ms) on every rank; "
        f"every rank's metrics {alone['metrics']}, {alone['finished']} "
        f"finished, {alone['decode_steps']} real decode steps: those of one "
        f"process's serve() at that cost ({alone_s:.2f} s); decode "
        f"{r0['decode_ms']:.2f} ms a step on the mesh, {ms_one:.2f} in one "
        f"process; step {MESH_DECODE_STEPS}'s gathered logits "
        f"max|d|/max|logits| {[f'{e:.3e}' for e in errs]} against one "
        f"process's (bar {NOISE_TOL}); max_memory_allocated a rank "
        f"{[g['peak'] for g in ranks]} B")
    if not all(e <= NOISE_TOL for e in errs):
        raise AssertionError(f"gathered decode logits {errs} beyond "
                             f"{NOISE_TOL}")
    del ranks, r0, logits
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    removal.join()
    log("mesh", f"the checkpoints' removal, joined: "
        f"{time.perf_counter() - t0:.2f} s")
    secs = time.perf_counter() - t_phase
    log("mesh", f"the phase took {secs:.2f} s of its {MESH_BUDGET_S:.0f} s "
        f"budget ({'within' if secs <= MESH_BUDGET_S else 'OVER'} it)")
    return {"flash_attention": {"mesh_launches": n_flash}}


# The dry-run on the card's software (the production mesh's rows) and a
# world of one against the card: internlm2-1.8b at the model and train
# phases' shapes.
DRYRUN_ARCH = "internlm2-1.8b"
DRYRUN_BUDGET_S = 90.0
DRYRUN_WORKERS = 7
DRYRUN_CARD_SHARE = 0.85     # of the card's memory for the child's allocator
DRYRUN_PEAK_TOL = 0.10       # |predicted - measured| / measured peak
# (label, kind, seq_len, batch, remat): a decode step runs into the model
# phase's cache of MODEL_MAX_LEN after a prefill of MODEL_S tokens.
DRYRUN_CASES = (("prefill", "prefill", MODEL_S, MODEL_B, True),
                ("decode", "decode", MODEL_MAX_LEN, MODEL_B, True),
                ("train", "train", TRAIN_S, TRAIN_B, True),
                ("train_no_remat", "train", TRAIN_S, TRAIN_B, False))
def dryrun_cells() -> list:
    """The production mesh's rows the card's run lowers: internlm2-1.8b's
    three shapes, every architecture's decode_32k, internlm2-1.8b's
    train_4k on the multi-pod mesh."""
    from repro_torch.configs import registry
    cells = [(DRYRUN_ARCH, s, False) for s in ("train_4k", "prefill_32k",
                                               "decode_32k")]
    cells += [(a, "decode_32k", False) for a in registry.ARCH_IDS
              if a != DRYRUN_ARCH]
    return cells + [(DRYRUN_ARCH, "train_4k", True)]


def dryrun_plan() -> tuple[list, list]:
    """(plan, jobs): the dry-run's traces for the production rows and the
    world of one (mesh (1, 1)): per case its full depth at the default
    chunks (FLOPs, peak) and under analysis mode, and a row's four
    (``dryrun.cell_jobs``).  ``plan`` holds (kind, key, first job,
    number of jobs)."""
    from repro_torch.configs.shapes import SHAPES, ShapeSpec
    from repro_torch.launch import dryrun as DR
    from repro_torch.launch import mesh as M
    plan, jobs = [], []

    def add(kind, key, js):
        plan.append((kind, key, len(jobs), len(js)))
        jobs.extend(js)
    for arch, shape, mp in dryrun_cells():
        add("row", (arch, shape, mp), DR.cell_jobs(
            arch, SHAPES[shape], *M.production_topology(multi_pod=mp),
            roofline=not mp, device="cuda"))
    one = ((1, 1), ("data", "model"))
    for label, kind, seq, B, remat in DRYRUN_CASES:
        shape = ShapeSpec(label, kind, seq, B)
        kw = dict(device="cuda", remat=remat)
        add("one", label, [DR.Job(DRYRUN_ARCH, shape, *one, None, False, **kw),
                           DR.Job(DRYRUN_ARCH, shape, *one, None, True, **kw)]
            + DR.cell_jobs(DRYRUN_ARCH, shape, *one, **kw))
    return plan, jobs


def dryrun_real(torch, cfg, params, label, kind, seq, B, remat) -> dict:
    """The world of one's case run for real on the card: the arguments'
    bytes, peak memory (reset once the arguments are made), FLOPs under
    FlopCounterMode, flash launches, and the median step ms."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.launch import dryrun as DR
    from repro_torch.launch import train as LT
    from repro_torch.models import decode as D
    from repro_torch.training import optimizer as O
    from repro_torch.training.tree import items
    dev = torch.device("cuda")
    shape = ShapeSpec(label, kind, seq, B)
    if kind == "decode":
        toks = LT.synthetic_batch(cfg, B, MODEL_S, 0, device=dev)["tokens"]
        with torch.no_grad():
            cache, logits = D.prefill(cfg, params, {"tokens": toks},
                                      max_len=seq)
        args = {"params": D.decode_weights(cfg, params), "cache": cache,
                "tokens": logits.argmax(-1).to(torch.int32)}
        del logits
    else:
        batch = LT.synthetic_batch(cfg, B, seq, 0, device=dev)
        args = {"params": params, "batch": {"tokens": batch["tokens"]}}
        if kind == "train":
            args = {"params": params, "opt": O.init_opt_state(params),
                    "batch": batch}
    arg_bytes = sum(t.numel() * t.element_size() for _, t in items(args))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    def step():
        out = DR.run_step(cfg, shape, args, remat=remat)
        torch.cuda.synchronize()
        del out

    step()
    peak = torch.cuda.max_memory_allocated()
    n0 = kfa.flash_attention.launches
    with FlopCounterMode(display=False) as fc:
        step()
    launches = kfa.flash_attention.launches - n0
    ms = []
    for _ in range(2 if kind == "train" else 5):
        t0 = time.perf_counter()
        step()
        ms.append((time.perf_counter() - t0) * 1e3)
    del args
    return dict(arg=arg_bytes, peak=peak, flops=fc.get_total_flops(),
                launches=launches, ms=statistics.median(ms))


def dryrun_child(path: str) -> int:
    """The dryrun phase's work, in a process of its own (chip_smoke.py
    --dryrun-child PATH): every trace of ``dryrun_plan`` in a pool of
    DRYRUN_WORKERS processes, the world of one's real runs on the card
    meanwhile; writes {"rows", "one", ...} as JSON to PATH."""
    import gc
    import multiprocessing

    import torch
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import registry
    from repro_torch.configs.shapes import SHAPES, ShapeSpec
    from repro_torch.dist.mesh import abstract_mesh
    from repro_torch.launch import dryrun as DR
    from repro_torch.launch import mesh as M
    from repro_torch.models import transformer as T
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    plan, jobs = dryrun_plan()
    # The longest first: the train traces, the multi-pod mesh's above all.
    order = sorted(range(len(jobs)), key=lambda i: (
        jobs[i].shape.kind != "train", len(jobs[i].mesh_shape) != 3,
        jobs[i].depth is not None))
    # Each worker of the pool holds a CUDA context of its own, and its
    # autograd on fake CUDA tensors reserves a little of the card's
    # memory: this process's allocator, which would cache up to the whole
    # card around the 54 GB train step, leaves them room.
    torch.cuda.set_per_process_memory_fraction(DRYRUN_CARD_SHARE)
    ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(DRYRUN_WORKERS) as pool:
        pending = pool.map_async(DR.run_job, [jobs[i] for i in order],
                                 chunksize=1)
        cfg = registry.get_config(DRYRUN_ARCH)
        params = T.init_params(cfg, seed=0, device=torch.device("cuda"))
        real = {}
        for case in DRYRUN_CASES:
            real[case[0]] = dryrun_real(torch, cfg, params, *case)
            gc.collect()
            torch.cuda.empty_cache()
        del params
        t_real = time.perf_counter() - t0
        done = pending.get(timeout=600)
    results = [None] * len(jobs)
    for i, r in zip(order, done):
        results[i] = r
    rows, one = [], {}
    for kind, key, i, n in plan:
        res = results[i:i + n]
        if kind == "row":
            arch, shape, mp = key
            row = {"arch": arch, "shape": shape,
                   "mesh": "multi" if mp else "single"}
            rows.append(DR.assemble_row(
                row, registry.get_config(arch), SHAPES[shape],
                M.make_abstract_production_mesh(multi_pod=mp), res))
            continue
        case = next(c for c in DRYRUN_CASES if c[0] == key)
        shape = ShapeSpec(*case[:4])
        row = DR.assemble_row({"arch": DRYRUN_ARCH, "shape": key}, cfg, shape,
                              abstract_mesh((1, 1), ("data", "model")),
                              res[2:])
        full, afull = res[0], res[1]
        one[key] = {"row": row, "real": real[key], "error": [
            r["error"] for r in res if "error" in r],
            "full": {k: full.get(k) for k in ("flops", "peak", "bytes")},
            "analysis_full": {k: afull.get(k) for k in ("flops", "bytes")},
            "trace_s": sum(r.get("wall_s", 0) for r in res)}
    with open(path, "w") as f:
        json.dump({"rows": rows, "one": one, "real_s": t_real,
                   "jobs": len(jobs), "job_s": sum(
                       r.get("wall_s", 0) for r in results),
                   "child_s": time.perf_counter() - t0}, f)
    return 0


def phase_dryrun(torch, np, block_record: dict | None) -> dict:
    """The dry-run (``repro_torch.launch.dryrun``) on the card's software,
    in a child process (``dryrun_child``): the production rows of
    ``dryrun_cells`` (target cuda) must read ``ok``; a world of one
    (mesh (1, 1)) against the card at the model and train phases' shapes
    (prefill, decode, train with remat on and off): argument bytes equal
    to the real tensors', traced FLOPs (full depth, default chunks) equal
    to FlopCounterMode over the real step, the row's peak within
    DRYRUN_PEAK_TOL of max_memory_allocated, under analysis mode the
    two-depth extrapolation equal to the full-depth trace in FLOPs and
    bytes, 24 flash launches a prefill; the roofline's terms beside the
    measured step; the CEP block's analytic bytes per event beside the
    kernels phase's."""
    import gc
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.cep import patterns as pat
    from repro_torch.cep import runner
    from repro_torch.data import streams
    from repro_torch.launch import roofline as RF
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    log("dryrun", f"this process holds {torch.cuda.memory_allocated()} B "
        f"allocated, {torch.cuda.memory_reserved()} B reserved on the card "
        "as the child starts")
    out = ROOT / "build" / "dryrun.json"
    out.unlink(missing_ok=True)
    res = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py"),
                          "--dryrun-child", str(out)], timeout=900)
    if res.returncode != 0:
        raise AssertionError(f"the dry-run child exited {res.returncode}")
    got = json.loads(out.read_text())
    bad = []
    for row in got["rows"]:
        ma = row.get("memory_analysis", {})
        log("dryrun", f"{row['arch']} {row['shape']} {row['mesh']}: "
            f"{row['status']}; argument {ma.get('argument_gb', 0):.6f} GB, "
            f"peak {ma.get('peak_gb', 0):.6f} GB per device"
            + (f"; {row['flops']:.6e} FLOP, {row['bytes']:.6e} B, "
               f"collectives {row['coll_bytes']:.6e} B; terms compute "
               f"{row['compute_s'] * 1e3:.4f} ms, memory "
               f"{row['memory_s'] * 1e3:.4f} ms, collective "
               f"{row['collective_s'] * 1e3:.4f} ms, dominant "
               f"{row['dominant']}, useful {row['useful_ratio']:.4f}"
               if "flops" in row else "")
            + f" ({row.get('wall_s', 0):.2f} s)"
            + (f" {row.get('error', '')}" if row["status"] != "ok" else ""))
        if row["status"] != "ok":
            bad.append((row["arch"], row["shape"], row["mesh"]))
    n_flash = 0
    for label, c in got["one"].items():
        if c["error"] or c["row"]["status"] != "ok":
            bad.append(("world of one", label, c["error"]))
            continue
        real, full, af, row = (c["real"], c["full"], c["analysis_full"],
                               c["row"])
        arg = row["memory_analysis"]["argument_gb"] * 1e9
        peak = row["memory_analysis"]["peak_gb"] * 1e9
        peak_err = abs(peak - real["peak"]) / real["peak"]
        step_s = real["ms"] / 1e3
        log("dryrun", f"world of one, {DRYRUN_ARCH} {label}: argument "
            f"bytes {round(arg)} predicted, {real['arg']} real; FLOPs "
            f"{full['flops']} traced (full depth), {real['flops']} "
            f"FlopCounterMode; peak {peak / 1e9:.4f} GB predicted (full "
            f"depth traced {full['peak'] / 1e9:.4f}), max_memory_allocated "
            f"{real['peak'] / 1e9:.4f} GB ({peak_err:.2%} apart); analysis "
            f"mode: two depths {row['flops']:.6e} FLOP / {row['bytes']:.6e} "
            f"B, full depth {af['flops']:.6e} / {af['bytes']:.6e}; roofline "
            f"compute {row['compute_s'] * 1e3:.3f} ms, memory "
            f"{row['memory_s'] * 1e3:.3f} ms, {row['dominant']}-bound, "
            f"against {real['ms']:.2f} ms measured (share "
            f"{max(row['compute_s'], row['memory_s']) / step_s:.2%}); flash "
            f"launches {real['launches']}; traces {c['trace_s']:.2f} s")
        if label == "prefill":
            n_flash = real["launches"]
        if not (round(arg) == real["arg"] and full["flops"] == real["flops"]
                and peak_err <= DRYRUN_PEAK_TOL
                and row["flops"] == af["flops"]
                and abs(row["bytes"] - af["bytes"]) <= 1e-9 * af["bytes"]):
            bad.append(("world of one", label))
    if n_flash != 24:
        bad.append(("prefill flash launches", n_flash))
    sc = streams.get_scenario("stock")
    ecfg = runner.default_config(pat.compile_patterns(sc.specs()),
                                 max_pms=256, block_events=W_BLOCK)
    bi = RF.engine_block_intensity(ecfg)
    measured = (f"{block_record['bytes_per_event']:.1f} B per event (the "
                "kernels phase's bound bytes of its stock block / W)"
                if block_record and "bytes_per_event" in block_record
                else "not measured in this run")
    log("dryrun", f"CEP block (stock, P={ecfg.num_patterns} "
        f"N={ecfg.max_pms} W={ecfg.block_events}): analytic "
        f"{bi['bytes_per_event_fused']:.1f} B per event fused, "
        f"{bi['bytes_per_event_unfused']:.1f} unfused, intensity fused "
        f"{bi['intensity_fused']:.3f} FLOP/B; measured {measured}")
    secs = time.perf_counter() - t_phase
    log("dryrun", f"child {got['child_s']:.2f} s ({got['jobs']} traces, "
        f"{got['job_s']:.2f} s of worker time on {DRYRUN_WORKERS} "
        f"processes; the real runs {got['real_s']:.2f} s); the phase took {secs:.2f} s of its "
        f"{DRYRUN_BUDGET_S:.0f} s budget "
        f"({'within' if secs <= DRYRUN_BUDGET_S else 'OVER'} it)")
    if bad:
        raise AssertionError(f"dry-run checks failed: {bad}")
    return {"flash_attention": {"dryrun_launches": n_flash}}


EXAMPLES = ("torch_quickstart", "torch_runtime_multitenant",
            "torch_serve_slo", "torch_train_lm")
EXAMPLES_BUDGET_S = 30.0


def phase_examples(torch, np) -> dict:
    """The port's four examples (examples/torch_*.py) in this process,
    each ``main([])`` at its default size on the card; logs each one's
    table, seconds and launches.  Gates: the quickstart's FN finite for
    every shedder and the block kernel launched; the runtime example's
    lane grid launched and every tenant refreshed; the serving example's
    three policies each finishing requests; the training example's kept
    losses finite, its NaN step restoring the step-20 checkpoint and its
    second run resuming at step 60, through the flash kernel.  Returns the
    block kernels' launches."""
    import contextlib
    import importlib
    import io
    import re

    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels import ops as kops

    sys.path.insert(0, str(ROOT / "examples"))
    t_phase = time.perf_counter()
    launches: dict = {}
    for name in EXAMPLES:
        mod = importlib.import_module(name)
        torch.cuda.synchronize()
        kops.reset_launch_counts()
        _reset_flash_counts(kfa)
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = mod.main([])
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        out = buf.getvalue()
        counts = kops.launch_counts()
        flash = kfa.flash_attention.launches
        lines = out.splitlines()
        if name == "torch_train_lm":
            losses = [float(x) for x in re.findall(
                r"\[train\] step +\d+ loss (\S+)", out)]
            shown = [ln for ln in lines if re.search(
                r"phase|restor|resum|first5|NON-FINITE", ln)]
            ok = (rc == 0 and len(losses) == 79
                  and all(math.isfinite(x) for x in losses)
                  and "restored step 20" in out
                  and "resuming from checkpoint step 60" in out
                  and flash > 0)
            shown.append(f"{len(losses)} kept steps, losses "
                         f"{losses[0]:.4f} .. {losses[-1]:.4f}")
        else:
            shown = [ln for ln in lines if ln.strip()]
            if name == "torch_quickstart":
                fns = [float(m) for m in re.findall(
                    r"^(?:pspice|pmbl|ebl) +(\S+)%", out, re.M)]
                ok = rc == 0 and len(fns) == 3 and all(
                    math.isfinite(x) for x in fns) and counts["block_step"]
            elif name == "torch_runtime_multitenant":
                refreshes = re.search(r"per-tenant refreshes: +\[(.*)\]",
                                      out)
                ok = rc == 0 and counts["block_step_lanes"] > 0 and \
                    refreshes is not None and all(
                        int(x) > 0 for x in refreshes.group(1).split(","))
            else:
                done = [int(m) for m in re.findall(
                    r"^(?:pspice|random|admission) +\S+ +(\d+)", out,
                    re.M)]
                ok = rc == 0 and len(done) == 3 and min(done) > 0
        for ln in shown:
            log("examples", f"{name}: {ln}")
        log("examples", f"{name}: {secs:.2f} s on the card; launches "
            f"{counts}, flash {flash} (bf16 {kfa.flash_attention.sm90_launches})")
        if not ok:
            raise AssertionError(f"example {name} failed its gates "
                                 f"(rc {rc}); its output:\n{out[-3000:]}")
        for k in ("block_step", "block_step_lanes"):
            launches[k] = launches.get(k, 0) + counts[k]
    secs = time.perf_counter() - t_phase
    log("examples", f"the phase took {secs:.2f} s of its "
        f"{EXAMPLES_BUDGET_S:.0f} s budget "
        f"({'within' if secs <= EXAMPLES_BUDGET_S else 'OVER'} it)")
    return {k: {"examples_launches": v} for k, v in launches.items()}


def phase_analysis() -> None:
    """The contract checker over the whole grid and the full-width cells
    on the card; logs each rule's pass count, the full-width cells'
    host reads per event, block launches per block, temp and gather bytes
    against their budgets, and each kernel's registers, spills and shared
    memory.  A FAIL raises."""
    from repro_torch.analysis.driver import check_all
    res = check_all(quick=False, device="cuda",
                    out=str(ROOT / "build" / "analysis_port.json"))
    by_rule: dict = {}
    for row in res["rows"]:
        ok, n = by_rule.get(row["rule"], (0, 0))
        by_rule[row["rule"]] = (ok + (row["status"] == "pass"), n + 1)
    log("analysis", f"{res['cells']} cells, {len(res['rows'])} findings, "
        f"{res['n_fail']} failures; passes by rule: " + ", ".join(
            f"{k} {ok}/{n}" for k, (ok, n) in sorted(by_rule.items())))

    def of(budget) -> str:
        return "(no budget)" if budget is None else f"of {budget} B"

    for name, s in res["summary"].items():
        if "stock" not in name:
            continue
        log("analysis", f"{name}: {s['events']} events, "
            f"{s['syncs_per_event']:.4f} host reads/event, "
            f"{s['block_launches_per_block']:.4f} block launches/block, "
            f"temp {s['temp_bytes']} B {of(s['temp_budget'])}, largest "
            f"gather {s['gather_bytes']} B {of(s['gather_budget'])}")
    for row in res["rows"]:
        if row["rule"] in ("kernel-regs", "kernel-smem", "kernel-grid",
                           "kernel-sass") and ("stock" in row["cell"] or
                                               row["cell"] == "kernels[build]"):
            log("analysis", f"{row['rule']} {row['cell']}: "
                f"{row['evidence'][:220]}")
    launches: dict = {}
    for s in res["summary"].values():
        for k, n in s["launches"].items():
            launches[k] = launches.get(k, 0) + n
    log("analysis", f"kernel launches over the sweep: {launches}")
    bad = [r for r in res["rows"] if r["status"] != "pass"]
    for r in bad:
        log("analysis", f"FAIL {r['rule']} {r['cell']}: {r['evidence']}")
    if bad:
        raise AssertionError(f"contract checker: {len(bad)} failures")
    idle = [k for k in ("nfa_advance", "utility_lookup", "utility_histogram",
                        "block_step", "block_step_lanes") if not launches[k]]
    if idle:
        raise AssertionError(f"the sweep launched no {idle}: its rules "
                             "judged no launch of them")


def phase_build_report(_build, build_log: str) -> None:
    """ptxas's registers, spills and static shared memory of the block
    kernel's two instantiations (the store in shared or in device
    memory), of the bf16 flash kernel's instances and of the probe, and
    any ptxas advisory about the flash kernel.  A spill in the flash
    kernel fails the phase."""
    from repro_torch.analysis.kernel_rules import ptxas_report
    for name, regs, st, ld, smem in ptxas_report(build_log,
                                                 "block_step_kernel"):
        store = "shared" if "ILb1E" in name else "global"
        log("build", f"ptxas block_step_kernel<{store} store> ({name}): "
            f"{regs} registers, spill stores {st} B, spill loads {ld} B, "
            f"static smem {smem} B (dynamic smem per launch: the kernels "
            "phase)")
    for name, regs, st, ld, smem in ptxas_report(
            build_log, "flash_attention_sm90_kernel") + ptxas_report(
            build_log, "wgmma_probe_kernel"):
        log("build", f"ptxas {name}: {regs} registers, spill stores {st} "
            f"B, spill loads {ld} B, static smem {smem} B")
        if "flash_attention_sm90_kernel" in name and (st or ld):
            raise AssertionError(f"{name} spills ({st} B stored, {ld} B "
                                 "loaded)")
    sec = build_log.split("== flash_attention_sm90.cu", 1)[-1]
    for line in sec.splitlines():
        if "C75" in line or "setmaxnreg" in line:
            log("build", f"ptxas advisory: {line.strip()[:200]}")
    if _build.build_seconds is not None:
        log("build", f"nvcc wall time of this build {_build.build_seconds:.2f}"
            " s (every source in parallel)")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help=f"comma-separated subset of {PHASES}")
    ap.add_argument("--dryrun-child", default=None, metavar="PATH",
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    phases = args.phases.split(",")

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    try:
        import repro_torch  # noqa: F401
        from repro_torch.kernels import _build
    except ImportError as e:
        print(f"chip_smoke: the repro_torch package is missing next to "
              f"this script ({e})", file=sys.stderr)
        return 2
    if args.dryrun_child:
        return dryrun_child(args.dryrun_child)
    t_all = time.perf_counter()
    smi = smi_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("card", f"{smi}; torch {torch.__version__} CUDA "
        f"{torch.version.cuda}; devices {torch.cuda.device_count()}; "
        f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")

    t0 = time.perf_counter()
    _build.load()
    log("build", f"kernels built and loaded in {time.perf_counter() - t0:.2f}"
        f" s ({_build.build_dir()})")
    build_log = (_build.build().parent / "build.log").read_text()
    for line in build_log.splitlines():
        if "registers" in line or "spill" in line:
            log("build", line.strip())
    phase_build_report(_build, build_log)

    record = {}
    timings = {}
    shared = {}          # the train phase's losses, the mesh phase's reference
    for phase, fn in (("analysis", phase_analysis),
                      ("kernels", lambda: phase_kernels(torch, np)),
                      ("parity", lambda: phase_parity(torch, np)),
                      ("main", lambda: phase_main(torch)),
                      ("quality", lambda: phase_quality(torch, np)),
                      ("runtime", lambda: phase_runtime(torch, np)),
                      ("resilience", lambda: phase_resilience(torch, np)),
                      ("recovery", lambda: phase_recovery(torch, np)),
                      ("dist", lambda: phase_dist(torch, np)),
                      ("profile", lambda: [phase_profile(torch, b) for b in
                                           ("cuda", "cuda_block")]),
                      ("model", lambda: phase_model(torch, np)),
                      ("moe", lambda: phase_moe(torch, np)),
                      ("ssm", lambda: phase_ssm(torch, np)),
                      ("encdec", lambda: phase_encdec(torch, np)),
                      ("train", lambda: phase_train(torch, np, shared)),
                      ("mesh", lambda: phase_mesh(
                          torch, np, shared.get("train_losses"))),
                      ("dryrun", lambda: phase_dryrun(
                          torch, np, record.get("block_step"))),
                      ("examples", lambda: phase_examples(torch, np))):
        if phase not in phases:
            continue
        t0 = time.perf_counter()
        out = fn()
        timings[phase] = time.perf_counter() - t0
        log(phase, f"phase done in {timings[phase]:.2f} s")
        if phase == "kernels":
            record = out
        if phase in ("main", "runtime", "resilience", "dist", "model",
                     "moe", "ssm", "encdec", "train", "mesh", "dryrun",
                     "examples"):
            for name, n in out.items():
                if isinstance(n, dict):
                    record.setdefault(name, {}).update(n)
                else:
                    record.setdefault(name, {})["launches"] = n
        if phase == "quality":
            for name, n in out.items():
                record.setdefault(name, {})["quality_launches"] = n
    log("total", f"{time.perf_counter() - t_all:.2f} s; phases {timings}")

    kernels = []
    for name, (source, replaces) in KERNEL_META.items():
        r = record.get(name, {})
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=r.get("launches", 0), max_abs_err=r.get("max_abs_err"),
            ms=r.get("ms"), plain_ms=r.get("plain_ms"),
            bound_ms=r.get("bound_ms"), bound_by=r.get("bound_by", "bytes"),
            library_ms=r.get("library_ms")))
        for extra in ("us_per_event", "call_ms", "host_us_per_launch",
                      "store", "smem_bytes", "lanes", "ms_by_lanes",
                      "bound_ms_by_lanes", "quality_launches", "device_us",
                      "launch_floor_us", "launch_floor_device_us",
                      "lanes_ms", "lanes_plain_ms", "lanes_bound_ms",
                      "lanes_device_us", "kernel_device_us",
                      "lanes_kernel_device_us",
                      "trim_ms", "trim_lane_by_lane_ms", "trim_launches",
                      "trim_lane_by_lane_launches", "dist_launches",
                      "moe_launches", "tflops", "train_launches",
                      "mesh_launches",
                      "dryrun_launches", "examples_launches",
                      "bytes_per_event",
                      "cross_ms", "cross_plain_ms", "cross_bound_ms",
                      "cross_bound_by", "cross_library_ms",
                      "cross_device_us", "cross_tflops"):
            if extra in r:
                kernels[-1][extra] = r[extra]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
