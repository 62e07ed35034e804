"""Experiment runner: the full pSPICE lifecycle (paper §IV methodology).

Port of ``repro.cep.runner``:
  1. WARM-UP at a sustainable rate with statistic gathering on;
  2. MODEL BUILD: transition and reward matrices, MRP value iteration,
     utility tables, latency regressions f (from the gathered samples)
     and g;
  3. MAX-THROUGHPUT from the fitted f at the warm steady-state PM count;
  4. OVERLOAD RUN at rate = multiplier × max throughput per shedder, vs
     a no-shed GROUND-TRUTH run on the identical stream.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Sequence

import numpy as np
import torch

from repro_torch.cep import engine as eng
from repro_torch.cep import patterns as pat
from repro_torch.core import markov, overload as ovl, utility as util
from repro_torch.data import streams
from repro_torch.device import resolve_device
from repro_torch.eval import quality as Q


@dataclasses.dataclass
class BuiltModel:
    """Everything the model builder produces."""
    T: list                   # per-pattern transition matrices
    R: list                   # per-pattern reward matrices
    tables: list              # per-pattern UtilityTable
    ut_stacked: torch.Tensor  # (P, B, M) float32
    ut_bins: torch.Tensor     # (P,) int32
    f_model: ovl.LatencyModel
    g_model: ovl.LatencyModel
    max_rate: float           # max operator throughput (events/s)
    steady_n_pm: float


def default_config(cp: pat.CompiledPatterns, **kw) -> eng.EngineConfig:
    """Engine config with the static pattern census filled in.

    ``backend`` selects the hot-path implementation: plain PyTorch ops
    ("torch"), the per-event CUDA kernels ("cuda"), or the event-block
    megakernel ("cuda_block", with ``block_events=W`` events fused per
    launch) — all bitwise-equivalent, so experiments may pick purely on
    speed.  Unknown backends and bad block sizes fail here
    (``EngineConfig.__post_init__``), never as a silent fallback."""
    kind, sm = np.asarray(cp.kind), np.asarray(cp.spawn_mode)
    base = dict(
        num_patterns=cp.num_patterns,
        max_states=cp.max_states,
        max_classes=cp.trans.shape[2] - 1,
        max_pms=2048,
        max_any_ids=max(8, int(cp.final_state.max()) + 1),
        ring_size=8,
        kinds=("seq" if (kind == pat.KIND_SEQ).all()
               else "any" if (kind == pat.KIND_ANY).all() else "mixed"),
        spawn_modes=("at_open" if (sm == pat.SPAWN_AT_OPEN).all()
                     else "in_windows" if (sm == pat.SPAWN_IN_WINDOWS).all()
                     else "mixed"),
    )
    base.update(kw)
    return eng.EngineConfig(**base)


def build_model(specs: Sequence[pat.PatternSpec], cfg: eng.EngineConfig,
                warm_events: eng.EventBatch, bin_size: int = 64,
                use_remaining_time: bool = True, seed: int = 0,
                device=None) -> BuiltModel:
    """Phase 1+2: warm-up run with stats on, then build everything."""
    dev = resolve_device(device)
    cp = pat.compile_patterns(specs)
    warm_cfg = dataclasses.replace(cfg, gather_stats=True,
                                   shedder=eng.SHED_NONE,
                                   emit_matches=False)
    model0 = eng.make_model(cp, warm_cfg, device=dev)
    carry = eng.init_carry(warm_cfg, seed=seed, device=dev)
    carry, outs = eng.run_engine(warm_cfg, model0, warm_events, carry,
                                 device=dev)

    Ts, Rs, tables = [], [], []
    for p, spec in enumerate(specs):
        m = spec.num_states
        stats = markov.TransitionStats(
            counts=carry.obs_counts[p, :m, :m],
            reward_sum=carry.obs_rewards[p, :m, :m])
        T = markov.estimate_transition_matrix(stats)
        R = markov.estimate_reward_matrix(
            stats, default_reward=cfg.c_match * float(spec.proc_cost))
        Ts.append(T)
        Rs.append(R)
        tables.append(util.build_utility_table(
            T, R, window_size=spec.window_size, bin_size=bin_size,
            weight=spec.weight, use_remaining_time=use_remaining_time))
    ut_stacked, ut_bins = util.stack_tables(tables,
                                            max_states=cp.max_states)

    S = carry.lat_samples_n.shape[0]
    n_valid = min(int(carry.lat_ptr.item()), S)
    valid = torch.arange(S, device=dev) < n_valid
    f_model = ovl.fit_latency_model(carry.lat_samples_n,
                                    carry.lat_samples_l, valid)
    # g from the simulator's calibrated shed-cost constants (the warm run
    # never sheds, so it has no shed samples to fit).
    g_model = ovl.latency_model(cfg.c_shed_pm, cfg.c_shed_base, ovl.LINEAR,
                                dev)

    # Max throughput at the warm steady state: 1 / E[t_proc].
    n_tail = max(1, warm_events.ev_class.shape[0] // 2)
    steady_n_pm = float(outs.n_pm.cpu().numpy()[-n_tail:].mean())
    t_proc = float(ovl.predict_latency_unfused(
        f_model, torch.tensor(steady_n_pm, dtype=torch.float32,
                              device=dev)))
    max_rate = 1.0 / max(t_proc, 1e-9)
    return BuiltModel(T=Ts, R=Rs, tables=tables, ut_stacked=ut_stacked,
                      ut_bins=ut_bins, f_model=f_model, g_model=g_model,
                      max_rate=max_rate, steady_n_pm=steady_n_pm)


def run_with_shedder(specs: Sequence[pat.PatternSpec],
                     cfg: eng.EngineConfig, built: BuiltModel,
                     raw: streams.RawStream, rate: float, shedder: str,
                     seed: int = 0, pattern_parallel: bool = False,
                     mesh=None, device=None) -> eng.RunResult:
    """One overload run of ``shedder`` at ``rate``.  With
    ``pattern_parallel`` the PM store is sharded on its pattern axis over
    ``mesh`` (default: the world of ranks, one rank without a process
    group; ``repro_torch.dist.run_engine_sharded``)."""
    dev = resolve_device(device)
    cp = pat.compile_patterns(specs)
    run_cfg = dataclasses.replace(cfg, gather_stats=False, shedder=shedder)
    events = streams.classify(specs, raw, rate=rate, seed=seed, device=dev)
    model = eng.make_model(cp, run_cfg, ut_tables=built.ut_stacked,
                           ut_bins=built.ut_bins, f_model=built.f_model,
                           g_model=built.g_model,
                           ebl_raw_mean=float(
                               events.ebl_raw.cpu().numpy().mean()),
                           device=dev)
    carry = eng.init_carry(run_cfg, seed=seed, device=dev)
    if pattern_parallel:
        # Pattern-parallel scale-out: shard the (P, N) PM store over the
        # mesh (repro_torch.dist.sharding.pm_specs).
        from repro_torch.dist import sharding as SH
        carry, outs = SH.run_engine_sharded(run_cfg, model, events, carry,
                                            mesh=mesh, device=dev)
    else:
        carry, outs = eng.run_engine(run_cfg, model, events, carry,
                                     device=dev)
    return eng.summarize(carry, outs)


@dataclasses.dataclass
class ExperimentResult:
    shedder: str
    fn: float                 # weighted false-negative fraction (counts)
    match_probability: float  # ground-truth match probability
    max_rate: float
    result: eng.RunResult
    ground_truth: eng.RunResult
    latency_bound: float = 1.0
    recall: float | None = None        # weighted |found ∩ gt| / |gt|
    fn_match: float | None = None      # 1 - recall
    per_pattern_fn: np.ndarray | None = None   # (P,)
    n_gt_matches: int = 0
    n_found_matches: int = 0
    seconds: float = 0.0      # wall time of this shedder's run
    built: BuiltModel | None = None    # the model the run used

    @property
    def lb_violations(self) -> float:
        """Fraction of events whose latency exceeded the bound."""
        l_e = np.asarray(self.result.l_e)
        if l_e.size == 0:
            return 0.0
        return float((l_e > self.latency_bound).mean())

    @property
    def lb_compliance(self) -> float:
        """Fraction of events whose latency met the bound."""
        return Q.latency_compliance(self.result.l_e, self.latency_bound)


def run_experiment(specs: Sequence[pat.PatternSpec], raw: streams.RawStream,
                   shedders: Sequence[str] = (eng.SHED_PSPICE, eng.SHED_PMBL,
                                              eng.SHED_EBL),
                   rate_multiplier: float = 1.2,
                   warm_frac: float = 0.3, latency_bound: float = 1.0,
                   bin_size: int = 64, max_pms: int = 2048,
                   use_remaining_time: bool = True,
                   seed: int = 0, pattern_parallel: bool = False,
                   emit_matches: bool = True, mesh=None, device=None,
                   **cfg_kw) -> dict[str, ExperimentResult]:
    """The full paper methodology on one stream; per-shedder results with
    count-based ``fn`` and (``emit_matches``) match-set recall/fn_match.
    ``cfg_kw`` reaches ``default_config``: e.g. ``backend="cuda_block"``
    with ``block_events=32`` runs the warm-up, the ground truth and every
    shedder run through the block kernel.  With ``pattern_parallel`` the
    ground truth and every shedder run shard the PM store over ``mesh``
    (see ``run_with_shedder``); the warm-up and the model build stay
    unsharded."""
    dev = resolve_device(device)
    cp = pat.compile_patterns(specs)
    cfg = default_config(cp, latency_bound=latency_bound, max_pms=max_pms,
                         emit_matches=emit_matches, **cfg_kw)

    n_warm = int(raw.n * warm_frac)
    raw_warm = dataclasses.replace(
        raw, n=n_warm, type_id=raw.type_id[:n_warm], attr=raw.attr[:n_warm],
        group=raw.group[:n_warm])
    raw_run = dataclasses.replace(
        raw, n=raw.n - n_warm, type_id=raw.type_id[n_warm:],
        attr=raw.attr[n_warm:], group=raw.group[n_warm:])

    warm_events = streams.classify(specs, raw_warm, rate=1.0, seed=seed,
                                   device=dev)
    built = build_model(specs, cfg, warm_events, bin_size=bin_size,
                        use_remaining_time=use_remaining_time, seed=seed,
                        device=dev)
    return run_shedders(specs, cfg, built, raw_run, shedders,
                        rate=built.max_rate * rate_multiplier, seed=seed,
                        latency_bound=latency_bound,
                        pattern_parallel=pattern_parallel, mesh=mesh,
                        device=dev)


def run_shedders(specs, cfg: eng.EngineConfig, built: BuiltModel,
                 raw_run: streams.RawStream, shedders: Sequence[str],
                 rate: float, seed: int, latency_bound: float,
                 pattern_parallel: bool = False, mesh=None,
                 device=None) -> dict[str, ExperimentResult]:
    """Steps 3-4 of ``run_experiment`` on a given model: the ground-truth
    run, then one run per shedder, each compared with it."""
    par = dict(pattern_parallel=pattern_parallel, mesh=mesh, device=device)
    gt = run_with_shedder(specs, cfg, built, raw_run, rate=rate,
                          shedder=eng.SHED_NONE, seed=seed, **par)
    weights = np.array([s.weight for s in specs])
    out = {}
    for sh in shedders:
        t0 = time.perf_counter()
        res = run_with_shedder(specs, cfg, built, raw_run, rate=rate,
                               shedder=sh, seed=seed, **par)
        seconds = time.perf_counter() - t0     # summarize synced the device
        er = ExperimentResult(
            shedder=sh, fn=res.false_negatives(gt, weights),
            match_probability=float(
                gt.complex_count.sum() / max(gt.pms_created.sum(), 1.0)),
            max_rate=built.max_rate, result=res, ground_truth=gt,
            latency_bound=latency_bound, seconds=seconds, built=built)
        if res.matches is not None and gt.matches is not None:
            rep = Q.compare_match_sets(res.matches, gt.matches, weights)
            er.recall = rep.recall
            er.fn_match = rep.fn_ratio
            er.per_pattern_fn = rep.per_pattern_fn
            er.n_gt_matches = rep.n_gt
            er.n_found_matches = rep.n_found
        out[sh] = er
    return out
