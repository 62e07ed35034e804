"""SLO-bounded continuous-batching scheduler with pSPICE eviction.

The paper's control loop (§III) transplanted onto LLM decoding:

  CEP concept              serving concept
  ----------------------   -------------------------------------------
  partial match (PM)       in-flight decode sequence (KV slot)
  PM state  s_i            progress bucket (tokens decoded / bucket_sz)
  events left in window    decode steps left in the request's deadline
  completion probability   P(sequence reaches EOS before its deadline),
                           from a Markov chain over progress buckets whose
                           absorbing state is EOS (learned online from
                           observed EOS hazards)
  remaining proc. time     expected remaining decode-step cost (Markov
                           reward process; reward = measured step cost,
                           which grows with the active batch)
  l_p = f(n_pm)            measured batch-step latency vs active slots
  utility U = w·P/tau      same formula, same min-max scaling
  Alg.1 overload detector  queue-delay + step-latency SLO check
  Alg.2 shedder            evict lowest-utility sequences (free KV slots)

Eviction baselines mirror the paper's: random eviction (PM-BL) and
admission-only throttling (E-BL analog: refuse new requests, never evict).

The scheduler is simulation-friendly (deterministic virtual time driven by a
per-step cost model calibrated from the real decode_step wall-clock).

Port of ``repro.serving.scheduler``: the model builder's Markov chain,
utility table and latency fit go through ``repro_torch.core`` on
``device`` (None = CUDA, as every entry point of the port); everything
else is the reference's NumPy and Python, unchanged.
"""
from __future__ import annotations

import dataclasses

import numpy as np

import torch

from repro_torch.core import markov as MK
from repro_torch.core import overload as OV
from repro_torch.core import utility as UT
from repro_torch.device import resolve_device


@dataclasses.dataclass
class Request:
    req_id: int
    arrival: float
    deadline: float           # absolute SLO deadline
    true_length: int          # tokens until EOS (hidden ground truth)
    weight: float = 1.0
    decoded: int = 0
    done: bool = False
    evicted: bool = False
    finish_time: float = -1.0


@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    max_slots: int = 64               # KV capacity (the PM store)
    bucket_size: int = 32             # tokens per progress bucket
    num_buckets: int = 16             # states incl. absorbing EOS
    step_cost_base: float = 2e-3      # s per decode step
    step_cost_per_seq: float = 2e-4   # s per active sequence per step
    slo: float = 2.0                  # seconds from arrival to completion
    policy: str = "pspice"            # pspice | random | admission
    safety_buffer: float = 0.0
    seed: int = 0


class PSpiceScheduler:
    """Virtual-time continuous batcher with utility-driven eviction."""

    def __init__(self, cfg: SchedulerConfig, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.time = 0.0
        self.active: list[Request] = []
        self.queue: list[Request] = []
        self.finished: list[Request] = []
        m = cfg.num_buckets
        self._counts = np.zeros((m, m))
        self._rewards = np.zeros((m, m))
        self.ut: UT.UtilityTable | None = None
        self._ut_np: np.ndarray | None = None
        self.rng = np.random.default_rng(cfg.seed)
        # latency model f(n_active) — the true cost model is linear; the
        # scheduler LEARNS it from observed step samples like the paper's f.
        self._lat_samples: list[tuple[int, float]] = []
        self.f_model: OV.LatencyModel | None = None
        self.evictions = 0

    # -- model building (the paper's model builder) -----------------------
    def _observe(self, s: int, s_next: int, t: float) -> None:
        self._counts[s, s_next] += 1
        self._rewards[s, s_next] += t

    def build_model(self) -> None:
        m = self.cfg.num_buckets
        f32 = dict(dtype=torch.float32, device=self.device)
        stats = MK.TransitionStats(counts=torch.as_tensor(self._counts, **f32),
                                   reward_sum=torch.as_tensor(self._rewards,
                                                              **f32))
        T = MK.estimate_transition_matrix(stats)
        R = MK.estimate_reward_matrix(
            stats, default_reward=self.cfg.step_cost_per_seq)
        # "window size" = max decode steps within the SLO at nominal cost
        ws = max(2 * self.cfg.bucket_size * m, 64)
        self.ut = UT.build_utility_table(T, R, window_size=ws,
                                         bin_size=self.cfg.bucket_size)
        self._ut_np = self.ut.table.cpu().numpy()
        if len(self._lat_samples) >= 8:
            n = torch.tensor([s[0] for s in self._lat_samples], **f32)
            lt = torch.tensor([s[1] for s in self._lat_samples], **f32)
            self.f_model = OV.fit_latency_model(n, lt)

    # -- utility ------------------------------------------------------------
    def _bucket(self, r: Request) -> int:
        return min(r.decoded // self.cfg.bucket_size,
                   self.cfg.num_buckets - 2)

    def _utility(self, r: Request) -> float:
        if self._ut_np is None:
            return 1.0
        steps_left = max(1.0, (r.deadline - self.time)
                         / self._step_cost(len(self.active)))
        tab = self._ut_np
        pos = np.clip(steps_left / self.ut.bin_size - 1.0, 0.0,
                      tab.shape[0] - 1.0)
        j0 = int(pos)
        j1 = min(j0 + 1, tab.shape[0] - 1)
        fr = pos - j0
        s = self._bucket(r)
        return float(tab[j0, s] * (1 - fr) + tab[j1, s] * fr) * r.weight

    # -- dynamics -------------------------------------------------------------
    def _step_cost(self, n_active: int) -> float:
        return self.cfg.step_cost_base \
            + self.cfg.step_cost_per_seq * n_active

    def submit(self, req: Request) -> None:
        self.queue.append(req)

    def _admit(self) -> None:
        while self.queue and len(self.active) < self.cfg.max_slots:
            r = self.queue.pop(0)
            if self.cfg.policy == "admission" and self._overloaded():
                # E-BL analog: refuse under overload (black-box input drop)
                r.evicted = True
                self.finished.append(r)
                continue
            self.active.append(r)

    def _overloaded(self) -> bool:
        cost = self._step_cost(len(self.active))
        worst = max((self.time + cost - (r.deadline - self.cfg.slo)
                     for r in self.active), default=0.0)
        return worst + cost > self.cfg.slo

    def _maybe_evict(self) -> None:
        """Alg. 1 + Alg. 2: if the projected step latency endangers the
        tightest deadline, evict lowest-utility sequences until the
        remaining batch is sustainable."""
        if self.cfg.policy == "admission" or not self.active:
            return
        while self.active:
            cost = self._step_cost(len(self.active))
            slack = min(r.deadline - self.time for r in self.active)
            # steps needed for the most-advanced request to finish
            if cost <= slack / max(1.0, self._min_steps_left()) \
               + self.cfg.safety_buffer:
                break
            # rho = 1 per iteration (incremental trim, same fixed point as
            # the paper's f^{-1} computation for a linear f)
            if self.cfg.policy == "pspice":
                victim = min(self.active, key=self._utility)
            else:  # random (PM-BL)
                victim = self.active[self.rng.integers(len(self.active))]
            self.active.remove(victim)
            victim.evicted = True
            victim.finish_time = self.time
            self.finished.append(victim)
            self.evictions += 1

    def _min_steps_left(self) -> float:
        return float(min((r.true_length - r.decoded for r in self.active),
                         default=1))

    def run_step(self) -> None:
        """One batched decode step in virtual time."""
        self._admit()
        self._maybe_evict()
        n = len(self.active)
        if n == 0:
            self.time += self.cfg.step_cost_base
            return
        cost = self._step_cost(n)
        self._lat_samples.append((n, cost))
        self.time += cost
        still = []
        for r in self.active:
            s = self._bucket(r)
            r.decoded += 1
            if r.decoded >= r.true_length:
                r.done = True
                r.finish_time = self.time
                self.finished.append(r)
                self._observe(s, self.cfg.num_buckets - 1,
                              self.cfg.step_cost_per_seq)
            else:
                self._observe(s, self._bucket(r),
                              self.cfg.step_cost_per_seq)
                still.append(r)
        self.active = still

    # -- metrics ----------------------------------------------------------
    def metrics(self) -> dict:
        # One linear pass: classify each request once (the SLO-miss test is
        # a predicate, not a membership scan over the in-SLO list).
        n_done = n_ev = n_slo = 0
        w_total = w_miss = 0.0
        for r in self.finished:
            hit = r.done and r.finish_time <= r.deadline
            n_done += r.done
            n_ev += r.evicted
            n_slo += hit
            w_total += r.weight
            if not hit:
                w_miss += r.weight
        total = len(self.finished)
        return {
            "completed": n_done,
            "evicted": n_ev,
            "in_slo": n_slo,
            "goodput": n_slo / max(total, 1),
            "weighted_miss": w_miss / max(w_total, 1e-9),
            "evictions": self.evictions,
        }


def synth_workload(n: int, rate: float, cfg: SchedulerConfig,
                   seed: int = 0) -> list[Request]:
    """Poisson arrivals; output lengths ~ mixture (short chats + long
    generations) so completion probability varies with progress bucket."""
    rng = np.random.default_rng(seed)
    t = np.cumsum(rng.exponential(1.0 / rate, n))
    short = rng.geometric(1 / 40.0, n)
    long_ = 200 + rng.geometric(1 / 200.0, n)
    lens = np.where(rng.random(n) < 0.7, short, long_)
    return [Request(req_id=i, arrival=float(t[i]),
                    deadline=float(t[i]) + cfg.slo,
                    true_length=int(max(2, lens[i])))
            for i in range(n)]


def run_simulation(cfg: SchedulerConfig, requests: list[Request],
                   warmup_frac: float = 0.3, device=None) -> dict:
    sched = PSpiceScheduler(cfg, device=device)
    reqs = sorted(requests, key=lambda r: r.arrival)
    i = 0
    n_warm = int(len(reqs) * warmup_frac)
    while len(sched.finished) < len(reqs):
        while i < len(reqs) and reqs[i].arrival <= sched.time:
            sched.submit(reqs[i])
            i += 1
        if i == n_warm and sched.ut is None:
            sched.build_model()
        if not sched.active and not sched.queue and i < len(reqs):
            sched.time = max(sched.time, reqs[i].arrival)
            continue
        sched.run_step()
        if sched.ut is None and len(sched.finished) >= n_warm:
            sched.build_model()
    return sched.metrics()
