"""Vectorized CEP operator with pSPICE load shedding (paper §III).

Port of ``repro.cep.engine`` (the per-event engine).  The operator keeps a
fixed-capacity dense PM store per pattern on the device and advances
EVERY active PM against each incoming event in one vectorized step.
Latency is a deterministic simulated-time model.

Per event step (order matters, mirrors the paper's operator):
  1. expire PMs whose window closed,
  2. overload check (Alg. 1) → optional shed (Alg. 2 / PM-BL),
  3. E-BL input-drop decision (black-box baseline only),
  4. advance PMs (SEQ table lookup / ANY distinct count), completions,
  5. spawn PMs (window-open events / slide-window ring),
  6. gather <q, s, s', t> observations (model-building phase),
  7. advance simulated time, record latency telemetry.

Where the reference scans events inside one XLA program, the port runs a
Python loop over events.  The PM store, ring and counters stay on the
device; the operator's scalar control state (simulated clock, EMA gap,
E-BL fraction, shed counters, latency ring, PRNG key) is float32 on the
host, where Algorithm 1 and E-BL decide.  Each event reads the store's
per-pattern active counts once (one host sync; a fired shed adds a
second), and every float32 operation rounds as the reference's does —
``fp.fma32`` wherever XLA fuses a multiply into an add — so the carry and
every ``StepOut`` equal the reference bit for bit.

Backends: ``"torch"`` (plain PyTorch ops; counterpart of ``xla``),
``"cuda"`` (counterpart of ``pallas``: the SEQ advance, the utility
lookup and the shed histogram go through the hand-written kernels of
``repro_torch.kernels``) and ``"cuda_block"`` (counterpart of
``pallas_block``: one launch of the event-block megakernel,
``kernels/block_step.py``, per ``block_events`` events, with the whole
operator state on the device and no host sync inside a block; on CPU
tensors it runs the kernel's plain version).

Lanes (the multi-tenant runtime's, ``repro_torch.runtime.lanes``): L
independent operators with lane-stacked models, carries and events
advance in lockstep.  The per-event loop is written over lanes — the
single-lane engine is its one-lane case — with its device half run once
over the L·P pattern rows; on "cuda_block" each W-event block is one
launch of the block kernel's lane instance, one CTA per lane.
``merge_carries`` folds the lanes into one L·P-pattern carry.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from repro_torch import fp, prng, spans
from repro_torch.analysis import contracts as ctr
from repro_torch.cep import patterns as pat
from repro_torch.core import overload as ovl
from repro_torch.core import shedder as shd
from repro_torch.device import check_on, resolve_device
from repro_torch.kernels import block_step as kblock
from repro_torch.kernels import ops as kops
from repro_torch.kernels import tiling as ktile

F32 = fp.F32

SHED_NONE, SHED_PSPICE, SHED_PMBL, SHED_EBL = "none", "pspice", "pmbl", "ebl"

BACKEND_TORCH, BACKEND_CUDA = "torch", "cuda"
BACKEND_CUDA_BLOCK = "cuda_block"
BACKENDS = (BACKEND_TORCH, BACKEND_CUDA, BACKEND_CUDA_BLOCK)
# Backends whose between-event shed (the ladder's PM trim, the replay of
# a fire) routes through the kernels, as the reference's pallas and
# pallas_block do: their utility lookup rounds as the kernel does.
_KERNEL_BACKENDS = (BACKEND_CUDA, BACKEND_CUDA_BLOCK)

# Host syncs made by the event loop (device→host reads), for telemetry.
host_syncs = 0


# ---------------------------------------------------------------------------
# Configuration
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Static engine configuration (same fields as the reference's)."""
    num_patterns: int
    max_states: int          # M (padded)
    max_classes: int         # C (padded), classes 0..C
    max_pms: int = 2048      # N PM slots per pattern
    max_any_ids: int = 8     # distinctness-set capacity for ANY patterns
    ring_size: int = 8       # open-window ring for SPAWN_IN_WINDOWS
    latency_bound: float = 1.0
    safety_buffer: float = 0.0
    # Simulated-time cost model (seconds): c_base per event + c_match per
    # PM (× proc_cost); a shed costs c_shed_base + c_shed_pm · n_pm; an
    # E-BL-dropped event costs c_ebl.
    c_base: float = 2e-6
    c_match: float = 1e-7
    c_shed_base: float = 5e-6
    c_shed_pm: float = 2e-9
    c_ebl: float = 5e-7
    # backend: "torch" runs plain PyTorch ops; "cuda" routes advance /
    # utility lookup / shed histogram through the CUDA kernels;
    # "cuda_block" runs block_events (W) events per launch of the block
    # megakernel.  block_shed: "fused" handles Algorithm-2 fires inside
    # the kernel; "replay" stops the kernel at a fire and replays that
    # event through the per-event step (forced by shed_plan="sort").
    backend: str = BACKEND_TORCH
    block_events: int = 32              # W — events fused per block launch
    block_shed: str = "fused"           # "fused" (in-kernel Alg. 2) | "replay"
    spawn_alloc: str = "cumsum"         # "cumsum" (O(N)) | "argsort" (legacy)
    shed_plan: str = "threshold"        # "threshold" (O(N)) | "sort" (legacy)
    # Static pattern census: skip the op family no pattern needs.
    kinds: str = "mixed"                # "seq" | "any" | "mixed"
    spawn_modes: str = "mixed"          # "at_open" | "in_windows" | "mixed"
    emit_matches: bool = False
    gather_stats: bool = False
    shedder: str = SHED_NONE
    ebl_backlog_gain: float = 0.5
    ebl_decay: float = 0.997
    ebl_floor: float = 0.25

    def __post_init__(self):
        if self.backend not in BACKENDS:
            raise ValueError(
                f"unknown engine backend {self.backend!r}; expected one "
                f"of {BACKENDS}")
        if self.block_events < 1:
            raise ValueError(
                f"block_events must be >= 1: {self.block_events}")
        for name in ("num_patterns", "max_states", "max_classes",
                     "max_pms", "max_any_ids", "ring_size"):
            v = getattr(self, name)
            if v < 1:
                raise ValueError(
                    f"{name} must be >= 1 (it sizes a store/table axis): "
                    f"{v}")
        if not self.latency_bound > 0:
            raise ValueError(
                "latency_bound must be > 0 seconds — the overload "
                "detector (Alg. 1) compares realized event latency l_e "
                f"against it: {self.latency_bound}")
        if self.safety_buffer < 0:
            raise ValueError(
                "safety_buffer must be >= 0 seconds (it tightens the "
                f"latency bound, never loosens it): {self.safety_buffer}")
        for name in ("c_base", "c_match", "c_shed_base", "c_shed_pm",
                     "c_ebl"):
            v = getattr(self, name)
            if v < 0:
                raise ValueError(
                    f"cost constant {name} must be >= 0 seconds (simulated-"
                    f"time costs are non-negative): {v}")
        for name in ("ebl_floor", "ebl_decay"):
            v = getattr(self, name)
            if not 0.0 <= v <= 1.0:
                raise ValueError(
                    f"{name} must be in [0, 1] (it scales/decays the E-BL "
                    f"drop fraction): {v}")
        if self.ebl_backlog_gain < 0:
            raise ValueError(
                "ebl_backlog_gain must be >= 0 (backlog-proportional term "
                f"of the E-BL drop controller): {self.ebl_backlog_gain}")
        if self.shedder not in (SHED_NONE, SHED_PSPICE, SHED_PMBL,
                                SHED_EBL):
            raise ValueError(
                f"unknown shedder {self.shedder!r}; expected one of "
                f"('{SHED_NONE}', '{SHED_PSPICE}', '{SHED_PMBL}', "
                f"'{SHED_EBL}')")
        if self.spawn_alloc not in ("cumsum", "argsort"):
            raise ValueError(f"unknown spawn_alloc {self.spawn_alloc!r}; "
                             "expected 'cumsum' or 'argsort'")
        if self.shed_plan not in ("threshold", "sort"):
            raise ValueError(f"unknown shed_plan {self.shed_plan!r}; "
                             "expected 'threshold' or 'sort'")
        if self.block_shed not in ("fused", "replay"):
            raise ValueError(f"unknown block_shed {self.block_shed!r}; "
                             "expected 'fused' or 'replay'")
        if self.kinds not in ("seq", "any", "mixed"):
            raise ValueError(f"unknown kinds census {self.kinds!r}; "
                             "expected 'seq', 'any' or 'mixed'")
        if self.spawn_modes not in ("at_open", "in_windows", "mixed"):
            raise ValueError(
                f"unknown spawn_modes census {self.spawn_modes!r}; "
                "expected 'at_open', 'in_windows' or 'mixed'")

    @property
    def flat_pms(self) -> int:
        return self.num_patterns * self.max_pms


class EngineModel(NamedTuple):
    """Compiled and learned inputs (tensors on one device)."""
    trans: torch.Tensor          # (P, M, C+1) int32
    kind: torch.Tensor           # (P,) int32
    spawn_mode: torch.Tensor     # (P,) int32
    window_size: torch.Tensor    # (P,) int32
    slide: torch.Tensor          # (P,) int32
    final_state: torch.Tensor    # (P,) int32
    proc_cost: torch.Tensor      # (P,) float32
    uses_binding: torch.Tensor   # (P,) bool
    spawn_counts: torch.Tensor   # (P,) bool
    ut_tables: torch.Tensor      # (P, B, M) float32
    ut_bins: torch.Tensor        # (P,) int32
    f_model: ovl.LatencyModel
    g_model: ovl.LatencyModel
    ebl_raw_mean: torch.Tensor   # () float32


class EventBatch(NamedTuple):
    """Per-event classified inputs (made by ``data.streams.classify``)."""
    ev_class: torch.Tensor    # (n, P) int32 — class per pattern (0 = none)
    ev_bind: torch.Tensor     # (n, P) int32 — binding value (-1 = none)
    ev_open: torch.Tensor     # (n, P) bool  — window-open flag
    ev_id: torch.Tensor       # (n,)  int32  — distinctness id (ANY)
    ev_rand: torch.Tensor     # (n,)  float32 — u(0,1) for E-BL sampling
    ebl_raw: torch.Tensor     # (n,)  float32 — E-BL raw drop priority
    arrival: torch.Tensor     # (n,)  float32 — arrival time (seconds)


class PMStore(NamedTuple):
    active: torch.Tensor     # (P, N) bool
    state: torch.Tensor      # (P, N) int32
    open_idx: torch.Tensor   # (P, N) int32 — event index at window open
    bind: torch.Tensor       # (P, N) int32
    idset: torch.Tensor      # (P, N, A) int32 — matched ids (ANY), -1 empty


class Carry(NamedTuple):
    pms: PMStore
    ring: torch.Tensor          # (P, K) int32 window-open indices (-1 empty)
    ring_ptr: torch.Tensor      # (P,) int32
    sim_time: torch.Tensor      # () float32
    key: torch.Tensor           # (2,) int32 — threefry key words
    ebl_frac: torch.Tensor      # () float32
    ema_gap: torch.Tensor       # () float32
    prev_arrival: torch.Tensor  # () float32
    complex_count: torch.Tensor  # (P,) float32
    pms_created: torch.Tensor   # (P,) float32
    pms_shed: torch.Tensor      # () float32
    shed_calls: torch.Tensor    # () float32
    overflow: torch.Tensor      # () float32
    ebl_dropped: torch.Tensor   # () float32
    obs_counts: torch.Tensor    # (P, M, M) float32
    obs_rewards: torch.Tensor   # (P, M, M) float32
    lat_samples_n: torch.Tensor  # (S,) float32
    lat_samples_l: torch.Tensor  # (S,) float32
    lat_ptr: torch.Tensor       # () int32


class StepOut(NamedTuple):
    """Per-event outputs, stacked over the events of a run."""
    l_e: torch.Tensor         # (n,) realized event latency (s)
    n_pm: torch.Tensor        # (n,) active PMs after the step
    shed: torch.Tensor        # (n,) bool — shed triggered at this event
    dropped: torch.Tensor     # (n,) bool — event dropped by E-BL
    match_open: torch.Tensor  # (n, P, N | 0) int32 — open_idx of a match
    match_bind: torch.Tensor  # (n, P, N | 0) int32 — bind of a match


# ---------------------------------------------------------------------------
# Engine construction
# ---------------------------------------------------------------------------

def make_model(cp: pat.CompiledPatterns, cfg: EngineConfig,
               ut_tables: torch.Tensor | None = None,
               ut_bins: torch.Tensor | None = None,
               f_model: ovl.LatencyModel | None = None,
               g_model: ovl.LatencyModel | None = None,
               ebl_raw_mean: float = 0.5, device=None) -> EngineModel:
    dev = resolve_device(device)
    P, M = cp.num_patterns, cp.max_states
    kind, sm = np.asarray(cp.kind), np.asarray(cp.spawn_mode)
    if (cfg.kinds == "seq" and (kind != pat.KIND_SEQ).any()) or \
       (cfg.kinds == "any" and (kind != pat.KIND_ANY).any()):
        raise ValueError(f"cfg.kinds={cfg.kinds!r} but patterns have "
                         f"kinds {sorted(set(kind.tolist()))}")
    if (cfg.spawn_modes == "at_open" and
            (sm != pat.SPAWN_AT_OPEN).any()) or \
       (cfg.spawn_modes == "in_windows" and
            (sm != pat.SPAWN_IN_WINDOWS).any()):
        raise ValueError(f"cfg.spawn_modes={cfg.spawn_modes!r} but patterns "
                         f"have spawn modes {sorted(set(sm.tolist()))}")
    if ut_tables is None:
        ut_tables = torch.ones((P, 1, M), dtype=torch.float32)
    if ut_bins is None:
        ut_bins = torch.ones((P,), dtype=torch.int32)
    t = lambda a: torch.as_tensor(np.asarray(a)).to(dev)  # noqa: E731
    return EngineModel(
        trans=t(cp.trans), kind=t(cp.kind), spawn_mode=t(cp.spawn_mode),
        window_size=t(cp.window_size), slide=t(cp.slide),
        final_state=t(cp.final_state), proc_cost=t(cp.proc_cost),
        uses_binding=t(cp.uses_binding), spawn_counts=t(cp.spawn_counts),
        ut_tables=ut_tables.to(dev, torch.float32).contiguous(),
        ut_bins=ut_bins.to(dev, torch.int32).contiguous(),
        f_model=(f_model if f_model is not None else ovl.latency_model(
            cfg.c_match, cfg.c_base, ovl.LINEAR, dev)),
        g_model=(g_model if g_model is not None else ovl.latency_model(
            cfg.c_shed_pm, cfg.c_shed_base, ovl.LINEAR, dev)),
        ebl_raw_mean=torch.tensor(ebl_raw_mean, dtype=torch.float32,
                                  device=dev),
    )


def init_carry(cfg: EngineConfig, seed: int = 0, lat_capacity: int = 4096,
               device=None) -> Carry:
    dev = resolve_device(device)
    P, N, M, A, K = (cfg.num_patterns, cfg.max_pms, cfg.max_states,
                     cfg.max_any_ids, cfg.ring_size)
    i32, f32 = torch.int32, torch.float32
    pms = PMStore(
        active=torch.zeros((P, N), dtype=torch.bool, device=dev),
        state=torch.zeros((P, N), dtype=i32, device=dev),
        open_idx=torch.zeros((P, N), dtype=i32, device=dev),
        bind=torch.full((P, N), -1, dtype=i32, device=dev),
        idset=torch.full((P, N, A), -1, dtype=i32, device=dev),
    )
    z = lambda: torch.zeros((), dtype=f32, device=dev)  # noqa: E731
    return Carry(
        pms=pms, ring=torch.full((P, K), -1, dtype=i32, device=dev),
        ring_ptr=torch.zeros((P,), dtype=i32, device=dev),
        sim_time=z(), key=prng.PRNGKey(seed, device=dev), ebl_frac=z(),
        ema_gap=torch.tensor(1e-3, dtype=f32, device=dev),
        prev_arrival=z(),
        complex_count=torch.zeros((P,), dtype=f32, device=dev),
        pms_created=torch.zeros((P,), dtype=f32, device=dev),
        pms_shed=z(), shed_calls=z(), overflow=z(), ebl_dropped=z(),
        obs_counts=torch.zeros((P, M, M), dtype=f32, device=dev),
        obs_rewards=torch.zeros((P, M, M), dtype=f32, device=dev),
        lat_samples_n=torch.zeros((lat_capacity,), dtype=f32, device=dev),
        lat_samples_l=torch.zeros((lat_capacity,), dtype=f32, device=dev),
        lat_ptr=torch.zeros((), dtype=i32, device=dev),
    )


# ---------------------------------------------------------------------------
# Per-run constants and the host half of the carry
# ---------------------------------------------------------------------------

def tree_map(fn, *trees):
    """``fn`` over the tensors of NamedTuple trees of one structure."""
    t0 = trees[0]
    if isinstance(t0, torch.Tensor):
        return fn(*trees)
    return type(t0)(*(tree_map(fn, *xs) for xs in zip(*trees)))


class _Ctx(NamedTuple):
    """What a run derives once from (cfg, model): index tensors on the
    device over the model's pattern rows."""
    dev: torch.device
    pidx: torch.Tensor         # (P, 1) int64 pattern index
    rowbase: torch.Tensor      # (P, 1) int64 pattern row offset p·N
    cols: torch.Tensor         # (P·N,) int32 slot index per flat slot
    k_iota: torch.Tensor       # (K,) int64
    a_iota: torch.Tensor       # (A,) int64
    ws: torch.Tensor           # (P, 1) int32 window sizes
    final: torch.Tensor        # (P, 1) int32 final states
    is_seq: torch.Tensor       # (P, 1) bool
    at_open: torch.Tensor      # (P,) bool
    in_win: torch.Tensor       # (P,) bool
    id_slot: torch.Tensor      # (P, A) bool: slot 0 where spawn counts
    neg_one: torch.Tensor      # () int32 -1


def _make_ctx(cfg: EngineConfig, model: EngineModel) -> _Ctx:
    dev = model.trans.device
    P, N, K, A = cfg.num_patterns, cfg.max_pms, cfg.ring_size, \
        cfg.max_any_ids
    pidx = torch.arange(P, device=dev)[:, None]
    return _Ctx(
        dev=dev, pidx=pidx, rowbase=pidx * N,
        cols=torch.arange(N, dtype=torch.int32, device=dev).repeat(P),
        k_iota=torch.arange(K, device=dev),
        a_iota=torch.arange(A, device=dev),
        ws=model.window_size[:, None], final=model.final_state[:, None],
        is_seq=(model.kind == pat.KIND_SEQ)[:, None],
        at_open=model.spawn_mode == pat.SPAWN_AT_OPEN,
        in_win=model.spawn_mode == pat.SPAWN_IN_WINDOWS,
        id_slot=model.spawn_counts[:, None] & (
            torch.arange(A, device=dev) == 0),
        neg_one=torch.tensor(-1, dtype=torch.int32, device=dev),
    )


class _LaneModel(NamedTuple):
    """One lane's model scalars on the host."""
    cp: np.ndarray             # (P,) float32 c_match · proc_cost
    f: ovl.HostLatencyModel
    g: ovl.HostLatencyModel
    ebl_mean_eff: np.float32


def _lane_models(cfg: EngineConfig, model: EngineModel) -> list[_LaneModel]:
    """Each lane's host scalars from a lane-stacked model (one read per
    leaf)."""
    h = lambda t: t.cpu().numpy()  # noqa: E731
    proc, mean = h(model.proc_cost), h(model.ebl_raw_mean)
    f, g = [tuple(h(x) for x in m) for m in (model.f_model, model.g_model)]
    floor = F32(cfg.ebl_floor)
    lat = lambda m, k: ovl.HostLatencyModel(  # noqa: E731
        a=F32(m[0][k]), b=F32(m[1][k]), kind=int(m[2][k]))
    return [_LaneModel(
        cp=(F32(cfg.c_match) * proc[k]).astype(np.float32), f=lat(f, k),
        g=lat(g, k),
        ebl_mean_eff=fp.fma32(F32(1.0 - cfg.ebl_floor), mean[k], floor))
        for k in range(proc.shape[0])]


@dataclasses.dataclass
class _Host:
    """One lane's scalar control state, as float32 host scalars."""
    sim_time: np.float32
    key: torch.Tensor           # (2,) int32, on the CPU
    ebl_frac: np.float32
    ema_gap: np.float32
    prev_arrival: np.float32
    pms_shed: np.float32
    shed_calls: np.float32
    ebl_dropped: np.float32
    lat_n: np.ndarray
    lat_l: np.ndarray
    lat_ptr: int

    _SCALARS = ("sim_time", "ebl_frac", "ema_gap", "prev_arrival",
                "pms_shed", "shed_calls", "ebl_dropped")

    @staticmethod
    def lanes(c: Carry) -> list["_Host"]:
        """Each lane's host state from a lane-stacked carry."""
        v = {k: getattr(c, k).cpu().numpy() for k in _Host._SCALARS}
        key = c.key.cpu()
        lat_n, lat_l = (t.cpu().numpy() for t in (c.lat_samples_n,
                                                  c.lat_samples_l))
        ptr = c.lat_ptr.cpu().numpy()
        return [_Host(key=key[k], lat_n=lat_n[k].copy(),
                      lat_l=lat_l[k].copy(), lat_ptr=int(ptr[k]),
                      **{name: F32(v[name][k]) for name in _Host._SCALARS})
                for k in range(key.shape[0])]

    @staticmethod
    def into(hs: list["_Host"], c: Carry) -> Carry:
        """``c`` with every lane's host state written back, lane-stacked."""
        dev = c.sim_time.device
        col = lambda name: torch.from_numpy(np.array(  # noqa: E731
            [getattr(h, name) for h in hs], dtype=np.float32)).to(dev)
        return c._replace(
            key=torch.stack([h.key for h in hs]).to(dev),
            lat_samples_n=torch.from_numpy(
                np.stack([h.lat_n for h in hs])).to(dev),
            lat_samples_l=torch.from_numpy(
                np.stack([h.lat_l for h in hs])).to(dev),
            lat_ptr=torch.tensor([_wrap32(h.lat_ptr) for h in hs],
                                 dtype=torch.int32, device=dev),
            **{name: col(name) for name in _Host._SCALARS})


def _wrap32(v: int) -> int:
    return ((int(v) + 2 ** 31) % 2 ** 32) - 2 ** 31


def _cost_sum(cp: np.ndarray, n_act: np.ndarray,
              c_base: np.float32) -> np.float32:
    """t_proc = c_base + sum_p cp_p·n_p, rounded in the order the
    reference's XLA CPU reduction uses (found by test for P ≤ 16):
      * P = 1: one fused multiply-add into c_base;
      * P = 4, 8 or a multiple of 8: vector lanes (width min(P, 8)), each
        a fused multiply-add chain over p ≡ lane, then a halving tree;
      * otherwise: a fused multiply-add chain over p, then + c_base.
    """
    P = cp.shape[0]
    if P == 1:
        return fp.fma32(cp[0], F32(n_act[0]), c_base)
    if P in (4, 8) or P % 8 == 0:
        vf = min(P, 8)
        lanes = [F32(cp[k] * F32(n_act[k])) for k in range(vf)]
        for p in range(vf, P):
            lanes[p % vf] = fp.fma32(cp[p], F32(n_act[p]), lanes[p % vf])
        while len(lanes) > 1:
            h = len(lanes) // 2
            lanes = [F32(lanes[k] + lanes[k + h]) for k in range(h)]
        return F32(lanes[0] + c_base)
    acc = F32(cp[0] * F32(n_act[0]))
    for p in range(1, P):
        acc = fp.fma32(cp[p], F32(n_act[p]), acc)
    return F32(acc + c_base)


def _read(t: torch.Tensor) -> np.ndarray:
    """One device→host read on the event loop (counted, and spanned as
    ``engine.read``, n = bytes)."""
    global host_syncs
    host_syncs += 1
    with spans.span("engine.read", n=t.numel() * t.element_size()):
        return t.cpu().numpy()


# ---------------------------------------------------------------------------
# One event step: the device half
# ---------------------------------------------------------------------------

def _advance(cfg: EngineConfig, model: EngineModel, ctx: _Ctx, pms: PMStore,
             ev_class: torch.Tensor, ev_bind: torch.Tensor,
             ev_id: torch.Tensor):
    """Advance all active PMs against one event (``ev_id`` one per
    pattern row).  Returns (pms, old_state, new_state, completed)."""
    M, C1 = model.trans.shape[1], model.trans.shape[2]
    final = ctx.final
    if cfg.kinds != "any" and cfg.backend == BACKEND_CUDA:
        # One kernel launch for the whole store: gather, binding check,
        # activity gate and completion flag fused (kernels/nfa_transition).
        seq_next, k_completed = kops.advance_seq_multi(
            pms.state, pms.bind, pms.active, model.trans, ev_class,
            ev_bind, model.final_state, model.uses_binding)
        if cfg.kinds == "seq":
            # The kernel already leaves inactive PMs at their state.
            pms2 = PMStore(active=pms.active & ~k_completed, state=seq_next,
                           open_idx=pms.open_idx, bind=pms.bind,
                           idset=pms.idset)
            return pms2, pms.state, seq_next, k_completed
    bind_ok = ~model.uses_binding[:, None] | (pms.bind == ev_bind[:, None])
    c_eff = torch.where(bind_ok, ev_class[:, None], 0)
    if cfg.kinds != "any" and cfg.backend != BACKEND_CUDA:
        flat_idx = (ctx.pidx * M + pms.state) * C1 + c_eff
        seq_next = model.trans.reshape(-1)[flat_idx]

    if cfg.kinds != "seq":
        in_set = (pms.idset == ev_id[:, None, None]).any(dim=-1)
        any_match = (c_eff == 1) & ~in_set & (pms.state < final)
        any_next = pms.state + any_match.to(torch.int32)
        A = cfg.max_any_ids
        sc = model.spawn_counts.to(torch.int32)[:, None]
        slot = torch.clamp(pms.state - 1 + sc, 0, A - 1)
        do_insert = ~ctx.is_seq & pms.active & any_match
        onehot = (slot[..., None] == ctx.a_iota) & do_insert[..., None]
        idset = torch.where(onehot, ev_id[:, None, None], pms.idset)

    if cfg.kinds == "seq":
        new_state = torch.where(pms.active, seq_next, pms.state)
        idset = pms.idset
    elif cfg.kinds == "any":
        new_state = torch.where(pms.active, any_next, pms.state)
    else:
        new_state = torch.where(pms.active,
                                torch.where(ctx.is_seq, seq_next, any_next),
                                pms.state)
    completed = pms.active & (new_state == final) & (pms.state != final)
    pms2 = PMStore(active=pms.active & ~completed, state=new_state,
                   open_idx=pms.open_idx, bind=pms.bind, idset=idset)
    return pms2, pms.state, new_state, completed


def _scatter_drop(flat: torch.Tensor, idx: torch.Tensor,
                  values) -> torch.Tensor:
    """``flat.at[idx].set(values, mode="drop")`` for idx in [0, len]:
    the out-of-range index ``len`` lands in a scratch row cut off after."""
    buf = torch.cat([flat, flat[:1]])
    buf[idx] = values
    return buf[:-1]


def _spawn(cfg: EngineConfig, model: EngineModel, ctx: _Ctx, pms: PMStore,
           ring: torch.Tensor, i: int, ev_open: torch.Tensor,
           ev_class: torch.Tensor, ev_bind: torch.Tensor,
           ev_id: torch.Tensor):
    """Spawn new PMs.  Returns (pms, spawned (P,) f32, overflow (P,) int
    per pattern row).

    SPAWN_AT_OPEN: the window-open event itself spawns one PM at state 1.
    SPAWN_IN_WINDOWS: a class-1 event spawns a PM (state 1, bound to its
    binding value) in every ring window that lacks one.
    """
    P, N, K, A = cfg.num_patterns, cfg.max_pms, cfg.ring_size, \
        cfg.max_any_ids
    flat_n = cfg.flat_pms
    if cfg.spawn_modes != "at_open":
        in_window = (i - ring) < ctx.ws
        exists = (pms.active[:, None, :] &
                  (pms.open_idx[:, None, :] == ring[:, :, None]) &
                  (pms.bind[:, None, :] == ev_bind[:, None, None])
                  ).any(dim=-1)
        win_spawn = ((ring >= 0) & in_window & ~exists &
                     (ev_class == 1)[:, None] & ~ctx.at_open[:, None])
    open_spawn = (ctx.at_open & ev_open)[:, None] & (ctx.k_iota == 0)
    if cfg.spawn_modes == "at_open":
        cand = open_spawn
        cand_open_idx = torch.full((P, K), i, dtype=torch.int32,
                                   device=ctx.dev)
    elif cfg.spawn_modes == "in_windows":
        cand = win_spawn
        cand_open_idx = ring
    else:
        cand = win_spawn | open_spawn
        cand_open_idx = torch.where(ctx.at_open[:, None], i, ring)

    # Candidate r takes the (r+1)-th lowest-index inactive slot.
    free = ~pms.active
    n_free = free.sum(dim=1)
    rank = torch.cumsum(cand, dim=1) - 1
    can_alloc = cand & (rank < n_free[:, None])
    overflow = (cand & ~can_alloc).sum(dim=1)
    pick = torch.clamp(rank, 0, N - 1)
    if cfg.spawn_alloc == "argsort":
        free_order = torch.argsort(pms.active.to(torch.uint8), dim=1,
                                   stable=True)
        slots = torch.gather(free_order, 1, pick)
    else:
        # O(N) free-list compaction: every inactive slot writes its index
        # at its rank among the free slots.
        free_rank = torch.cumsum(free, dim=1) - 1
        tgt = torch.where(free, ctx.rowbase + free_rank, flat_n).reshape(-1)
        free_slots = _scatter_drop(
            torch.full((flat_n,), N, dtype=torch.int32, device=ctx.dev),
            tgt, ctx.cols).reshape(P, N)
        slots = torch.gather(free_slots, 1, pick).long()

    upd = torch.where(can_alloc, ctx.rowbase + slots, flat_n).reshape(-1)
    active = _scatter_drop(pms.active.reshape(-1), upd, True)
    state = _scatter_drop(pms.state.reshape(-1), upd, 1)
    open_i = _scatter_drop(pms.open_idx.reshape(-1), upd,
                           cand_open_idx.reshape(-1))
    bind = _scatter_drop(pms.bind.reshape(-1), upd,
                         ev_bind[:, None].expand(P, K).reshape(-1))
    # Fresh idset row: the spawning event's id fills slot 0 where the
    # spawn consumes the first distinct match (Q4).
    fresh = torch.where(ctx.id_slot, ev_id[:, None], ctx.neg_one)
    idset = _scatter_drop(pms.idset.reshape(flat_n, A), upd,
                          fresh[:, None, :].expand(P, K, A).reshape(-1, A))
    spawned = can_alloc.sum(dim=1).float()
    pms2 = PMStore(active=active.reshape(P, N), state=state.reshape(P, N),
                   open_idx=open_i.reshape(P, N), bind=bind.reshape(P, N),
                   idset=idset.reshape(P, N, A))
    return pms2, spawned, overflow


def _shed_now(cfg: EngineConfig, model: EngineModel, pms: PMStore,
              sub: torch.Tensor, i: int, rho: torch.Tensor) -> torch.Tensor:
    """Run the load shedder (Alg. 2 / PM-BL) on L operators' stores at
    once: ``model`` and ``pms`` lane-stacked ((L, P, N) stores), ``sub``
    (L, 2) each lane's threefry subkey of the fire, ``rho`` (L,) int32
    each lane's budget.  Returns the new (L, P, N) active masks; each lane
    equals its one-lane call bit for bit.  On the kernel backends one
    utility-lookup launch covers the L·P pattern rows laid end to end and
    each histogram level is one launch of the histogram's lane instance
    (of the one-lane kernel for a single lane)."""
    L, P, N = pms.active.shape
    dev = pms.active.device
    rows = lambda x: x.reshape((L * P,) + x.shape[2:])  # noqa: E731
    r_w = model.window_size[:, :, None] - (i - pms.open_idx)
    flat_active = pms.active.reshape(L, P * N)
    if cfg.shedder == SHED_PSPICE:
        if cfg.backend in _KERNEL_BACKENDS:
            # Kernel path: one utility-lookup launch for the stores, then
            # the threshold plan with the histogram kernel counting.
            u = kops.pm_utilities_multi(
                rows(pms.state), rows(r_w), rows(pms.active),
                rows(model.ut_tables), rows(model.ut_bins)).reshape(L, -1)
            if cfg.shed_plan == "sort":
                new_flat = shd.drop_lowest_utility(
                    flat_active, torch.where(flat_active, u,
                                             torch.full_like(u, np.inf)),
                    rho)
            else:
                new_flat = kops.shed_lowest_threshold(flat_active, u, rho)
        else:
            pattern_id = torch.arange(L * P, device=dev).repeat_interleave(
                N).reshape(L, P * N)
            new_flat = shd.shed(
                "pspice", key=sub, active=flat_active, rho=rho,
                stacked_tables=rows(model.ut_tables),
                bin_sizes=rows(model.ut_bins), pattern_id=pattern_id,
                state=pms.state.reshape(L, -1), r_w=r_w.reshape(L, -1),
                plan=cfg.shed_plan)
    else:  # PM-BL — O(N) select over uniform scores on either backend
        new_flat = shd.shed("pmbl", key=sub, active=flat_active, rho=rho,
                            plan=cfg.shed_plan)
    return new_flat.reshape(L, P, N)


def shed_carry_lanes(cfg: EngineConfig, model: EngineModel, carry: Carry,
                     i: int, rho: torch.Tensor) -> tuple[Carry, torch.Tensor]:
    """The reference's carry-level ``_shed_now`` on L lane-stacked
    carries: each lane splits its key, sheds its store by ``rho`` (L,)
    int32, pays the simulated shed cost ``c_shed_base + c_shed_pm ·
    n_before`` and bumps ``pms_shed`` / ``shed_calls`` — with no host
    sync.  Returns (carry, dropped (L,) float32).  The degradation
    ladder's PM trim is this call between chunks."""
    pms = carry.pms
    L = carry.sim_time.shape[0]
    n_before = pms.active.reshape(L, -1).sum(1)
    keys = prng.split(carry.key)                     # (L, 2, 2)
    active = _shed_now(cfg, model, pms, keys[:, 1], i, rho)
    dropped = (n_before - active.reshape(L, -1).sum(1)).float()
    # The reference's compiled form: one fused multiply-add into the
    # base cost, then the add into the clock (found by test).
    cost = fp.fma(cfg.c_shed_pm, n_before.float(), cfg.c_shed_base)
    c = carry._replace(
        pms=pms._replace(active=active), key=keys[:, 0].contiguous(),
        sim_time=carry.sim_time + cost, pms_shed=carry.pms_shed + dropped,
        shed_calls=carry.shed_calls + 1.0)
    return c, dropped


# ---------------------------------------------------------------------------
# The event loop
# ---------------------------------------------------------------------------

def _scan_events(cfg: EngineConfig, model: EngineModel, events: EventBatch,
                 carry: Carry, start: int) -> tuple[Carry, StepOut]:
    """Run events ``start, start+1, ...`` (global, int32-wrapped indices,
    so chunked runs replay a monolithic run's op sequence): the lane loop
    with one lane."""
    one = lambda x: x[None]  # noqa: E731
    c, outs = _scan_events_lanes(cfg, tree_map(one, model),
                                 tree_map(one, events), tree_map(one, carry),
                                 start)
    return tree_map(lambda x: x[0], c), tree_map(lambda x: x[0], outs)


def _scan_events_lanes(cfg: EngineConfig, model: EngineModel,
                       events: EventBatch, carry: Carry,
                       start: int) -> tuple[Carry, StepOut]:
    """The per-event engine over L lanes in lockstep (the reference's
    ``_scan_events_lanes`` / ``_step_lanes``).  ``model`` and ``carry``
    are lane-stacked (a leading (L,) axis), ``events`` (L, n, ...); the
    lanes share the global index ``start + j`` and each keeps its own
    clock in its events.

    The device half of each event runs ONCE over the L·P pattern rows —
    the lanes' stores, rings and models laid end to end as one operator
    of L·P patterns (on "cuda" one ``_nfa_kernel`` launch per event over
    all of them) — and one read brings every lane's counts to the host.
    The host half (Algorithm 1, E-BL, the clock, the latency ring, the
    key) runs per lane on that lane's scalars; the shed runs once for
    each lane that sheds, on its rows alone, and one more read brings
    the shedding lanes' counts.  Returned StepOut leaves are (L, n, ...).
    Every lane equals its own single-lane run bit for bit."""
    L, n, P = events.ev_class.shape
    N, R = cfg.max_pms, L * P
    rows_of = lambda x: x.reshape((R,) + x.shape[2:])  # noqa: E731
    flat = model._replace(**{k: rows_of(getattr(model, k)) for k in (
        "trans", "kind", "spawn_mode", "window_size", "final_state",
        "proc_cost", "uses_binding", "spawn_counts")})
    rcfg = dataclasses.replace(cfg, num_patterns=R)
    ctx = _make_ctx(rcfg, flat)
    dev = ctx.dev
    lm = _lane_models(cfg, model)
    hs = _Host.lanes(carry)
    pm_shedder = cfg.shedder in (SHED_PSPICE, SHED_PMBL)
    # Each lane's model as a one-lane stack (the shed's lane axis).
    lane_model = [tree_map(lambda x, k=k: x[k:k + 1], model)
                  for k in range(L)] if pm_shedder else []
    arrival, ev_rand, ebl_raw = (x.cpu().numpy() for x in (
        events.arrival, events.ev_rand, events.ebl_raw))
    S = hs[0].lat_n.shape[0]
    l_e_out = np.zeros((L, n), np.float32)
    n_pm_out = np.zeros((L, n), np.float32)
    shed_out = np.zeros((L, n), bool)
    drop_out = np.zeros((L, n), bool)
    width = N if cfg.emit_matches else 0
    m_open_out = torch.full((n, R, width), -1, dtype=torch.int32,
                            device=dev)
    m_bind_out = torch.full((n, R, width), -1, dtype=torch.int32,
                            device=dev)
    ev_class_h = events.ev_class.cpu().numpy()
    ev_open_h = events.ev_open.cpu().numpy()
    # The events by index, each row over the L·P pattern rows (contiguous:
    # at P = 1 the reshape is a view whose rows stride over the events,
    # and the advance kernel takes contiguous rows only).
    by_j = lambda x: x.transpose(0, 1).reshape(n, R).contiguous()  # noqa: E731
    ev_class_r, ev_bind_r, ev_open_r = (by_j(x) for x in (
        events.ev_class, events.ev_bind, events.ev_open))
    ev_id_r = events.ev_id.transpose(0, 1).repeat_interleave(P, dim=1)
    at_open_h = ctx.at_open.cpu().numpy().reshape(L, P)
    in_win_h = ctx.in_win.cpu().numpy().reshape(L, P)

    pms = PMStore(*(rows_of(x) for x in carry.pms))
    ring, ring_ptr = rows_of(carry.ring), rows_of(carry.ring_ptr)
    complex_count = rows_of(carry.complex_count)
    pms_created = rows_of(carry.pms_created)
    overflow = carry.overflow
    obs_counts, obs_rewards = carry.obs_counts, carry.obs_rewards
    lb, sb = cfg.latency_bound, cfg.safety_buffer
    one, c_base = F32(1.0), F32(cfg.c_base)
    bk_rate = kblock.backlog_rate(cfg)
    arr = np.zeros(L, np.float32)
    l_q = np.zeros(L, np.float32)

    for j in range(n):
        i = _wrap32(start + j)
        # -- 1. expire closed windows; ring bookkeeping ---------------------
        expired = pms.active & ((i - pms.open_idx) >= ctx.ws)
        act0 = pms.active
        pms = pms._replace(active=pms.active & ~expired)
        if cfg.spawn_modes != "at_open" and \
                (ev_open_h[:, j] & in_win_h).any():
            opens = ev_open_r[j] & ctx.in_win
            ring = torch.where(
                opens[:, None] & (ctx.k_iota == ring_ptr[:, None]), i, ring)
            ring_ptr = torch.where(opens, (ring_ptr + 1) % cfg.ring_size,
                                   ring_ptr)
        # The one read of the event: active counts before (= the previous
        # event's StepOut.n_pm) and after expiry, for every lane.
        counts = _read(torch.stack((act0.sum(dim=1),
                                    pms.active.sum(dim=1)))).reshape(2, L, P)
        if j:
            n_pm_out[:, j - 1] = counts[0].sum(axis=1)
        n_act = counts[1].copy()
        n_pm_i = [int(v) for v in n_act.sum(axis=1)]

        # -- 2. queueing latency & overload check (Alg. 1) -------------------
        did_shed = np.zeros(L, bool)
        sheds = []
        for k, h in enumerate(hs):
            arr[k] = arrival[k, j]
            h.sim_time = fp.nan_max32(h.sim_time, arr[k])
            l_q[k] = F32(h.sim_time - arr[k])
            if pm_shedder:
                shed, rho, _ = ovl.detect_overload_host(
                    lm[k].f, lm[k].g, l_q[k], n_pm_i[k], lb, sb)
                if shed and rho > 0:
                    keys = prng.split(h.key)
                    h.key = keys[0]
                    rows = slice(k * P, (k + 1) * P)
                    sheds.append((k, rows, _shed_now(
                        cfg, lane_model[k],
                        PMStore(*(x[None, rows] for x in pms)),
                        keys[1:].to(dev), i,
                        torch.tensor([rho], dtype=torch.int32,
                                     device=dev))[0]))
        if sheds:
            active = pms.active.clone()
            for _, rows, new_active in sheds:
                active[rows] = new_active
            pms = pms._replace(active=active)
            after = _read(active.sum(dim=1)).reshape(L, P)
            for k, _, _ in sheds:
                h = hs[k]
                n_act[k] = after[k]
                dropped = n_pm_i[k] - int(after[k].sum())
                h.sim_time = F32(h.sim_time + fp.fma32(
                    cfg.c_shed_pm, F32(n_pm_i[k]), cfg.c_shed_base))
                h.pms_shed = F32(h.pms_shed + F32(dropped))
                h.shed_calls = F32(h.shed_calls + one)
                did_shed[k] = True

        # -- 3. E-BL input drop ----------------------------------------------
        ev_dropped = np.zeros(L, bool)
        for k, h in enumerate(hs):
            gap = max(F32(arr[k] - h.prev_arrival), F32(1e-9))
            h.ema_gap = fp.fma32(0.99, h.ema_gap, F32(F32(0.01) * gap))
            h.prev_arrival = arr[k]
            if cfg.shedder != SHED_EBL:
                continue
            n_pm_f = F32(n_pm_i[k])
            shed, _, _ = ovl.detect_overload_host(lm[k].f, lm[k].g, l_q[k],
                                                  n_pm_i[k], lb, sb)
            l_p_est = ovl.predict_latency_host(lm[k].f, n_pm_f)
            d_ff = F32(l_p_est - h.ema_gap) / max(
                F32(l_p_est - F32(cfg.c_ebl)), F32(1e-9))
            d_need = min(max(fp.fma32(l_q[k], bk_rate, d_ff), F32(0.0)),
                         one)
            decayed = F32(h.ebl_frac * F32(cfg.ebl_decay))
            h.ebl_frac = fp.nan_max32(decayed, d_need) if shed \
                else decayed
            raw_eff = fp.fma32(F32(1.0 - cfg.ebl_floor), ebl_raw[k, j],
                               cfg.ebl_floor)
            p_drop = min(max(F32(F32(raw_eff * h.ebl_frac) /
                                 max(lm[k].ebl_mean_eff, F32(1e-9))),
                             F32(0.0)), one)
            ev_dropped[k] = bool(F32(ev_rand[k, j]) < p_drop)
            h.ebl_dropped = F32(h.ebl_dropped + F32(ev_dropped[k]))
            did_shed[k] = shed

        # Host-known no-ops: an event whose class is 0 for every pattern
        # row advances no PM, and one that opens no at-open window and is
        # of class 1 for no in-window pattern spawns none — skipping those
        # ops leaves every output bit as it is.
        cls_h = np.where(ev_dropped[:, None], 0, ev_class_h[:, j])
        open_h = ev_open_h[:, j] & ~ev_dropped[:, None]
        advances = bool(cls_h.any())
        spawns = bool(((open_h & at_open_h) |
                       ((cls_h == 1) & ~at_open_h)).any())
        if advances or spawns:
            live_class, live_open = ev_class_r[j], ev_open_r[j]
            if ev_dropped.any():
                gone = torch.from_numpy(np.repeat(ev_dropped, P)).to(dev)
                live_class = torch.where(gone, 0, live_class)
                live_open = live_open & ~gone
            ev_bind, ev_id = ev_bind_r[j], ev_id_r[j]

        # -- 4. advance + completions ----------------------------------------
        if advances:
            pms2, s_old, s_new, completed = _advance(
                rcfg, flat, ctx, pms, live_class, ev_bind, ev_id)
            complex_count = complex_count + completed.sum(dim=1).float()
            if cfg.emit_matches:
                torch.where(completed, pms.open_idx, ctx.neg_one,
                            out=m_open_out[j])
                torch.where(completed, pms.bind, ctx.neg_one,
                            out=m_bind_out[j])
        else:
            pms2, s_old, s_new = pms, pms.state, pms.state

        # -- 5. spawn --------------------------------------------------------
        if spawns:
            pms3, spawned, oflow = _spawn(rcfg, flat, ctx, pms2, ring, i,
                                          live_open, live_class, ev_bind,
                                          ev_id)
            pms_created = pms_created + spawned
            overflow = overflow + oflow.reshape(L, P).sum(dim=1).float()
        else:
            pms3 = pms2

        # -- 6. observations (model-building phase only) ---------------------
        if cfg.gather_stats:
            M = cfg.max_states
            w = pms.active.float()
            t = (cfg.c_match * flat.proc_cost)[:, None] * w
            cell = ((ctx.pidx * M + s_old) * M + s_new).reshape(-1)
            obs_counts = obs_counts.reshape(-1).index_add(
                0, cell, w.reshape(-1)).reshape(obs_counts.shape)
            obs_rewards = obs_rewards.reshape(-1).index_add(
                0, cell, t.reshape(-1)).reshape(obs_rewards.shape)

        # -- 7. simulated processing time & latency --------------------------
        for k, h in enumerate(hs):
            t_proc = F32(cfg.c_ebl) if ev_dropped[k] else \
                _cost_sum(lm[k].cp, n_act[k], c_base)
            h.sim_time = F32(h.sim_time + t_proc)
            l_e_out[k, j] = F32(h.sim_time - arr[k])
            ptr = h.lat_ptr % S
            h.lat_n[ptr] = F32(n_pm_i[k])
            h.lat_l[ptr] = t_proc
            h.lat_ptr = _wrap32(h.lat_ptr + 1)
        shed_out[:, j] = did_shed
        drop_out[:, j] = ev_dropped
        pms = pms3

    if n:
        n_pm_out[:, n - 1] = _read(pms.active.sum(dim=1)).reshape(
            L, P).sum(axis=1)
    lanes_of = lambda x: x.reshape((L, P) + x.shape[1:])  # noqa: E731
    c = carry._replace(
        pms=PMStore(*(lanes_of(x) for x in pms)), ring=lanes_of(ring),
        ring_ptr=lanes_of(ring_ptr), complex_count=lanes_of(complex_count),
        pms_created=lanes_of(pms_created), overflow=overflow,
        obs_counts=obs_counts, obs_rewards=obs_rewards)
    by_lane = lambda x: x.reshape(n, L, P, width).transpose(  # noqa: E731
        0, 1).contiguous()
    outs = StepOut(
        l_e=torch.from_numpy(l_e_out).to(dev),
        n_pm=torch.from_numpy(n_pm_out).to(dev),
        shed=torch.from_numpy(shed_out).to(dev),
        dropped=torch.from_numpy(drop_out).to(dev),
        match_open=by_lane(m_open_out), match_bind=by_lane(m_bind_out))
    return _Host.into(hs, c), outs


# ---------------------------------------------------------------------------
# Event-block execution (backend="cuda_block")
# ---------------------------------------------------------------------------

def _pad_event_blocks(events: EventBatch, n: int, w: int,
                      axis: int = 0) -> tuple[EventBatch, int]:
    """Pad the event axis (``axis``: 1 for lane-stacked events) with
    zeros to a whole number of ``w``-event blocks (the kernel masks the
    tail); returns (padded events, nb)."""
    pad = ktile.tile_pad(w, n)
    nb = max(1, (n + pad) // w)
    pad = nb * w - n

    def f(x):
        if not pad:
            return x.contiguous()
        shape = list(x.shape)
        shape[axis] = pad
        return torch.cat([x, x.new_zeros(shape)], dim=axis)

    return EventBatch(*(f(x) for x in events)), nb


def _own(carry: Carry, copy: bool = True) -> Carry:
    """The carry the block kernel updates in place: a contiguous copy, so
    the caller's carry stays as it was; with ``copy=False`` (the caller
    hands its carry over) its own tensors wherever they are contiguous."""
    if copy:
        cp = lambda t: t.clone(  # noqa: E731
            memory_format=torch.contiguous_format)
    else:
        cp = lambda t: t.contiguous()  # noqa: E731
    return tree_map(cp, carry)


def _replay(cfg: EngineConfig, model: EngineModel, scan: kblock.BlockScan,
            b: int, i0: int, n_valid: int) -> int:
    """Block ``b`` of ``scan`` in the replay protocol
    (``block_shed="replay"`` or ``shed_plan="sort"``): the kernel commits
    events up to the first fire; the fired event is replayed through the
    per-event step (which re-derives the same decision, splits the key
    and sheds), and the kernel re-enters at ``fire_idx + 1``.  Each
    re-entry reads the kernel's status: one host sync per launch.  On a
    lane-stacked scan every launch runs all lanes from their own starts —
    a lane that has finished its block starts at ``n_valid`` and does
    nothing — and each lane that stopped replays its own event, as the
    reference's batched while loop does.  Returns the launches made."""
    replay_cfg = dataclasses.replace(cfg, backend=BACKEND_CUDA)
    W = cfg.block_events
    off = b * W
    L = scan.lanes
    starts = [0] * (L or 1)
    launches = 0
    while any(s < n_valid for s in starts):
        launches += 1
        status = _read(scan.launch(b, i0, starts[0] if L is None else
                                   starts, n_valid)).reshape(-1, 2)
        for k, (fired, j) in enumerate(status.tolist()):
            if starts[k] >= n_valid:
                continue
            if not fired:
                starts[k] = n_valid
                continue
            lv = (lambda x: x) if L is None else \
                (lambda x, k=k: x[k])   # noqa: E731
            one = EventBatch(*(lv(x)[off + j:off + j + 1]
                               for x in scan.events))
            carry = tree_map(lv, scan.carry)
            c, row = _scan_events(replay_cfg, tree_map(lv, model), one,
                                  carry, _wrap32(i0 + j))
            kblock.write_back(carry, c)
            for name, v in zip(StepOut._fields, row):
                lv(scan.rows[name])[off + j] = v[0]
            starts[k] = j + 1
    return launches


def _scan_blocks(cfg: EngineConfig, model: EngineModel, events: EventBatch,
                 carry: Carry, start: int, lanes: int | None,
                 own: bool) -> tuple[Carry, StepOut]:
    """``_scan_events`` with one kernel launch per ``cfg.block_events``
    events.  Event indices stay global, so monolithic, chunked and
    blocked runs replay the same operator sequence.  The launches share
    one argument block (``kblock.BlockScan``): the kernel updates the
    scan's carry in place — a copy of the caller's, or with ``own`` the
    caller's own.  With ``lanes`` everything is lane-stacked and each
    launch is the lane instance, one CTA per lane.

    Fused (the default): ONE launch per block for every shedder, with
    Algorithm-2 fires handled in the kernel and no host sync.  Replay:
    ``_replay``."""
    n = events.ev_class.shape[0 if lanes is None else 1]
    W = cfg.block_events
    with spans.span("driver.prepare"):
        blocks, nb = _pad_event_blocks(events, n, W, axis=0 if lanes is None
                                       else 1)
        carry = _own(carry, copy=not own)
        rows = kblock.new_rows(cfg, nb * W, carry.sim_time.device,
                               lanes=lanes)
        scan = kblock.BlockScan(cfg, model, carry, blocks, rows, lanes=lanes)
    replay = cfg.shedder in (SHED_PSPICE, SHED_PMBL) and \
        not kblock.fused_shed(cfg)
    with spans.span("driver.launches") as sp:
        for b in range(nb):
            off = b * W
            i0, n_valid = _wrap32(start + off), min(max(n - off, 0), W)
            if replay:
                sp.n += _replay(cfg, model, scan, b, i0, n_valid)
            else:
                scan.launch(b, i0, 0, n_valid)
        if not replay:
            sp.n = nb
    cut = (lambda v: v[:n]) if lanes is None else (lambda v: v[:, :n])
    return carry, StepOut(**{k: cut(v) for k, v in rows.items()})


def _keep(carry: Carry, c: Carry, outs: StepOut,
          own: bool) -> tuple[Carry, StepOut]:
    """The per-event loop's result; with ``own`` written into the
    caller's carry, which it then returns, so an owned carry keeps its
    storage as it does under the block kernel."""
    if own:
        kblock.write_back(carry, c)
        c = carry
    return c, outs


def _scan_events_backend(cfg: EngineConfig, model: EngineModel,
                         events: EventBatch, carry: Carry, start: int,
                         own: bool = False) -> tuple[Carry, StepOut]:
    """Backend dispatch of run_engine and run_engine_chunk (``own``: the
    caller hands its carry over, to be updated in place)."""
    if cfg.backend == BACKEND_CUDA_BLOCK:
        return _scan_blocks(cfg, model, events, carry, start, None, own)
    return _keep(carry, *_scan_events(cfg, model, events, carry, start),
                 own)


def _scan_events_lanes_backend(cfg: EngineConfig, model: EngineModel,
                               events: EventBatch, carry: Carry, start: int,
                               own: bool = False) -> tuple[Carry, StepOut]:
    """Lane-batched backend dispatch (the runtime's lanes): on
    "cuda_block" one launch of the lane instance, one CTA per lane, per
    W-event block."""
    if cfg.backend == BACKEND_CUDA_BLOCK:
        return _scan_blocks(cfg, model, events, carry, start,
                            events.ev_class.shape[0], own)
    return _keep(carry, *_scan_events_lanes(cfg, model, events, carry,
                                            start), own)


# ---------------------------------------------------------------------------
# Public entry points
# ---------------------------------------------------------------------------

def _check_inputs(dev, model: EngineModel, events: EventBatch,
                  carry: Carry) -> None:
    check_on(dev, trans=model.trans, ut_tables=model.ut_tables,
             ev_class=events.ev_class, arrival=events.arrival,
             active=carry.pms.active, sim_time=carry.sim_time)


# Aten ops per event outside the kernels: the largest cell of the
# contract checker's sweep makes ~71 (two lanes of the per-event loop
# under fire); ~2x headroom, as the reference calibrated its budgets.
OPS_PER_EVENT = 160
# The hot-path contract of the scan entry points (DESIGN.md §11; checked
# by repro_torch.analysis): host syncs, launches and aten ops within
# budget, no rebuild after warm-up, the reference's byte budgets.
HOT_PATH = dict(max_syncs_per_event=ctr.hot_path_sync_budget,
                max_launches_per_block=1, max_ops_per_event=OPS_PER_EVENT,
                max_compiles=0, max_temp_bytes=ctr.hot_path_temp_budget,
                max_gather_bytes=ctr.hot_path_gather_budget)
# The entries that copy the caller's carry (the runtime's owned entries
# take it over): the reference donates it there.
NOT_OWNED = dict(donate=("carry",), waived=("in-place",),
                 waiver_note="the entry copies the carry (the owned "
                 "entries run_chunk_lanes_donated and _run_group_* take "
                 "it over)")


@ctr.contract("cep.run_engine", **HOT_PATH)
def run_engine(cfg: EngineConfig, model: EngineModel, events: EventBatch,
               carry: Carry, device=None) -> tuple[Carry, StepOut]:
    """Run the operator over a whole event stream.  Every input must lie
    on ``device`` (default CUDA)."""
    dev = resolve_device(device)
    _check_inputs(dev, model, events, carry)
    return _scan_events_backend(cfg, model, events, carry, 0)


def wrap_event_index(start) -> int:
    """An unbounded event index as an int32-wrapped Python int (the
    window arithmetic is int32 differences, correct across wraparound as
    long as windows are << 2^31)."""
    return _wrap32(int(start))


@ctr.contract("cep.run_engine_chunk", **HOT_PATH, **NOT_OWNED)
def run_engine_chunk(cfg: EngineConfig, model: EngineModel,
                     events: EventBatch, carry: Carry, start,
                     device=None) -> tuple[Carry, StepOut]:
    """One micro-batch: ``run_engine`` restricted to the events
    ``[start, start + chunk)`` of a longer stream (global indices)."""
    dev = resolve_device(device)
    _check_inputs(dev, model, events, carry)
    if isinstance(start, torch.Tensor):
        start = int(start.item())
    return _scan_events_backend(cfg, model, events, carry,
                                wrap_event_index(start))


def merge_carries(stacked: Carry, axis: int = 0) -> Carry:
    """Fold an L-lane-stacked carry (every leaf has a lane axis at
    ``axis``) into one flat carry over L·P patterns — the global view the
    runtime's telemetry and reporting aggregate over.

    Pattern-dim state (PM store, rings, per-pattern counters, obs
    matrices) concatenates along the pattern axis; scalar counters sum;
    clocks take the slowest lane (``max``); the key is lane 0's; the
    latency ring keeps per-slot global PM counts (sum) against the
    slowest lane's per-event time (max).  With no lanes every folded
    leaf takes its reduction's identity: zeros."""
    def flat(x):  # (L, P, ...) -> (L·P, ...)
        x = torch.movedim(x, axis, 0)
        return x.reshape((-1,) + tuple(x.shape[2:]))

    if stacked.sim_time.shape[axis] == 0:
        def zero(x):
            return torch.zeros(x.shape[:axis] + x.shape[axis + 1:],
                               dtype=x.dtype, device=x.device)
        mx = sm = first = zero
    else:
        def mx(x):
            return x.amax(dim=axis)

        def sm(x):
            return x.sum(dim=axis)

        def first(x):
            return x.select(axis, 0)
    return Carry(
        pms=PMStore(*(flat(x) for x in stacked.pms)),
        ring=flat(stacked.ring), ring_ptr=flat(stacked.ring_ptr),
        sim_time=mx(stacked.sim_time), key=first(stacked.key),
        ebl_frac=mx(stacked.ebl_frac), ema_gap=mx(stacked.ema_gap),
        prev_arrival=mx(stacked.prev_arrival),
        complex_count=flat(stacked.complex_count),
        pms_created=flat(stacked.pms_created),
        pms_shed=sm(stacked.pms_shed), shed_calls=sm(stacked.shed_calls),
        overflow=sm(stacked.overflow), ebl_dropped=sm(stacked.ebl_dropped),
        obs_counts=flat(stacked.obs_counts),
        obs_rewards=flat(stacked.obs_rewards),
        lat_samples_n=sm(stacked.lat_samples_n),
        lat_samples_l=mx(stacked.lat_samples_l),
        lat_ptr=mx(stacked.lat_ptr),
    )


# ---------------------------------------------------------------------------
# Durable-state manifest (repro_torch.runtime.persist)
# ---------------------------------------------------------------------------

def tree_leaves_with_path(tree, path: str = ""):
    """``(path, array)`` pairs of a tree's leaves as host NumPy arrays, in
    the reference's ``jax.tree_util`` flatten order and with its
    ``keystr`` paths: NamedTuple fields ``.name``, list items ``[i]``,
    dict keys ``['k']`` (sorted), None no leaf.  A latency model is a
    registered pytree without keys in the reference, so its leaves read
    ``[<flat index i>]``.  The carry's threefry key is written as the
    reference's uint32 words (the same bits as the port's int32 key)."""
    if tree is None:
        return
    if isinstance(tree, ovl.LatencyModel):
        for k, x in enumerate(tree):
            yield from tree_leaves_with_path(x, f"{path}[<flat index {k}>]")
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for name, x in zip(tree._fields, tree):
            if isinstance(tree, Carry) and name == "key":
                yield f"{path}.key", _host(x).view(np.uint32)
            else:
                yield from tree_leaves_with_path(x, f"{path}.{name}")
    elif isinstance(tree, (list, tuple)):
        for k, x in enumerate(tree):
            yield from tree_leaves_with_path(x, f"{path}[{k}]")
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_leaves_with_path(tree[k], f"{path}[{k!r}]")
    else:
        yield path, _host(tree)


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def pytree_manifest(tree) -> list[dict]:
    """Leaf schema of a tree in the reference's flatten order:
    ``[{"path", "dtype", "shape"}, ...]`` — equal to
    ``repro.cep.engine.pytree_manifest`` of the reference's tree of the
    same config, so a snapshot written by either package validates in
    the other."""
    return [{"path": p, "dtype": a.dtype.str, "shape": list(a.shape)}
            for p, a in tree_leaves_with_path(tree)]


def carry_manifest(cfg: EngineConfig, seed: int = 0,
                   lat_capacity: int = 4096) -> list[dict]:
    """The manifest any durable snapshot of this config's carry must
    match (``init_carry`` shapes are a pure function of the config; the
    carry is built on the CPU, where it costs nothing)."""
    return pytree_manifest(init_carry(cfg, seed=seed,
                                      lat_capacity=lat_capacity,
                                      device="cpu"))


# ---------------------------------------------------------------------------
# Results summary
# ---------------------------------------------------------------------------

def match_sets(outs: StepOut, start: int = 0) -> list[set[tuple]]:
    """Decode emitted matches into per-pattern sets of match identities
    ``(open_idx, bind, end_idx)`` (requires ``cfg.emit_matches``)."""
    m_open = outs.match_open.cpu().numpy()
    m_bind = outs.match_bind.cpu().numpy()
    if m_open.ndim != 3 or m_open.shape[-1] == 0:
        raise ValueError("run had cfg.emit_matches off — no match identity "
                         "was emitted (match fields are zero-width)")
    n, P, _ = m_open.shape
    out: list[set[tuple]] = [set() for _ in range(P)]
    ev, p, slot = np.nonzero(m_open >= 0)
    for e, q, s in zip(ev.tolist(), p.tolist(), slot.tolist()):
        out[q].add((int(m_open[e, q, s]), int(m_bind[e, q, s]),
                    start + e))
    return out


@dataclasses.dataclass
class RunResult:
    complex_count: np.ndarray   # (P,)
    pms_created: np.ndarray     # (P,)
    pms_shed: float
    shed_calls: float
    overflow: float
    ebl_dropped: float
    l_e: np.ndarray             # (n,)
    n_pm: np.ndarray            # (n,)
    carry: Carry
    matches: list | None = None

    @property
    def match_probability(self) -> np.ndarray:
        return self.complex_count / np.maximum(self.pms_created, 1.0)

    def false_negatives(self, ground_truth: "RunResult",
                        weights: np.ndarray | None = None) -> float:
        """Weighted FN fraction vs a no-shed run on the same stream."""
        gt = np.maximum(ground_truth.complex_count, 1e-9)
        fn = np.maximum(gt - self.complex_count, 0.0)
        w = np.ones_like(gt) if weights is None else np.asarray(weights)
        return float((w * fn).sum() / (w * gt).sum())


def summarize(carry: Carry, outs: StepOut) -> RunResult:
    emitted = outs.match_open.ndim == 3 and outs.match_open.shape[-1] > 0
    return RunResult(
        complex_count=carry.complex_count.cpu().numpy(),
        pms_created=carry.pms_created.cpu().numpy(),
        pms_shed=float(carry.pms_shed),
        shed_calls=float(carry.shed_calls),
        overflow=float(carry.overflow),
        ebl_dropped=float(carry.ebl_dropped),
        l_e=outs.l_e.cpu().numpy(),
        n_pm=outs.n_pm.cpu().numpy(),
        carry=carry,
        matches=match_sets(outs) if emitted else None,
    )
