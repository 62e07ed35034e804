"""The event-block megakernel: W events of the operator per launch.

Port of ``repro.kernels.block_step``.  One launch of the CUDA kernel
(``csrc/block_step.cu``) advances the engine through a block of
``W = cfg.block_events`` events with the PM store, the window ring, the
overload scalars, the latency ring and the PRNG key kept on the device:
expire → Algorithm 1 (lazy f-inverse) → Algorithm 2 when it fires → E-BL
→ SEQ / ANY advance → completions and match tiles → stats scatter →
spawn by rank → simulated time → one ``StepOut`` row per event.  There is
no host sync inside a block.

Shedding protocols, as in the reference:

* FUSED (``fused_shed(cfg)``, the default): a fire is handled inside the
  kernel — the pSPICE utility column (the lookup kernel's arithmetic) or
  the PM-BL uniforms, then ``core.shedder.threshold_drop_mask``.  The
  kernel splits the carry's threefry key itself on every fire
  (``key, sub = split(key)``) and PM-BL draws the fire's uniforms from
  ``sub``, exactly the draws the per-event engine makes, in the layout
  ``repro_torch.prng.PARTITIONABLE`` names when the scan starts (jax's
  partitionable layout or its original one; the argument block carries
  it).
* REPLAY (``block_shed="replay"`` or ``shed_plan="sort"``): the kernel
  stops before the first fire, commits nothing of that event and reports
  it; the engine replays the event through its per-event step and
  re-enters the kernel after it.

``block_step`` launches the kernel for CUDA tensors and runs
``block_step_plain`` — a straight PyTorch transcription of the kernel
body, written independently of the per-event engine — for CPU tensors;
nothing falls back from one to the other.  ``block_step_lanes`` is the
lane instance (the reference vmaps the kernel over tenant lanes): L
independent operators whose every operand carries a leading ``(L,)``
axis, one CTA per lane in one launch; on CPU tensors it runs the plain
version lane by lane.  The engine launches through
``BlockScan``, which checks the operands and builds the argument block
once per scan; ``plan_layout`` picks the kernel's instantiation (the PM
store in shared or in device memory) from the byte count.  Both update the carry's
tensors in place (its store, ring, counters and 0-d scalars) and write
the rows ``[s, stop)`` of the caller's row buffers: the engine hands
them a carry it owns.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch import fp, prng
from repro_torch.cep import patterns as pat
from repro_torch.core import overload as ovl
from repro_torch.core import shedder as shd
from repro_torch.kernels import _build
from repro_torch.kernels.shed_select import utility_lookup_plain

SHED_PSPICE, SHED_PMBL, SHED_EBL = "pspice", "pmbl", "ebl"
SHED_NBINS = 128          # the engine shed paths' histogram width

# The kernel's codes for the static configuration.
_KINDS = {"seq": 0, "any": 1, "mixed": 2}
_SPAWN_MODES = {"at_open": 0, "in_windows": 1, "mixed": 2}
_SHEDDERS = {"none": 0, SHED_PSPICE: 1, SHED_PMBL: 2, SHED_EBL: 3}


def fused_shed(cfg) -> bool:
    """True when this config runs Algorithm 2 inside the block kernel.

    The fused path implements the O(N) threshold plan only; the sort
    plan and an explicit ``block_shed="replay"`` pin the replay
    protocol instead."""
    return (cfg.shedder in (SHED_PSPICE, SHED_PMBL)
            and cfg.shed_plan == "threshold"
            and cfg.block_shed == "fused")


def new_rows(cfg, n: int, device, lanes: int | None = None) -> dict:
    """Row buffers for ``n`` events (match tiles zero-width unless
    ``cfg.emit_matches``), with a leading ``(lanes,)`` axis when given."""
    width = cfg.max_pms if cfg.emit_matches else 0
    P = cfg.num_patterns
    lead = () if lanes is None else (lanes,)
    return dict(
        l_e=torch.zeros(lead + (n,), dtype=torch.float32, device=device),
        n_pm=torch.zeros(lead + (n,), dtype=torch.float32, device=device),
        shed=torch.zeros(lead + (n,), dtype=torch.bool, device=device),
        dropped=torch.zeros(lead + (n,), dtype=torch.bool, device=device),
        match_open=torch.full(lead + (n, P, width), -1, dtype=torch.int32,
                              device=device),
        match_bind=torch.full(lead + (n, P, width), -1, dtype=torch.int32,
                              device=device))


def lane(tree, k: int):
    """Lane ``k`` of a lane-stacked NamedTuple tree of tensors (views)."""
    if isinstance(tree, torch.Tensor):
        return tree[k]
    return type(tree)(*(lane(x, k) for x in tree))


def _wrap32(v: int) -> int:
    return ((int(v) + 2 ** 31) % 2 ** 32) - 2 ** 31


def _cost_sum(cp: torch.Tensor, n: torch.Tensor,
              c_base: torch.Tensor) -> torch.Tensor:
    """t_proc = c_base + Σ_p cp_p·n_p on 0-d tensors, in the order the
    reference's CPU reduction rounds it for this P: one FMA for P = 1; for
    P ∈ {4, 8, 8k} lanes of FMA chains and a halving tree; otherwise an
    FMA chain."""
    P = cp.shape[0]
    nf = n.float()
    if P == 1:
        return fp.fma(cp[0], nf[0], c_base)
    if P == 4 or P % 8 == 0:
        vf = min(P, 8)
        lanes = [cp[k] * nf[k] for k in range(vf)]
        for p in range(vf, P):
            lanes[p % vf] = fp.fma(cp[p], nf[p], lanes[p % vf])
        while len(lanes) > 1:
            h = len(lanes) // 2
            lanes = [lanes[k] + lanes[k + h] for k in range(h)]
        return lanes[0] + c_base
    acc = cp[0] * nf[0]
    for p in range(1, P):
        acc = fp.fma(cp[p], nf[p], acc)
    return acc + c_base


def backlog_rate(cfg) -> float:
    """E-BL's backlog term ``gain·l_q / LB`` is compiled by the
    reference's XLA as ``l_q · (gain · (1/LB))`` fused into the add of
    ``d_ff``: this constant, in float32 (found by test)."""
    one = fp.F32(1.0)
    return float(fp.F32(cfg.ebl_backlog_gain) *
                 (one / fp.F32(cfg.latency_bound)))


def _scatter_drop(flat: torch.Tensor, idx: torch.Tensor, values) -> None:
    """``flat[idx] = values`` in place, dropping the index ``len(flat)``."""
    keep = idx < flat.shape[0]
    if isinstance(values, torch.Tensor) and values.dim():
        values = values[keep]
    flat[idx[keep]] = values


def block_step_plain(cfg, model, carry, blk, i0: int, s: int,
                     n_valid: int, rows: dict):
    """Plain PyTorch version of the kernel (the same function on any
    device): events ``[s, n_valid)`` of the block ``blk`` with global
    indices ``i0 + j``.  Scalars are 0-d float32 tensors and every site
    the kernel rounds with one fused multiply-add goes through ``fp.fma``.
    Returns ``(carry, rows, status)`` like ``block_step``."""
    P, N, M = cfg.num_patterns, cfg.max_pms, cfg.max_states
    A, K, W = cfg.max_any_ids, cfg.ring_size, cfg.block_events
    dev = carry.sim_time.device
    i32, f32 = torch.int32, torch.float32
    S = carry.lat_samples_n.shape[0]
    fused = fused_shed(cfg)
    pm_shedder = cfg.shedder in (SHED_PSPICE, SHED_PMBL)

    def c(v):
        return torch.tensor(v, dtype=f32, device=dev)

    zero, one = c(0.0), c(1.0)
    lb, sb = cfg.latency_bound, cfg.safety_buffer
    ws, final = model.window_size[:, None], model.final_state[:, None]
    is_seq = (model.kind == pat.KIND_SEQ)[:, None]
    at_open = model.spawn_mode == pat.SPAWN_AT_OPEN
    in_win = model.spawn_mode == pat.SPAWN_IN_WINDOWS
    uses = model.uses_binding[:, None]
    scount = model.spawn_counts.to(i32)
    cp = c(cfg.c_match) * model.proc_cost
    pidx = torch.arange(P, device=dev)[:, None]
    k_iota = torch.arange(K, device=dev)
    a_iota = torch.arange(A, device=dev)
    mean_eff = fp.fma(c(1.0 - cfg.ebl_floor), model.ebl_raw_mean,
                      c(cfg.ebl_floor))

    pms = carry.pms
    active, state = pms.active.clone(), pms.state.clone()
    open_idx, bind, idset = pms.open_idx.clone(), pms.bind.clone(), \
        pms.idset.clone()
    ring, ring_ptr = carry.ring.clone(), carry.ring_ptr.clone()
    cplx, crtd = carry.complex_count.clone(), carry.pms_created.clone()
    obs_c, obs_r = carry.obs_counts.clone(), carry.obs_rewards.clone()
    lat_n, lat_l = carry.lat_samples_n.clone(), carry.lat_samples_l.clone()
    lat_ptr, key = carry.lat_ptr.clone(), carry.key.clone()
    sim, ema, prev = carry.sim_time, carry.ema_gap, carry.prev_arrival
    eblf, ovf, ebld = carry.ebl_frac, carry.overflow, carry.ebl_dropped
    pshed, scalls = carry.pms_shed, carry.shed_calls
    n_act = active.sum(dim=1)
    nfire, fire_idx = 0, W

    for j in range(s, n_valid):
        i = _wrap32(i0 + j)
        ec, eb, eo = blk.ev_class[j], blk.ev_bind[j], blk.ev_open[j]
        eid, arr = blk.ev_id[j], blk.arrival[j]
        # -- 1. expiry and Algorithm 1 (nothing committed yet) -------------
        expired = active & ((i - open_idx) >= ws)
        n_act1 = n_act - expired.sum(dim=1)
        sim1 = torch.maximum(sim, arr)
        l_q = sim1 - arr
        n_pm_i = n_act1.sum().to(i32)
        n_pm_f = n_pm_i.float()
        fire = False
        if pm_shedder:
            dec = ovl.detect_overload(model.f_model, model.g_model, l_q,
                                      n_pm_i, lb, sb)
            fire = bool(dec.shed & (dec.rho > 0))
            if fire and not fused:           # replay: stop before it
                nfire, fire_idx = 1, j
                break
        # -- committed: expiry, ring, clock --------------------------------
        active = active & ~expired
        n_act = n_act1
        if cfg.spawn_modes != "at_open":
            opens = eo & in_win
            ring = torch.where(opens[:, None] &
                               (k_iota == ring_ptr[:, None]), i, ring)
            ring_ptr = torch.where(opens, (ring_ptr + 1) % K, ring_ptr)
        sim = sim1
        # -- 2b. fused Algorithm 2 -----------------------------------------
        if fire:
            keys = prng.split(key)
            key, sub = keys[0], keys[1]
            if cfg.shedder == SHED_PSPICE:
                r_w = ws - (i - open_idx)
                u = utility_lookup_plain(state, r_w, active, model.ut_tables,
                                         model.ut_bins).reshape(-1)
            else:
                u = prng.uniform(sub, (P * N,))
            active = shd.threshold_drop_mask(
                active.reshape(-1), u, dec.rho,
                nbins=SHED_NBINS).reshape(P, N)
            n_act = active.sum(dim=1)
            pshed = pshed + (n_pm_i - n_act.sum()).float()
            scalls = scalls + one
            sim = sim + fp.fma(c(cfg.c_shed_pm), n_pm_f, c(cfg.c_shed_base))
            nfire, fire_idx = nfire + 1, j
        # -- 3. E-BL input drop and the inter-arrival EMA ------------------
        gap = torch.clamp_min(arr - prev, 1e-9)
        ema = fp.fma(c(0.99), ema, c(0.01) * gap)
        prev = arr
        dropped, did_shed = False, fire
        if cfg.shedder == SHED_EBL:
            dec_e = ovl.detect_overload(model.f_model, model.g_model, l_q,
                                        n_pm_i, lb, sb)
            l_p_est = ovl.predict_latency(model.f_model, n_pm_f)
            d_ff = (l_p_est - ema) / torch.clamp_min(l_p_est - cfg.c_ebl,
                                                     1e-9)
            # d_ff + gain·l_q / LB as the reference's compiler folds it.
            d_need = torch.clamp(fp.fma(l_q, c(backlog_rate(cfg)), d_ff),
                                 0.0, 1.0)
            decayed = eblf * cfg.ebl_decay
            did_shed = bool(dec_e.shed)
            eblf = torch.maximum(decayed, d_need) if did_shed else decayed
            raw_eff = fp.fma(c(1.0 - cfg.ebl_floor), blk.ebl_raw[j],
                             c(cfg.ebl_floor))
            p_drop = torch.clamp(
                (raw_eff * eblf) / torch.clamp_min(mean_eff, 1e-9), 0.0, 1.0)
            dropped = bool(blk.ev_rand[j] < p_drop)
            ebld = ebld + (one if dropped else zero)
        lc = torch.zeros_like(ec) if dropped else ec
        lo = torch.zeros_like(eo) if dropped else eo
        n_proc = n_act                      # the PMs the event meets
        # -- 4. advance and completions ------------------------------------
        bind_ok = ~uses | (bind == eb[:, None])
        if cfg.kinds != "any":
            looked = model.trans[pidx, state.long(), ec.long()[:, None]]
            seq_next = state if dropped else torch.where(bind_ok, looked,
                                                         state)
        if cfg.kinds != "seq":
            in_set = (idset == eid).any(dim=-1)
            any_match = bind_ok & (lc[:, None] == 1) & ~in_set & \
                (state < final)
            any_next = state + any_match.to(i32)
            slot = torch.clamp(state - 1 + scount[:, None], 0, A - 1)
            ins = (~is_seq & active & any_match)[..., None] & \
                (slot[..., None] == a_iota)
            idset = torch.where(ins, eid, idset)
        if cfg.kinds == "seq":
            nxt = seq_next
        elif cfg.kinds == "any":
            nxt = any_next
        else:
            nxt = torch.where(is_seq, seq_next, any_next)
        new_state = torch.where(active, nxt, state)
        completed = active & (nxt == final) & (state != final)
        ncomp = completed.sum(dim=1)
        cplx = cplx + ncomp.float()
        if cfg.emit_matches:
            rows["match_open"][j] = torch.where(completed, open_idx, -1)
            rows["match_bind"][j] = torch.where(completed, bind, -1)
        if cfg.gather_stats:
            w = active.float()
            cell = ((pidx * M + state) * M + new_state).reshape(-1)
            obs_c.view(-1).index_add_(0, cell, w.reshape(-1))
            obs_r.view(-1).index_add_(0, cell, (cp[:, None] * w).reshape(-1))
        active = active & ~completed
        state = new_state
        n_act = n_act - ncomp
        # -- 5. spawn --------------------------------------------------------
        n_free = N - n_act
        if cfg.spawn_modes == "at_open":
            can = lo & (n_free > 0)
            ovf = ovf + (lo & ~can).sum().float()
            slot1 = (~active).to(torch.uint8).argmax(dim=1)
            flat = torch.where(can, pidx[:, 0] * N + slot1, P * N)
            spawn_open = torch.full((P,), i, dtype=i32, device=dev)
            spawn_bind = eb
            spawned = can.to(n_act.dtype)
        else:
            in_window = (i - ring) < ws
            exists = (active[:, None, :] &
                      (open_idx[:, None, :] == ring[:, :, None]) &
                      (bind[:, None, :] == eb[:, None, None])).any(dim=-1)
            win = (ring >= 0) & in_window & ~exists & \
                (lc == 1)[:, None] & ~at_open[:, None]
            if cfg.spawn_modes == "in_windows":
                cand, spawn_open = win, ring
            else:
                cand = win | ((at_open & lo)[:, None] & (k_iota == 0))
                spawn_open = torch.where(at_open[:, None], i, ring)
            rank = torch.cumsum(cand, dim=1) - 1
            can = cand & (rank < n_free[:, None])
            ovf = ovf + (cand & ~can).sum().float()
            frank = torch.cumsum(~active, dim=1)
            hits = frank[:, None, :] == (rank[:, :, None] + 1)
            slots = hits.to(torch.uint8).argmax(dim=-1)
            flat = torch.where(can, pidx * N + slots, P * N).reshape(-1)
            spawn_open = spawn_open.reshape(-1)
            spawn_bind = eb[:, None].expand(P, K).reshape(-1)
            spawned = can.sum(dim=1)
        _scatter_drop(active.view(-1), flat, True)
        _scatter_drop(state.view(-1), flat, 1)
        _scatter_drop(open_idx.view(-1), flat, spawn_open)
        _scatter_drop(bind.view(-1), flat, spawn_bind)
        if cfg.kinds != "seq":
            fresh = torch.full((flat.shape[0], A), -1, dtype=i32, device=dev)
            head = torch.where(scount > 0, eid, -1)
            fresh[:, 0] = head if flat.shape[0] == P else \
                head[:, None].expand(P, K).reshape(-1)
            _scatter_drop(idset.view(P * N, A), flat, fresh)
        crtd = crtd + spawned.float()
        n_act = n_act + spawned
        # -- 7. simulated time, latency ring, the StepOut row ---------------
        t_proc = c(cfg.c_ebl) if dropped else _cost_sum(cp, n_proc,
                                                        c(cfg.c_base))
        sim = sim + t_proc
        ptr = lat_ptr % S
        lat_n[ptr] = n_pm_f
        lat_l[ptr] = t_proc
        lat_ptr = lat_ptr + 1
        rows["l_e"][j] = sim - arr
        rows["n_pm"][j] = n_act.sum().float()
        rows["shed"][j] = did_shed
        rows["dropped"][j] = dropped

    out = carry._replace(
        pms=pms._replace(active=active, state=state, open_idx=open_idx,
                         bind=bind, idset=idset),
        ring=ring, ring_ptr=ring_ptr, sim_time=sim, key=key, ebl_frac=eblf,
        ema_gap=ema, prev_arrival=prev, complex_count=cplx,
        pms_created=crtd, pms_shed=pshed, shed_calls=scalls, overflow=ovf,
        ebl_dropped=ebld, obs_counts=obs_c, obs_rewards=obs_r,
        lat_samples_n=lat_n, lat_samples_l=lat_l, lat_ptr=lat_ptr)
    write_back(carry, out)
    return carry, rows, torch.tensor([nfire, fire_idx], dtype=i32,
                                     device=dev)


def write_back(carry, out) -> None:
    """Copy ``out``'s values into ``carry``'s tensors (the in-place
    contract both versions share)."""
    for name in ("active", "state", "open_idx", "bind", "idset"):
        getattr(carry.pms, name).copy_(getattr(out.pms, name))
    for name in ("ring", "ring_ptr", "sim_time", "key", "ebl_frac",
                 "ema_gap", "prev_arrival", "complex_count", "pms_created",
                 "pms_shed", "shed_calls", "overflow", "ebl_dropped",
                 "obs_counts", "obs_rewards", "lat_samples_n",
                 "lat_samples_l", "lat_ptr"):
        getattr(carry, name).copy_(getattr(out, name))


# ---------------------------------------------------------------------------
# The kernel's shared-memory layout (mirror of ``plan()`` in the source)
# ---------------------------------------------------------------------------

# Dynamic shared memory one CTA may take: the H100's 227 KB per block less
# 1 KB for the kernel's static part.
SMEM_CAP = 232448 - 1024
# The event rows, the model tables and the stats counts stay in device
# memory when they alone exceed these shares.
ROWS_SMEM_MAX, MODEL_SMEM_MAX, STATS_SMEM_MAX = 32768, 49152, 65536
_PAT_ARRAYS, _PK_ARRAYS, _RED_SLOTS = 20, 3, 8


class Layout(NamedTuple):
    """Where one launch keeps its state.  ``store`` names the kernel's
    instantiation: "shared" keeps the PM store and the fire's scratch in
    shared memory for the whole launch, "global" in device memory."""
    store: str
    rows_smem: bool
    model_smem: bool
    stats_smem: bool
    store_bytes: int     # the store and the fire's scratch
    smem_bytes: int      # the launch's dynamic shared memory


def _pad16(n: int) -> int:
    return (n + 15) // 16 * 16


def _round4(n: int) -> int:
    return (n + 3) // 4 * 4


def plan_layout(cfg, C1: int, B: int) -> Layout:
    """The layout of a launch at this config, with ``C1`` classes + 1 and
    ``B`` utility bins, byte for byte as the kernel's ``plan()`` computes
    it (the launch refuses a block whose byte count differs).  The store
    goes to shared memory when everything fits in ``SMEM_CAP``; raises
    when even the device-memory store leaves too much for one CTA."""
    P, N, M = cfg.num_patterns, cfg.max_pms, cfg.max_states
    A, K, W = cfg.max_any_ids, cfg.ring_size, cfg.block_events
    F = P * N
    base = (_pad16(4 * _PAT_ARRAYS * _round4(P)) +
            _pad16(4 * _PK_ARRAYS * _round4(P * K)) + _pad16(4 * SHED_NBINS)
            + _pad16(4 * (SHED_NBINS + 4)) + _pad16(4 * _RED_SLOTS * 32) +
            _pad16(4 * ((F + 31) // 32)) +
            4 * _pad16(4 * W) + 2 * _pad16(W))     # the staged StepOut rows
    rows = 2 * _pad16(4 * W * P) + _pad16(W * P) + 4 * _pad16(4 * W)
    model = _pad16(4 * P * M * C1) + _pad16(4 * P * B * M)
    hits = _pad16(4 * P * M * M) if cfg.gather_stats else 0
    store = (_pad16(F) + 3 * _pad16(4 * F) + _pad16(4 * F) + _pad16(F) +
             (_pad16(4 * F * A) if cfg.kinds != "seq" else 0))
    rows_smem = rows <= ROWS_SMEM_MAX
    model_smem = model <= MODEL_SMEM_MAX
    stats_smem = 0 < hits <= STATS_SMEM_MAX
    fixed = base + rows * rows_smem + model * model_smem + hits * stats_smem
    if fixed + store <= SMEM_CAP:
        return Layout("shared", rows_smem, model_smem, stats_smem, store,
                      fixed + store)
    if fixed > SMEM_CAP:
        raise ValueError(
            f"block_step: {fixed} B of per-launch state (P={P}, K={K}, "
            f"N={N}) exceed the {SMEM_CAP} B of shared memory one CTA has")
    return Layout("global", rows_smem, model_smem, stats_smem, store, fixed)


# ---------------------------------------------------------------------------
# The kernel's argument block (mirror of ``struct BlockStepArgs``)
# ---------------------------------------------------------------------------

_PTRS = (
    "ev_class", "ev_bind", "ev_open", "ev_id", "ev_rand", "ebl_raw",
    "arrival",
    "trans", "kind", "spawn_mode", "window_size", "final_state",
    "proc_cost", "uses_binding", "spawn_counts", "ut_tables", "ut_bins",
    "f_a", "f_b", "f_kind", "g_a", "g_b", "g_kind", "ebl_raw_mean",
    "active", "state", "open_idx", "bind", "idset", "ring", "ring_ptr",
    "sim_time", "key", "ebl_frac", "ema_gap", "prev_arrival",
    "complex_count", "pms_created", "pms_shed", "shed_calls", "overflow",
    "ebl_dropped", "obs_counts", "obs_rewards", "lat_n", "lat_l", "lat_ptr",
    "l_e", "n_pm", "shed", "dropped", "m_open", "m_bind",
    "scratch_u", "scratch_sel", "status", "lane_s")
_INTS = ("P", "N", "M", "C1", "A", "K", "S", "B", "W", "s", "n_valid",
         "i0", "blk", "kinds", "spawn_modes", "shedder", "fused", "emit",
         "stats", "partitionable", "store_shared", "rows_smem",
         "model_smem", "stats_smem", "smem_bytes", "lanes", "n_rows")
_FLOATS = ("c_base", "c_match", "c_ebl", "c_shed_base", "c_shed_pm",
           "latency_bound", "safety_buffer", "ebl_backlog_gain",
           "ebl_decay", "ebl_floor", "one_minus_floor")


class _Args(ctypes.Structure):
    _fields_ = ([(n, ctypes.c_void_p) for n in _PTRS] +
                [(n, ctypes.c_int) for n in _INTS] +
                [(n, ctypes.c_float) for n in _FLOATS])


def _check(name, t, dtype, shape, dev):
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) or \
            not t.is_contiguous() or t.device != dev:
        raise ValueError(f"block_step: {name} must be a contiguous {dtype} "
                         f"of shape {tuple(shape)} on {dev}, got {t.dtype} "
                         f"{tuple(t.shape)} on {t.device}")


def _operands(cfg, model, carry, events, rows, scratch_u, scratch_sel,
              status, lanes: int | None = None):
    """Every tensor the kernel reads or writes, by its argument name,
    with the dtype and shape it must have.  ``events`` and ``rows`` hold
    whole W-event blocks (the scan's, or one block's).  With ``lanes``
    every operand has a leading ``(lanes,)`` axis: the lane instance,
    whose CTA l works on the l-th slice of each (contiguous, so its
    offset is l times the slice's element count)."""
    P, N, M = cfg.num_patterns, cfg.max_pms, cfg.max_states
    A, K = cfg.max_any_ids, cfg.ring_size
    C1, B = model.trans.shape[-1], model.ut_tables.shape[-2]
    S = carry.lat_samples_n.shape[-1]
    n = events.ev_id.shape[-1]
    width = N if cfg.emit_matches else 0
    i32, f32, b8 = torch.int32, torch.float32, torch.bool
    pms = carry.pms
    lead = () if lanes is None else (lanes,)
    return tuple((name, t, dtype, lead + shape) for name, t, dtype, shape in (
        ("ev_class", events.ev_class, i32, (n, P)),
        ("ev_bind", events.ev_bind, i32, (n, P)),
        ("ev_open", events.ev_open, b8, (n, P)),
        ("ev_id", events.ev_id, i32, (n,)),
        ("ev_rand", events.ev_rand, f32, (n,)),
        ("ebl_raw", events.ebl_raw, f32, (n,)),
        ("arrival", events.arrival, f32, (n,)),
        ("trans", model.trans, i32, (P, M, C1)),
        ("kind", model.kind, i32, (P,)),
        ("spawn_mode", model.spawn_mode, i32, (P,)),
        ("window_size", model.window_size, i32, (P,)),
        ("final_state", model.final_state, i32, (P,)),
        ("proc_cost", model.proc_cost, f32, (P,)),
        ("uses_binding", model.uses_binding, b8, (P,)),
        ("spawn_counts", model.spawn_counts, b8, (P,)),
        ("ut_tables", model.ut_tables, f32, (P, B, M)),
        ("ut_bins", model.ut_bins, i32, (P,)),
        ("f_a", model.f_model.a, f32, ()),
        ("f_b", model.f_model.b, f32, ()),
        ("f_kind", model.f_model.kind, i32, ()),
        ("g_a", model.g_model.a, f32, ()),
        ("g_b", model.g_model.b, f32, ()),
        ("g_kind", model.g_model.kind, i32, ()),
        ("ebl_raw_mean", model.ebl_raw_mean, f32, ()),
        ("active", pms.active, b8, (P, N)),
        ("state", pms.state, i32, (P, N)),
        ("open_idx", pms.open_idx, i32, (P, N)),
        ("bind", pms.bind, i32, (P, N)),
        ("idset", pms.idset, i32, (P, N, A)),
        ("ring", carry.ring, i32, (P, K)),
        ("ring_ptr", carry.ring_ptr, i32, (P,)),
        ("sim_time", carry.sim_time, f32, ()),
        ("key", carry.key, i32, (2,)),
        ("ebl_frac", carry.ebl_frac, f32, ()),
        ("ema_gap", carry.ema_gap, f32, ()),
        ("prev_arrival", carry.prev_arrival, f32, ()),
        ("complex_count", carry.complex_count, f32, (P,)),
        ("pms_created", carry.pms_created, f32, (P,)),
        ("pms_shed", carry.pms_shed, f32, ()),
        ("shed_calls", carry.shed_calls, f32, ()),
        ("overflow", carry.overflow, f32, ()),
        ("ebl_dropped", carry.ebl_dropped, f32, ()),
        ("obs_counts", carry.obs_counts, f32, (P, M, M)),
        ("obs_rewards", carry.obs_rewards, f32, (P, M, M)),
        ("lat_n", carry.lat_samples_n, f32, (S,)),
        ("lat_l", carry.lat_samples_l, f32, (S,)),
        ("lat_ptr", carry.lat_ptr, i32, ()),
        ("l_e", rows["l_e"], f32, (n,)),
        ("n_pm", rows["n_pm"], f32, (n,)),
        ("shed", rows["shed"], b8, (n,)),
        ("dropped", rows["dropped"], b8, (n,)),
        ("m_open", rows["match_open"], i32, (n, P, width)),
        ("m_bind", rows["match_bind"], i32, (n, P, width)),
        ("scratch_u", scratch_u, f32, (P * N,)),
        ("scratch_sel", scratch_sel, torch.uint8, (P * N,)),
        ("status", status, i32, (2,)),
    ))


def fill_args(cfg, model, carry, events, i0: int, s: int, n_valid: int,
              rows: dict, scratch_u, scratch_sel, status, b: int = 0,
              lanes: int | None = None) -> _Args:
    """The kernel's argument block for block ``b`` of ``events`` /
    ``rows`` (whole W-event blocks), after checking every operand's dtype,
    shape, contiguity and device; ``lanes`` as in ``_operands`` (the
    launch's grid).  ``lane_s`` starts NULL: every lane starts at ``s``."""
    dev = carry.sim_time.device
    W = cfg.block_events
    n = events.ev_id.shape[-1]
    if n % W or not 0 <= b < n // W:
        raise ValueError(f"block_step: block {b} of {n} event rows at "
                         f"W={W}")
    if lanes is not None and lanes < 1:
        raise ValueError(f"block_step: {lanes} lanes")
    args = _Args()
    for name, t, dtype, shape in _operands(cfg, model, carry, events, rows,
                                           scratch_u, scratch_sel, status,
                                           lanes):
        _check(name, t, dtype, shape, dev)
        setattr(args, name, t.data_ptr())
    lay = plan_layout(cfg, model.trans.shape[-1], model.ut_tables.shape[-2])
    for name, v in dict(
            P=cfg.num_patterns, N=cfg.max_pms, M=cfg.max_states,
            C1=model.trans.shape[-1], A=cfg.max_any_ids, K=cfg.ring_size,
            S=carry.lat_samples_n.shape[-1], B=model.ut_tables.shape[-2],
            W=W, s=s, n_valid=n_valid, i0=_wrap32(i0), blk=b,
            kinds=_KINDS[cfg.kinds],
            spawn_modes=_SPAWN_MODES[cfg.spawn_modes],
            shedder=_SHEDDERS[cfg.shedder], fused=int(fused_shed(cfg)),
            emit=int(cfg.emit_matches), stats=int(cfg.gather_stats),
            partitionable=int(prng.PARTITIONABLE),
            store_shared=int(lay.store == "shared"),
            rows_smem=int(lay.rows_smem), model_smem=int(lay.model_smem),
            stats_smem=int(lay.stats_smem),
            smem_bytes=lay.smem_bytes, lanes=lanes or 1,
            n_rows=n).items():
        setattr(args, name, v)
    for name in _FLOATS[:-1]:
        setattr(args, name, getattr(cfg, name))
    args.one_minus_floor = 1.0 - cfg.ebl_floor
    return args


class BlockScan:
    """The launches of one scan over whole W-event blocks.

    ``events`` and ``rows`` hold ``nb·W`` rows; the carry's tensors are
    updated in place by every launch.  The operands are checked, the
    layout planned and the argument block built once, with the fire's
    scratch and the status; each block then sets only its index, ``i0``,
    ``s`` and ``n_valid`` (``set_block``).  On a CUDA carry ``launch``
    enqueues the kernel; on a CPU carry it runs ``block_step_plain`` on
    the block's rows.  With ``lanes`` every operand is lane-stacked and a
    launch is the lane instance: one CTA per lane (``block_step_lanes``),
    on a CPU carry the plain version lane by lane."""

    def __init__(self, cfg, model, carry, events, rows,
                 lanes: int | None = None):
        self.cfg, self.model, self.carry = cfg, model, carry
        self.events, self.rows, self.lanes = events, rows, lanes
        dev = carry.sim_time.device
        if dev.type not in ("cpu", "cuda"):
            raise ValueError(f"block_step: unsupported device {dev}")
        self.cuda = dev.type == "cuda"
        F = cfg.num_patterns * cfg.max_pms
        lead = () if lanes is None else (lanes,)
        self.layout = plan_layout(cfg, model.trans.shape[-1],
                                  model.ut_tables.shape[-2])
        # The fire's scratch in device memory (the "global" store's).
        self.scratch_u = torch.empty(lead + (F,), dtype=torch.float32,
                                     device=dev)
        self.scratch_sel = torch.empty(lead + (F,), dtype=torch.uint8,
                                       device=dev)
        self.status = torch.zeros(lead + (2,), dtype=torch.int32,
                                  device=dev)
        # Per-lane starts (the replay protocol's relaunches; a lane whose
        # start is n_valid does nothing).
        self.starts = torch.zeros(lead, dtype=torch.int32, device=dev) \
            if lanes is not None else None
        self.args = fill_args(cfg, model, carry, events, 0, 0, 0, rows,
                              self.scratch_u, self.scratch_sel, self.status,
                              lanes=lanes)
        if self.cuda:
            self._ref = ctypes.byref(self.args)
            self._stream = torch.cuda.current_stream(dev).cuda_stream
            self._fn = _build.load().block_step_launch

    def set_block(self, b: int, i0: int, s, n_valid: int) -> _Args:
        """The argument block for events ``[s, n_valid)`` of block ``b``
        with global indices ``i0 + j``: the kernel offsets the event rows
        and the row buffers by ``b·W`` itself.  ``s`` is an int (every
        lane) or, for a lane-stacked scan, one start per lane."""
        a = self.args
        a.blk, a.i0, a.n_valid = b, _wrap32(i0), n_valid
        if isinstance(s, int):
            a.s, a.lane_s = s, None
        else:
            if self.lanes is None or len(s) != self.lanes or \
                    not all(0 <= int(v) <= n_valid for v in s):
                raise ValueError(f"block_step: per-lane starts {list(s)} "
                                 f"for {self.lanes} lanes, n_valid "
                                 f"{n_valid}")
            self.starts.copy_(torch.as_tensor(s, dtype=torch.int32))
            a.s, a.lane_s = 0, self.starts.data_ptr()
        return a

    def launch(self, b: int, i0: int, s, n_valid: int):
        """Run events ``[s, n_valid)`` of block ``b`` (``s`` as in
        ``set_block``).  Returns the status ``[fires, index]``, (2,) or
        (lanes, 2) int32."""
        if not self.cuda:
            return self._plain(b, i0, s, n_valid)
        self.set_block(b, i0, s, n_valid)
        _build.check(self._fn(self._ref, self._stream), "block_step")
        if self.lanes is None:
            block_step.launches += 1
        else:
            block_step_lanes.launches += 1
        return self.status

    def _plain(self, b: int, i0: int, s, n_valid: int):
        W = self.cfg.block_events
        cut = slice(b * W, b * W + W)
        if self.lanes is None:
            blk = type(self.events)(*(x[cut] for x in self.events))
            _, _, status = block_step_plain(
                self.cfg, self.model, self.carry, blk, i0, s, n_valid,
                {k: v[cut] for k, v in self.rows.items()})
            return status
        starts = [s] * self.lanes if isinstance(s, int) else list(s)
        for k in range(self.lanes):
            blk = type(self.events)(*(x[k, cut] for x in self.events))
            _, _, st = block_step_plain(
                self.cfg, lane(self.model, k), lane(self.carry, k), blk, i0,
                int(starts[k]), n_valid,
                {name: v[k, cut] for name, v in self.rows.items()})
            self.status[k] = st
        return self.status


def block_step(cfg, model, carry, blk, i0: int, s: int, n_valid: int,
               rows: dict | None = None):
    """Run events ``[s, n_valid)`` of the W-event block ``blk`` (global
    indices ``i0 + j``) against ``carry``.

    ``cfg``/``model``/``carry``/``blk`` are the engine's ``EngineConfig``
    / ``EngineModel`` / ``Carry`` / W-row ``EventBatch`` (duck-typed;
    this module never imports the engine).  The carry's tensors are
    updated in place; rows ``[s, stop)`` of ``rows`` (W-row buffers, see
    ``new_rows``; allocated when None) are written.  Returns ``(carry,
    rows, status)`` with ``status`` a (2,) int32 tensor on the carry's
    device: ``[fires, index]``.  Fused, ``fires`` counts the fires handled
    in the kernel and ``stop = n_valid``; replay, ``fires`` is 1 when the
    kernel stopped before a fire at ``index`` (``stop = index``), else 0.
    """
    dev = carry.sim_time.device
    W = cfg.block_events
    if rows is None:
        rows = new_rows(cfg, W, dev)
    if not 0 <= s <= n_valid <= W:
        raise ValueError(f"block_step: need 0 <= s <= n_valid <= W, got "
                         f"s={s} n_valid={n_valid} W={W}")
    if dev.type == "cpu":
        return block_step_plain(cfg, model, carry, blk, i0, s, n_valid,
                                rows)
    if dev.type != "cuda":
        raise ValueError(f"block_step: unsupported device {dev}")
    status = BlockScan(cfg, model, carry, blk, rows).launch(0, i0, s,
                                                            n_valid)
    return carry, rows, status



def block_step_lanes(cfg, model, carry, blk, i0: int, s, n_valid: int,
                     rows: dict | None = None):
    """The lane instance of ``block_step``: L independent operators, each
    advancing its own W-event block against its own model and carry in
    one launch of L CTAs (the reference vmaps the kernel over tenant
    lanes).  Every operand carries a leading ``(L,)`` axis; events
    ``[s, n_valid)`` of each lane's block run, with ``s`` an int or one
    start per lane (a lane whose start is ``n_valid`` does nothing).
    Returns ``(carry, rows, status)`` with ``status`` (L, 2).  On CPU
    tensors it runs ``block_step_plain`` lane by lane."""
    dev = carry.sim_time.device
    W = cfg.block_events
    L = blk.ev_id.shape[0]
    if rows is None:
        rows = new_rows(cfg, W, dev, lanes=L)
    if not 0 <= n_valid <= W or (isinstance(s, int) and not 0 <= s <= n_valid):
        raise ValueError(f"block_step: need 0 <= s <= n_valid <= W, got "
                         f"s={s} n_valid={n_valid} W={W}")
    status = BlockScan(cfg, model, carry, blk, rows, lanes=L).launch(
        0, i0, s, n_valid)
    return carry, rows, status


def threefry_probe(key: torch.Tensor, n: int,
                   partitionable: bool | None = None):
    """The kernel's threefry on the card, for the tests: ``(split(key)
    (2, 2) int32, uniform(split(key)[1], (n,)))`` in the given layout
    (default ``prng.PARTITIONABLE``) — hold it against
    ``repro_torch.prng``."""
    if key.device.type != "cuda":
        raise ValueError("threefry_probe runs on a CUDA device")
    _check("key", key, torch.int32, (2,), key.device)
    part = prng.PARTITIONABLE if partitionable is None else partitionable
    keys = torch.empty((2, 2), dtype=torch.int32, device=key.device)
    u = torch.empty((n,), dtype=torch.float32, device=key.device)
    _build.check(_build.load().threefry_probe_launch(
        key.data_ptr(), n, int(part), keys.data_ptr(), u.data_ptr(),
        torch.cuda.current_stream(key.device).cuda_stream), "threefry_probe")
    return keys, u


block_step.launches = 0
block_step_lanes.launches = 0
