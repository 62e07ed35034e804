"""The port on the card: each CUDA kernel against its plain PyTorch
version (the block kernel also as its lane instance, one CTA per lane,
and inside the multi-tenant runtime), the block kernel's threefry against ``repro_torch.prng`` (in
both of jax's layouts), the engine's ``cuda`` and ``cuda_block`` backends
on the card against its ``torch`` backend on the CPU, and both on the
card against the NumPy oracle — BITWISE.

Every test here is marked ``gpu`` and skips where no CUDA device is
present.  The module imports only the port (no jax, no reference), so it
also runs on a machine with a card and no JAX:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.cep import block_cases, convert, engine, patterns as pat
from repro_torch.cep import runner
from repro_torch.core import shedder as shd
from repro_torch import prng
from repro_torch.configs import pspice_paper as pp
from repro_torch.data import streams
from repro_torch.kernels import block_step as kblock
from repro_torch.kernels import nfa_transition as kn
from repro_torch.kernels import ops as kops
from repro_torch.kernels import shed_select as ks

pytestmark = pytest.mark.gpu

SHAPES = [(3, 256, 11, 11, 38), (2, 1000, 5, 7, 9), (1, 37, 4, 3, 3),
          (8, 53, 11, 2, 3)]
COST = pp.COST


@pytest.fixture
def original_layout():
    """jax's original (non-partitionable) threefry layout, in which the
    committed quality results were made, for the test's duration."""
    with prng.layout(False):
        yield


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return torch.device("cuda")


def _inputs(P, N, M, C1, B, dev, seed=0):
    rng = np.random.default_rng(seed + N)
    d = dict(
        state=rng.integers(0, M, (P, N)).astype(np.int32),
        bind=rng.integers(-1, 3, (P, N)).astype(np.int32),
        active=rng.random((P, N)) < 0.6,
        trans=rng.integers(0, M, (P, M, C1)).astype(np.int32),
        ev_class=rng.integers(0, C1, P).astype(np.int32),
        ev_bind=rng.integers(-1, 3, P).astype(np.int32),
        final=np.full(P, M - 1, np.int32),
        uses=rng.random(P) < 0.5,
        tables=rng.random((P, B, M)).astype(np.float32),
        bins=rng.integers(1, 80, P).astype(np.int32),
        r_w=rng.integers(-50, B * 80 + 50, (P, N)).astype(np.int32),
        u=np.where(rng.random(P * N) < 0.7, rng.random(P * N),
                   np.nan).astype(np.float32))
    return {k: torch.from_numpy(v).to(dev) for k, v in d.items()}


@pytest.mark.parametrize("P,N,M,C1,B", SHAPES)
def test_cuda_kernels_equal_plain(cuda, P, N, M, C1, B):
    t = _inputs(P, N, M, C1, B, cuda)
    args = (t["state"], t["bind"], t["active"], t["trans"], t["ev_class"],
            t["ev_bind"], t["final"], t["uses"])
    before = kops.launch_counts()
    a, b = kn.nfa_advance(*args), kn.nfa_advance_plain(*args)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    lk = (t["state"], t["r_w"], t["active"], t["tables"], t["bins"])
    assert torch.equal(ks.utility_lookup(*lk), ks.utility_lookup_plain(*lk))
    fin = t["u"][~torch.isnan(t["u"])]
    edges = shd.bucket_edges(fin.min(), fin.max(), 128)
    assert torch.equal(ks.utility_histogram_edges(t["u"], edges),
                       ks.utility_histogram_plain(t["u"], edges))
    after = kops.launch_counts()
    assert all(after[k] == before[k] + 1 for k in
               ("nfa_advance", "utility_lookup", "utility_histogram"))


def test_cuda_wrappers_reject_bad_input(cuda):
    t = _inputs(3, 256, 11, 11, 38, cuda)
    with pytest.raises(ValueError):
        kn.nfa_advance(t["state"].long(), t["bind"], t["active"], t["trans"],
                       t["ev_class"], t["ev_bind"], t["final"], t["uses"])
    with pytest.raises(ValueError):
        ks.utility_lookup(t["state"].t(), t["r_w"], t["active"],
                          t["tables"], t["bins"])


@pytest.mark.parametrize("backend", ["cuda", "cuda_block"])
@pytest.mark.parametrize("shedder", ["pspice", "pmbl", "ebl"])
def test_engine_cuda_on_card_equals_torch_on_cpu(cuda, shedder, backend):
    sc = streams.get_scenario("stock")
    specs = sc.specs()
    cp = pat.compile_patterns(specs)
    cfg = runner.default_config(cp, max_pms=97, latency_bound=0.005,
                                shedder=shedder, emit_matches=True,
                                gather_stats=True, **COST)
    raw = sc.raw(n=600)
    rate = 3.0 / (cfg.c_base + cfg.c_match * 30)
    out = {}
    for name, dev in ((backend, "cuda"), ("torch", "cpu")):
        c = dataclasses.replace(cfg, backend=name)
        ev = streams.classify(specs, raw, rate=rate, seed=1, device=dev)
        model = engine.make_model(cp, c, device=dev)
        carry, outs = engine.run_engine(
            c, model, ev, engine.init_carry(c, seed=1, device=dev),
            device=dev)
        out[name] = convert.tree_to_numpy((carry, outs))
    (gc, go), (cc, co) = out[backend], out["torch"]
    assert float(cc["shed_calls"]) + float(cc["ebl_dropped"]) > 0

    def flat(tree, path=""):
        if isinstance(tree, dict):
            for k, v in tree.items():
                yield from flat(v, f"{path}.{k}")
        else:
            yield path, np.asarray(tree)

    a = dict(flat({"carry": gc, "outs": go}))
    b = dict(flat({"carry": cc, "outs": co}))
    bad = [k for k in a if not np.array_equal(a[k], b[k])]
    assert not bad, bad


# ---------------------------------------------------------------------------
# The event-block kernel
# ---------------------------------------------------------------------------

BLOCK_CASES = block_cases.CASES + (("stock", 97, "none"),)


def _block_case(name, N, shedder, dev):
    return block_cases.firing_block(name, N, shedder, dev, **COST)


@pytest.mark.parametrize("name,N,shedder", BLOCK_CASES)
def test_block_kernel_equals_plain(cuda, name, N, shedder):
    _kernel_equals_plain(cuda, name, N, shedder)


PMBL_CASES = [c for c in block_cases.CASES if c[2] == "pmbl"]


@pytest.mark.parametrize("name,N,shedder", PMBL_CASES)
def test_block_kernel_equals_plain_original_layout(cuda, original_layout,
                                                   name, N, shedder):
    """PM-BL fires in jax's original threefry layout, with the store in
    shared memory (stock, bus) and in device memory (soccer N=2048)."""
    _kernel_equals_plain(cuda, name, N, shedder)


@pytest.mark.parametrize("name,N,shedder", [block_cases.CASES[0],
                                            block_cases.CASES[-1]])
def test_block_kernel_device_memory_pieces_equal_plain(cuda, monkeypatch,
                                                       name, N, shedder):
    """The event rows, the model tables and the stats counts left in
    device memory (their shares set to 0 B), in both instantiations."""
    for share in ("ROWS_SMEM_MAX", "MODEL_SMEM_MAX", "STATS_SMEM_MAX"):
        monkeypatch.setattr(kblock, share, 0)
    _kernel_equals_plain(cuda, name, N, shedder)


def _kernel_equals_plain(cuda, name, N, shedder):
    cfg, model, carry, blk, i0 = _block_case(name, N, shedder, cuda)
    W = cfg.block_events
    got = {}
    for label, fn in (("kernel", kblock.block_step),
                      ("plain", kblock.block_step_plain)):
        c = convert.carry_from_numpy(convert.tree_to_numpy(carry), cuda)
        rows = kblock.new_rows(cfg, W, cuda)
        before = kblock.block_step.launches
        c, rows, status = fn(cfg, model, c, blk, i0, 0, W, rows)
        if label == "kernel":
            assert kblock.block_step.launches == before + 1
        torch.cuda.synchronize()
        got[label] = convert.tree_to_numpy((c, rows, status))
    if shedder in ("pspice", "pmbl"):
        assert int(got["plain"][2][0]) > 0, "the block must fire Alg. 2"
    a = dict(_flat(got["kernel"]))
    b = dict(_flat(got["plain"]))
    assert a.keys() == b.keys()
    bad = [k for k in a if not np.array_equal(a[k], b[k])]
    assert not bad, bad


@pytest.mark.parametrize("name,N,shedder", block_cases.CASES)
def test_lane_kernel_equals_plain_and_single_lane_kernel(cuda, name, N,
                                                         shedder):
    """The block kernel's lane instance (one CTA per lane, L = 3 lanes
    with their own streams, models and carries) equals, on every lane,
    ``block_step_plain`` and the one-lane kernel on that lane alone: bit
    for bit, in both instantiations (soccer N=2048 keeps its store in
    device memory)."""
    cfg, model, carry, blk, i0 = block_cases.firing_lanes(name, N, shedder,
                                                          cuda, **COST)
    W, L = cfg.block_events, blk.ev_id.shape[0]
    saved = convert.tree_to_numpy(carry)
    c = convert.carry_from_numpy(saved, cuda)
    before = kblock.block_step_lanes.launches
    _, rows, status = kblock.block_step_lanes(cfg, model, c, blk, i0, 0, W)
    assert kblock.block_step_lanes.launches == before + 1
    torch.cuda.synchronize()
    got = dict(_flat(convert.tree_to_numpy((c, rows, status))))
    fired = 0
    for k in range(L):
        lane = lambda t, k=k: engine.tree_map(lambda x: x[k], t)  # noqa
        for fn in (kblock.block_step, kblock.block_step_plain):
            ck = engine.tree_map(lambda x, k=k: x[k].clone(),
                                 convert.carry_from_numpy(saved, cuda))
            rk = kblock.new_rows(cfg, W, cuda)
            ck, rk, sk = fn(cfg, lane(model), ck, lane(blk), i0, 0, W, rk)
            torch.cuda.synchronize()
            want = dict(_flat(convert.tree_to_numpy((ck, rk, sk))))
            lane_got = dict(_flat(convert.tree_to_numpy(
                (lane(c), {n: v[k] for n, v in rows.items()}, status[k]))))
            bad = [n for n in want
                   if not np.array_equal(want[n], lane_got[n])]
            assert not bad, (k, fn.__name__, bad)
        fired += int(status[k, 0]) > 0
    assert got.keys()
    if shedder in ("pspice", "pmbl"):
        assert fired >= 2, "two lanes must fire Alg. 2 in the block"


def test_lanes_on_cuda_backend_equal_torch_on_cpu(cuda):
    """Lanes on "cuda" (the per-event kernels: one nfa_advance launch per
    event over all L·P pattern rows, the lookup and histogram kernels once
    per shedding lane) on the card equal lanes on "torch" on the CPU, bit
    for bit, with at most one advance launch per event."""
    from repro_torch import runtime as RT
    sc = streams.get_scenario("stock")
    specs = sc.specs()
    cp = pat.compile_patterns(specs)
    cfg = runner.default_config(cp, max_pms=97, latency_bound=0.005,
                                shedder="pspice", emit_matches=True,
                                gather_stats=True, **COST)
    rate = 3.0 / (cfg.c_base + cfg.c_match * 30)
    L, n = 3, 400
    out = {}
    for backend, dev in (("cuda", "cuda"), ("torch", "cpu")):
        c = dataclasses.replace(cfg, backend=backend)
        evs = [streams.classify(specs, sc.raw(n=n, seed=sc.seed + k),
                                rate=rate * (1 + 0.3 * k), seed=k,
                                device=dev) for k in range(L)]
        model = engine.make_model(cp, c, device=dev)
        kops.reset_launch_counts()
        carry, outs = RT.run_chunk_lanes(
            c, RT.broadcast_model(model, L), RT.stack(evs),
            RT.init_lane_carries(c, L, seed=1, device=dev), 0, device=dev)
        counts = kops.launch_counts()
        out[backend] = dict(_flat(convert.tree_to_numpy((carry, outs))))
        if backend == "cuda":
            torch.cuda.synchronize()
            assert 0 < counts["nfa_advance"] <= n
            assert counts["utility_lookup"] >= 2
            fired = (carry.shed_calls > 0).sum().item()
            assert fired >= 2, "two lanes must shed"
    a, b = out["cuda"], out["torch"]
    bad = [k for k in a if not np.array_equal(a[k], b[k])]
    assert not bad, bad


def test_multitenant_runtime_on_card_equals_cpu(cuda):
    """MultiTenantRuntime on "cuda_block" (the lane instance per W-event
    block, fused) on the card equals its run on the CPU (the plain
    version lane by lane), with refresh on: every carry leaf and every
    telemetry field but the walls, bit for bit; 0 engine host syncs."""
    from repro_torch import runtime as RT
    specs = [pat.make_q1(window_size=400, num_symbols=4)]
    cp = pat.compile_patterns(specs)
    cfg = runner.default_config(cp, max_pms=64, latency_bound=0.005,
                                gather_stats=True, shedder="pspice",
                                backend="cuda_block", block_events=32,
                                **COST)
    rate = 3.0 / (cfg.c_base + cfg.c_match * 20)
    L, n = 4, 1500
    rt = RT.RuntimeConfig(chunk_size=256, refresh=RT.RefreshConfig(
        every_chunks=2, min_observations=64.0))
    out = {}
    for dev in ("cuda", "cpu"):
        evs = [streams.classify(specs, streams.gen_stock(
            n, num_symbols=50, pattern_symbols=4, p_class=0.05,
            seed=100 + k), rate=rate * (1 + 0.3 * k), seed=k, device=dev)
            for k in range(L)]
        model = engine.make_model(cp, cfg, device=dev)
        mt = RT.MultiTenantRuntime(cfg, RT.broadcast_model(model, L), L,
                                   rt=rt, specs=specs, device=dev)
        engine.host_syncs = 0
        kops.reset_launch_counts()
        mt.push(RT.stack(evs), flush=True)
        if dev == "cuda":
            torch.cuda.synchronize()
            assert engine.host_syncs == 0
            assert kops.launch_counts()["block_step_lanes"] == sum(
                -(-c.n_events // (L * 32)) for c in mt.telemetry.chunks)
        rows = [{k: v for k, v in r.items() if "wall" not in k
                 and k != "events_per_s"} for r in mt.telemetry.rows()]
        out[dev] = (dict(_flat(convert.tree_to_numpy(mt.carry))), rows,
                    [s.refresh_count for s in mt.refresh_state])
    (a, ra, na), (b, rb, nb) = out["cuda"], out["cpu"]
    assert sum(na) > 0 and na == nb
    assert ra == rb
    bad = [k for k in a if not np.array_equal(a[k], b[k])]
    assert not bad, bad


def test_block_kernel_rejects_bad_input(cuda):
    cfg, model, carry, blk, i0 = _block_case("stock", 97, "none", cuda)
    bad = engine.EventBatch(*blk[:-1], blk.arrival.double())
    with pytest.raises(ValueError, match="arrival"):
        kblock.block_step(cfg, model, carry, bad, i0, 0, cfg.block_events)


@pytest.mark.parametrize("n", [5000, 4097])
@pytest.mark.parametrize("partitionable", [True, False])
@pytest.mark.parametrize("seed", [0, 7, 123456789])
def test_threefry_on_card_equals_prng(cuda, seed, partitionable, n):
    """Both layouts; an odd n takes the original layout's padded pair."""
    key = prng.PRNGKey(seed, device=cuda)
    keys, u = kblock.threefry_probe(key, n, partitionable=partitionable)
    want = prng.split(key, partitionable=partitionable)
    assert torch.equal(keys, want)
    assert torch.equal(u, prng.uniform(want[1], (n,),
                                       partitionable=partitionable))


@pytest.mark.parametrize("partitionable", [True, False])
@pytest.mark.parametrize("backend", ["cuda", "cuda_block"])
@pytest.mark.parametrize("shedder", ["none", "pspice", "pmbl", "ebl"])
def test_engines_on_card_equal_oracle(cuda, monkeypatch, shedder, backend,
                                      partitionable):
    """The oracle's overload fixture (x1.2/1.4/1.6) and a stream whose
    PM-BL fires depend on the layout, through each engine path on the
    card, under the literal sort-based Algorithm 2."""
    from repro_torch.eval import oracle, oracle_cases
    monkeypatch.setattr(prng, "PARTITIONABLE", partitionable)
    cases = [oracle_cases.overload_case(shedder, m, cuda)
             for m in oracle_cases.OVERLOAD_LEVELS]
    cases.append(oracle_cases.layout_case(shedder, cuda))
    for cfg, model, ev in cases:
        cfg = dataclasses.replace(cfg, backend=backend)
        o = oracle.run_oracle(cfg, model, ev, seed=0)
        carry, outs = engine.run_engine(
            cfg, model, ev, engine.init_carry(cfg, seed=0, device=cuda),
            device=cuda)
        assert engine.match_sets(outs) == o.matches
        np.testing.assert_array_equal(carry.complex_count.cpu().numpy(),
                                      o.complex_count)
        for f in ("pms_shed", "shed_calls", "overflow", "ebl_dropped"):
            assert float(getattr(carry, f)) == getattr(o, f), f
        np.testing.assert_array_equal(outs.l_e.cpu().numpy(), o.l_e)
        np.testing.assert_array_equal(outs.shed.cpu().numpy(), o.shed)
        np.testing.assert_array_equal(outs.dropped.cpu().numpy(), o.dropped)


def _flat(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, f"{path}.{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _flat(v, f"{path}[{i}]")
    else:
        yield path, np.asarray(tree)


# ---------------------------------------------------------------------------
# The flash kernel and the dense serving path
# ---------------------------------------------------------------------------

FLASH_SHAPES = [  # (B, Sq, Sk, H, KVH, D, Dv, causal, q_offset)
    (1, 128, 128, 2, 2, 32, 32, True, 0),
    (2, 256, 256, 4, 2, 64, 64, False, 0),
    (1, 256, 256, 8, 1, 64, 64, True, 0),      # MQA
    (2, 128, 256, 4, 4, 128, 128, False, 0),   # Sq != Sk
    (1, 2047, 2047, 4, 2, 8, 8, True, 0),      # ragged S
    (2, 48, 48, 4, 2, 16, 16, True, 0),
    (2, 64, 192, 4, 2, 32, 32, True, 100),     # a fully masked KV tile
    (4, 2048, 2048, 16, 8, 128, 128, True, 0),  # the prefill shape
    (2, 300, 300, 4, 2, 128, 128, True, 0),    # S not a multiple of 128
    (1, 130, 383, 2, 2, 128, 128, False, 0),
    (2, 200, 328, 4, 2, 128, 128, True, 128),  # Sq < Sk, q_offset Sk - Sq
    (1, 1000, 1000, 4, 2, 8, 8, True, 0),      # D in {8, 16, 64, 128}
    (1, 1000, 1000, 4, 2, 16, 16, True, 0),
    (1, 1000, 1000, 4, 2, 64, 64, True, 0),
    (2, 256, 256, 4, 2, 64, 128, True, 0),     # Dv != D
]
FLASH_TOL = {torch.float32: 2e-5, torch.bfloat16: 3e-2}
# bf16 is also held row by row, scaled to the output: the largest
# ‖kernel − plain‖ / ‖plain‖ over the Dv columns of one (b, i, h) row.
# A causal row that sees i keys has outputs of about sqrt(e / i), so the
# absolute bar alone is about a late row's size (chip_smoke.py,
# FLASH_ROW_TOL, gives the readings and the planted faults it rejects).
FLASH_ROW_TOL = 2e-2


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("B,Sq,Sk,H,KVH,D,Dv,causal,q_off", FLASH_SHAPES)
def test_flash_kernel_equals_plain(cuda, B, Sq, Sk, H, KVH, D, Dv, causal,
                                   q_off, dtype):
    from repro_torch.kernels import flash_attention as kfa
    rng = np.random.default_rng(Sq + D)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               .to(cuda, dtype) for s in ((B, Sq, H, D), (B, Sk, KVH, D),
                                          (B, Sk, KVH, Dv)))
    before = kfa.flash_attention.launches
    before_tc = kfa.flash_attention.sm90_launches
    got = kfa.flash_attention(q, k, v, causal=causal, q_offset=q_off)
    assert kfa.flash_attention.launches == before + 1
    # bf16 takes the tensor-core kernel, float32 the SIMT kernel.
    assert kfa.flash_attention.sm90_launches == \
        before_tc + (dtype == torch.bfloat16)
    want = kfa.flash_attention_plain(q, k, v, causal=causal, q_offset=q_off)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == (B, Sq, H, Dv)
    assert torch.isfinite(got).all()
    diff = got.float() - want.float()
    assert float(diff.abs().max()) <= FLASH_TOL[dtype]
    if dtype == torch.bfloat16:
        rows = diff.norm(dim=-1) / want.float().norm(dim=-1).clamp_min(1e-30)
        assert float(rows.max()) <= FLASH_ROW_TOL


def test_wgmma_probe_equals_matmul(cuda):
    """The bf16 kernel's building blocks (TMA with the 128-byte swizzle,
    wgmma from shared memory and from registers, V read transposed)
    against torch.matmul of the same tiles; the two sum in another order,
    and a layout fault moves entries by their own size (~10)."""
    from repro_torch.kernels import flash_attention as kfa
    rng = np.random.default_rng(14)
    a, b, v = (torch.from_numpy(rng.standard_normal((64, 128)).astype(
        np.float32)).to(cuda, torch.bfloat16) for _ in range(3))
    c, e = kfa.wgmma_probe(a, b, v)
    torch.cuda.synchronize()
    want_c = a.float() @ b.float().t()
    want_e = c.to(torch.bfloat16).float() @ v.float()
    assert float((c - want_c).abs().max()) <= 1e-2
    assert float((e - want_e).abs().max()) <= 1e-2


def test_flash_kernel_rejects_bad_input(cuda):
    from repro_torch.kernels import flash_attention as kfa
    q = torch.zeros((1, 16, 2, 32), device=cuda)
    with pytest.raises(ValueError, match="multiple of 8"):
        kfa.flash_attention(q[..., :12].contiguous(), q[..., :12].contiguous(),
                            q[..., :12].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        kfa.flash_attention(q.transpose(1, 2), q, q)
    with pytest.raises(ValueError, match="float32 or"):
        kfa.flash_attention(q.half(), q.half(), q.half())


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "qwen1.5-110b"])
def test_smoke_serving_path_on_card_equals_cpu(cuda, arch):
    """prefill and decode_step of a smoke config (float32) on the card
    (the flash kernel in each layer) against the CPU (its plain
    version)."""
    from repro_torch.configs import registry
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.models import decode as D
    from repro_torch.models import transformer as T
    cfg = registry.get_smoke_config(arch)
    params = T.init_params(cfg, seed=0, device="cpu")
    on_card = _to(params, cuda)
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 33))
                            .astype(np.int32))
    out = {}
    for dev, p in (("cpu", params), ("cuda", on_card)):
        before = kfa.flash_attention.launches
        cache, lg = D.prefill(cfg, p, {"tokens": toks[:, :32].to(dev)}, 40)
        if dev == "cuda":
            assert kfa.flash_attention.launches == before + cfg.num_layers
        lg2, cache = D.decode_step(cfg, p, cache, toks[:, 32].to(dev))
        out[dev] = [x.cpu() for x in (lg, lg2, cache["k"], cache["v"])]
    for a, b in zip(out["cuda"], out["cpu"]):
        assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max())


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    return tree.to(dev)


# ---------------------------------------------------------------------------
# The ladder's PM trim over lanes and SIGKILL recovery on the card
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("L", [1, 3, 128])
def test_histogram_lanes_kernel_equals_plain(cuda, L):
    """The lane instance of the histogram kernel (grid y = lane) equals
    its plain version and, row by row, the one-lane kernel; NaN counts
    nowhere; one launch per call."""
    rng = np.random.default_rng(L)
    n, nbins = 768, 128
    u = rng.random((L, n)).astype(np.float32)
    u[rng.random((L, n)) < 0.3] = np.nan
    u = torch.from_numpy(u).to(cuda)
    lo = torch.nan_to_num(u, nan=2.0).amin(1)
    hi = torch.nan_to_num(u, nan=-1.0).amax(1)
    edges = shd.bucket_edges(lo, torch.where(hi > lo, hi, lo + 1.0), nbins)
    before = ks.utility_histogram_lanes.launches
    got = ks.utility_histogram_lanes(u, edges)
    assert ks.utility_histogram_lanes.launches == before + 1
    want = ks.utility_histogram_lanes_plain(u, edges)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    for k in (0, L - 1):
        assert torch.equal(got[k], ks.utility_histogram_edges(u[k],
                                                              edges[k]))


@pytest.mark.parametrize("shedder", ["pspice", "pmbl"])
def test_trim_store_lanes_on_card_equals_cpu(cuda, shedder):
    """The ladder's trim over 16 lanes on the card (one lookup launch over
    the L·P pattern rows, one lane-histogram launch per level) equals the
    plain versions on the CPU, bit for bit."""
    from repro_torch.runtime import guard as GD
    sc = streams.get_scenario("stock")
    cp = pat.compile_patterns(sc.specs())
    cfg = runner.default_config(cp, max_pms=256, shedder=shedder,
                                backend="cuda_block", **COST)
    P, N, M, L = cfg.num_patterns, cfg.max_pms, cfg.max_states, 16
    rng = np.random.default_rng(5)
    tables = torch.from_numpy(rng.random((L, P, 9, M)).astype(np.float32))
    model = engine.make_model(cp, cfg, device="cpu")
    mL = engine.tree_map(lambda x: x[None].expand(
        (L,) + tuple(x.shape)).contiguous(), model)._replace(
            ut_tables=tables, ut_bins=torch.full((L, P), 60,
                                                 dtype=torch.int32))
    cL = engine.tree_map(lambda *xs: torch.stack(xs), *[
        engine.init_carry(cfg, seed=k, device="cpu") for k in range(L)])
    cL = cL._replace(pms=cL.pms._replace(
        active=torch.from_numpy(rng.random((L, P, N)) < 0.5),
        state=torch.from_numpy(rng.integers(1, M, (L, P, N)).astype(
            np.int32)),
        open_idx=torch.from_numpy(rng.integers(0, 2000, (L, P, N)).astype(
            np.int32))))
    want = GD.trim_store_lanes(cfg, mL, cL, 2500, 0.3)
    to = lambda t: engine.tree_map(lambda x: x.to(cuda), t)  # noqa: E731
    kops.reset_launch_counts()
    got = GD.trim_store_lanes(cfg, to(mL), to(cL), 2500, 0.3)
    torch.cuda.synchronize()
    counts = kops.launch_counts()
    if shedder == "pspice":
        assert counts["utility_lookup"] == 1
        assert counts["utility_histogram_lanes"] == 3
    for a, b in zip(convert.tree_to_numpy(want).values(),
                    convert.tree_to_numpy(got).values()):
        if isinstance(a, dict):
            for x, y in zip(a.values(), b.values()):
                np.testing.assert_array_equal(x, y)
        else:
            np.testing.assert_array_equal(a, b)


def test_sigkill_recovery_on_card(cuda, tmp_path):
    """A child on the card (cuda_block) is SIGKILLed mid-chunk, relaunched,
    recovers from its snapshot + WAL and ends with the report of the
    uninterrupted run on the card, bit for bit."""
    from repro_torch.runtime import supervisor as SV
    spec = {"backend": "cuda_block", "shedder": "pspice", "n": 4096,
            "push": 512, "chunk": 256, "max_pms": 256, "block_events": 32,
            "rate_mult": 1.0, "refresh_every": 4, "snapshot_every": 4,
            "min_observations": 64.0}
    clean = SV.run_service(spec)     # builds the kernels before any child
    res = SV.Supervisor(str(tmp_path)).run(spec, kill="chunk:6")
    assert res["killed"] and res["recovered"]
    rep = res["report"]
    for k in ("carry_sha", "counters", "matches", "events_processed"):
        assert rep[k] == clean[k], k


@pytest.mark.parametrize("poison", ["sim_time", "ema_gap", "tables"])
def test_block_kernel_equals_plain_on_poisoned_state(cuda, poison):
    """A NaN clock, EMA or utility table (what the fault injector's
    lane_poison / table_corrupt plant) flows through the kernel as through
    its plain version: NaN where the plain version has NaN, every other
    bit equal — the kernel's max/min propagate NaN as torch's do."""
    cfg, model, carry, blk, i0 = _block_case("stock", 256, "pspice", cuda)
    nan = torch.tensor(float("nan"), device=cuda)
    if poison == "tables":
        model = model._replace(ut_tables=torch.where(
            torch.rand_like(model.ut_tables) < 0.3, nan, model.ut_tables))
    else:
        carry = carry._replace(**{poison: nan.clone()})
    W = cfg.block_events
    got = {}
    for label, fn in (("kernel", kblock.block_step),
                      ("plain", kblock.block_step_plain)):
        c = convert.carry_from_numpy(convert.tree_to_numpy(carry), cuda)
        rows = kblock.new_rows(cfg, W, cuda)
        c, rows, status = fn(cfg, model, c, blk, i0, 0, W, rows)
        torch.cuda.synchronize()
        got[label] = convert.tree_to_numpy((c, rows, status))
    a, b = dict(_flat(got["kernel"])), dict(_flat(got["plain"]))
    bad = [k for k in a if not np.array_equal(a[k], b[k], equal_nan=(
        a[k].dtype.kind == "f"))]
    assert not bad, bad
    if poison != "tables":
        assert np.isnan(b[f"[0].{poison}"]), "the poison must stay in"
