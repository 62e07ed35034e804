"""The port's contract checker (``repro_torch.analysis``) is LIVE and
agrees with the reference's (``repro.analysis``).

Every rule is proven by mutation on the CPU: reintroduce the sort plans,
read the device inside the scan, promote to float64 outside ``fp.fma``,
copy an owned carry, key a plan on a per-call value, present a plain
cell as the block backend, feed the kernel parsers a spill and a DFMA,
run a census on a workload that never fires — the rule must FAIL, and
the unmutated cell must pass it.  Parity: the budget formulas equal the
reference's on every cell's config, the no-sort verdicts on one
workload agree (the reference's ``xla`` against the port's ``torch``),
and every reference (rule, cell) with a counterpart appears, renamed by
backend, in the port's quick sweep, passing as the reference's own
``xla`` cells pass.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import pytest
import torch

from _torch_bridge import port_config, to_port
from repro.analysis import contracts as RC
from repro.analysis import driver as RD
from repro.analysis import rules as RR
from repro.cep import engine as reng
from repro_torch import fp
from repro_torch.analysis import contracts as C
from repro_torch.analysis import driver as D
from repro_torch.analysis import kernel_rules as KR
from repro_torch.analysis import rules as R
from repro_torch.analysis import tracing as T
from repro_torch.cep import engine as eng
from repro_torch.runtime import lanes as LN

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def fired():
    return D._workload_fired(device=CPU)


@pytest.fixture(scope="module")
def sweep():
    return D.check_all(quick=True, device="cpu")


def _art(cfg, model, ev, name="cell", entry="cep.run_engine", fn=None,
         carry=None):
    f, _ = C.registry()[entry]
    carry = eng.init_carry(cfg, device=CPU) if carry is None else carry
    return R.run_artifact(fn or f, cfg, model, ev, carry, CPU, name=name,
                          n_events=ev.ev_class.shape[0])


def _block(fired, n=32):
    """The fired workload's first block on "cuda_block" (on the CPU the
    kernel's plain version runs, ~1 s a block)."""
    cfg, model, ev = fired
    return (dataclasses.replace(cfg, backend="cuda_block"), model,
            eng.EventBatch(*(x[:n] for x in ev)))


def _rule(findings, rule):
    out = [f for f in findings if f.rule == rule]
    assert out, f"rule {rule} produced no findings"
    return out


def _verdict(art, rule, entry="cep.run_engine"):
    fs = R.run_rules(art, C.get_contract(entry)) + \
        KR.check_kernel_launches(art)
    return all(f.ok for f in _rule(fs, rule)), fs


# ---------------------------------------------------------------------------
# Liveness: each rule trips under its mutation
# ---------------------------------------------------------------------------

class TestMutationNoSort:
    @pytest.mark.parametrize("mutation", [{}, {"spawn_alloc": "argsort"},
                                          {"shed_plan": "sort"}],
                             ids=["default", "argsort", "sortplan"])
    def test_sort_plans_trip(self, fired, mutation):
        cfg, model, ev = fired
        art = _art(dataclasses.replace(cfg, **mutation), model, ev)
        ok, fs = _verdict(art, "no-sort")
        assert ok == (not mutation), [f.evidence for f in fs
                                      if f.rule == "no-sort"]
        if mutation:
            assert "aten.sort" in _rule(fs, "no-sort")[0].evidence

    def test_waiver_is_visible(self, fired):
        """A waived rule reports a PASSING finding naming the waiver."""
        cfg, model, ev = fired
        art = _art(dataclasses.replace(cfg, shed_plan="sort"), model, ev,
                   name="legacy")
        legacy = C.Contract(name="legacy.oracle", waived=("no-sort",),
                            waiver_note="keeps its sort on purpose")
        f, = _rule(R.run_rules(art, legacy), "no-sort")
        assert f.ok and "waived by contract legacy.oracle" in f.evidence
        assert "on purpose" in f.evidence


def _with_item(entry, reads):
    """``entry`` wrapped to read ``reads`` of its latencies to the host
    with ``.item()`` (a sync per read on the card)."""
    def wrapped(*args):
        carry, outs = entry(*args)
        for k in range(reads):
            outs.l_e[k].item()
        return carry, outs
    return wrapped


class TestMutationNoSync:
    def test_item_per_event_trips_the_per_event_budget(self, fired):
        cfg, model, ev = fired
        n = ev.ev_class.shape[0]
        assert _verdict(_art(cfg, model, ev), "no-sync")[0]
        art = _art(cfg, model, ev, name="mut[item]",
                   fn=_with_item(eng.run_engine, n))
        ok, fs = _verdict(art, "no-sync")
        assert not ok, _rule(fs, "no-sync")[0].evidence

    def test_one_item_trips_the_fused_block_path(self, fired):
        cfg, model, ev = _block(fired)
        clean = _art(cfg, model, ev)
        assert _verdict(clean, "no-sync")[0] and clean.syncs == 0
        art = _art(cfg, model, ev, name="mut[item]",
                   fn=_with_item(eng.run_engine, 1))
        assert art.syncs == 1 and not _verdict(art, "no-sync")[0]

    def test_engine_reads_are_counted_on_the_cpu(self, fired):
        """A CPU read dispatches nothing: the engine's own count of its
        reads joins the census (one a event, one more a fire)."""
        cfg, model, ev = fired
        art = _art(cfg, model, ev)
        n, fires = ev.ev_class.shape[0], int(art.counts["shed_calls"])
        assert fires > 0 and art.syncs == n + fires + 1


class TestMutationNoF64:
    def test_float64_outside_fma_trips(self, fired):
        cfg, model, ev = fired

        def promoted(*args):
            carry, outs = eng.run_engine(*args)
            return carry._replace(sim_time=carry.sim_time.double()), outs

        ok, fs = _verdict(_art(cfg, model, ev, fn=promoted), "no-f64")
        assert not ok and "aten._to_copy" in _rule(fs, "no-f64")[0].evidence

    def test_fma_is_the_waived_site(self, fired):
        cfg, model, ev = fired

        def with_fma(*args):
            carry, outs = eng.run_engine(*args)
            fp.fma(outs.l_e, outs.l_e, outs.l_e)
            return carry, outs

        art = _art(cfg, model, ev, fn=with_fma)
        ok, fs = _verdict(art, "no-f64")
        assert ok and sum(art.f64_waived.values()) > 0
        assert "waived by site" in _rule(fs, "no-f64")[0].evidence

    def test_plain_block_version_is_not_judged(self, fired):
        """On the CPU the block kernel's plain version runs (float64 in
        its fp.fma, host reads): none of it counts against the path."""
        art = _art(*_block(fired))
        assert art.plain_ops > 1000 and not art.f64 and art.syncs == 0
        assert _verdict(art, "no-f64")[0]


class TestMutationInPlace:
    def _lanes(self, cfg, model, ev, L=2):
        return (LN.broadcast_model(model, L), LN.stack([ev] * L),
                LN.init_lane_carries(cfg, L, device=CPU))

    @pytest.mark.parametrize("backend", ["torch", "cuda_block"])
    def test_owned_scan_that_copies_trips(self, fired, monkeypatch,
                                          backend):
        cfg, model, ev = _block(fired)
        cfg = dataclasses.replace(cfg, backend=backend)
        entry = "runtime.run_chunk_lanes_donated"
        fn, ctr = C.registry()[entry]

        def art(name):
            lm, le, lc = self._lanes(cfg, model, ev)
            return R.run_artifact(fn, cfg, lm, le, lc, 0, CPU, name=name,
                                  n_events=ev.ev_class.shape[0], owned=True)

        assert all(f.ok for f in _rule(R.run_rules(art("clean"), ctr),
                                       "in-place"))
        keep, own = eng._keep, eng._own
        monkeypatch.setattr(eng, "_keep", lambda carry, c, outs, own_: keep(
            eng.tree_map(torch.clone, carry), c, outs, own_))
        monkeypatch.setattr(eng, "_own", lambda carry, copy=True: own(
            carry, copy=True))
        mut = art("mut[copied carry]")
        f, = _rule(R.run_rules(mut, ctr), "in-place")
        assert not f.ok and "kept their storage" in f.evidence
        if backend == "cuda_block":
            bi, = _rule(KR.check_kernel_launches(mut), "block-inplace")
            assert not bi.ok

    def test_undonated_entry_waives_with_its_reason(self, sweep):
        rows = [r for r in sweep["rows"] if r["rule"] == "in-place"
                and r["cell"].startswith("run_engine_chunk[")]
        assert rows and all("waived by contract cep.run_engine_chunk: the "
                            "entry copies the carry" in r["evidence"]
                            for r in rows)


class TestMutationRetrace:
    def test_plan_keyed_on_a_per_call_value_trips(self):
        @functools.lru_cache(maxsize=32)
        def plan(cfg, k):
            return (cfg, k)

        plan("cfg", 0)                         # warm-up
        with T.CompileCounter(plan) as cc:
            for k in range(3):
                plan("cfg", k)
            leaky = {"plan": cc.compiles(plan)}
        with T.CompileCounter(plan) as cc:
            for _ in range(3):
                plan("cfg", 0)
            tight = {"plan": cc.compiles(plan)}
        assert leaky == {"plan": 2} and tight == {"plan": 0}
        bad, = T.retrace_findings(leaky, {"plan": 0})
        good, = T.retrace_findings(tight, {"plan": 0})
        assert not bad.ok and "per-call value" in bad.evidence and good.ok

    def test_build_counters_count(self, monkeypatch):
        from repro_torch.kernels import _build
        with T.CompileCounter(_build.build, _build.load) as cc:
            monkeypatch.setattr(_build.load, "compiles",
                                _build.load.compiles + 1)
            assert cc.compiles(_build.load) == 1
            assert cc.compiles(_build.build) == 0

    def test_sweep_has_no_rebuild(self, sweep):
        rows = [r for r in sweep["rows"] if r["rule"] == "retrace"]
        names = {r["evidence"].split(":")[0] for r in rows}
        assert {"kernels.build", "kernels.load", "dist.lanes_plan",
                "dist.lanes_plan[post-recovery]"} <= names
        assert all(r["status"] == "pass" and ": 0 builds" in r["evidence"]
                   for r in rows)


class TestKernelRules:
    def test_plain_cell_presented_as_block_trips(self, fired):
        cfg, model, ev = fired
        art = _art(cfg, model, ev)                       # torch run ...
        art.cfg = dataclasses.replace(cfg, backend="cuda_block")  # ... block
        f, = KR.check_kernel_launches(art)
        assert f.rule == "kernel-block" and not f.ok

    def test_block_cell_launches_and_updates_in_place(self, fired):
        art = _art(*_block(fired, 64))
        fs = KR.check_kernel_launches(art)
        assert {f.rule for f in fs} == {"kernel-block", "block-inplace"}
        assert all(f.ok for f in fs), [f.evidence for f in fs]
        assert art.launches == {"block_step": 2}

    PTXAS = "\n".join([
        "ptxas info    : 0 bytes gmem",
        "ptxas info    : Compiling entry function "
        "'_Z17block_step_kernelILb1EEv13BlockStepArgs' for 'sm_90a'",
        "ptxas info    : Function properties for "
        "_Z17block_step_kernelILb1EEv13BlockStepArgs",
        "    {st} bytes stack frame, {st} bytes spill stores, {ld} bytes "
        "spill loads",
        "ptxas info    : Used 255 registers, 1024 bytes smem, 784 bytes "
        "cmem[0]",
        "ptxas info    : Compiling entry function "
        "'_Z18nfa_advance_kernelPKiS0_PKbS0_S0_S0_S0_S2_iiiiPiPb' for "
        "'sm_90a'",
        "ptxas info    : Function properties for "
        "_Z18nfa_advance_kernelPKiS0_PKbS0_S0_S0_S0_S2_iiiiPiPb",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 18 registers, 432 bytes cmem[0]",
    ])
    SASS = "\n".join([
        "\tcode for sm_90a",
        "\t\tFunction : _Z18nfa_advance_kernelPKiS0_PKbS0_S0_S0_S0_S2_"
        "iiiiPiPb",
        "\t.headerflags\t@\"EF_CUDA_TEXMODE_UNIFIED EF_CUDA_64BIT_ADDRESS\"",
        "        /*0000*/                   LDC R1, c[0x0][0x28] ;"
        "                 /* 0x00000a00ff017b82 */",
        "        /*0010*/                   {op} ;",
        "        /*0020*/                   EXIT ;",
    ])

    def test_ptxas_report_parses_the_log(self):
        rows = KR.ptxas_report(self.PTXAS.format(st=28, ld=36),
                               "block_step_kernel")
        assert rows == [("_Z17block_step_kernelILb1EEv13BlockStepArgs", 255,
                         28, 36, 1024)]
        assert KR.ptxas_report(self.PTXAS.format(st=0, ld=0),
                               "nfa_advance")[0][1:] == (18, 0, 0, 0)

    @pytest.mark.parametrize("st,ld,ok", [(28, 36, True), (80, 36, False)])
    def test_spill_budget(self, st, ld, ok):
        fs = KR.build_findings(self.PTXAS.format(st=st, ld=ld), "")
        block = [f for f in fs if "block_step_kernel" in f.evidence]
        assert block and block[0].ok == ok, block[0].evidence
        nfa = [f for f in fs if "nfa_advance_kernel" in f.evidence
               and f.rule == "kernel-regs"]
        assert nfa and nfa[0].ok
        missing = [f for f in fs if "no entry" in f.evidence]
        assert missing and not any(f.ok for f in missing)

    @pytest.mark.parametrize("op,ok", [
        ("FFMA R4, R2, R4, R6", True), ("DFMA R4, R2, R4, R6", False),
        ("DADD R4, R2, R6", False), ("CALL.ABS.NOINC `(vprintf)", False),
        ("CALL.ABS.NOINC `(malloc)", False)])
    def test_sass_census(self, op, ok):
        sass = self.SASS.format(op=op)
        funcs = KR.sass_functions(sass)
        assert list(funcs) == ["_Z18nfa_advance_kernelPKiS0_PKbS0_S0_S0_"
                               "S0_S2_iiiiPiPb"]
        fs = [f for f in KR.build_findings("", sass)
              if f.rule == "kernel-sass" and "nfa_advance" in f.evidence]
        assert len(fs) == 1 and fs[0].ok == ok, fs[0].evidence


def test_lane_rows_reach_the_advance_contiguous(fired, monkeypatch):
    """Found by the checker on the card: with one pattern a lane, the
    lane loop's event rows were strided views, which the advance kernel
    refuses; every row it hands the kernel is contiguous now."""
    from repro_torch.kernels import ops as kops
    cfg, model, ev = fired
    cfg = dataclasses.replace(cfg, backend="cuda")
    seen = []
    advance = kops.advance_seq_multi

    def checked(*args):
        seen.append(all(t.is_contiguous() for t in args))
        return advance(*args)

    monkeypatch.setattr(kops, "advance_seq_multi", checked)
    L, lev = 2, LN.stack([eng.EventBatch(*(x[:32] for x in ev))] * 2)
    LN.run_chunk_lanes(cfg, LN.broadcast_model(model, L), lev,
                       LN.init_lane_carries(cfg, L, device=CPU), 0, CPU)
    assert cfg.num_patterns == 1 and seen and all(seen)


def test_coverage_fails_on_the_quiet_workload():
    """The reference's quiet fixture spawns nothing on the per-event
    path: a census there judges code that never ran."""
    cfg, model, ev = D._workload(device=CPU)
    f, = _rule(R.run_rules(_art(cfg, model, ev),
                           C.get_contract("cep.run_engine")), "coverage")
    assert not f.ok and "never" in f.evidence


class TestCheckAll:
    def test_quick_sweep_green(self, sweep):
        bad = [r for r in sweep["rows"] if r["status"] != "pass"]
        assert sweep["ok"], bad
        assert sweep["cells"] >= 12 and sweep["device"] == "cpu"
        seen = {r["rule"] for r in sweep["rows"]}
        for must in ("no-sort", "no-sync", "no-f64", "launch-budget",
                     "in-place", "temp-bytes", "gather-bytes", "coverage",
                     "retrace", "kernel-block", "block-inplace"):
            assert must in seen, must

    def test_cli_exits_zero(self, tmp_path, monkeypatch):
        from repro_torch.analysis import __main__ as M
        monkeypatch.setattr(D, "check_all", lambda **kw: {
            "ok": True, "n_fail": 0, "cells": 1, "rows": [
                {"rule": "no-sort", "cell": "c", "status": "pass",
                 "evidence": "e"}]})
        assert M.main(["--quick", "--device", "cpu",
                       "--out", str(tmp_path / "a.json")]) == 0

    def test_default_device_is_the_card(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="CUDA"):
            D.check_all(quick=True)


def test_contract_decorator_is_zero_cost():
    marker = object()

    @C.contract("test.zero_cost", max_compiles=0)
    def fn():
        return marker

    assert fn() is marker
    assert C.get_entry("test.zero_cost") is fn
    assert C.get_contract("test.zero_cost").max_compiles == 0
    assert C.get_entry("cep.run_engine") is eng.run_engine
    assert C.get_entry("runtime.run_chunk_lanes_donated") is \
        LN.run_chunk_lanes_donated


# ---------------------------------------------------------------------------
# Parity with the reference's checker
# ---------------------------------------------------------------------------

def _ref_cfgs():
    """The configs of every reference cell (both fixtures)."""
    out = []
    for fixture in (RD._workload, RD._workload_fired):
        cfg0 = fixture()[0]
        out += [dataclasses.replace(cfg0, backend=b, shedder=s)
                for b in RD.BACKENDS for s in RD.SHEDDERS]
    return out


def test_budget_formulas_equal_the_reference():
    for cfg in _ref_cfgs():
        pcfg = port_config(cfg, {"xla": "torch", "pallas": "cuda",
                                 "pallas_block": "cuda_block"}[cfg.backend])
        assert C.store_bytes(pcfg) == RC.store_bytes(cfg)
        for n in (32, 64, 96, 30000):
            assert C.hot_path_temp_budget(pcfg, n) == \
                RC.hot_path_temp_budget(cfg, n)
            assert C.hot_path_gather_budget(pcfg, n) == \
                RC.hot_path_gather_budget(cfg, n)


def test_registry_covers_the_reference_entry_points():
    import repro.runtime.lanes     # noqa: F401 — registers lanes
    import repro.runtime.service   # noqa: F401 — registers groups
    import repro_torch.runtime     # noqa: F401
    ref = {k for k in RC.registry() if not k.startswith("test.")}
    assert ref <= set(C.registry())


@pytest.mark.parametrize("mutation", [{}, {"spawn_alloc": "argsort"},
                                      {"shed_plan": "sort"}],
                         ids=["default", "argsort", "sortplan"])
def test_no_sort_verdicts_equal_the_reference(mutation):
    """The reference's xla verdict (its jaxpr census) and the port's
    torch verdict (its dispatch census) on the very same fired
    workload."""
    cfg, model, ev = RD._workload_fired()
    cfg = dataclasses.replace(cfg, **mutation)
    art = RR.trace_artifact(reng.run_engine, cfg, model, ev,
                            reng.init_carry(cfg), compile=False)
    ref_ok = all(f.ok for f in RR.run_rules(
        art, RC.get_contract("cep.run_engine")) if f.rule == "no-sort")
    pmodel, pev, pcarry = to_port(model, ev, reng.init_carry(cfg))
    part = _art(port_config(cfg, "torch"), pmodel, pev, carry=pcarry)
    assert _verdict(part, "no-sort")[0] == ref_ok == (not mutation)


_RULE = {"no-sort": "no-sort", "no-callback": "no-sync", "no-f64": "no-f64",
         "control-flow": "launch-budget", "donation": "in-place",
         "temp-bytes": "temp-bytes", "gather-bytes": "gather-bytes",
         "pallas": "kernel-block", "pallas-block-alias": "block-inplace",
         "retrace": "retrace"}
_BACKEND = (("pallas_block", "cuda_block"), ("pallas", "cuda"),
            ("xla", "torch"))


def _port_cell(cell: str) -> str:
    for a, b in _BACKEND:
        cell = cell.replace(f"[{a}/", f"[{b}/")
    return cell


@pytest.fixture(scope="module")
def reference_xla_rows():
    """The reference's own verdicts on its quick sweep's xla cells,
    compiled as its check_all compiles them (its pallas_block cells stop
    at pl.load under this jax)."""
    cfg0, model, ev = RD._workload()
    n, chunk = ev.ev_class.shape[0], 32
    fs = []
    for backend, shedder in RD._cells(quick=True):
        if backend != "xla":
            continue
        cfg = dataclasses.replace(cfg0, backend=backend, shedder=shedder)
        art = RR.trace_artifact(reng.run_engine, cfg, model, ev,
                                reng.init_carry(cfg), n_events=n,
                                name=f"run_engine[{backend}/{shedder}]")
        fs += RD._findings_for(art, RC.get_contract("cep.run_engine"))
    piece = jax.tree.map(lambda x: x[:chunk], ev)
    carry = reng.init_carry(cfg0)
    art = RR.trace_artifact(reng.run_engine_chunk, cfg0, model, piece,
                            carry, jnp.int32(0), n_events=chunk,
                            name=f"run_engine_chunk[xla/{cfg0.shedder}]",
                            min_alias_pairs=len(jax.tree.leaves(carry)))
    fs += RD._findings_for(art, RC.get_contract("cep.run_engine_chunk"))
    return [f.row() for f in fs]


def test_every_reference_finding_has_a_passing_counterpart(
        reference_xla_rows, sweep):
    port = {(r["rule"], r["cell"]): r for r in sweep["rows"]}
    port_cells = {r["cell"] for r in sweep["rows"]}
    ref_quick_cells = {f"run_engine[{b}/{s}]"
                       for b, s in RD._cells(quick=True)} | {
        "run_engine[fired-heavy/fused/pspice]",
        "run_engine_chunk[xla/pspice]", "run_chunk_lanes[xla/pspice]",
        "run_chunk_lanes_donated[xla/pspice]", "retrace-sweep",
        "persist-sweep", "run_engine_chunk[xla/pspice/persist-restored]"}
    assert {_port_cell(c) for c in ref_quick_cells} <= port_cells
    assert reference_xla_rows
    for row in reference_xla_rows:
        assert row["status"] == "pass", row
        key = (_RULE[row["rule"]], _port_cell(row["cell"]))
        assert key in port and port[key]["status"] == "pass", (row, key)


@pytest.mark.parametrize("name,sort", [
    ("void cub::DeviceRadixSortOnesweepKernel<...>", True),
    ("void at::native::bitonicSortKVInPlace<...>", True),
    ("void at::native::(anonymous namespace)::sort_postprocess_kernel", True),
    ("void at::native::(anonymous namespace)::searchsorted_cuda_kernel<"
     "float, long>(long*, float const*, float const*)", False),
    ("block_step_kernel<true>", False)])
def test_sort_kernel_names(name, sort):
    """The profiler half of no-sort: a binary search is no sort (the
    threshold plan's searchsorted ran on the card in every cell)."""
    assert R._is_sort_kernel(name) == sort
