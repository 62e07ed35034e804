"""The block kernel's launch path on the CPU: the shared-memory layout
planner, the argument block built once per scan and patched per block,
and one launch per W-event block.  No card is needed: the planner and the
argument block are plain Python over CPU tensors, and on CPU tensors a
scan's launches run the kernel's plain version."""
from __future__ import annotations

import ctypes
import dataclasses
import math
import pathlib
import re

import pytest

from repro_torch.cep import block_cases, engine, runner
from repro_torch.cep import patterns as pat
from repro_torch.data import streams
from repro_torch.kernels import block_step as kblock

COST = dict(c_base=3e-4, c_match=6e-5, c_shed_base=1.5e-4, c_shed_pm=5e-7,
            c_ebl=6e-5)
CSRC = pathlib.Path(kblock.__file__).resolve().parent.parent / "csrc"

# Each case of block_cases.CASES: the kernel's instantiation and the bytes
# of its store and fire scratch, 18 per slot (active 1, state, open_idx,
# bind 4 each, score 4, selection flag 1) plus 4·A idset bytes per slot
# when a pattern is ANY (A = 11 for stock and soccer, 8 for bus).
PLANNED = {
    ("stock", 256, "pspice"): ("shared", 768 * 18),
    ("stock", 256, "pmbl"): ("shared", 768 * 18),
    ("stock", 2048, "pspice"): ("shared", 6144 * 18),
    ("bus", 128, "pmbl"): ("shared", 128 * (18 + 4 * 8)),
    ("soccer", 256, "ebl"): ("shared", 2048 * (18 + 4 * 11)),
    ("soccer", 2048, "pmbl"): ("global", 16384 * (18 + 4 * 11)),
}


def _layout(cfg, cp):
    return kblock.plan_layout(cfg, cp.trans.shape[2], 1)


@pytest.mark.parametrize("case", block_cases.CASES)
def test_planner_places_each_case(case):
    cp, cfg = block_cases.case_config(*case, **COST)
    lay = _layout(cfg, cp)
    assert (lay.store, lay.store_bytes) == PLANNED[case]
    assert lay.rows_smem and lay.model_smem and lay.stats_smem
    assert lay.smem_bytes <= kblock.SMEM_CAP
    if lay.store == "shared":
        assert lay.smem_bytes > lay.store_bytes
    else:
        assert lay.store_bytes + lay.smem_bytes > kblock.SMEM_CAP


def test_cases_take_both_instantiations():
    stores = {_layout(*reversed(block_cases.case_config(*c, **COST))).store
              for c in block_cases.CASES}
    assert stores == {"shared", "global"}


def test_planner_eight_any_patterns_at_default_width():
    """P = 8 ANY patterns at default_config's N = 2048 (about 1 MB of
    store) keep the store in device memory; the rest stays in shared
    memory, well inside one CTA's share."""
    cp = pat.compile_patterns(streams.get_scenario("soccer").specs())
    cfg = runner.default_config(cp, backend="cuda_block")
    assert (cfg.num_patterns, cfg.max_pms, cfg.kinds) == (8, 2048, "any")
    lay = kblock.plan_layout(cfg, cp.trans.shape[2], 40)
    assert lay.store == "global"
    assert lay.store_bytes == 16384 * (18 + 4 * cfg.max_any_ids)
    assert lay.smem_bytes < 32 * 1024
    assert not lay.stats_smem            # gather_stats is off


def test_planner_sheds_the_optional_pieces_then_refuses():
    """Event rows and model tables too large for their share stay in
    device memory; per-launch state beyond one CTA raises."""
    cp = pat.compile_patterns(streams.get_scenario("stock").specs())
    cfg = runner.default_config(cp, max_pms=256, block_events=4096)
    lay = kblock.plan_layout(cfg, cp.trans.shape[2], 5000)
    assert not lay.rows_smem and not lay.model_smem
    assert lay.store == "shared"
    huge = dataclasses.replace(cfg, max_pms=1 << 22, block_events=32)
    with pytest.raises(ValueError, match="shared memory"):
        kblock.plan_layout(huge, cp.trans.shape[2], 1)


def test_planner_mirrors_the_kernel_source():
    """The Python planner's counts of per-pattern arrays, ring arrays,
    reduction slots and histogram bins are the kernel source's."""
    src = (CSRC / "block_step.cu").read_text()
    pat_enum = re.search(r"enum PatArray \{([^}]*)\}", src).group(1)
    pk_enum = re.search(r"enum PkArray \{([^}]*)\}", src).group(1)
    count = lambda body: len([t for t in body.replace("\n", " ").split(",")
                              if t.strip()]) - 1     # noqa: E731
    assert count(pat_enum) == kblock._PAT_ARRAYS
    assert count(pk_enum) == kblock._PK_ARRAYS
    assert f"kRedSlots = {kblock._RED_SLOTS};" in src
    assert f"kNbins = {kblock.SHED_NBINS};" in src


def _scan_inputs(nb: int = 3, W: int = 8):
    """A stock config and a scan's padded events, carry and row buffers
    on the CPU."""
    cp, cfg = block_cases.case_config("stock", 64, "pspice", W=W, **COST)
    sc = streams.get_scenario("stock")
    ev = streams.classify(sc.specs(), sc.raw(n=nb * W), rate=1e4, seed=1,
                          device="cpu")
    model = engine.make_model(cp, cfg, device="cpu")
    carry = engine.init_carry(cfg, seed=1, device="cpu")
    rows = kblock.new_rows(cfg, nb * W, "cpu")
    return cfg, model, carry, ev, rows


def _fields(args):
    return {name: getattr(args, name) for name, _ in args._fields_}


@pytest.mark.parametrize("b,i0,s,n_valid", [(0, 0, 0, 8), (1, 8, 3, 8),
                                             (2, 2 ** 31 - 4, 0, 5)])
def test_patched_args_equal_args_from_scratch(b, i0, s, n_valid):
    cfg, model, carry, ev, rows = _scan_inputs()
    scan = kblock.BlockScan(cfg, model, carry, ev, rows)
    scan.set_block(2, 17, 1, 2)             # an earlier block's values
    got = _fields(scan.set_block(b, i0, s, n_valid))
    want = _fields(kblock.fill_args(cfg, model, carry, ev, i0, s, n_valid,
                                    rows, scan.scratch_u, scan.scratch_sel,
                                    scan.status, b=b))
    assert got == want


def test_block_offsets_reach_the_block_rows():
    """The kernel reads block b at the base pointers plus b·W rows: those
    are the addresses of the block's own slices."""
    cfg, model, carry, ev, rows = _scan_inputs()
    W, P = cfg.block_events, cfg.num_patterns
    args = kblock.BlockScan(cfg, model, carry, ev, rows).set_block(2, 16, 0,
                                                                   W)
    for name, t, per_row in (("ev_class", ev.ev_class, P * 4),
                             ("ev_open", ev.ev_open, P),
                             ("arrival", ev.arrival, 4),
                             ("l_e", rows["l_e"], 4),
                             ("m_open", rows["match_open"],
                              P * cfg.max_pms * 4)):
        assert getattr(args, name) + args.blk * W * per_row == \
            t[args.blk * W:].data_ptr(), name


def test_argument_block_matches_the_kernel_struct():
    """Every field of struct BlockStepArgs, in order, is a field of _Args
    of the same kind (pointer, int or float)."""
    src = (CSRC / "block_step.cu").read_text()
    body = src.split("struct BlockStepArgs {", 1)[1].split("};", 1)[0]
    names, kinds = [], []
    for line in body.splitlines():
        line = line.split("//")[0].strip()
        if not line:
            continue
        m = re.match(r"(const )?(\w+)(\*?)\s+(.*);", line)
        for n in m.group(4).replace("*", "").split(","):
            names.append(n.strip())
            kinds.append("p" if m.group(3) or "*" in m.group(4) else
                         ("f" if m.group(2) == "float" else "i"))
    ctype = {ctypes.c_void_p: "p", ctypes.c_int: "i", ctypes.c_float: "f"}
    assert [(n, ctype[t]) for n, t in kblock._Args._fields_] == \
        list(zip(names, kinds))


@pytest.mark.parametrize("n,W,shedder", [(40, 8, "pspice"), (64, 32, "pmbl"),
                                         (65, 32, "ebl"), (7, 16, "none")])
def test_scan_makes_one_launch_per_block(monkeypatch, n, W, shedder):
    """One BlockScan per scan and ceil(n/W) launches, each on its own
    block, on the fused protocol."""
    calls, scans = [], []
    real_init, real_launch = kblock.BlockScan.__init__, \
        kblock.BlockScan.launch

    def init(self, *a, **kw):
        scans.append(self)
        real_init(self, *a, **kw)

    def launch(self, b, i0, s, n_valid):
        calls.append((b, i0, s, n_valid))
        return real_launch(self, b, i0, s, n_valid)

    monkeypatch.setattr(kblock.BlockScan, "__init__", init)
    monkeypatch.setattr(kblock.BlockScan, "launch", launch)
    cp, cfg = block_cases.case_config("stock", 64, shedder, W=W, **COST)
    sc = streams.get_scenario("stock")
    ev = streams.classify(sc.specs(), sc.raw(n=n), rate=1e4, seed=1,
                          device="cpu")
    model = engine.make_model(cp, cfg, device="cpu")
    carry = engine.init_carry(cfg, seed=1, device="cpu")
    engine.run_engine(cfg, model, ev, carry, device="cpu")
    assert len(scans) == 1
    nb = math.ceil(n / W)
    assert calls == [(b, b * W, 0, min(n - b * W, W)) for b in range(nb)]
