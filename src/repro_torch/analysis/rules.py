"""Rule engine over executed cells (DESIGN.md §11).

Port of ``repro.analysis.rules``.  The reference checks COMPILED
representations (jaxpr census, HLO text, ``memory_analysis()``).  Eager
PyTorch has none, so the port's evidence is the record of one executed
cell, :class:`Artifact`, made by :func:`run_artifact`:

  * a dispatch census (``TorchDispatchMode``): aten ops by name, float64
    outputs by call site, the largest gather/index/scatter result, and
    host reads (``_local_scalar_dense``, copies from the card to the
    host) — outside the kernels' plain versions, which on the card are
    the kernels themselves;
  * on the CPU, the engine's own count of its reads (``engine.host_syncs``:
    a read of a CPU tensor dispatches nothing);
  * kernel launches (the wrappers' counters on the card; on the CPU the
    calls of the wrappers, whose plain versions run instead);
  * every ``BlockScan`` the cell made (its argument block's pointers);
  * the carry's storage pointers before and after;
  * on the card: ``torch.cuda.set_sync_debug_mode("error")`` around a
    cell whose budget is no sync, ``torch.profiler``'s kernel rows (name,
    grid, registers, shared memory) and ``max_memory_allocated``.

A census only sees the code that runs, so ``check_all`` runs the census
cells on a workload that takes every branch, and each cell carries a
``coverage`` finding.  Every rule yields a :class:`Finding` with
pass/fail AND an evidence line, which ``driver.check_all`` writes out.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import json
import math
import os
import sys
import tempfile

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import fp
from repro_torch.analysis import contracts as C

_SORT_OPS = ("sort", "argsort", "topk", "msort", "kthvalue")
_GATHER_PREFIXES = ("gather", "index", "scatter", "take")
_F64 = (torch.float64, torch.complex128)
# The one float64 site the contracts waive: ``fp.fma`` emulates a
# correctly rounded float32 FMA through float64 (round to odd) on
# purpose, to equal XLA's contracted multiply-adds bit for bit.
F64_WAIVED_SITES = (fp.fma,)


# ---------------------------------------------------------------------------
# The cell's scope: which code is running while an op dispatches
# ---------------------------------------------------------------------------

def _code(fn):
    return getattr(fn, "__wrapped__", fn).__code__


def _site() -> str:
    """``file:line`` of the innermost frame of the port (not this
    package): where an op of interest was called."""
    f = sys._getframe(1)
    while f is not None:
        fn = f.f_code.co_filename
        if "repro_torch" in fn and f"analysis{os.sep}" not in fn:
            rel = fn[fn.rindex("repro_torch"):]
            return f"{rel}:{f.f_lineno}"
        f = f.f_back
    return "?"


class _Scope:
    """A ``sys.setprofile`` hook over the cell's Python calls: the depth
    inside the kernels' plain versions (not judged: on the card they are
    the kernels) and inside the float64 sites a contract waives, the
    calls of each kernel wrapper, and every ``BlockScan`` made."""

    def __init__(self):
        from repro_torch.kernels import block_step as kb
        from repro_torch.kernels import nfa_transition as kn
        from repro_torch.kernels import shed_select as ks
        self.plain = self.waived = 0
        self.calls: collections.Counter = collections.Counter()
        self.scans: list = []
        self._plain = {_code(f) for f in (
            kb.block_step_plain, kn.nfa_advance_plain,
            ks.utility_lookup_plain, ks.utility_histogram_plain,
            ks.utility_histogram_lanes_plain)}
        self._waived = {_code(f) for f in F64_WAIVED_SITES}
        self._wrappers = {_code(f): n for n, f in (
            ("nfa_advance", kn.nfa_advance),
            ("utility_lookup", ks.utility_lookup),
            ("utility_histogram", ks.utility_histogram_edges),
            ("utility_histogram_lanes", ks.utility_histogram_lanes))}
        self._launch = _code(kb.BlockScan.launch)
        self._init = _code(kb.BlockScan.__init__)

    def hook(self, frame, event, arg):
        if event == "call":
            code = frame.f_code
            if code in self._plain:
                self.plain += 1
            elif code in self._waived:
                self.waived += 1
            elif code is self._launch:
                lanes = frame.f_locals["self"].lanes
                self.calls["block_step" if lanes is None
                           else "block_step_lanes"] += 1
            elif code in self._wrappers:
                self.calls[self._wrappers[code]] += 1
        elif event == "return":
            code = frame.f_code
            if code in self._plain:
                self.plain -= 1
            elif code in self._waived:
                self.waived -= 1
            elif code is self._init:
                self.scans.append(frame.f_locals["self"])


class _Census(TorchDispatchMode):
    """Counts every aten op of the cell outside the kernels' plain
    versions: by name, float64 outputs by site, the largest gather-class
    result, and host reads."""

    def __init__(self, scope: _Scope, device: torch.device):
        super().__init__()
        self.scope, self.device = scope, device
        self.ops: collections.Counter = collections.Counter()
        self.plain_ops = 0
        self.f64: collections.Counter = collections.Counter()
        self.f64_waived: collections.Counter = collections.Counter()
        self.sort_sites: collections.Counter = collections.Counter()
        self.gather = (0, "", "")
        self.syncs = 0
        self.sync_sites: collections.Counter = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if self.scope.plain:
            self.plain_ops += 1
            return out
        name = func.overloadpacket.__name__
        self.ops[name] += 1
        outs = [t for t in (out if isinstance(out, (tuple, list))
                            else (out,)) if isinstance(t, torch.Tensor)]
        ins = [t for t in list(args) + list((kwargs or {}).values())
               if isinstance(t, torch.Tensor)]
        if any(t.dtype in _F64 for t in outs):
            if self.scope.waived:
                self.f64_waived[name] += 1
            else:
                self.f64[f"aten.{name} at {_site()}"] += 1
        if name in _SORT_OPS:
            self.sort_sites[f"aten.{name} at {_site()}"] += 1
        if name.startswith(_GATHER_PREFIXES) and outs:
            b = max(t.numel() * t.element_size() for t in outs)
            if b > self.gather[0]:
                self.gather = (b, name, _site())
        if self._is_read(name, ins, outs):
            self.syncs += 1
            if len(self.sync_sites) < 64:
                self.sync_sites[_site()] += 1
        return out

    def _is_read(self, name, ins, outs) -> bool:
        """A host read: ``.item()`` of a tensor on the cell's device, or a
        copy from the card to the host."""
        if name == "_local_scalar_dense":
            return bool(ins) and ins[0].device.type == self.device.type
        if self.device.type != "cuda":
            return False
        if name == "copy_" and len(ins) >= 2:
            return ins[0].device.type == "cpu" and \
                ins[1].device.type == "cuda"
        return any(t.device.type == "cpu" for t in outs) and \
            any(t.device.type == "cuda" for t in ins)


# ---------------------------------------------------------------------------
# Artifacts
# ---------------------------------------------------------------------------

def _leaves(tree, path: str = ""):
    if isinstance(tree, torch.Tensor):
        yield path, tree
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for k, v in zip(tree._fields, tree):
            yield from _leaves(v, f"{path}.{k}" if path else k)
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}[{i}]")


def _storages(tree) -> dict:
    return {t.untyped_storage().data_ptr(): t.untyped_storage().nbytes()
            for _, t in _leaves(tree)}


_COVER = ("pms_created", "complex_count", "shed_calls", "ebl_dropped")


def _counters(carry) -> dict:
    return {k: float(getattr(carry, k).sum()) for k in _COVER}


@dataclasses.dataclass
class Artifact:
    """The record of one entry point executed at one config cell."""
    name: str                  # cell label, e.g. "run_engine[cuda/pspice]"
    cfg: object                # the cell's EngineConfig (budget resolution)
    n_events: int
    device: str
    owned: bool = False        # the call took the carry over
    ops: collections.Counter = None
    plain_ops: int = 0
    f64: collections.Counter = None
    f64_waived: collections.Counter = None
    sort_sites: collections.Counter = None
    gather: tuple = (0, "", "")
    syncs: int = 0
    sync_sites: collections.Counter = None
    sync_error: str = ""       # set_sync_debug_mode("error") raised
    launches: dict = None      # kernel name -> launches in the cell
    scans: list = None         # the BlockScans the cell made
    carry_in: dict = None      # carry leaf -> data_ptr before the call
    carry_out: dict = None     # ... and of the returned carry
    counts: dict = None        # coverage: counter deltas over the call
    kernel_rows: list = None   # card: profiler kernel rows
    temp_bytes: int | None = None


def run_artifact(fn, *args, name: str, n_events: int,
                 owned: bool = False) -> Artifact:
    """Execute ``fn(*args)`` (the engine convention: cfg leads, the
    carry is the fourth argument, the carry comes back first) on the
    carry's device and record the evidence.  On the card a cell whose
    sync budget is 0 runs under ``set_sync_debug_mode("error")``, and the
    profiler records its kernels."""
    from repro_torch.cep import engine as eng
    from repro_torch.kernels import ops as kops
    cfg, carry = args[0], args[3]
    dev = carry.sim_time.device
    cuda = dev.type == "cuda"
    no_sync = C.hot_path_sync_budget(cfg, n_events) == 0
    before = _counters(carry)
    carry_in = {k: t.data_ptr() for k, t in _leaves(carry)}
    in_storages = set(_storages(args))
    scope = _Scope()
    census = _Census(scope, dev)
    art = Artifact(name=name, cfg=cfg, n_events=n_events, device=dev.type,
                   owned=owned)
    syncs0 = eng.host_syncs
    launches0 = kops.launch_counts()
    with contextlib.ExitStack() as stack:
        if cuda:
            from torch.profiler import ProfilerActivity
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            prof = stack.enter_context(torch.profiler.profile(
                activities=[ProfilerActivity.CUDA]))
        out = _call(fn, args, scope, census, art, cuda and no_sync)
        if cuda:
            torch.cuda.synchronize()
    if cuda:
        art.kernel_rows = _kernel_rows(prof)
        if out is not None:
            new = {p: b for p, b in _storages(out).items()
                   if p not in in_storages}
            art.temp_bytes = torch.cuda.max_memory_allocated() - base - \
                sum(new.values())
    art.ops, art.plain_ops = census.ops, census.plain_ops
    art.f64, art.f64_waived = census.f64, census.f64_waived
    art.sort_sites, art.gather = census.sort_sites, census.gather
    art.syncs, art.sync_sites = census.syncs, census.sync_sites
    if not cuda:   # the engine's reads of CPU tensors dispatch nothing
        art.syncs += eng.host_syncs - syncs0
    art.launches = ({k: v - launches0[k]
                     for k, v in kops.launch_counts().items()}
                    if cuda else dict(scope.calls))
    art.scans = scope.scans
    art.carry_in = carry_in
    if out is not None:
        art.carry_out = {k: t.data_ptr() for k, t in _leaves(out[0])}
        after = _counters(out[0])
        art.counts = {k: after[k] - before[k] for k in _COVER}
    return art


def _call(fn, args, scope: _Scope, census: _Census, art: Artifact,
          no_sync: bool):
    """``fn(*args)`` under the scope hook and the census; with
    ``no_sync`` under ``set_sync_debug_mode("error")``, whose error is
    recorded (the call then returns None)."""
    old = sys.getprofile()
    sys.setprofile(scope.hook)
    try:
        with census:
            if no_sync:
                torch.cuda.set_sync_debug_mode("error")
            try:
                return fn(*args)
            except RuntimeError as e:
                if "synchronizing" not in str(e):
                    raise
                art.sync_error = str(e).splitlines()[0][:160]
                return None
            finally:
                if no_sync:
                    torch.cuda.set_sync_debug_mode(0)
    finally:
        sys.setprofile(old)


def _kernel_rows(prof) -> list:
    """(name, grid, registers per thread, shared memory) of every kernel
    of a profile, from its trace (the fields kineto records per launch;
    None where it records none)."""
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as fh:
            trace = json.load(fh)
    rows = []
    for ev in trace.get("traceEvents", []):
        if ev.get("cat") != "kernel":
            continue
        a = ev.get("args", {})
        rows.append((ev.get("name", ""), a.get("grid"),
                     a.get("registers per thread"), a.get("shared memory")))
    return rows


# ---------------------------------------------------------------------------
# Rules
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Finding:
    rule: str
    ok: bool
    evidence: str
    cell: str = ""

    def row(self) -> dict:
        return {"rule": self.rule, "cell": self.cell,
                "status": "pass" if self.ok else "FAIL",
                "evidence": self.evidence}


@dataclasses.dataclass(frozen=True)
class Rule:
    """One machine-checked invariant.  ``ports`` names the reference's
    rule it stands for (DESIGN.md §11), "" for the port's own."""
    name: str
    ports: str
    description: str
    check: object           # (Artifact, Contract) -> list[Finding]

    def run(self, art: Artifact, ctr: C.Contract) -> list:
        out = self.check(art, ctr)
        for f in out:
            f.cell = f.cell or art.name
        return out


def _ok(rule, art, evidence):
    return [Finding(rule, True, evidence, art.name)]


def _fail(rule, art, evidence):
    return [Finding(rule, False, evidence, art.name)]


def _first(counter) -> str:
    (site, n), = counter.most_common(1)
    return f"{n} x {site}"


def _plain_note(art) -> str:
    return (f"; {art.plain_ops} ops in the kernels' plain versions not "
            "judged (the kernels on the card)") if art.plain_ops else ""


def _is_sort_kernel(name: str) -> bool:
    """A sort kernel by its name (cub's radix sort, the bitonic sorts,
    at::native's sort kernels); searchsorted is a binary search."""
    return "sort" in name.lower().replace("searchsorted", "")


def _check_no_sort(art: Artifact, ctr: C.Contract) -> list:
    if not ctr.no_sort:
        return _ok("no-sort", art, "not required by contract")
    if art.sort_sites:
        return _fail("no-sort", art, f"sort in the hot path: "
                     f"{_first(art.sort_sites)}")
    kern = [r[0] for r in art.kernel_rows or () if _is_sort_kernel(r[0])]
    if kern:
        return _fail("no-sort", art, f"sort kernel launched: {kern[0][:100]}")
    what = "census" + (f" + {len(art.kernel_rows)} profiled kernels"
                       if art.kernel_rows is not None else "")
    return _ok("no-sort", art, f"0 sort ops ({what})")


def _check_no_sync(art: Artifact, ctr: C.Contract) -> list:
    if not ctr.no_sync:
        return _ok("no-sync", art, "not required by contract")
    if art.sync_error:
        return _fail("no-sync", art, f"set_sync_debug_mode('error'): "
                     f"{art.sync_error}")
    fires = int(art.counts["shed_calls"]) if art.counts else 0
    budget = ctr.budget("max_syncs_per_event", art.cfg, art.n_events,
                        fires=fires)
    if budget is None:
        return _ok("no-sync", art, "no budget declared")
    n = max(art.n_events, 1)
    per = art.syncs / n
    ok = per <= budget + 1e-12
    ev = (f"{art.syncs} host reads over {art.n_events} events = "
          f"{per:.4f}/event vs budget {budget:.4f}/event ({fires} fires)")
    if art.device == "cuda" and budget == 0:
        ev += "; no sync under set_sync_debug_mode('error')"
    if not ok and art.sync_sites:
        ev += f"; top site {_first(art.sync_sites)}"
    return [Finding("no-sync", ok, ev)]


def _check_no_f64(art: Artifact, ctr: C.Contract) -> list:
    if not ctr.no_f64:
        return _ok("no-f64", art, "not required by contract")
    if art.f64:
        return _fail("no-f64", art, f"float64 output: {_first(art.f64)}")
    waived = sum(art.f64_waived.values())
    ev = "0 float64/complex128 outputs"
    if waived:
        ev += (f"; {waived} inside fp.fma (waived by site: the correctly "
               "rounded float32 FMA)")
    return _ok("no-f64", art, ev + _plain_note(art))


def _check_launch_budget(art: Artifact, ctr: C.Contract) -> list:
    n = max(art.n_events, 1)
    out = []
    if ctr.max_ops_per_event is not None:
        tot = sum(art.ops.values())
        out.append(Finding(
            "launch-budget", tot / n <= ctr.max_ops_per_event,
            f"{tot} aten ops outside the kernels = {tot / n:.1f}/event vs "
            f"budget {ctr.max_ops_per_event}"))
    per = ctr.max_launches_per_block
    backend = getattr(art.cfg, "backend", "")
    if per is not None and backend == "cuda_block":
        W = art.cfg.block_events
        nb = math.ceil(art.n_events / W)
        got = art.launches.get("block_step", 0) + \
            art.launches.get("block_step_lanes", 0)
        fires = int(art.counts["shed_calls"]) if art.counts else 0
        fused = C.hot_path_sync_budget(art.cfg, art.n_events) == 0
        want = per * nb
        ok = got == want if fused else want <= got <= want + fires
        out.append(Finding(
            "launch-budget", ok,
            f"{got} block launches for {art.n_events} events at W={W} vs "
            + (f"{want} (= ceil(n/W))" if fused else
               f"{want}..{want + fires} (replay: + one per fire)")))
    elif per is not None and backend == "cuda":
        got = art.launches.get("nfa_advance", 0)
        out.append(Finding(
            "launch-budget", got <= per * n,
            f"{got} nfa_advance launches for {art.n_events} events vs "
            f"<= {per}/event"))
    return out or _ok("launch-budget", art, "no budget declared")


def _check_in_place(art: Artifact, ctr: C.Contract) -> list:
    if not ctr.donate:
        return _ok("in-place", art, "contract takes nothing over")
    if not art.owned:
        return _fail("in-place", art, f"donate={ctr.donate} but the cell "
                     "did not hand its carry over")
    if art.carry_out is None:
        return _fail("in-place", art, "the call did not return")
    kept = [k for k, p in art.carry_in.items()
            if art.carry_out.get(k) == p]
    need = len(art.carry_in)
    if len(kept) < need:
        moved = sorted(set(art.carry_in) - set(kept))
        return _fail("in-place", art,
                     f"{len(kept)}/{need} carry leaves kept their storage; "
                     f"moved: {', '.join(moved[:4])}"
                     + (" ..." if len(moved) > 4 else "")
                     + " (a copied carry doubles steady-state memory)")
    return _ok("in-place", art, f"{len(kept)}/{need} carry leaves updated "
               "in place (same storage in and out)")


def _check_temp_bytes(art: Artifact, ctr: C.Contract) -> list:
    budget = ctr.budget("max_temp_bytes", art.cfg, art.n_events)
    if budget is None:
        return _ok("temp-bytes", art, "no budget declared")
    if art.temp_bytes is None:
        return _ok("temp-bytes", art, "device memory statistics "
                   "unavailable (CPU): judged on the card")
    t = art.temp_bytes
    return [Finding("temp-bytes", t <= budget,
                    f"peak device bytes beyond inputs and outputs {t} B vs "
                    f"budget {budget} B")]


def _check_gather_bytes(art: Artifact, ctr: C.Contract) -> list:
    budget = ctr.budget("max_gather_bytes", art.cfg, art.n_events)
    if budget is None:
        return _ok("gather-bytes", art, "no budget declared")
    b, op, site = art.gather
    ok = b <= budget
    return [Finding("gather-bytes", ok,
                    f"largest gather/index/scatter result {b} B "
                    f"{'<=' if ok else '>'} {budget} B"
                    + (f" (aten.{op} at {site})" if op else ""))]


def _check_coverage(art: Artifact, ctr: C.Contract) -> list:
    """The cell took the path its rules judge: it spawned and completed
    PMs and, if it sheds, shed."""
    if art.counts is None:
        return _fail("coverage", art, "the call did not return")
    c = art.counts
    need = {"spawned": c.get("pms_created", 0),
            "completed": c.get("complex_count", 0)}
    shedder = getattr(art.cfg, "shedder", "none")
    if shedder in ("pspice", "pmbl"):
        need["shed calls"] = c.get("shed_calls", 0)
    elif shedder == "ebl":
        need["dropped"] = c.get("ebl_dropped", 0)
    zero = [k for k, v in need.items() if not v > 0]
    ev = ", ".join(f"{k} {v:g}" for k, v in need.items())
    if zero:
        return _fail("coverage", art, f"{ev}: the cell never "
                     f"{'/'.join(zero)} (its rules judge a path it did not "
                     "take)")
    return _ok("coverage", art, ev)


RULES = (
    Rule("no-sort", "no-sort",
         "No sort in the hot path: the spawn allocator is O(N) free-list "
         "compaction and Algorithm 2 is the histogram-refinement select.",
         _check_no_sort),
    Rule("no-sync", "no-callback",
         "The scan stays on the device: host reads within the per-event "
         "budget (none on the fused block path).", _check_no_sync),
    Rule("no-f64", "no-f64",
         "All hot-path arithmetic is f32/i32 outside fp.fma; an "
         "accidental float64 doubles every store pass.", _check_no_f64),
    Rule("launch-budget", "control-flow",
         "One block-kernel launch per W-event block, at most one advance "
         "launch per event, aten ops per event within budget — new "
         "data-dependent loops are how O(N log N) work returns.",
         _check_launch_budget),
    Rule("in-place", "donation",
         "An owned carry is updated in place (the port's donation).",
         _check_in_place),
    Rule("temp-bytes", "temp-bytes",
         "Device temp bytes within the per-cell budget "
         "(allocation-free hot path).", _check_temp_bytes),
    Rule("gather-bytes", "gather-bytes",
         "No single gather/index/scatter result larger than the flat-"
         "advance budget (kills (P,N,C+1)-per-event temps).",
         _check_gather_bytes),
    Rule("coverage", "",
         "The cell spawned, completed and (if it sheds) shed: a census "
         "only sees the code that runs.", _check_coverage),
)


def run_rules(art: Artifact, ctr: C.Contract, rules=None,
              extra_rules=()) -> list:
    """Evaluate rules against one artifact.  Waived rules report as
    passing with the waiver (and its reason) as evidence, so the rows
    show the waiver instead of hiding it."""
    out = []
    for rule in tuple(RULES if rules is None else rules) + tuple(
            extra_rules):
        if rule.name in ctr.waived:
            note = f": {ctr.waiver_note}" if ctr.waiver_note else ""
            out.append(Finding(rule.name, True,
                               f"waived by contract {ctr.name}{note}",
                               art.name))
            continue
        out.extend(rule.run(art, ctr))
    return out
