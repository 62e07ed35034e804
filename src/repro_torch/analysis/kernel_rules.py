"""Checks on the hand-written kernels (DESIGN.md §11).

Port of ``repro.analysis.pallas_rules``.  The reference walks a jaxpr
for ``pallas_call`` equations and checks their BlockSpec geometry; the
port's kernels are CUDA C++, so its evidence is what the build and the
launches say:

* kernel-regs — ptxas's report (``nvcc -Xptxas -v``, the build log):
  registers <= 255 and spills within each kernel's budget (0 for the
  bf16 flash kernel, the build's gate; 64 B for the block kernel, above
  the 40 B stored / 56 B loaded of its device-memory instantiation in
  the H100 build, so that growth trips it; 0 for the per-event kernels);
* kernel-sass — the SASS of each CEP kernel entry (``cuobjdump -sass``
  of the built library): no double-precision instruction and no call to
  ``vprintf`` or ``malloc`` (the counterpart of the inner kernel census);
* kernel-smem — per launch of the block kernel: ``plan_layout``'s
  dynamic bytes plus the entry's static shared memory within the card's
  ``sharedMemPerBlockOptin``;
* kernel-grid — the lane instance runs one CTA per lane (the profiler's
  launch rows);
* kernel-block — ``backend="cuda_block"`` with no block launch fails
  outright;
* block-inplace — the counterpart of ``pallas-block-alias``: the
  kernel's argument block points at the returned carry's store tensors
  (at least ``BLOCK_STEP_MIN_ALIASES`` of them), and across an owned
  scan at the caller's own.

The launch checks run on the same artifacts as ``rules.RULES``; they
no-op on cells that launch no block kernel (backend "torch", "cuda").
"""
from __future__ import annotations

import pathlib
import re
import subprocess

from repro_torch.analysis import rules as R

# The block kernel updates these store tensors in place (its argument
# names, csrc/block_step.cu): active, state, open_idx, bind, idset, ring,
# ring_ptr, complex_count, pms_created, lat_n, lat_l.
BLOCK_STEP_MIN_ALIASES = 11
_STORE_ARGS = {"active": "pms.active", "state": "pms.state",
               "open_idx": "pms.open_idx", "bind": "pms.bind",
               "idset": "pms.idset", "ring": "ring", "ring_ptr": "ring_ptr",
               "complex_count": "complex_count",
               "pms_created": "pms_created", "lat_n": "lat_samples_n",
               "lat_l": "lat_samples_l"}

# The CEP kernels' entries (csrc/*.cu) and the bf16 flash kernel, with
# each one's spill budget in bytes (stores, loads).
MAX_REGISTERS = 255
SPILL_BUDGET = {"nfa_advance_kernel": (0, 0),
                "utility_lookup_kernel": (0, 0),
                "utility_histogram_kernel": (0, 0),
                "block_step_kernel": (64, 64),
                "flash_attention_sm90_kernel": (0, 0)}
CEP_KERNELS = ("nfa_advance_kernel", "utility_lookup_kernel",
               "utility_histogram_kernel", "block_step_kernel")
_F64_SASS = re.compile(r"\bD(ADD|MUL|FMA)\b")
_CALLS = re.compile(r"\b(vprintf|malloc)\b")


def ptxas_report(log_text: str, kernel: str) -> list:
    """(mangled name, registers, spill stores, spill loads, static smem
    bytes) of every entry function whose name contains ``kernel``, read
    from the nvcc/ptxas log of the build."""
    rows = []
    for block in log_text.split("Compiling entry function '")[1:]:
        name = block.split("'", 1)[0]
        if kernel not in name:
            continue

        def num(pattern):
            m = re.search(pattern, block)
            return int(m.group(1)) if m else 0
        rows.append((name, num(r"Used (\d+) registers"),
                     num(r"(\d+) bytes spill stores"),
                     num(r"(\d+) bytes spill loads"),
                     num(r"(\d+) bytes smem")))
    return rows


def sass_functions(sass_text: str) -> dict:
    """mangled name -> SASS text of every function in ``cuobjdump
    -sass`` output."""
    out = {}
    parts = re.split(r"^\s*Function : (\S+)\s*$", sass_text, flags=re.M)
    for name, body in zip(parts[1::2], parts[2::2]):
        out[name] = out.get(name, "") + body
    return out


def read_build() -> tuple[str, str]:
    """The build log (ptxas's report) and the SASS of the built kernel
    library (on a machine with the CUDA toolkit)."""
    from repro_torch.kernels import _build
    lib = _build.build()
    log_text = (lib.parent / "build.log").read_text()
    tool = pathlib.Path(_build.nvcc_path()).with_name("cuobjdump")
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    return log_text, sass


def build_findings(log_text: str, sass_text: str,
                   cell: str = "kernels[build]") -> list:
    """kernel-regs and kernel-sass over the built library."""
    out = []
    for kernel, (st_max, ld_max) in SPILL_BUDGET.items():
        rows = ptxas_report(log_text, kernel)
        if not rows:
            out.append(R.Finding("kernel-regs", False,
                                 f"{kernel}: no entry in ptxas's report",
                                 cell))
        for name, regs, st, ld, smem in rows:
            ok = regs <= MAX_REGISTERS and st <= st_max and ld <= ld_max
            out.append(R.Finding(
                "kernel-regs", ok,
                f"{name}: {regs} registers (<= {MAX_REGISTERS}), spill "
                f"stores {st} B (<= {st_max}), loads {ld} B (<= {ld_max}), "
                f"static smem {smem} B", cell))
    funcs = sass_functions(sass_text)
    for kernel in CEP_KERNELS:
        names = [n for n in funcs if kernel in n]
        if not names:
            out.append(R.Finding("kernel-sass", False,
                                 f"{kernel}: no function in the SASS", cell))
        for name in names:
            body = funcs[name]
            bad = sorted({m.group(0) for m in _F64_SASS.finditer(body)} |
                         {m.group(0) for m in _CALLS.finditer(body)})
            n_ins = len(re.findall(r"/\*[0-9a-f]{4,}\*/", body))
            out.append(R.Finding(
                "kernel-sass", not bad,
                f"{name}: " + (f"found {bad}" if bad else
                               f"{n_ins} instructions, no DADD/DMUL/DFMA, "
                               "no vprintf/malloc"), cell))
    return out


def _static_smem(log_text: str, store: str) -> int:
    """Static shared memory of the block kernel's instantiation (the
    store in "shared" or "global" memory: template argument 1 or 0)."""
    tag = "ILb1E" if store == "shared" else "ILb0E"
    for name, _, _, _, smem in ptxas_report(log_text, "block_step_kernel"):
        if tag in name:
            return smem
    raise ValueError(f"block_step_kernel<{store}> not in ptxas's report")


def check_kernel_launches(art: R.Artifact, log_text: str | None = None
                          ) -> list:
    """The block-kernel findings for one artifact: kernel-block and
    block-inplace everywhere; on the card also kernel-smem and
    kernel-grid (``log_text``: the build log, for static shared
    memory)."""
    is_block = getattr(art.cfg, "backend", "") == "cuda_block"
    if not art.scans:
        if is_block:
            return [R.Finding("kernel-block", False,
                              "backend=cuda_block but no block kernel "
                              "launch found", art.name)]
        return [R.Finding("kernel-block", True, "no block kernel launch "
                          f"(backend {getattr(art.cfg, 'backend', '?')})",
                          art.name)]
    out = []
    n = sum(art.launches.get(k, 0) for k in ("block_step",
                                              "block_step_lanes"))
    out.append(R.Finding("kernel-block", n > 0,
                         f"{n} block kernel launches over {len(art.scans)} "
                         "scan(s)", art.name))
    out.append(_block_inplace(art))
    if art.device == "cuda":
        out += _smem_and_grid(art, log_text)
    return out


def _block_inplace(art: R.Artifact) -> R.Finding:
    if art.carry_out is None:
        return R.Finding("block-inplace", False, "the call did not return",
                         art.name)
    worst = None
    for scan in art.scans:
        kept = [a for a, leaf in _STORE_ARGS.items()
                if getattr(scan.args, a) == art.carry_out.get(leaf) and
                (not art.owned or art.carry_in.get(leaf) ==
                 art.carry_out.get(leaf))]
        if worst is None or len(kept) < len(worst):
            worst = kept
    ok = len(worst) >= BLOCK_STEP_MIN_ALIASES
    where = "the caller's own carry (owned scan)" if art.owned else \
        "the returned carry"
    return R.Finding(
        "block-inplace", ok,
        f"{len(worst)} store tensors updated in place by the kernel in "
        f"{where} (needs >= {BLOCK_STEP_MIN_ALIASES})"
        + ("" if ok else f"; missing {sorted(set(_STORE_ARGS) - set(worst))}"),
        art.name)


def _smem_and_grid(art: R.Artifact, log_text: str | None) -> list:
    import torch
    out = []
    optin = torch.cuda.get_device_properties(0).shared_memory_per_block_optin
    for scan in art.scans[:1]:
        lay = scan.layout
        static = _static_smem(log_text, lay.store)
        tot = lay.smem_bytes + static
        out.append(R.Finding(
            "kernel-smem", tot <= optin,
            f"block_step_kernel<{lay.store} store>: {lay.smem_bytes} B "
            f"dynamic + {static} B static = {tot} B vs {optin} B "
            "(sharedMemPerBlockOptin)",
            art.name))
        lanes = scan.lanes or 1
        rows = [r for r in art.kernel_rows or ()
                if "block_step_kernel" in r[0]]
        grids = sorted({tuple(r[1] or ()) for r in rows})
        out.append(R.Finding(
            "kernel-grid", grids == [(lanes, 1, 1)],
            f"profiled grids {grids} over {len(rows)} launches vs "
            f"{lanes} CTA(s) (one per lane)", art.name))
    return out
