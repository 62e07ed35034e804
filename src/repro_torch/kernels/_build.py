"""Build and load the port's CUDA kernels (``repro_torch/csrc/*.cu``).

Each source is compiled by its own ``nvcc`` process, all started
together, for ``sm_90a`` (Hopper), and the objects link into one shared
library with a plain C interface that :func:`load` opens with
``ctypes``.  The build lands in ``build/kernels/<hash>/`` at the root of
the checkout, keyed by a hash of the sources and flags, so a library is
built once per source change and the first kernel call builds it.
Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import time

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
SOURCES = ("nfa_transition.cu", "shed_select.cu", "block_step.cu",
           "flash_attention.cu", "flash_attention_sm90.cu")
HEADERS = ("common.cuh",)
LIB_NAME = "librepro_torch_kernels.so"
# -fmad=false: no multiply-add is contracted behind the kernels' backs —
# the CEP kernels write the one fused multiply-add they need as __fmaf_rn,
# and the flash kernels, which have no bitwise bar, write their products
# and softmax as fmaf.  The bf16 flash kernel takes the driver's
# cuTensorMapEncodeTiled through cudaGetDriverEntryPoint at run time, so
# the link needs no -lcuda.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_VP, _I, _LL, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                    ctypes.c_float)
_SIGNATURES = {
    "nfa_advance_launch": [_VP] * 8 + [_I] * 4 + [_VP] * 3,
    "utility_lookup_launch": [_VP] * 5 + [_I] * 4 + [_VP] * 2,
    "utility_histogram_launch": [_VP, _LL, _VP, _I, _VP, _VP],
    "utility_histogram_lanes_launch": [_VP, _I, _LL, _VP, _I, _VP, _VP],
    "block_step_launch": [_VP, _VP],
    "threefry_probe_launch": [_VP, _I, _I, _VP, _VP, _VP],
    "empty_kernel_launch": [_I, _VP],
    "flash_attention_launch": [_VP] * 4 + [_I] * 9 + [_F, _VP],
    "flash_attention_sm90_launch": [_VP] * 4 + [_I] * 9 + [_F, _VP],
    "wgmma_probe_launch": [_VP] * 6,
}

_lib: ctypes.CDLL | None = None
build_seconds: float | None = None   # wall time of this process's build


def build_dir() -> pathlib.Path:
    return CSRC.parents[2] / "build" / "kernels"


def nvcc_path() -> str:
    for cand in ("/usr/local/cuda/bin/nvcc", shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build on a machine "
                       "with the CUDA toolkit")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def build() -> pathlib.Path:
    """Compile the library if this source hash has none yet; return it."""
    global build_seconds
    final = build_dir() / _digest()
    lib = final / LIB_NAME
    if lib.exists():
        return lib
    nvcc = nvcc_path()
    build_dir().mkdir(parents=True, exist_ok=True)
    tmp = pathlib.Path(tempfile.mkdtemp(dir=build_dir(), prefix=".tmp-"))
    t0 = time.perf_counter()
    try:
        procs = [(name, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", str(CSRC / name), "-o",
             str(tmp / (name + ".o"))],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
            for name in SOURCES]
        logs, failed = [], []
        for name, proc in procs:
            out, _ = proc.communicate()
            logs.append(f"== {name}\n{out}")
            if proc.returncode:
                failed.append(name)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n" + "".join(logs))
        link = subprocess.run(
            [nvcc, "-shared", "-o", str(tmp / LIB_NAME),
             *[str(tmp / (n + ".o")) for n in SOURCES]],
            capture_output=True, text=True)
        if link.returncode:
            raise RuntimeError(f"link failed:\n{link.stdout}{link.stderr}")
        (tmp / "build.log").write_text("".join(logs))
        try:
            os.replace(tmp, final)
        except OSError:          # another process finished the same build
            shutil.rmtree(tmp, ignore_errors=True)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    build_seconds = time.perf_counter() - t0
    return lib


def load() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for fn, args in _SIGNATURES.items():
            getattr(lib, fn).argtypes = args
            getattr(lib, fn).restype = ctypes.c_int
        _lib = lib
    return _lib


def check(code: int, what: str) -> None:
    """Raise on a non-zero return from a launch: a ``cudaError_t``, or the
    negated ``CUresult`` of a tensor-map encode that failed."""
    if code < 0:
        raise RuntimeError(f"{what}: tensor-map encode failed with CUresult "
                           f"{-code}")
    if code:
        raise RuntimeError(f"{what}: CUDA error {code} at launch")
