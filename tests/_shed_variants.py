"""The shed kernels' design alternatives against the shipped kernels, on
the card (run on the card; not a test, never collected):

    python3 tests/_shed_variants.py

Builds ``tests/_shed_variants.cu`` with the kernels' own flags and times,
as the profiler's device time per call (every device operation summed),
each alternative beside the shipped wrapper's call on the same inputs
(``repro_torch.kernels.shed_cases``), after checking it against the
plain version:

  histogram  n = 768 and 128 bins (stock's P·N; L = 1, the engine's shed,
             and L = 128, the trim), random and refinement-level
             utilities: the previous design (memset, 3 CTAs a lane,
             bisection, global atomics), one CTA of 256 threads (three
             utilities a thread), warp-aggregated increments, per-warp
             sub-histograms, the bisection, and a cluster of 2 or 3 CTAs;
  longer     the shipped histogram against the previous design at n =
             3 000 and 6 144 (the kernels phase's N = 1 000 and the parity
             cell's N = 2 048, P = 3), where it takes one CTA of 1 024
             threads and a cluster of 8;
  lookup     stock's (3, 256) and the trim's (384, 256): the previous
             design (active flag first), staged tables, four PMs a
             thread with and without staging.

and the shipped kernels' skeletons, which say where their time goes: the
histogram without its bucket search, and without its atomics too (the
loads, the edges copy, two barriers and the stores); the lookup without
its table read (the loads and the store).

Prints one line per shape and writes ``chiprun_out/shed_variants.json``.
"""
import ctypes
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "..", "src"))

import torch  # noqa: E402

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import shed_cases as sc  # noqa: E402
from repro_torch.kernels import shed_select as ks  # noqa: E402

HIST = {"previous (memset, 3 CTAs, bisection, global atomics)": (0, 256, 1),
        "one CTA of 256 threads": (1, 256, 1),
        "warp-aggregated (__match_any_sync)": (2, 768, 1),
        "per-warp sub-histograms": (3, 768, 1),
        "bisection": (4, 768, 1),
        "cluster of 2": (5, 384, 2), "cluster of 3": (5, 256, 3)}
# The skeletons: the shipped kernel without its search (and atomics), or
# without its table read; they compute something else and are not checked.
HIST_SKELETON = {"skeleton: no search": (6, 768, 1),
                 "skeleton: no search, no atomics": (7, 768, 1)}
LOOKUP = {"previous (active first)": 0, "one PM a thread, staged": 1,
          "four PMs a thread": 2, "four PMs a thread, staged": 3}
LOOKUP_SKELETON = {"skeleton: no table read": 4}


def device_us(fn, iters: int = 100) -> float:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return sum(k.self_device_time_total for k in prof.key_averages()
               if k.device_type != DeviceType.CPU) / iters


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    os.makedirs("chiprun_out", exist_ok=True)
    so = os.path.join(_build.build_dir(), "shed_variants.so")
    os.makedirs(_build.build_dir(), exist_ok=True)
    subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-shared", "-o",
                    so, os.path.join(HERE, "_shed_variants.cu")],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(so)
    V, I = ctypes.c_void_p, ctypes.c_int
    lib.hist_variant_launch.argtypes = [I, V, I, I, V, I, V, I, I]
    lib.lookup_variant_launch.argtypes = [I] + [V] * 5 + [I] * 4 + [V]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    dev = torch.device("cuda")
    res = {"smi": smi}
    for case in ("random", "refinement"):
        for L in (1, 128):
            n, nbins = 768, 128
            u, _, _, e = sc.hist_case(case, L, n, nbins, seed=1)
            u, e = torch.from_numpy(u).to(dev), torch.from_numpy(e).to(dev)
            want = ks.utility_histogram_lanes_plain(u, e)
            row = {"shipped": device_us(
                lambda: ks.utility_histogram_lanes(u, e))}
            for name, (v, t, c) in {**HIST, **HIST_SKELETON}.items():
                out = torch.empty(L, nbins, dtype=torch.int32, device=dev)

                def call():
                    _build.check(lib.hist_variant_launch(
                        v, u.data_ptr(), L, n, e.data_ptr(), nbins,
                        out.data_ptr(), t, c), name)
                call()
                torch.cuda.synchronize()
                if name in HIST and not torch.equal(out, want):
                    raise AssertionError(f"histogram {name} != plain")
                row[name] = device_us(call)
            res[f"histogram {case} L={L} n={n}"] = row
            print(f"histogram {case} L={L} n={n}: device us per call "
                  f"{row}", flush=True)
    for n in (3000, 6144):
        u, _, _, e = sc.hist_case("random", 1, n, 128, seed=n)
        u, e = torch.from_numpy(u).to(dev), torch.from_numpy(e).to(dev)
        want = ks.utility_histogram_lanes_plain(u, e)
        out = torch.empty(1, 128, dtype=torch.int32, device=dev)

        def prev():
            _build.check(lib.hist_variant_launch(
                0, u.data_ptr(), 1, n, e.data_ptr(), 128, out.data_ptr(),
                256, 1), "previous")
        prev()
        torch.cuda.synchronize()
        if not torch.equal(out, want):
            raise AssertionError(f"histogram previous n={n} != plain")
        row = {"shipped": device_us(
            lambda: ks.utility_histogram_lanes(u, e)),
            "previous": device_us(prev), "ctas": ks.hist_ctas(n)}
        res[f"histogram random L=1 n={n}"] = row
        print(f"histogram random L=1 n={n}: device us per call {row}",
              flush=True)
    for P, N in ((3, 256), (384, 256)):
        args = tuple(torch.from_numpy(a).to(dev)
                     for a in sc.lookup_case("random", P, N, seed=1))
        want = ks.utility_lookup_plain(*args)
        B, M = args[3].shape[1:]
        row = {"shipped": device_us(lambda: ks.utility_lookup(*args))}
        for name, v in {**LOOKUP, **LOOKUP_SKELETON}.items():
            out = torch.empty_like(want)

            def call():
                _build.check(lib.lookup_variant_launch(
                    v, *(a.data_ptr() for a in args), P, N, B, M,
                    out.data_ptr()), name)
            call()
            torch.cuda.synchronize()
            if name in LOOKUP and not torch.equal(out, want):
                raise AssertionError(f"lookup {name} != plain")
            row[name] = device_us(call)
        res[f"lookup P={P} N={N}"] = row
        print(f"lookup P={P} N={N}: device us per call {row}", flush=True)
    with open("chiprun_out/shed_variants.json", "w") as f:
        json.dump(res, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
