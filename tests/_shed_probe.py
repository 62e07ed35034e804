"""Device time of the load shedder's kernels on the card (run on the card;
not a test, never collected):

    python3 tests/_shed_probe.py [--root DIR] [--label NAME] [sweep]

Times, at the shapes of ``chip_smoke.py``'s kernels phase, each call of
the shed kernels' wrappers (``repro_torch.kernels.shed_select``) from the
``repro_torch`` package under ``DIR/src`` (default: this checkout, so an
unpacked older tree can be timed beside it in one call):

  hist      ``utility_histogram_edges``, n = 768 (P·N = 3 x 256), 128 bins
  hist_hot  the same on a refinement level: two thirds NaN, the rest on
            11 distinct values
  lanes     ``utility_histogram_lanes``, L = 128 lanes of n = 768
  lookup    ``utility_lookup``, P = 3, N = 256 (stock's store)
  lookup_lp ``utility_lookup`` over L·P = 384 rows of N = 256 (the trim)

Each as CUDA events around 200 calls, and as the profiler's device time
per call: every device operation the call issues (kernels, memsets,
copies) summed, the kernel alone, and the device operations per call.

``sweep`` also times the histogram's lanes at n from 768 to 2**20
spread over 1, 2, 3, 4 and 8 CTAs (the cluster), which is how
``HIST_ONE_CTA`` and the cluster's size were chosen.

Prints one line per case and writes ``chiprun_out/shed_probe_NAME.json``.
"""
import argparse
import json
import os
import subprocess
import sys


def timed(torch, fn, kernel: str, iters: int = 200) -> dict:
    """CUDA-event ms per call, and the profiler's device µs per call: all
    device rows, the kernel alone, device operations per call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    ms = a.elapsed_time(b) / iters
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(100):
            fn()
        torch.cuda.synchronize()
    rows = [(getattr(k, "self_device_time_total", 0), k.count, k.key)
            for k in prof.key_averages() if k.device_type != DeviceType.CPU]
    rows = [r for r in rows if r[0] > 0]
    return dict(ms=ms, all_us=sum(r[0] for r in rows) / 100,
                kernel_us=sum(r[0] for r in rows if kernel in r[2]) / 100,
                ops=sum(r[1] for r in rows) / 100,
                rows=[r[2] for r in rows])


def cases(torch, np, dev):
    from repro_torch.core.shedder import bucket_edges
    from repro_torch.kernels import shed_select as ks

    def lookup_args(P, N, seed, M=11, B=38):
        rng = np.random.default_rng(seed)
        state = rng.integers(0, M, (P, N)).astype(np.int32)
        active = rng.random((P, N)) < 0.6
        tables = rng.random((P, B, M)).astype(np.float32)
        bins = np.full(P, 64, np.int32)
        r_w = rng.integers(-64, B * 64 + 64, (P, N)).astype(np.int32)
        return tuple(torch.from_numpy(x).to(dev)
                     for x in (state, r_w, active, tables, bins))

    def hist_args(L, n, seed, hot=False):
        rng = np.random.default_rng(seed)
        if hot:
            u = rng.integers(0, 11, (L, n)).astype(np.float32) / 10
            u[rng.random((L, n)) < 2 / 3] = np.nan
        else:
            u = rng.random((L, n)).astype(np.float32)
            u[rng.random((L, n)) < 0.4] = np.nan
        u = torch.from_numpy(u).to(dev)
        lo = torch.nan_to_num(u, nan=2.0).amin(1)
        hi = torch.nan_to_num(u, nan=-1.0).amax(1)
        return u, bucket_edges(lo, torch.where(hi > lo, hi, lo + 1.0), 128)

    u1, e1 = hist_args(1, 768, 256)
    uh, eh = hist_args(1, 768, 11, hot=True)
    uL, eL = hist_args(128, 768, 128)
    lk = lookup_args(3, 256, 256)
    lp = lookup_args(384, 256, 7)
    return {
        "hist": (lambda: ks.utility_histogram_edges(u1[0], e1[0]),
                 lambda: ks.utility_histogram_plain(u1[0], e1[0]),
                 "utility_histogram_kernel"),
        "hist_hot": (lambda: ks.utility_histogram_edges(uh[0], eh[0]),
                     lambda: ks.utility_histogram_plain(uh[0], eh[0]),
                     "utility_histogram_kernel"),
        "lanes": (lambda: ks.utility_histogram_lanes(uL, eL),
                  lambda: ks.utility_histogram_lanes_plain(uL, eL),
                  "utility_histogram_kernel"),
        "lookup": (lambda: ks.utility_lookup(*lk),
                   lambda: ks.utility_lookup_plain(*lk),
                   "utility_lookup_kernel"),
        "lookup_lp": (lambda: ks.utility_lookup(*lp),
                      lambda: ks.utility_lookup_plain(*lp),
                      "utility_lookup_kernel"),
    }, hist_args


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.join(
        os.path.dirname(os.path.abspath(__file__)), ".."))
    ap.add_argument("--label", default="change")
    ap.add_argument("what", nargs="*")
    args = ap.parse_args()
    sys.path.insert(0, os.path.join(os.path.abspath(args.root), "src"))
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build
    from repro_torch.kernels import shed_select as ks
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()[0]
    _build.load()
    print(f"[{args.label}] {smi}; {ks.__file__}", flush=True)
    out = {"label": args.label, "smi": smi, "cases": {}, "sweep": {}}
    table, hist_args = cases(torch, np, dev)
    for name, (fn, plain, kernel) in table.items():
        got, want = fn(), plain()
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"{name}: kernel != plain")
        r = timed(torch, fn, kernel)
        out["cases"][name] = r
        print(f"[{args.label}] {name}: {r['ms'] * 1e3:.3f} us per call "
              f"(events); device {r['all_us']:.3f} us per call over "
              f"{r['ops']:g} device ops ({r['rows']}), kernel alone "
              f"{r['kernel_us']:.3f} us", flush=True)
    if "sweep" in args.what:
        for L in (1, 16):
            for n in (768, 2048, 4096, 6144, 8192, 12288, 16384, 32768,
                      65536, 262144, 1 << 20):
                u, e = hist_args(L, n, n)
                want = ks.utility_histogram_lanes_plain(u, e) \
                    if L * n <= (1 << 22) else None
                row = {}
                for ctas in (1, 2, 3, 4, 8):
                    ks.hist_ctas = lambda n, c=ctas: c
                    got = ks.utility_histogram_lanes(u, e)
                    torch.cuda.synchronize()
                    if want is not None and not torch.equal(got, want):
                        raise AssertionError(f"sweep L={L} n={n} "
                                             f"ctas={ctas} != plain")
                    row[ctas] = timed(torch, lambda: ks.
                                      utility_histogram_lanes(u, e),
                                      "utility_histogram_kernel",
                                      iters=50)["all_us"]
                out["sweep"][f"hist L={L} n={n}"] = row
                print(f"[{args.label}] sweep hist L={L} n={n}: device us "
                      f"by CTAs a lane {row}", flush=True)
    os.makedirs("chiprun_out", exist_ok=True)
    with open(f"chiprun_out/shed_probe_{args.label}.json", "w") as f:
        json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
