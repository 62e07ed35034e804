"""The yardstick of the kernels' roofline shares: the card's peak and the
bytes one launch of the block kernel's lane instance needs.

NVIDIA H100 SXM (its data sheet): 3.35 TB/s of HBM3 at the 700 W power
limit.  The block kernel does no matrix work, so its bound is bytes.
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12


def kernel_launches(tr, name: str):
    """(device ns, launches) of the device operations whose name holds
    ``name`` in the traced window, or None if there is none."""
    ns, n = 0, 0
    for k, a, b in zip(tr.dev_name, tr.dev_start.tolist(),
                       tr.dev_end.tolist()):
        if name in k:
            ns += b - a
            n += 1
    return (ns, n) if n else None


def lane_bytes(P: int, N: int, A: int, W: int, live: float, seq: bool,
               binds: bool) -> float:
    """Bytes one lane's W-event block must move, each input byte read
    once and each output byte written once: the active flags of every
    slot; open_idx, state, and (patterns that bind) bind and (ANY) the
    id set of the ``live`` PMs it meets; the event rows; the per-pattern
    model columns, counters and scalars.  Out: the whole store, counters
    and scalars, the W output rows and latency-ring entries.  (The transition and utility
    table entries a block gathers are left out: a handful of bytes.)"""
    scalars = 2 * P * 4 + 12 * 4 + 2 * 4
    reads = (P * N + live * 4 * 2 + (live * 4 if binds else 0) +
             (live * A * 4 if not seq else 0) +
             W * (P * (4 + 4 + 1) + 4 * 4) + P * 22 + scalars)
    store = P * N * (1 + 4 * 3) + (0 if seq else P * N * A * 4)
    writes = store + scalars + W * (4 + 4 + 1 + 1) + W * 2 * 4
    return reads + writes


def block_bytes(tr) -> float | None:
    """Bytes of one launch over every lane in the traced window, with the
    PMs each block meets taken as the window's mean live PMs a lane (the
    pushes' end-of-chunk counts)."""
    c = tr.counts
    if not c.get("pushes") or "mean_live_pms" not in c:
        return None
    from cepbench.reference.patterns import SEQ, compile_specs
    pats = compile_specs(tr.config["patterns"])
    P, N = len(pats["specs"]), tr.config["max_pms"]
    A = max(8, int(pats["final_state"].max()) + 1)
    L = tr.cell["lanes"]
    return L * lane_bytes(
        P, N, A, tr.config["block_events"], c["mean_live_pms"] / L,
        seq=bool((pats["kind"] == SEQ).all()),
        binds=bool(pats["uses_binding"].any()))
