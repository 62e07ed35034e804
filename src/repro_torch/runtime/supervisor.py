"""Process-level chaos harness: SIGKILL + restart + bitwise recovery
(DESIGN.md §13).

Port of ``repro.runtime.supervisor``.  A child worker runs a
persist-enabled :class:`MatchRuntime` over a seeded workload with a kill
switch armed at one of the instrumented sites (``faults.KILL_SITES``:
mid-chunk, mid-refresh, mid-snapshot-write).  The supervisor launches
it, watches it die with SIGKILL, relaunches it WITHOUT the switch, and
the restarted child recovers from the newest valid snapshot + WAL tail
and finishes the stream.  The final report — carry sha256, telemetry
counters, decoded match sets — must be bitwise identical to an
uninterrupted run.

The child is this module run as ``__main__``::

    python -m repro_torch.runtime.supervisor --child --spec JSON \\
        --dir PERSIST_DIR --out REPORT.json

Kill specs travel in the ``PSPICE_KILL`` environment variable, so the
harness exercises the same entry path an external process manager would
use.  The child runs on the card unless its spec says ``"device":
"cpu"``; on the card it loads the kernel library the parent built (the
build's final rename is atomic, so a SIGKILL never leaves a half-built
library), and the CUDA driver frees a killed child's context.
"""
from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import os
import signal
import subprocess
import sys

from repro_torch.cep import engine as eng
from repro_torch.cep import patterns as pat
from repro_torch.cep import runner
from repro_torch.data import streams
from repro_torch.device import resolve_device
from repro_torch.runtime import chunker, faults as FT, guard as GD, \
    ingest as IG, persist as PS, refresh as RF
from repro_torch.runtime import service as RT

# Simulated-cost scale of the chaos workloads: chunk latencies land in
# the ladder's measurable range.
COST = dict(c_base=3e-4, c_match=6e-5, c_shed_base=1.5e-4,
            c_shed_pm=1.5e-6, c_ebl=6e-5)


class MatchRuntime(RT.StreamRuntime):
    """StreamRuntime that accumulates decoded match identities.

    Matches emitted BEFORE a snapshot are not re-emitted by WAL replay
    (replay starts at the snapshot), so the accumulator rides inside the
    snapshot via the ``_persist_extra`` hook — exactly the pattern an
    exactly-once downstream sink needs.  Requires ``cfg.emit_matches``
    and forces ``group_chunks=1`` (match decode is per chunk).
    """

    def __init__(self, cfg, model, rt, **kw):
        if not cfg.emit_matches:
            raise ValueError("MatchRuntime needs cfg.emit_matches")
        rt = dataclasses.replace(rt, group_chunks=1)
        super().__init__(cfg, model, rt, **kw)
        self.matches: list[set[tuple]] = [set() for _ in
                                          range(cfg.num_patterns)]

    def _run(self, chunk, start):
        carry, outs = super()._run(chunk, start)
        # Set-union is idempotent, so a chunk that ran but died before
        # its snapshot re-absorbs the same identities on replay.
        for p, s in enumerate(eng.match_sets(outs, start)):
            self.matches[p] |= s
        return carry, outs

    def _run_group(self, start, piece, n_chunks):  # group_chunks == 1
        raise AssertionError("MatchRuntime must run chunk-at-a-time")

    def _persist_extra(self) -> dict:
        return {"matches": [sorted([list(map(int, m)) for m in s])
                            for s in self.matches]}

    def _persist_restore_extra(self, extra: dict) -> None:
        if "matches" in extra:
            self.matches = [{tuple(m) for m in s}
                            for s in extra["matches"]]


def build_workload(spec: dict):
    """Seeded (specs, cfg, model, events) — every knob from the spec
    dict (``device`` among them: the card unless it says ``"cpu"``), so
    the parent, the killed child and the restarted child build the
    IDENTICAL workload from the JSON spec alone."""
    dev = resolve_device(spec.get("device"))
    specs = [pat.make_q1(window_size=400, num_symbols=4)]
    cp = pat.compile_patterns(specs)
    cfg = runner.default_config(
        cp, max_pms=spec["max_pms"], latency_bound=0.005,
        gather_stats=True, emit_matches=True, shedder=spec["shedder"],
        backend=spec["backend"], block_events=spec.get("block_events", 16),
        **COST)
    model = eng.make_model(cp, cfg, device=dev)
    rate = spec.get("rate_mult", 3.0) / (cfg.c_base
                                         + cfg.c_match * 0.3 * cfg.max_pms)
    raw = streams.gen_stock(spec["n"], num_symbols=50, pattern_symbols=4,
                            p_class=0.05, seed=101)
    ev = streams.classify(specs, raw, rate=rate, seed=7, device=dev)
    return specs, cfg, model, ev


def runtime_config(spec: dict, persist_dir: str | None) -> RT.RuntimeConfig:
    return RT.RuntimeConfig(
        chunk_size=spec["chunk"],
        refresh=RF.RefreshConfig(
            every_chunks=spec.get("refresh_every", 4),
            min_observations=spec.get("min_observations", 64.0)),
        ingest=IG.IngestConfig(max_queue_events=1 << 15,
                               high_watermark=1 << 13,
                               low_watermark=1 << 11, seed=5),
        ladder=RT.LadderConfig(escalate_streak=2, deescalate_streak=2,
                               latency_bound=0.01),
        guard=GD.GuardConfig(check_every_chunks=1,
                             checkpoint_every_chunks=4),
        persist=None if persist_dir is None else PS.PersistConfig(
            dir=persist_dir,
            snapshot_every_chunks=spec.get("snapshot_every", 4)))


def carry_sha(srt: RT.StreamRuntime) -> str:
    """sha256 of the carry's leaves in the reference's order and bytes
    (equal carries in the two packages hash alike)."""
    h = hashlib.sha256()
    for _, leaf in eng.tree_leaves_with_path(srt.carry):
        h.update(leaf.tobytes())
    return h.hexdigest()


# Wall-clock aggregate fields: real time, not recovered state — excluded
# from every divergence comparison.
WALL_FIELDS = ("wall_s", "refresh_wall_s", "events_per_s")


def semantic_counters(srt: RT.StreamRuntime) -> dict:
    return {k: v for k, v in srt.telemetry.aggregate().items()
            if k not in WALL_FIELDS}


def run_service(spec: dict, persist_dir: str | None = None,
                telemetry_dump: str | None = None) -> dict:
    """One worker lifetime: recover (or cold-start), push the remaining
    stream, flush, report.  A cold start and a post-crash restart are THE
    SAME code path — recovery with an empty directory is a no-op."""
    specs, cfg, model, ev = build_workload(spec)
    srt = MatchRuntime(cfg, model, runtime_config(spec, persist_dir),
                       specs=specs, device=spec.get("device"))
    recovery = None
    if persist_dir is not None:
        recovery = srt.recover_from_disk()
        if recovery["replayed_records"] or recovery["snapshot_chunk"] \
                is not None:
            # A REAL recovery dumps the restored telemetry for post-mortem
            # before new chunks dilute it.
            dump = telemetry_dump or os.path.join(
                persist_dir, "telemetry_recovered.json")
            with open(dump, "w") as f:
                json.dump(srt.telemetry.to_json(), f)
    # Resume the push loop after the last durable record: record ids are
    # global and one push == one record, so the WAL length IS the cursor
    # (the recovery report's ``next_record``).
    push = spec["push"]
    start_push = 0 if recovery is None else recovery["next_record"]
    n = chunker.num_events(ev)
    for s in range(start_push * push, n, push):
        srt.push(chunker.slice_events(ev, s, min(s + push, n)))
    srt.flush()
    return {
        "carry_sha": carry_sha(srt),
        "counters": semantic_counters(srt),
        "matches": [sorted([list(map(int, m)) for m in s])
                    for s in srt.matches],
        "events_processed": int(srt.events_processed),
        "recovery": recovery,
    }


def child_main(argv: list[str]) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--spec", required=True, help="workload spec JSON")
    ap.add_argument("--dir", required=True, help="persistence directory")
    ap.add_argument("--out", required=True, help="final report JSON path")
    args = ap.parse_args(argv)
    FT.install_kill_from_env()
    report = run_service(json.loads(args.spec), persist_dir=args.dir)
    PS.atomic_write(args.out,
                    json.dumps(report, sort_keys=True).encode())
    return 0


class Supervisor:
    """Launch the child worker, expect the armed SIGKILL, relaunch until
    the report file appears."""

    def __init__(self, workdir: str):
        self.workdir = workdir
        self.attempts: list[dict] = []

    def _launch(self, spec: dict, out: str, kill: str | None):
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            [os.path.dirname(os.path.dirname(os.path.dirname(
                os.path.abspath(__file__))))]
            + env.get("PYTHONPATH", "").split(os.pathsep))
        env.pop(FT.KILL_ENV, None)
        if kill is not None:
            env[FT.KILL_ENV] = kill
        cmd = [sys.executable, "-m", "repro_torch.runtime.supervisor",
               "--child", "--spec", json.dumps(spec),
               "--dir", os.path.join(self.workdir, "persist"),
               "--out", out]
        return subprocess.run(cmd, env=env, capture_output=True, text=True)

    def run(self, spec: dict, kill: str | None,
            max_restarts: int = 2) -> dict:
        """Returns {report, attempts, killed, recovered}; raises when the
        child fails for any reason other than the armed kill."""
        out = os.path.join(self.workdir, "report.json")
        killed = False
        for attempt in range(max_restarts + 1):
            want_kill = kill if attempt == 0 else None
            proc = self._launch(spec, out, want_kill)
            self.attempts.append({"attempt": attempt, "kill": want_kill,
                                  "returncode": proc.returncode})
            if proc.returncode == 0:
                with open(out, "rb") as f:
                    report = json.loads(f.read())
                return {"report": report, "attempts": self.attempts,
                        "killed": killed,
                        "recovered": killed and attempt > 0}
            if want_kill is not None \
                    and proc.returncode == -signal.SIGKILL:
                killed = True     # the armed crash — restart and recover
                continue
            raise RuntimeError(
                f"child attempt {attempt} failed rc={proc.returncode} "
                f"(kill={want_kill!r}):\n{proc.stderr[-2000:]}")
        raise RuntimeError(f"child did not finish in {max_restarts + 1} "
                           "attempts")


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv and argv[0] == "--child":
        return child_main(argv[1:])
    raise SystemExit("repro_torch.runtime.supervisor is the chaos-harness "
                     "child entry point; drive it via Supervisor.run "
                     "(--child --spec JSON --dir DIR --out PATH)")


if __name__ == "__main__":
    sys.exit(main())
