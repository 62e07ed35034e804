"""Recovery of the port's mesh runtime on several ranks, SIGKILL-tested.

A ``MultiTenantRuntime`` on a mesh is one process per rank; rank 0 alone
writes snapshots and the write-ahead log.  Here the four-lane fixture of
``tests/test_torch_dist_lanes.py`` (four mixed patterns, N = 32, 288
events a lane) runs with refresh every 2 chunks of 32 events and a
snapshot every 2 chunks, pushed 48 events at a time, on gloo worlds of
CPU ranks (``repro_torch.dist.spawn``):

* a world is started with the kill switch armed in one rank alone
  (``faults.KILL_ENV``), which dies by SIGKILL at its site — ``chunk``,
  ``refresh`` or ``snapshot`` (rank 0 leaves a torn generation there; a
  rank that writes nothing dies where its writer writes) — and ``spawn``
  names it with exit code -9 and stops the survivors;
* a fresh world (a new store, no switch) recovers on every rank: rank 0
  reads the newest valid snapshot and the WAL tail and broadcasts them,
  every rank applies and replays them, then pushes the rest of the stream
  from the report's ``next_record`` and flushes.

Bars, BITWISE (carry sha256 and every carry leaf, the telemetry's
semantic counters, events processed): each recovered world equals the
uninterrupted world of its shape, on every rank, and every rank equals
rank 0; the uninterrupted world equals the port's one-process runtime
over the same lanes (meshless on the ``(2,)`` "data" mesh; on the
``(2, 2)`` mesh, whose pattern shards are each their own simulated
operator with clocks merged by max, the ``AbstractMesh`` runtime that
runs every rank's block in this process); an ``AbstractMesh`` runtime
recovering from a killed world's directory equals it too.  The
reference's meshless ``MultiTenantRuntime`` on ``backend="xla"`` (its own
mesh runtime stops in ``jnp.quantile`` under jax 0.9.0, ROADMAP §3) is
the bar on the data mesh: every carry leaf, the counters and the events
bitwise, but the latency ring (``lat_samples_l``), which the reference's
lane-batched step at four patterns rounds 1 ulp apart on a few entries
(ROADMAP §3; ``tests/test_torch_dist_lanes.py`` pins the same leaf).  The
reference's own recovery from the directory a killed port world left
ends equal to its uninterrupted run by the same bar (the formats are
shared; the ring the port's snapshot carries is the port's).
"""
import concurrent.futures
import shutil
import time

import numpy as np
import pytest

from repro import runtime as RT
from repro.runtime import supervisor as RSV
from repro_torch import dist as D
from repro_torch import runtime as TRT
from repro_torch.cep import convert

import _dist_reference as R
import _dist_worlds as W
from _torch_bridge import port_config

CHUNK, PUSH, REFRESH, SNAP = 32, 48, 2, 2
AFTER = {"chunk": 5, "refresh": 2, "snapshot": 2}
MESHES = {"2-data": ((2,), ("data",)),
          "2x2-data-model": ((2, 2), ("data", "model"))}
# (mesh, kill site, killed rank)
CELLS = [("2-data", site, rank) for site in AFTER for rank in (0, 1)] \
    + [("2x2-data-model", "chunk", 3), ("2x2-data-model", "snapshot", 0)]
RING = "carry.lat_samples_l"
# The killed world whose directory the reference recovers from.
REF_CELL = ("2-data", "snapshot", 0)


def _id(cell) -> str:
    return "{}/{}@rank{}".format(*cell)


def _inputs():
    cfg, mL, evL = R.lanes_inputs("pspice")
    n = convert.tree_to_numpy
    return cfg, port_config(cfg, "torch"), n(mL), n(evL)


def _cell(name, tcfg, d, mL, evL):
    return (name, tcfg, CHUNK, PUSH, REFRESH, SNAP, str(d), mL, evL)


def _crash(mesh, cell, d, tcfg, mL, evL):
    """The killed world: returns (killed rank, exit code, seconds)."""
    shape, names = MESHES[mesh]
    _, site, rank = cell
    t0 = time.perf_counter()
    with pytest.raises(D.RankError) as err:
        D.spawn(W.durable_world, int(np.prod(shape)), args=(
            shape, names, [_cell("crash", tcfg, d, mL, evL)],
            (rank, f"{site}:{AFTER[site]}")), timeout=W.WORLD_TIMEOUT)
    return err.value.rank, err.value.exitcode, time.perf_counter() - t0


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Every crash world (two at a time), then one recovery world per
    mesh shape that runs the uninterrupted cell on an empty directory and
    recovers each killed cell's; meanwhile the in-process runs: the
    port's one-process runtimes, the reference's uninterrupted run and its
    recovery from a killed world's directory."""
    base = tmp_path_factory.mktemp("mesh-recovery")
    cfg, tcfg, mL, evL = _inputs()
    dirs = {c: base / _id(c).replace("/", "_").replace("@", "_")
            for c in CELLS}
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        futs = {c: pool.submit(_crash, c[0], c, dirs[c], tcfg, mL, evL)
                for c in CELLS}
        crashed = {c: f.result() for c, f in futs.items()}
    # What the killed worlds left, before the recoveries write to it: a
    # copy for the abstract-mesh runtime, one for the reference.
    copies = {c: base / f"copy-{dirs[c].name}" for c in CELLS}
    copies["reference"] = base / "copy-reference"
    for c, d in copies.items():
        shutil.copytree(dirs[REF_CELL if c == "reference" else c], d)

    def recover(mesh):
        shape, names = MESHES[mesh]
        cells = [_cell("uninterrupted", tcfg, base / f"clean-{mesh}", mL,
                       evL)]
        cells += [_cell(_id(c), tcfg, dirs[c], mL, evL)
                  for c in CELLS if c[0] == mesh]
        return D.spawn(W.durable_world, int(np.prod(shape)),
                       args=(shape, names, cells),
                       timeout=W.WORLD_TIMEOUT)

    # A copy left as the killed world wrote it.
    pristine = {REF_CELL: base / "copy-pristine"}
    shutil.copytree(dirs[REF_CELL], pristine[REF_CELL])
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        futs = {m: pool.submit(recover, m) for m in MESHES}
        local = _in_process(cfg, tcfg, mL, evL, copies)
        recovered = {m: f.result() for m, f in futs.items()}
    return crashed, recovered, local, pristine


def _port_run(tcfg, mL, evL, mesh=None, d=None):
    events = convert.events_from_numpy(evL, "cpu")
    srt = TRT.MultiTenantRuntime(
        tcfg, convert.model_from_numpy(mL, "cpu"), R.LANES,
        rt=W.durable_config(TRT, d, CHUNK, REFRESH, SNAP),
        specs=W.mixed_specs(tcfg.num_patterns), seed=5, mesh=mesh,
        device="cpu")
    return W.durable_run(srt, events, PUSH, recover=d is not None)


def _ref_run(cfg, d=None):
    """The reference's meshless runtime over the lanes, recovering from
    ``d`` first when given."""
    _, mL, evL = R.lanes_inputs("pspice")
    srt = RT.MultiTenantRuntime(
        cfg, mL, R.LANES, rt=W.durable_config(RT, d, CHUNK, REFRESH, SNAP),
        specs=R._mixed(4), seed=5)
    rep = None
    if d is not None:
        rep = srt.recover_from_disk()
    first = 0 if d is None else srt.persist.wal.next_record_id * PUSH
    for s in range(first, R.LANE_EV, PUSH):
        srt.push(RT.slice_events(evL, s, min(s + PUSH, R.LANE_EV), axis=1))
    srt.flush()
    return {"carry_sha": RSV.carry_sha(srt),
            "counters": RSV.semantic_counters(srt),
            "events_processed": int(srt.events_processed),
            "recovery": rep, "carry": W.flat(srt.carry, "carry")}


def _in_process(cfg, tcfg, mL, evL, copies):
    out = {"meshless": _port_run(tcfg, mL, evL),
           "abstract": _port_run(tcfg, mL, evL, mesh=D.abstract_mesh(
               *MESHES["2x2-data-model"])),
           "reference": _ref_run(cfg),
           "reference_recovered": _ref_run(cfg, copies["reference"])}
    for c in CELLS:
        out[c] = _port_run(tcfg, mL, evL, D.abstract_mesh(*MESHES[c[0]]),
                           copies[c])
    return out


def _report(rep: dict) -> dict:
    """A recovery report with each rejected generation by its file name
    (its error names the directory)."""
    return dict(rep, rejected_snapshots=[
        r["path"] for r in rep["rejected_snapshots"]])


def _same(a: dict, b: dict, skip=()) -> list:
    """The keys in which two reports differ (the carry leaf by leaf)."""
    bad = [k for k in ("carry_sha", "counters", "events_processed")
           if k not in skip and a[k] != b[k]]
    bad += [k for k in a["carry"] if k not in skip
            and not np.array_equal(a["carry"][k], b["carry"][k])]
    return bad


@pytest.mark.parametrize("cell", CELLS, ids=_id)
def test_armed_rank_dies_by_sigkill_and_is_named(worlds, cell):
    """``spawn`` names the armed rank and its exit code -9, and stops the
    survivors well within their collectives' timeout."""
    rank, code, secs = worlds[0][cell]
    assert (rank, code) == (cell[2], -9)
    assert secs < W.WORLD_TIMEOUT / 2, secs


@pytest.mark.parametrize("cell", CELLS, ids=_id)
def test_recovered_world_equals_uninterrupted(worlds, cell):
    """Bar: on every rank, bit for bit, the uninterrupted world of the
    same shape (rank 0's report); the recovery restored a snapshot or
    replayed the WAL."""
    ranks = worlds[1][cell[0]]
    want = ranks[0]["uninterrupted"]
    for r, res in enumerate(ranks):
        got = res[_id(cell)]
        assert not _same(want, got), (r, _same(want, got))
    rep = ranks[0][_id(cell)]["recovery"]
    assert rep["snapshot_chunk"] is not None or rep["replayed_records"]
    assert rep["next_record"] > 0
    assert want["counters"]["shed_calls"] > 0 and want["counters"][
        "refreshes"] > 0


@pytest.mark.parametrize("cell", CELLS, ids=_id)
def test_every_rank_recovers_as_rank_zero(worlds, cell):
    """After recovery and the rest of the stream every rank holds rank
    0's carry, counters and recovery report (its wall apart)."""
    ranks = worlds[1][cell[0]]
    r0 = ranks[0][_id(cell)]
    for r, res in enumerate(ranks[1:], 1):
        got = res[_id(cell)]
        assert not _same(r0, got), (r, _same(r0, got))
        assert got["recovery"] == r0["recovery"], r
        assert got["recovery_wall_s"] is not None


@pytest.mark.parametrize("cell", [c for c in CELLS if c[1] == "snapshot"],
                         ids=_id)
def test_snapshot_kill_recovery_falls_back_past_a_torn_generation(worlds,
                                                                  cell):
    """Rank 0 killed in its snapshot write leaves a torn generation that
    recovery rejects; a rank that writes nothing, killed at the same
    site, leaves none."""
    rep = worlds[1][cell[0]][0][_id(cell)]["recovery"]
    assert len(rep["rejected_snapshots"]) == (1 if cell[2] == 0 else 0)
    assert rep["snapshot_chunk"] is not None and rep["replayed_records"]


@pytest.mark.parametrize("mesh", list(MESHES))
def test_world_equals_one_process_port_runtime(worlds, mesh):
    """Bar: the uninterrupted world, bit for bit, the port's runtime in
    one process — meshless on the data mesh, the ``AbstractMesh`` runtime
    (every rank's block here) on the (2, 2) mesh."""
    local = worlds[2]["meshless" if mesh == "2-data" else "abstract"]
    got = worlds[1][mesh][0]["uninterrupted"]
    assert not _same(local, got), _same(local, got)


def test_pattern_shards_are_their_own_operators(worlds):
    """Why the (2, 2) world's bar is the abstract-mesh runtime: its pattern
    shards clock their own simulated operators, so it differs from the
    meshless run."""
    assert _same(worlds[2]["meshless"],
                 worlds[1]["2x2-data-model"][0]["uninterrupted"])


@pytest.mark.parametrize("cell", CELLS, ids=_id)
def test_abstract_mesh_recovers_a_killed_worlds_directory(worlds, cell):
    """An ``AbstractMesh`` runtime of the world's shape (no process group:
    the one-process recovery path, every rank's block in this process)
    recovering from the directory the killed world left ends bitwise
    equal to the recovered world."""
    got = worlds[2][cell]
    want = worlds[1][cell[0]][0][_id(cell)]
    assert not _same(want, got), _same(want, got)
    assert _report(got["recovery"]) == _report(want["recovery"])


@pytest.mark.parametrize("cell", [c for c in CELLS if c[0] == "2-data"],
                         ids=_id)
def test_recovered_world_equals_reference_meshless_runtime(worlds, cell):
    """Bar: the reference's meshless ``MultiTenantRuntime`` (``xla``) over
    the same lanes — counters and events exact, every carry leaf bitwise
    but the latency ring, which is within 1 ulp on under 5 % of its
    entries."""
    _assert_reference(worlds[2]["reference"],
                      worlds[1]["2-data"][0][_id(cell)])


def _assert_reference(ref: dict, got: dict) -> None:
    """Counters, events and every carry leaf bitwise but the latency
    ring, which is within 1 ulp on under 5 % of its entries."""
    bad = _same(ref, got, skip=("carry_sha", RING))
    assert not bad, bad
    ulps = np.abs(ref["carry"][RING].view(np.int32).astype(np.int64)
                  - got["carry"][RING].view(np.int32).astype(np.int64))
    assert ulps.max() <= 1 and (ulps > 0).mean() < 0.05


def test_reference_recovers_from_a_killed_port_world(worlds):
    """The reference's meshless runtime, recovering from the directory the
    data-mesh world left when rank 0 died in its snapshot write (rejecting
    the torn generation, replaying the WAL tail), ends equal to its
    uninterrupted run as the port's world does: the latency ring the
    port's snapshot carries is the port's rounding."""
    local = worlds[2]
    rec = local["reference_recovered"]
    assert len(rec["recovery"]["rejected_snapshots"]) == 1
    assert rec["recovery"]["replayed_records"]
    _assert_reference(local["reference"], rec)


def test_spawn_names_a_killed_rank_at_once(tmp_path):
    """Rank 1 dies by SIGKILL while rank 0 waits in a collective with it:
    ``spawn`` raises within 5 s of the death, naming rank 1 and -9,
    where it used to wait for the peer's collective timeout."""
    stamp = tmp_path / "death"
    with pytest.raises(D.RankError) as err:
        D.spawn(W.killed_rank, 2, args=(str(stamp),), timeout=60.0)
    seen = time.time()
    assert (err.value.rank, err.value.exitcode) == (1, -9)
    assert "rank 1 of 2 exited with code -9" in str(err.value)
    assert seen - float(stamp.read_text()) < 5.0


def test_rank_zero_sends_what_a_recovery_reads(worlds):
    """What rank 0 broadcasts is what the one-process recovery reads: the
    newest valid generation's bytes parse to ``load_latest``'s header and
    sections (the torn newer one rejected alike), and the encoded WAL
    records decode to ``records_since``'s batches."""
    from repro_torch.runtime import persist as PS
    d = str(worlds[3][REF_CELL])
    store, wal = PS.SnapshotStore(d), PS.WriteAheadLog(d)
    data, header, sections, meta = store.load_latest_raw()
    assert (header, sections, meta) == store.load_latest()
    assert PS.parse_snapshot_bytes(data, meta["path"]) == (header, sections)
    assert len(meta["rejected"]) == 1
    start = int(header["control"]["wal_next_record"])
    want = wal.records_since(start)
    got = [(rid, PS.decode_record(m, b)) for rid, m, b in
           wal.encoded_since(start)]
    assert [r for r, _ in got] == [r for r, _ in want] == [2, 3]
    for (_, a), (_, b) in zip(got, want):
        assert all(np.array_equal(x, y) for x, y in zip(a, b))
