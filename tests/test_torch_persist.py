"""The port's durable persistence (repro_torch.runtime.persist, the
runtime's snapshot/WAL recovery and the SIGKILL supervisor) against the
reference's (repro.runtime.persist / supervisor).

Bars, all BITWISE:
* ``carry_manifest`` equals the reference's; the snapshot sections the
  port encodes from converted state — manifests, payload and the whole
  framed file — equal the reference's bytes;
* a snapshot + WAL written by the reference, recovered by the port and
  run to the end (and the other way round) equals the reference's
  uninterrupted run: carry sha256, decoded match sets, semantic
  telemetry counters, events;
* the port's in-process crash-resume and lane-stacked round trip equal
  its uninterrupted runs; a SIGKILLed child recovers to the same report;
* torn, wrong-magic, wrong-version and wrong-manifest snapshots and torn
  WAL segments raise the reference's error classes.
"""
import os
import struct
import zlib

import jax
import pytest

from repro.cep import engine as eng
from repro.cep import patterns as pat
from repro.cep import runner
from repro.runtime import persist as RPS
from repro.runtime import supervisor as RSV
from repro_torch.cep import convert
from repro_torch.cep import engine as teng
from repro_torch.runtime import chunker as TCH
from repro_torch.runtime import lanes as TLN
from repro_torch.runtime import persist as TPS
from repro_torch.runtime import supervisor as TSV

from _torch_bridge import assert_trees_equal, port_config


def _spec(backend="xla", shedder="pspice", refresh_every=4, n=1536):
    return {"backend": backend, "shedder": shedder, "n": n, "push": 256,
            "chunk": 128, "max_pms": 32, "block_events": 16,
            "rate_mult": 3.0, "refresh_every": refresh_every,
            "snapshot_every": 4, "min_observations": 64.0}


PORT_BACKEND = {"xla": "torch", "pallas_block": "cuda_block"}


def _port_spec(spec, backend=None):
    return dict(spec, backend=backend or PORT_BACKEND[spec["backend"]],
                device="cpu")


# ---------------------------------------------------------------------------
# The codec
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("max_pms,lat", [(32, 4096), (48, 128), (7, 16)])
def test_carry_manifest_equals_reference(max_pms, lat):
    specs = [pat.make_q1(window_size=400, num_symbols=4),
             pat.make_q3(3, window_size=300)]
    cfg = runner.default_config(pat.compile_patterns(specs),
                                max_pms=max_pms)
    assert teng.carry_manifest(port_config(cfg, "torch"),
                               lat_capacity=lat) == \
        eng.carry_manifest(cfg, lat_capacity=lat)


@pytest.fixture(scope="module")
def ref_state():
    """A reference runtime mid-stream (no persistence), its sections and
    the port's copy of them."""
    spec = _spec()
    specs, cfg, model, ev = RSV.build_workload(spec)
    srt = RSV.MatchRuntime(cfg, model, RSV.runtime_config(spec, None),
                           specs=specs)
    srt.push(jax.tree.map(lambda x: x[:600], ev))
    ref = {"carry": srt.carry, "model": srt.model,
           "pending": srt._buf.buffered(), "events": ev}
    port = {"carry": convert.carry_from_numpy(
        convert.tree_to_numpy(srt.carry), "cpu"),
        "model": convert.model_from_numpy(
            convert.tree_to_numpy(srt.model), "cpu"),
        "pending": convert.events_from_numpy(
            convert.tree_to_numpy(srt._buf.buffered()), "cpu"),
        "events": convert.events_from_numpy(convert.tree_to_numpy(ev),
                                            "cpu")}
    return ref, port


def test_sections_and_file_byte_identical(ref_state):
    ref, port = ref_state
    for name in ref:
        rm, rb = RPS.encode_tree(ref[name])
        tm, tb = TPS.encode_tree(port[name])
        assert tm == rm, name
        assert tb == rb, name
    control = {"chunk_i": 4, "x": [1.5, None, "a"], "key": [3, 4000000000]}
    assert TPS.build_snapshot_bytes(4, control, port) == \
        RPS.build_snapshot_bytes(4, control, ref)


def test_decode_round_trip_restores_tensors(ref_state):
    _, port = ref_state
    man, blob = TPS.encode_tree(port["carry"])
    back = TPS.to_device(TPS.decode_tree(man, blob, port["carry"]), "cpu")
    assert_trees_equal(port["carry"], back, "carry round trip")
    ev = TPS.to_device(TPS.decode_tree(*TPS.encode_tree(port["pending"]),
                                       TPS.event_template(), strict=False),
                       "cpu")
    assert_trees_equal(port["pending"], ev, "events round trip")


def _snapshot_bytes(port):
    return TPS.build_snapshot_bytes(3, {"k": 1}, {"carry": port["carry"]})


def test_torn_magic_version_and_manifest_errors(ref_state, tmp_path):
    _, port = ref_state
    data = _snapshot_bytes(port)
    with pytest.raises(TPS.CorruptSnapshotError, match="CRC"):
        TPS.parse_snapshot_bytes(data[:len(data) // 2] + data[-4:])
    with pytest.raises(TPS.CorruptSnapshotError, match="shorter"):
        TPS.parse_snapshot_bytes(data[:10])
    with pytest.raises(TPS.CorruptSnapshotError, match="magic"):
        TPS.parse_snapshot_bytes(b"NOTSNAP!" + data[8:])
    body = struct.pack("<I", 99) + data[12:-4]
    with pytest.raises(TPS.CorruptSnapshotError, match="version 99"):
        TPS.parse_snapshot_bytes(TPS.SNAP_MAGIC + body +
                                 struct.pack("<I", zlib.crc32(body)))
    _, sections = TPS.parse_snapshot_bytes(data)
    other = teng.init_carry(teng.EngineConfig(
        num_patterns=1, max_states=5, max_classes=4, max_pms=16),
        device="cpu")
    with pytest.raises(TPS.ManifestMismatchError, match="manifest"):
        TPS.decode_tree(*sections["carry"], other, what="carry")
    # Each package's errors read the same.
    with pytest.raises(RPS.CorruptSnapshotError) as want:
        RPS.parse_snapshot_bytes(data[:-1])
    with pytest.raises(TPS.CorruptSnapshotError) as got:
        TPS.parse_snapshot_bytes(data[:-1])
    assert str(got.value) == str(want.value)


def test_store_rotation_and_torn_fallback(ref_state, tmp_path):
    _, port = ref_state
    store = TPS.SnapshotStore(str(tmp_path), keep_generations=2)
    for chunk in (4, 8, 12):
        store.save(chunk, {"chunk": chunk}, {"carry": port["carry"]})
    assert [os.path.basename(p) for p in store.paths()] == \
        ["snap-0000000008.ckpt", "snap-0000000012.ckpt"]
    with open(store.paths()[-1], "r+b") as f:
        f.truncate(100)
    header, _, meta = store.load_latest()
    assert header["chunk_index"] == 8
    assert len(meta["rejected"]) == 1
    # The reference reads the port's store the same way.
    h2, _, m2 = RPS.SnapshotStore(str(tmp_path), 2).load_latest()
    assert h2 == header and m2["rejected"] == meta["rejected"]


def test_wal_append_reopen_replay_across_packages(ref_state, tmp_path):
    ref, port = ref_state
    wal = TPS.WriteAheadLog(str(tmp_path))
    pieces = [TCH.slice_events(port["events"], s, s + 100)
              for s in (0, 100, 200)]
    assert [wal.append(p) for p in pieces] == [0, 1, 2]
    wal.close()
    again = TPS.WriteAheadLog(str(tmp_path))
    assert again.next_record_id == 3
    assert again.append(pieces[0]) == 3
    again.close()
    got = TPS.WriteAheadLog(str(tmp_path)).records_since(1)
    want = RPS.WriteAheadLog(str(tmp_path)).records_since(1)
    assert [r for r, _ in got] == [r for r, _ in want] == [1, 2, 3]
    for (_, a), (_, b) in zip(got, want):
        assert_trees_equal(b, a, "wal record")
    seg = again.segments()[-1][1]
    with open(seg, "r+b") as f:
        f.truncate(os.path.getsize(seg) - 3)
    with pytest.raises(TPS.CorruptSegmentError, match="torn record"):
        TPS.WriteAheadLog(str(tmp_path))


def test_persist_config_validation_equals_reference(tmp_path):
    for kw in (dict(dir=""), dict(dir="d", snapshot_every_chunks=0),
               dict(dir="d", keep_generations=0)):
        with pytest.raises(ValueError) as want:
            RPS.PersistConfig(**kw)
        with pytest.raises(ValueError) as got:
            TPS.PersistConfig(**kw)
        assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# Recovery through the runtime
# ---------------------------------------------------------------------------

def _report(srt, sv):
    return {"carry_sha": sv.carry_sha(srt),
            "counters": sv.semantic_counters(srt),
            "matches": [sorted([list(map(int, m)) for m in s])
                        for s in srt.matches],
            "events_processed": int(srt.events_processed)}


def _run_crashed(sv, spec, d, crash_after=3, resume_sv=None,
                 resume_spec=None):
    """Push ``crash_after`` pushes into a persist-enabled runtime of
    ``sv`` and abandon it (its disk state is what a SIGKILL leaves); a
    fresh runtime of ``resume_sv`` recovers from the directory and runs
    the stream to its end.  Returns (report, recovery report)."""
    resume_sv, resume_spec = resume_sv or sv, resume_spec or spec
    specs, cfg, model, ev = sv.build_workload(spec)
    a = sv.MatchRuntime(cfg, model, sv.runtime_config(spec, d), specs=specs,
                        **({"device": "cpu"} if sv is TSV else {}))
    push = spec["push"]
    n = int(ev.arrival.shape[0])
    for s in range(0, crash_after * push, push):
        a.push(jax.tree.map(lambda x: x[s:s + push], ev) if sv is RSV
               else TCH.slice_events(ev, s, s + push))
    a.persist.wal.close()
    del a
    specs, cfg, model, ev = resume_sv.build_workload(resume_spec)
    b = resume_sv.MatchRuntime(
        cfg, model, resume_sv.runtime_config(resume_spec, d), specs=specs,
        **({"device": "cpu"} if resume_sv is TSV else {}))
    rec = b.recover_from_disk()
    for s in range(b.persist.wal.next_record_id * push, n, push):
        b.push(jax.tree.map(lambda x: x[s:s + push], ev)
               if resume_sv is RSV
               else TCH.slice_events(ev, s, min(s + push, n)))
    b.flush()
    return _report(b, resume_sv), rec


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_snapshot_restores_across_packages(writer, tmp_path):
    """A snapshot + WAL written by one package, recovered by the other
    and run to the end, equals the reference's uninterrupted run (no
    refresh: a refreshed table may differ in its last bits between the
    packages, within tests/test_torch_runtime.py's tolerance)."""
    spec = _spec(refresh_every=0)
    clean = RSV.run_service(spec)
    sv_w, sv_r = (RSV, TSV) if writer == "reference" else (TSV, RSV)
    w_spec = spec if sv_w is RSV else _port_spec(spec)
    r_spec = spec if sv_r is RSV else _port_spec(spec)
    rep, rec = _run_crashed(sv_w, w_spec, str(tmp_path), resume_sv=sv_r,
                            resume_spec=r_spec)
    assert rec["snapshot_chunk"] is not None and rec["replayed_records"]
    for k in ("carry_sha", "counters", "matches", "events_processed"):
        assert rep[k] == clean[k], k
    assert clean["counters"]["shed_calls"] > 0


@pytest.mark.parametrize("backend,shedder", [("torch", "pspice"),
                                             ("cuda_block", "pmbl")])
def test_crash_resume_bitwise(backend, shedder, tmp_path):
    """In the port: abandon mid-stream, recover in a fresh runtime, finish
    — equal to the uninterrupted run with the full resilience stack and
    refresh on."""
    spec = _port_spec(_spec(shedder=shedder), backend)
    clean = TSV.run_service(spec)
    rep, rec = _run_crashed(TSV, spec, str(tmp_path))
    assert rec["snapshot_chunk"] is not None
    for k in ("carry_sha", "counters", "matches", "events_processed"):
        assert rep[k] == clean[k], k


def test_recover_empty_dir_and_snapshot_requires_persist(tmp_path):
    spec = _port_spec(_spec(n=300))
    specs, cfg, model, _ = TSV.build_workload(spec)
    srt = TSV.MatchRuntime(cfg, model, TSV.runtime_config(spec, None),
                           specs=specs, device="cpu")
    with pytest.raises(ValueError, match="persist"):
        srt.snapshot_now()
    with pytest.raises(ValueError, match="persist"):
        srt.recover_from_disk()
    srt = TSV.MatchRuntime(cfg, model,
                           TSV.runtime_config(spec, str(tmp_path)),
                           specs=specs, device="cpu")
    rep = srt.recover_from_disk()
    assert rep["snapshot_chunk"] is None and rep["replayed_records"] == 0


def test_multitenant_snapshot_round_trip(tmp_path):
    """Three lanes with ingest, ladder and guard: snapshot, abandon the
    runtime mid-stream, recover into a fresh MultiTenantRuntime, finish —
    every lane's carry and the telemetry equal the uninterrupted run."""
    spec = _port_spec(_spec(n=1024))
    specs, cfg, model, ev = TSV.build_workload(spec)
    L = 3
    evL = TLN.stack([ev] * L)
    mL = TLN.broadcast_model(model, L)

    def make(d):
        return TSV.RT.MultiTenantRuntime(
            cfg, mL, L, rt=TSV.runtime_config(spec, d), specs=specs,
            device="cpu")

    def push_from(mt, lo):
        for s in range(lo * 256, 1024, 256):
            mt.push(TCH.slice_events(evL, s, s + 256, axis=1))
        mt.flush()

    clean = make(None)
    push_from(clean, 0)
    a = make(str(tmp_path))
    for s in range(0, 768, 256):
        a.push(TCH.slice_events(evL, s, s + 256, axis=1))
    a.snapshot_now()
    a.persist.wal.close()
    b = make(str(tmp_path))
    rec = b.recover_from_disk()
    assert rec["replayed_records"] == 0
    push_from(b, b.persist.wal.next_record_id)
    assert_trees_equal(clean.carry, b.carry, "lanes carry")
    assert TSV.semantic_counters(b) == TSV.semantic_counters(clean)


def test_supervisor_sigkill_at_snapshot_recovers_bitwise(tmp_path):
    """A child on the CPU dies by SIGKILL inside its second snapshot write
    (a torn file); the relaunched child rejects the torn generation,
    recovers and ends with the uninterrupted run's report."""
    spec = _port_spec(_spec(n=1280))
    clean = TSV.run_service(spec)
    res = TSV.Supervisor(str(tmp_path)).run(spec, kill="snapshot:2")
    assert res["killed"] and res["recovered"]
    assert [a["returncode"] for a in res["attempts"]] == [-9, 0]
    rep = res["report"]
    assert len(rep["recovery"]["rejected_snapshots"]) == 1
    for k in ("carry_sha", "counters", "matches", "events_processed"):
        assert rep[k] == clean[k], k
