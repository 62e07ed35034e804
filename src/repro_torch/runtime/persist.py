"""Durable snapshots + write-ahead event log (DESIGN.md §13).

Port of ``repro.runtime.persist``; the file formats are the reference's
byte for byte, so a snapshot or WAL written by either package restores
in the other (the carry's key is written as the reference's uint32
words).

Everything the runtime is — the owned carry, the deployed model, the
PRNG key chain, and the host-side control state (ladder rung + streaks,
token-bucket clocks, watermark latches, refresh state, telemetry) —
lives in one process.  This module makes that state durable with two
artifacts, sized so that recovery is *provably bitwise*:

1. **Snapshots** — a versioned container holding every pytree flattened
   in the reference's ``jax.tree_util`` order with a ``{path, dtype,
   shape}`` manifest (``repro_torch.cep.engine.pytree_manifest``), a
   JSON control block, and a
   CRC32 over the whole body.  Writes are atomic (tmp + fsync + rename
   + directory fsync) and rotate across ``keep_generations`` files;
   ``load_latest`` CRC-rejects torn generations and falls back to the
   previous one.

2. **Write-ahead log** — every ``push`` batch is appended (and flushed)
   to a segment file BEFORE the runtime processes it.  Records carry
   globally monotone ids; a snapshot stores ``wal_next_record``, the
   first id NOT absorbed into it.  Recovery = restore newest valid
   snapshot + re-push records ``>= wal_next_record`` through the normal
   chunk path.  Because admission, shedding and refresh are all clocked
   by event arrival time and seeded PRNG chains (never wall clock), the
   replay re-derives every decision exactly and the recovered state is
   bitwise-identical to the uninterrupted run.

The guard's in-memory checkpoint (repro_torch.runtime.guard) is one more
consumer of the same codec: its host copies and control dict ride along
inside the durable snapshot, so a recovered process can still roll back
to its last good in-memory checkpoint.
"""
from __future__ import annotations

import dataclasses
import glob
import json
import os
import struct
import zlib

import numpy as np
import torch

from repro_torch.cep import engine as eng
from repro_torch.runtime import faults as FT

SNAP_MAGIC = b"PSPSNAP\x01"
SNAP_VERSION = 1
WAL_MAGIC = b"PSPWAL\x01\x00"
_REC_MAGIC = 0x50455631  # "PEV1"
_REC_HEAD = struct.Struct("<IQII")   # magic, record id, manifest len, blob len


class PersistError(ValueError):
    """Base class for durable-state errors (all are actionable)."""


class CorruptSnapshotError(PersistError):
    """Torn/truncated/wrong-magic/wrong-version/CRC-failing snapshot.
    ``SnapshotStore.load_latest`` treats this as 'try the previous
    generation'; direct loads surface it."""


class ManifestMismatchError(PersistError):
    """The snapshot's leaf manifest does not match the live tree — a
    config/shape mismatch, not corruption.  Never falls back silently:
    loading an incompatible snapshot into a differently-shaped runtime
    is operator error and must be surfaced."""


class CorruptSegmentError(PersistError):
    """A WAL segment failed to parse (bad magic, torn record, CRC)."""


@dataclasses.dataclass(frozen=True)
class PersistConfig:
    """Durability knobs (validated at construction)."""
    dir: str                        # snapshot + WAL directory
    snapshot_every_chunks: int = 8  # snapshot cadence (checked per push)
    keep_generations: int = 3       # snapshot files retained
    wal_fsync_every: int = 1        # fsync cadence in appends; <=0 = flush
                                    # to the OS only (process-crash safe,
                                    # not power-loss safe)

    def __post_init__(self):
        if not self.dir:
            raise ValueError("persist.dir must name a directory")
        if self.snapshot_every_chunks < 1:
            raise ValueError("persist.snapshot_every_chunks must be >= 1: "
                             f"{self.snapshot_every_chunks}")
        if self.keep_generations < 1:
            raise ValueError("persist.keep_generations must be >= 1: "
                             f"{self.keep_generations}")


# -- leaf codec -------------------------------------------------------------
def encode_tree(tree) -> tuple[list[dict], bytes]:
    """Flatten ``tree`` to (manifest, payload): leaves in the reference's
    flatten order, each a contiguous little-endian-native byte run
    described by one ``{path, dtype, shape}`` manifest entry."""
    manifest, blobs = [], []
    for path, leaf in eng.tree_leaves_with_path(tree):
        manifest.append({"path": path, "dtype": leaf.dtype.str,
                         "shape": list(leaf.shape)})
        blobs.append(np.ascontiguousarray(leaf).tobytes())
    return manifest, b"".join(blobs)


def _unflatten(template, leaves):
    """``template``'s structure with its leaves taken in order from the
    iterator ``leaves`` (the traversal of
    ``engine.tree_leaves_with_path``)."""
    if template is None:
        return None
    if isinstance(template, tuple) and hasattr(template, "_fields"):
        return type(template)(*(_unflatten(x, leaves) for x in template))
    if isinstance(template, (list, tuple)):
        return type(template)(_unflatten(x, leaves) for x in template)
    if isinstance(template, dict):
        return {k: _unflatten(template[k], leaves) for k in sorted(template)}
    return next(leaves)


def decode_tree(manifest: list[dict], blob: bytes, template,
                what: str = "tree", strict: bool = True):
    """Rebuild a tree with ``template``'s structure from codec output.

    ``strict`` validates dtype AND shape per leaf against the template
    (carry/model: a mismatch means the snapshot belongs to a different
    config); non-strict validates structure only (event batches, whose
    event-axis length legitimately varies).  Leaves come back as host
    NumPy views into ``blob`` (``to_device`` makes tensors of them).
    """
    exp = eng.pytree_manifest(template)
    if len(exp) != len(manifest):
        raise ManifestMismatchError(
            f"{what}: snapshot has {len(manifest)} leaves, live tree has "
            f"{len(exp)} — snapshot was written by a different config")
    bad = []
    for e, m in zip(exp, manifest):
        if e["path"] != m["path"]:
            bad.append(f"{m['path']} (expected {e['path']})")
        elif strict and (e["dtype"] != m["dtype"]
                         or e["shape"] != list(m["shape"])):
            bad.append(f"{m['path']}: {m['dtype']}{m['shape']} != live "
                       f"{e['dtype']}{e['shape']}")
    if bad:
        raise ManifestMismatchError(
            f"{what}: manifest mismatch on {len(bad)} leaves (snapshot "
            f"from a different config/shape): " + "; ".join(bad[:4]))
    leaves, off = [], 0
    for m in manifest:
        dt = np.dtype(m["dtype"])
        count = int(np.prod(m["shape"], dtype=np.int64)) if m["shape"] \
            else 1
        nbytes = dt.itemsize * count
        if off + nbytes > len(blob):
            raise CorruptSnapshotError(
                f"{what}: payload truncated at leaf {m['path']} "
                f"(need {off + nbytes} bytes, have {len(blob)})")
        arr = np.frombuffer(blob, dtype=dt, count=count, offset=off)
        leaves.append(arr.reshape(tuple(m["shape"])))
        off += nbytes
    if off != len(blob):
        raise CorruptSnapshotError(
            f"{what}: {len(blob) - off} trailing payload bytes")
    return _unflatten(template, iter(leaves))


def to_device(tree, device):
    """Tensors on ``device`` (owned copies) from a decoded NumPy tree; the
    key's uint32 words become the port's int32 bits."""
    def t(a):
        a = np.array(a)
        if a.dtype == np.uint32:
            a = a.view(np.int32)
        return torch.from_numpy(a).to(device)

    return _unflatten(tree, (t(a) for a in _leaves(tree)))


def _leaves(tree):
    """A decoded tree's leaves in ``_unflatten`` order."""
    if tree is None:
        return
    if isinstance(tree, (list, tuple)):
        for x in tree:
            yield from _leaves(x)
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    else:
        yield tree


def event_template() -> eng.EventBatch:
    """A structure-only EventBatch for non-strict decodes (shapes and
    dtypes come from the snapshot manifest)."""
    return eng.EventBatch(*([np.zeros(0)] * len(eng.EventBatch._fields)))


# -- snapshot container -----------------------------------------------------
def build_snapshot_bytes(chunk_index: int, control: dict,
                         sections: dict) -> bytes:
    """``MAGIC | <u32 version, u32 header_len> | header JSON | payload |
    u32 CRC32(everything after MAGIC)``.  ``sections`` maps name →
    pytree; None values are skipped."""
    secmeta, blobs, off = {}, [], 0
    for name in sorted(sections):
        tree = sections[name]
        if tree is None:
            continue
        man, blob = encode_tree(tree)
        secmeta[name] = {"manifest": man, "offset": off,
                         "nbytes": len(blob)}
        blobs.append(blob)
        off += len(blob)
    header = {"format": "pspice-snapshot", "version": SNAP_VERSION,
              "chunk_index": int(chunk_index), "control": control,
              "sections": secmeta}
    hj = json.dumps(header, sort_keys=True).encode()
    body = struct.pack("<II", SNAP_VERSION, len(hj)) + hj + b"".join(blobs)
    return SNAP_MAGIC + body + struct.pack("<I", zlib.crc32(body))


def parse_snapshot_bytes(data: bytes, path: str = "<bytes>"
                         ) -> tuple[dict, dict]:
    """Validate + parse a snapshot file: returns ``(header, sections)``
    with ``sections[name] == (manifest, payload_bytes)``.  CRC is checked
    FIRST (over version + header + payload), so a torn write of any part
    — including the version field — reads as corruption, and only an
    intact file can fail the version check."""
    n_min = len(SNAP_MAGIC) + 8 + 4
    if len(data) < n_min:
        raise CorruptSnapshotError(
            f"{path}: {len(data)} bytes is shorter than the fixed "
            f"snapshot framing ({n_min}) — torn or not a snapshot")
    if data[:len(SNAP_MAGIC)] != SNAP_MAGIC:
        raise CorruptSnapshotError(f"{path}: bad magic — not a pSPICE "
                                   "snapshot file")
    body, (crc,) = data[len(SNAP_MAGIC):-4], struct.unpack("<I", data[-4:])
    if zlib.crc32(body) != crc:
        raise CorruptSnapshotError(
            f"{path}: CRC mismatch — torn or corrupted write; the "
            "previous generation (if any) is the newest valid state")
    version, hlen = struct.unpack("<II", body[:8])
    if version != SNAP_VERSION:
        raise CorruptSnapshotError(
            f"{path}: snapshot version {version}; this build reads "
            f"version {SNAP_VERSION} only")
    try:
        header = json.loads(body[8:8 + hlen])
    except ValueError as e:
        raise CorruptSnapshotError(f"{path}: header is not valid JSON "
                                   f"({e})") from e
    payload = body[8 + hlen:]
    sections = {}
    for name, sm in header.get("sections", {}).items():
        blob = payload[sm["offset"]:sm["offset"] + sm["nbytes"]]
        if len(blob) != sm["nbytes"]:
            raise CorruptSnapshotError(
                f"{path}: section {name} extends past the payload")
        sections[name] = (sm["manifest"], blob)
    return header, sections


def _fsync_dir(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def atomic_write(path: str, data: bytes) -> None:
    """tmp + fsync + rename + directory fsync: readers see either the
    previous generation or the complete new one, never a torn file."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    _fsync_dir(os.path.dirname(path) or ".")


class SnapshotStore:
    """Generation-rotated snapshot files: ``snap-<chunk>.ckpt``."""

    def __init__(self, dir: str, keep_generations: int = 3):
        self.dir = dir
        self.keep = max(1, keep_generations)
        os.makedirs(dir, exist_ok=True)

    def paths(self) -> list[str]:
        return sorted(glob.glob(os.path.join(self.dir, "snap-*.ckpt")))

    def save(self, chunk_index: int, control: dict, sections: dict) -> str:
        data = build_snapshot_bytes(chunk_index, control, sections)
        path = os.path.join(self.dir, f"snap-{int(chunk_index):010d}.ckpt")
        ks = FT.active_kill_switch()
        if ks is not None and ks.pending("snapshot"):
            # Crash harness: die MID-WRITE the way a non-atomic writer
            # would — a torn file at the FINAL path, which recovery must
            # CRC-reject in favor of the previous generation.
            with open(path, "wb") as f:
                f.write(data[:max(len(SNAP_MAGIC) + 4, len(data) // 2)])
                f.flush()
                os.fsync(f.fileno())
            ks.kill()
        atomic_write(path, data)
        self._prune()
        return path

    def _prune(self) -> None:
        for p in self.paths()[:-self.keep]:
            os.remove(p)

    def load_latest(self) -> tuple[dict | None, dict | None, dict]:
        """Newest generation that parses + passes CRC; torn/corrupt ones
        are recorded in ``meta['rejected']`` and skipped.  Returns
        ``(header, sections, meta)`` — ``(None, None, meta)`` when no
        valid generation exists (recovery then replays the WAL from
        record 0 against the initial state)."""
        _, header, sections, meta = self.load_latest_raw()
        return header, sections, meta

    def load_latest_raw(self) -> tuple:
        """``load_latest`` with the generation's file bytes first:
        ``(data, header, sections, meta)``, all None but ``meta`` when no
        valid generation exists.  The bytes passed the CRC check; a mesh
        runtime's rank 0 sends them to the other ranks, which parse them
        with ``parse_snapshot_bytes``."""
        rejected = []
        for path in reversed(self.paths()):
            with open(path, "rb") as f:
                data = f.read()
            try:
                header, sections = parse_snapshot_bytes(data, path)
            except CorruptSnapshotError as e:
                rejected.append({"path": os.path.basename(path),
                                 "error": str(e)})
                continue
            return data, header, sections, {"path": path,
                                            "rejected": rejected}
        return None, None, None, {"path": None, "rejected": rejected}


# -- write-ahead log --------------------------------------------------------
class WriteAheadLog:
    """Append-only event-batch log across ``wal-<seq>.seg`` segments.

    Record ids are globally monotone across segments; ``append`` writes
    and FLUSHES before returning (fsync on the configured cadence), so
    once the runtime starts processing a push, its events are already
    durable against process death.  A snapshot stores the first
    unabsorbed id; replay never re-appends (the records are already on
    disk), and the next post-recovery append opens a fresh segment.
    """

    def __init__(self, dir: str, fsync_every: int = 1):
        self.dir = dir
        self.fsync_every = fsync_every
        os.makedirs(dir, exist_ok=True)
        self._f = None
        self._appends = 0
        last_id, last_seq = -1, -1
        for seq, path in self.segments():
            last_seq = max(last_seq, seq)
            for rid, _man, _blob in _iter_segment(path):
                last_id = max(last_id, rid)
        self._next_id = last_id + 1
        self._next_seq = last_seq + 1

    def segments(self) -> list[tuple[int, str]]:
        out = []
        for path in sorted(glob.glob(os.path.join(self.dir, "wal-*.seg"))):
            stem = os.path.basename(path)[4:-4]
            out.append((int(stem), path))
        return out

    @property
    def next_record_id(self) -> int:
        return self._next_id

    def append(self, events) -> int:
        if self._f is None:
            path = os.path.join(self.dir, f"wal-{self._next_seq:08d}.seg")
            self._next_seq += 1
            self._f = open(path, "wb")
            self._f.write(WAL_MAGIC)
        man, blob = encode_tree(events)
        mj = json.dumps(man, sort_keys=True).encode()
        rid = self._next_id
        head = _REC_HEAD.pack(_REC_MAGIC, rid, len(mj), len(blob))
        rec = head + mj + blob
        self._f.write(rec + struct.pack("<I", zlib.crc32(rec[4:])))
        self._f.flush()
        self._appends += 1
        if self.fsync_every > 0 \
                and self._appends % self.fsync_every == 0:
            os.fsync(self._f.fileno())
        self._next_id = rid + 1
        return rid

    def records_since(self, start_id: int) -> list[tuple[int, object]]:
        """All ``(record_id, EventBatch)`` with id >= ``start_id``, in id
        order.  Strict: any torn segment raises ``CorruptSegmentError``
        (the append path flushes before processing starts, so kill-based
        crashes never tear the tail — a torn segment means real damage)."""
        return [(rid, decode_record(man, blob, what))
                for rid, man, blob, what in self._encoded_since(start_id)]

    def encoded_since(self, start_id: int) -> list[tuple[int, list, bytes]]:
        """``records_since``'s records still encoded: ``(record_id,
        manifest, payload)``, which ``decode_record`` turns into an
        EventBatch — what a mesh runtime's rank 0 sends the other
        ranks."""
        return [(rid, man, blob)
                for rid, man, blob, _ in self._encoded_since(start_id)]

    def _encoded_since(self, start_id: int) -> list:
        out = []
        for _seq, path in self.segments():
            for rid, man, blob in _iter_segment(path):
                if rid >= start_id:
                    out.append((rid, man, blob, os.path.basename(path)))
        out.sort(key=lambda r: r[0])
        return out

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None


def decode_record(manifest: list, blob: bytes, what: str = "record"):
    """One WAL record's EventBatch (host NumPy) from its encoded form."""
    return decode_tree(manifest, blob, event_template(), what=what,
                       strict=False)


def _iter_segment(path: str):
    """Yield ``(record_id, manifest, blob)`` per record, strictly."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:len(WAL_MAGIC)] != WAL_MAGIC:
        raise CorruptSegmentError(f"{path}: bad segment magic — not a "
                                  "pSPICE WAL segment")
    off = len(WAL_MAGIC)
    while off < len(data):
        if off + _REC_HEAD.size > len(data):
            raise CorruptSegmentError(
                f"{path}: torn record header at offset {off}")
        magic, rid, mlen, blen = _REC_HEAD.unpack_from(data, off)
        if magic != _REC_MAGIC:
            raise CorruptSegmentError(
                f"{path}: bad record magic at offset {off}")
        end = off + _REC_HEAD.size + mlen + blen + 4
        if end > len(data):
            raise CorruptSegmentError(
                f"{path}: torn record {rid} at offset {off} (need "
                f"{end - len(data)} more bytes)")
        body = data[off + 4:end - 4]
        (crc,) = struct.unpack_from("<I", data, end - 4)
        if zlib.crc32(body) != crc:
            raise CorruptSegmentError(
                f"{path}: CRC mismatch on record {rid} at offset {off}")
        mj = data[off + _REC_HEAD.size:off + _REC_HEAD.size + mlen]
        blob = data[off + _REC_HEAD.size + mlen:end - 4]
        yield rid, json.loads(mj), blob
        off = end


class Persistence:
    """One runtime's durability bundle: store + WAL under one dir."""

    def __init__(self, cfg: PersistConfig):
        self.cfg = cfg
        os.makedirs(cfg.dir, exist_ok=True)
        self.store = SnapshotStore(cfg.dir, cfg.keep_generations)
        self.wal = WriteAheadLog(cfg.dir, cfg.wal_fsync_every)
