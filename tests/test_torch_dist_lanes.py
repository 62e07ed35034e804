"""The port's lane-parallel scale-out against the reference's, BITWISE.

Four tenant lanes of four mixed patterns (N = 32, 288 events, overloaded)
run through ``repro_torch.dist.run_chunk_lanes_sharded`` in chunks of 96
on a world of four gloo ranks: on a ``(4,)`` "data" mesh (one lane a
rank), a ``(2, 2)`` "data" x "model" mesh (two lanes x two patterns a
rank) and a ``(4,)`` "model" mesh (every lane, one pattern a rank).
After every chunk every rank's global carry and StepOut must equal the
reference's ``run_chunk_lanes_sharded`` on four forced host devices
(``tests/_dist_reference.py``, in a subprocess) in every leaf — so the
per-chunk merge, whose clock seeds the next chunk, shows — and the port's
plain emulation (``run_chunk_lanes_plain``: every block in one process,
merged with ``merge_shards_plain`` after every chunk).

One leaf is pinned to the plain emulation alone where each rank runs all
four patterns (the ``(4,)`` "data" mesh): the latency ring
(``lat_samples_l``), which the reference's shard-mapped step at four or
eight patterns a shard rounds 1 ulp apart from its own clock on a few
events (as in tests/test_torch_dist.py).

The leaves the merge sums (the four float32 counters and the latency
ring's PM counts) are pinned to the plain emulation from the second
chunk on wherever the mesh has a pattern axis: every shard holds them
whole, and the reference psums them as they come in, so its merge
counts the carry-in once per shard (``ROADMAP.md`` §3).  The port counts
it once; ``test_reference_counts_the_carry_in_per_shard`` pins the
reference's behaviour, and a runtime of 36 chunks is held to the sum of
every shard's own run (``test_long_mesh_runtime_counts_every_shard_once``).

``MultiTenantRuntime(mesh)`` on the ``(2, 2)`` mesh, fed in pushes of 150
events, must end with the reference's carry and report each chunk's
telemetry as the reference's chunk outputs give it.  (The reference's own
``MultiTenantRuntime(mesh=...)`` stops in its telemetry's quantile with a
``ShardingTypeError`` under jax 0.9.0, so its chunk step is the truth.)
"""
import numpy as np
import pytest

from repro_torch import dist as D
from repro_torch.cep import convert

import _dist_reference as R
import _dist_worlds as W
from _torch_bridge import port_config, to_port

PUSH = 150
CHUNKS = R.LANE_EV // R.CHUNK
# The lane cases and the backends each runs through; the plain
# emulation holds every case on "torch" and the (2, 2) pspice case on
# every backend.
FULL = "2x2-data-model/pspice"
LANE_CASES = [(name, b) for name in R.lane_case_names()
              for b in (("torch", "cuda", "cuda_block") if name == FULL
                        else ("torch", "cuda_block"))]
PLAIN_CASES = [(n, b) for n, b in LANE_CASES if b == "torch" or n == FULL]
RUNTIME_CASES = [(sh, b) for sh in ("pspice", "ebl")
                 for b in ("torch", "cuda_block")]
# (case prefix, leaf) held to the plain emulation, not the reference.
PINNED = {("4-data", "carry.lat_samples_l")}
# Meshes with a pattern axis, by its size, and the leaves their merge
# sums: held to the port's "torch" case (itself held to the plain
# emulation) from the second chunk on, not to the reference.
PATTERN_SHARDS = {"2x2-data-model": 2, "4-model": 4}
SUMMED = tuple(f"carry.{k}" for k in W.COUNTERS) + ("carry.lat_samples_n",)
LONG_CHUNK = 8           # the long runtime: 36 chunks of the lane stream


def _want(ref, got, name, chunk, leaf):
    """The value a case's leaf is held to after ``chunk``."""
    if chunk > 0 and leaf in SUMMED and name.split("/")[0] in PATTERN_SHARDS:
        return got[0][f"{name}/torch/chunk{chunk}"][leaf]
    return ref[f"{name}/chunk{chunk}/{leaf}"]


def _lanes_jobs():
    n = convert.tree_to_numpy
    cases = R.lanes_cases()
    jobs = []
    for shape, names, _ in R.LANE_MESHES:
        tag = R.mesh_tag(shape, names)
        jobs.append(("lanes", shape, names, [
            (f"{name}/{b}", port_config(cases[name][2], b), R.CHUNK,
             *(n(x) for x in cases[name][3:]))
            for name, b in LANE_CASES if name.startswith(tag + "/")]))
    rt = []
    for sh, b in RUNTIME_CASES:
        cfg, mL, evL = R.lanes_inputs(sh)
        rt.append((f"runtime/{sh}/{b}", port_config(cfg, b), R.CHUNK, PUSH,
                   5, n(mL), n(evL)))
    jobs.append(("runtime", (2, 2), ("data", "model"), rt))
    return jobs


@pytest.fixture(scope="module")
def persist_dir(tmp_path_factory):
    return tmp_path_factory.mktemp("persist")


@pytest.fixture(scope="module")
def runs(tmp_path_factory, persist_dir):
    out = tmp_path_factory.mktemp("dist") / "lanes.npz"
    proc = W.reference_process("lanes", out)
    cfg, mL, evL = R.lanes_inputs("pspice")
    n = convert.tree_to_numpy
    persist = ("persist", (2, 2), ("data", "model"), [
        ("persist", port_config(cfg, "torch"), R.CHUNK, str(persist_dir),
         n(mL), n(evL))])
    long = ("chunks", (2, 2), ("data", "model"), [
        ("long", port_config(cfg, "torch"), LONG_CHUNK, 5, n(mL), n(evL))])
    try:
        got = D.spawn(W.world, 4, args=(_lanes_jobs() + [persist, long],),
                      timeout=W.WORLD_TIMEOUT)
        ref = W.reference_result(proc, out)
    finally:
        proc.kill()
    return ref, got


@pytest.mark.parametrize("chunk", range(CHUNKS))
@pytest.mark.parametrize("name,backend", LANE_CASES)
def test_lanes_sharded_equal_reference_chunk_by_chunk(runs, name, backend,
                                                      chunk):
    """Bar: bit for bit in every leaf of the global carry and StepOut
    after every chunk (the summed leaves from the second chunk on, on a
    mesh with a pattern axis, against the port's "torch" case)."""
    ref, got = runs
    res = got[0][f"{name}/{backend}/chunk{chunk}"]
    prefix = f"{name}/chunk{chunk}/"
    assert len(res) == sum(k.startswith(prefix) for k in ref)
    bad = [k for k, v in res.items()
           if (name.split("/")[0], k) not in PINNED
           and not np.array_equal(_want(ref, got, name, chunk, k), v)]
    assert not bad, f"{name}/{backend} chunk {chunk} differs in {bad}"


def test_pinned_leaf_differs_only_by_the_reference_rounding(runs):
    ref, got = runs
    for k in range(CHUNKS):
        a = ref[f"4-data/pspice/chunk{k}/carry.lat_samples_l"]
        b = got[0][f"4-data/pspice/torch/chunk{k}"]["carry.lat_samples_l"]
        ulps = np.abs(a.view(np.int32).astype(np.int64) -
                      b.view(np.int32).astype(np.int64))
        assert ulps.max() <= 1 and (ulps > 0).mean() < 0.1, k


@pytest.mark.parametrize("name,backend", PLAIN_CASES)
def test_lanes_sharded_equal_plain_emulation(runs, name, backend):
    """Bar: the collective path equals ``run_chunk_lanes_plain`` — every
    (lane block, pattern block) in this process, merged after every
    chunk — bit for bit, chunk by chunk."""
    shape, names, cfg, mL, evL, carry = R.lanes_cases()[name]
    tcfg = port_config(cfg, backend)
    model, events, carry = to_port(mL, evL, carry)
    mesh = D.abstract_mesh(shape, names)
    for k in range(CHUNKS):
        s = k * R.CHUNK
        piece = type(events)(*(x[:, s:s + R.CHUNK] for x in events))
        carry, outs = D.run_chunk_lanes_plain(tcfg, model, piece, carry, s,
                                              mesh=mesh, device="cpu")
        want = W.result(carry, outs)
        got = runs[1][0][f"{name}/{backend}/chunk{k}"]
        bad = [key for key in want if not np.array_equal(want[key],
                                                          got[key])]
        assert not bad, (k, bad)


def test_every_rank_holds_the_global_lanes(runs):
    got = runs[1]
    for r in range(1, 4):
        for name, res in got[r].items():
            if name == "persist":            # rank 0 alone writes
                continue
            want = W.flat(got[0][name])
            bad = [k for k, v in W.flat(res).items()
                   if not np.array_equal(want[k], v)]
            assert not bad, (r, name, bad)


def test_lane_fixture_sheds_on_every_mesh(runs):
    ref = runs[0]
    for name in R.lane_case_names():
        last = f"{name}/chunk{CHUNKS - 1}/carry."
        if name.endswith(("pspice", "pmbl")):
            assert (ref[last + "shed_calls"] > 0).sum() >= 2, name
        if name.endswith("ebl"):
            assert (ref[last + "ebl_dropped"] > 0).sum() >= 2, name
        assert ref[last + "complex_count"].sum() > 0, name


@pytest.mark.parametrize("shedder,backend", RUNTIME_CASES)
def test_mesh_runtime_equals_reference_chunk_steps(runs, shedder, backend):
    """Bar: the runtime's final carry bitwise the reference's chunk steps
    on the same mesh (the summed leaves the port's own chunk steps), and
    each chunk's telemetry as those steps' outputs give it."""
    ref, got = runs
    res = got[0][f"runtime/{shedder}/{backend}"]
    case = f"2x2-data-model/{shedder}"
    carry = {k: v for k, v in res.items() if k.startswith("carry.")}
    bad = [k for k, v in carry.items() if not np.array_equal(
        _want(ref, got, case, CHUNKS - 1, k), v)]
    assert not bad, bad
    want = {k: [] for k in W.TELEMETRY}
    done = 0.0
    for k in range(CHUNKS):
        p = f"{case}/chunk{k}/"
        want["n_events"].append(R.LANES * R.CHUNK)
        want["l_e_max"].append(ref[p + "outs.l_e"].max())
        want["n_pm_end"].append(ref[p + "outs.n_pm"][:, -1].sum())
        want["shed_events"].append(ref[p + "outs.shed"].sum())
        want["dropped_events"].append(ref[p + "outs.dropped"].sum())
        total = ref[p + "carry.complex_count"].sum()
        want["completions"].append(total - done)
        done = total
    for key, v in want.items():
        np.testing.assert_array_equal(res[f"telemetry.{key}"],
                                      np.asarray(v, res[f"telemetry.{key}"]
                                                 .dtype), err_msg=key)


def test_mesh_runtime_ranks_agree(runs):
    got = runs[1]
    for r in range(1, 4):
        for sh, b in RUNTIME_CASES:
            name = f"runtime/{sh}/{b}"
            assert all(np.array_equal(got[0][name][k], v)
                       for k, v in got[r][name].items()), (r, name)


def test_only_rank_zero_writes_durable_state(runs, persist_dir):
    """Every rank holds the global carry; rank 0 alone writes the WAL and
    the snapshots, the others write nothing (their runtime's config has
    no persistence)."""
    got = [r["persist"] for r in runs[1]]
    assert [g["writer"] for g in got] == [True, False, False, False]
    assert [g["rt_persist"] for g in got] == [True, False, False, False]
    assert got[0]["snapshot"] and all(g["snapshot"] is None
                                      for g in got[1:])
    files = sorted(p.name for p in persist_dir.rglob("*") if p.is_file())
    assert files and all(not f.endswith(".part") for f in files), files
    assert any(f.startswith("snap-") for f in files), files


@pytest.mark.parametrize("name", [n for n in R.lane_case_names()
                                  if n.split("/")[0] in PATTERN_SHARDS])
def test_reference_counts_the_carry_in_per_shard(runs, name):
    """The reference's fault, pinned: with n pattern shards its counters
    after chunk k are n times its carry-in plus the shards' own parts,
    where the port's are its carry-in once plus the same parts; the ring
    entries chunk k writes agree, and the reference multiplies the others
    by n."""
    ref, got = runs
    n = PATTERN_SHARDS[name.split("/")[0]]
    shown = False
    for k in range(1, CHUNKS):
        r0, r1 = (f"{name}/chunk{j}/carry." for j in (k - 1, k))
        p0, p1 = (got[0][f"{name}/torch/chunk{j}"] for j in (k - 1, k))
        for leaf in W.COUNTERS:
            np.testing.assert_array_equal(
                ref[r1 + leaf] - n * ref[r0 + leaf],
                p1["carry." + leaf] - p0["carry." + leaf], err_msg=leaf)
            shown |= bool((ref[r0 + leaf] > 0).any())
        ring = "lat_samples_n"
        w = np.zeros(ref[r1 + ring].shape[-1], bool)
        w[k * R.CHUNK:(k + 1) * R.CHUNK] = True      # lat_ptr starts at 0
        np.testing.assert_array_equal(ref[r1 + ring][:, w],
                                      p1["carry." + ring][:, w])
        np.testing.assert_array_equal(ref[r1 + ring][:, ~w],
                                      n * ref[r0 + ring][:, ~w])
        np.testing.assert_array_equal(p1["carry." + ring][:, ~w],
                                      p0["carry." + ring][:, ~w])
        shown |= bool((ref[r0 + ring] > 0).any())
    assert shown, name


def _narrow(tree, spec, coords):
    """A tree's block: each dim whose spec names a mesh dim in ``coords``
    ({dim: (coordinate, size)}) cut to the coordinate's slice."""
    if not hasattr(spec, "_fields"):
        for d, ax in enumerate(spec):
            if ax in coords:
                r, n = coords[ax]
                k = tree.shape[d] // n
                tree = tree[(slice(None),) * d + (slice(r * k, r * k + k),)]
        return tree
    return type(spec)(*(_narrow(t, s, coords) for t, s in zip(tree, spec)))


def test_long_mesh_runtime_counts_every_shard_once(runs):
    """Bar: ``MultiTenantRuntime`` on the (2, 2) mesh over 36 chunks of 8
    events: after every chunk each counter equals the one before plus the
    sum of the four (lane block, pattern block) shards' own increments,
    each shard run alone (``run_chunk_lanes`` at two patterns) from its
    block of the previous global carry; the telemetry's deltas are those
    increments; no lane sheds more PMs than it created.  A merge that
    counted the carry-in once per shard would double the counters every
    chunk from the first shed (by chunk 8 here) and pass 2**24."""
    import dataclasses

    from repro_torch.runtime import lanes as LN
    res = runs[1][0]["long"]
    cfg, mL, evL = R.lanes_inputs("pspice")
    tcfg = port_config(cfg, "torch")
    model = convert.model_from_numpy(convert.tree_to_numpy(mL), "cpu")
    events = convert.events_from_numpy(convert.tree_to_numpy(evL), "cpu")
    local = dataclasses.replace(tcfg, num_patterns=tcfg.num_patterns // 2)
    specs = D.lane_specs(D.abstract_mesh((2, 2), ("data", "model")), tcfg,
                         R.LANES)
    carries = [convert.carry_from_numpy(c, "cpu") for c in res["carries"]]
    assert len(carries) == R.LANE_EV // LONG_CHUNK + 1 == 37
    first_shed = None
    for k in range(1, len(carries)):
        s = (k - 1) * LONG_CHUNK
        piece = type(events)(*(x[:, s:s + LONG_CHUNK] for x in events))
        inc = {c: [] for c in W.COUNTERS}
        for i in range(2):
            part = {c: 0.0 for c in W.COUNTERS}
            for j in range(2):
                at = {"data": (i, 2), "model": (j, 2)}
                before = _narrow(carries[k - 1], specs["carry"], at)
                after, _ = LN.run_chunk_lanes(
                    local, _narrow(model, specs["model"], at),
                    _narrow(piece, specs["events"], at), before, s,
                    device="cpu")
                for c in W.COUNTERS:
                    part[c] = part[c] + (getattr(after, c).numpy()
                                         - getattr(before, c).numpy())
            for c in W.COUNTERS:
                inc[c].append(part[c])
        for c in W.COUNTERS:
            step = np.concatenate(inc[c])
            np.testing.assert_array_equal(
                getattr(carries[k], c).numpy(),
                getattr(carries[k - 1], c).numpy() + step,
                err_msg=f"{c} after chunk {k - 1}")
            assert res["telemetry"][c][k - 1] == step.sum(), (c, k - 1)
        if first_shed is None and carries[k].shed_calls.sum() > 0:
            first_shed = k - 1
    assert first_shed is not None and first_shed < 8, first_shed
    last = carries[-1]
    assert (last.pms_shed.numpy() <= last.pms_created.numpy().sum(-1)).all()
