"""The port's admission front-end (repro_torch.runtime.ingest) against the
reference's (repro.runtime.ingest), on the same NumPy-made batches.

Bars: BITWISE — every AdmitReport, the admitted events (as the queue
hands them out) and the control state (the threefry key as the
reference's uint32 words) after a sequence of offers that exercises the
watermark latch, the token bucket, the forced drop and the hard bound,
in both threefry layouts; the front-end's lockstep take, neutral padding
and quarantine likewise.  The config validation raises the reference's
messages.
"""
import dataclasses

import jax
import numpy as np
import pytest

from repro.cep import engine as eng
from repro.runtime import ingest as RIG
from repro_torch.cep import convert
from repro_torch.runtime import ingest as TIG

from _torch_bridge import assert_trees_equal


def _batch(rng, n, t0=0.0, P=2, lanes=None):
    """An EventBatch of n events (lane-stacked with ``lanes``) as NumPy
    arrays, arrivals increasing from t0."""
    lead = () if lanes is None else (lanes,)
    gaps = rng.random(lead + (n,)).astype(np.float32) * np.float32(1e-3)
    arrival = (np.float32(t0) + np.cumsum(gaps, axis=-1)).astype(np.float32)
    return eng.EventBatch(
        ev_class=rng.integers(0, 3, lead + (n, P)).astype(np.int32),
        ev_bind=rng.integers(-1, 4, lead + (n, P)).astype(np.int32),
        ev_open=rng.random(lead + (n, P)) < 0.2,
        ev_id=rng.integers(0, 50, lead + (n,)).astype(np.int32),
        ev_rand=rng.random(lead + (n,)).astype(np.float32),
        ebl_raw=rng.random(lead + (n,)).astype(np.float32),
        arrival=arrival)


def _ref(b):
    return jax.tree.map(jax.numpy.asarray, b)


def _port(b):
    return convert.events_from_numpy(convert.tree_to_numpy(b), "cpu")


CFG = dict(max_queue_events=900, high_watermark=500, low_watermark=200,
           shed_max=0.8, admit_rate=40000.0, admit_burst=300.0, seed=11)


@pytest.fixture(params=[True, False], ids=["partitionable", "original"])
def layout(request):
    from repro_torch import prng
    old = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", request.param)
    with prng.layout(request.param):
        yield request.param
    jax.config.update("jax_threefry_partitionable", old)


def _drive(q_ref, q_port, rng, offers):
    """Offer the same batches to both queues, interleaved with takes and
    forced drops; compare after every step."""
    t = 0.0
    for k, (n, take, forced) in enumerate(offers):
        b = _batch(rng, n, t0=t)
        t = float(b.arrival[-1]) + 1e-3 if n else t
        q_ref.forced_drop = q_port.forced_drop = forced
        r1, r2 = q_ref.offer(_ref(b)), q_port.offer(_port(b))
        assert dataclasses.asdict(r1) == dataclasses.asdict(r2), k
        if take:
            a, c = q_ref.take(take), q_port.take(take)
            assert (a is None) == (c is None)
            if a is not None:
                assert_trees_equal(a, c, f"take after offer {k}")
        assert q_ref.control_state() == q_port.control_state(), k
    return t


OFFERS = [(400, 0, 0.0), (300, 0, 0.0), (250, 100, 0.0), (350, 0, 0.0),
          (200, 400, 0.3), (500, 0, 0.0), (64, 700, 0.0), (300, None, 1.0),
          (256, 0, 0.0), (0, 0, 0.0), (600, None, 0.0)]


# The bucket and the watermarks shed; without them (no refill, no
# watermark ramp) the hard bound rejects.
QUEUES = {"shedding": CFG,
          "bounded": dict(CFG, admit_rate=0.0, shed_max=0.0)}


@pytest.mark.parametrize("which", sorted(QUEUES))
def test_queue_equals_reference(layout, which):
    cfg = QUEUES[which]
    q_ref = RIG.IngestQueue(RIG.IngestConfig(**cfg))
    q_port = TIG.IngestQueue(TIG.IngestConfig(**cfg))
    _drive(q_ref, q_port, np.random.default_rng(3), OFFERS)
    assert (q_port.total_shed if which == "shedding"
            else q_port.total_rejected) > 0
    assert [dataclasses.asdict(r) for r in q_port.reports] == \
        [dataclasses.asdict(r) for r in q_ref.reports]
    a, c = q_ref.queued_events(), q_port.queued_events()
    assert (a is None) == (c is None)
    if a is not None:
        assert_trees_equal(a, c, "queued")


def test_control_state_round_trip_resumes_bitwise(layout):
    """A queue restored from the reference's control state and queued
    events admits the reference's subsets from there on."""
    rng = np.random.default_rng(5)
    q_ref = RIG.IngestQueue(RIG.IngestConfig(**CFG))
    t = _drive(q_ref, TIG.IngestQueue(TIG.IngestConfig(**CFG)), rng,
               OFFERS[:5])
    q_port = TIG.IngestQueue(TIG.IngestConfig(**CFG))
    q_port.restore_control_state(q_ref.control_state())
    qe = q_ref.queued_events()
    q_port.restore_queued(None if qe is None else _port(qe))
    for n in (450, 300, 200):
        b = _batch(rng, n, t0=t)
        t = float(b.arrival[-1]) + 1e-3
        assert dataclasses.asdict(q_ref.offer(_ref(b))) == \
            dataclasses.asdict(q_port.offer(_port(b)))
    assert_trees_equal(q_ref.take(None), q_port.take(None), "resumed")
    assert q_ref.control_state() == q_port.control_state()


def test_front_end_lockstep_quarantine_and_drain(layout):
    """Per-lane queues (seed + lane), the aligned take, the neutral pad of
    a drain and a quarantined lane's substitutes equal the reference's."""
    L = 3
    rng = np.random.default_rng(7)
    fe_ref = RIG.IngestFrontEnd(RIG.IngestConfig(**CFG), L)
    fe_port = TIG.IngestFrontEnd(TIG.IngestConfig(**CFG), L)
    t = 0.0
    for k, n in enumerate((350, 420, 300, 250)):
        b = _batch(rng, n, t0=t, lanes=L)
        t = float(b.arrival.max()) + 1e-3
        if k == 2:
            assert fe_ref.quarantine_lane(1, 2) == \
                fe_port.quarantine_lane(1, 2)
        r1, r2 = fe_ref.offer(_ref(b)), fe_port.offer(_port(b))
        assert [dataclasses.asdict(r) for r in r1] == \
            [dataclasses.asdict(r) for r in r2], k
        a, c = fe_ref.take(200), fe_port.take(200)
        assert (a is None) == (c is None)
        if a is not None:
            assert_trees_equal(a, c, f"lockstep take {k}")
        assert fe_ref.control_state() == fe_port.control_state()
    assert_trees_equal(fe_ref.take(None, drain=True),
                       fe_port.take(None, drain=True), "drain")
    assert fe_ref.depth == fe_port.depth


def test_neutral_and_take_rows_equal_reference():
    b = _batch(np.random.default_rng(1), 40)
    assert_trees_equal(RIG.neutral_like(_ref(b)),
                       TIG.neutral_like(_port(b)), "neutral_like")
    idx = [3, 3, 0, 39, 17]
    assert_trees_equal(RIG.take_rows(_ref(b), idx),
                       TIG.take_rows(_port(b), idx), "take_rows")


@pytest.mark.parametrize("kw", [
    dict(max_queue_events=0), dict(low_watermark=10, high_watermark=5),
    dict(high_watermark=1 << 20), dict(shed_max=1.5),
    dict(admit_rate=10.0, admit_burst=0.5)])
def test_config_validation_equals_reference(kw):
    with pytest.raises(ValueError) as want:
        RIG.IngestConfig(**kw)
    with pytest.raises(ValueError) as got:
        TIG.IngestConfig(**kw)
    assert str(got.value) == str(want.value)
