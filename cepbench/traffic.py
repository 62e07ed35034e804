"""The benchmark's traffic: the paper's event streams (pSPICE §IV-A),
classified per pattern, for every tenant lane and session, all from the
run's seed.

The generators are frozen NumPy copies of the port's
``repro_torch/data/streams.py`` (``gen_stock``, ``gen_soccer``,
``classify``), drawing every lane of a set in one call, so
a change to the program cannot change the yardstick.  A configuration
file names its generator and its parameters (``generator``); a cell
file says how many lanes, sessions and pushes (``lanes``,
``session_events``, ``session_sets``, ``push_events``) and the overload
each lane sees (``rate_lo`` to ``rate_hi`` times the operator's
capacity, lane 0 to lane L - 1).  The capacity is the model builder's,
from a warm-up stream of the configuration's own seed, so the run's seed
changes the events and not their number or their arrival times.
"""
from __future__ import annotations

import numpy as np

from cepbench.reference.patterns import SEQ, spec as pattern_spec

FIELDS = ("cls", "bind", "open", "id", "rand", "ebl", "arrival")


def gen_stock(shape: tuple, rng: np.random.Generator,
              num_symbols: int = 500, pattern_symbols: int = 10,
              hot_fraction: float = 0.9, p_class: float = 0.03) -> dict:
    """NYSE-like quotes: pattern symbols 0..k-1 take ``hot_fraction`` of
    the ticks; a pattern symbol's tick rises strongly (attr 1) with
    probability ``p_class``.  Streams of ``shape`` (lanes, n)."""
    hot = rng.integers(0, pattern_symbols, size=shape)
    cold = rng.integers(pattern_symbols, num_symbols, size=shape)
    is_hot = rng.random(shape) < hot_fraction
    type_id = np.where(is_hot, hot, cold).astype(np.int32)
    rise = ((rng.random(shape) < p_class) & is_hot).astype(np.int32)
    return dict(kind="stock", type_id=type_id, attr=rise,
                group=np.zeros(shape, np.int32))


def gen_soccer(shape: tuple, rng: np.random.Generator,
               num_players: int = 32, num_strikers: int = 2,
               p_striker: float = 0.004, p_defend: float = 0.05) -> dict:
    """RTLS-like positions (DEBS 2013): a striker's possession (attr 2)
    opens a window; a defend event (attr 1) refers to the last striker in
    possession, its defender id is the distinct id."""
    n = shape[-1]
    r = rng.random(shape)
    is_striker = r < p_striker
    is_defend = (~is_striker) & (r < p_striker + p_defend)
    striker_ids = rng.integers(0, num_strikers, size=shape).astype(np.int32)
    cur = np.maximum.accumulate(np.where(is_striker, np.arange(n), -1),
                                axis=-1)
    last = np.where(cur >= 0, np.take_along_axis(
        striker_ids, np.maximum(cur, 0), axis=-1), -1)
    defender = rng.integers(num_strikers, num_players,
                            size=shape).astype(np.int32)
    type_id = np.where(is_striker, striker_ids,
                       np.where(is_defend, defender, -1)).astype(np.int32)
    attr = np.where(is_striker, 2, np.where(is_defend, 1, 0)).astype(
        np.int32)
    group = np.where(is_striker, striker_ids, last).astype(np.int32)
    return dict(kind="soccer", type_id=type_id, attr=attr, group=group)


GENERATORS = {"stock": gen_stock, "soccer": gen_soccer}


def _classify_one(s: dict, raw: dict):
    """(class, bind, open, potential class) of every event for pattern
    ``s`` (a ``reference.patterns.spec``)."""
    kind, t, a, g = raw["kind"], raw["type_id"], raw["attr"], raw["group"]
    if kind == "stock":
        is_pat = t < s["num_classes"]
        pot = np.where(is_pat, t + 1, 0)
        cls = np.where(is_pat & (a == 1), t + 1, 0)
        opener = s["sequence"][0] if s["sequence"] else 1
        opens = cls == opener
        bind = np.full(t.shape, -1, np.int32)
    elif kind == "soccer":
        cls = np.where(a == 1, 1, 0)
        opens = a == 2
        bind = g
        pot = np.where(a == 2, 2, np.where(t >= 0, 1, 0))
    else:
        raise ValueError(kind)
    return cls, bind, opens, pot


def _class_key(s: dict, kind: str) -> tuple:
    """What of pattern ``s`` its events' classification reads."""
    if kind == "stock":
        return (s["num_classes"], s["sequence"][0] if s["sequence"] else 1)
    return ()


def _ebl_table(s: dict, pot: np.ndarray) -> np.ndarray:
    """Pattern ``s``'s share of E-BL's event-type utility by lane and
    potential class: (L, C), class 0 nought."""
    L, n = pot.shape
    if s["kind"] == SEQ:
        rep = np.bincount(np.array(s["sequence"]),
                          minlength=s["num_classes"] + 1).astype(float)
    else:
        rep = np.zeros(3)
        rep[1], rep[2] = s["any_n"], 1.0
    C = max(len(rep), int(pot.max()) + 1)
    rep = np.pad(rep, (0, C - len(rep)))
    lane = np.arange(L)[:, None]
    freq = np.bincount((pot + lane * C).reshape(-1),
                       minlength=L * C).reshape(L, C).astype(float) / n
    out = s["weight"] * (rep / np.maximum(freq, 1e-9))
    out[:, 0] = 0.0
    return out


def streams(cfg: dict, shape: tuple, rng: np.random.Generator) -> dict:
    """``shape`` = (lanes, n) classified events, every field but
    ``arrival``: ``cls``/``bind``/``open`` (L, n, P), ``id``, ``rand``,
    and ``ebl`` (L, n), E-BL's drop priority (1 - the event type's
    normalized utility over its lane's stream), which the stream carries
    whichever shedder runs."""
    gen = dict(cfg["generator"])
    kind = gen.pop("kind")
    raw = GENERATORS[kind](shape, rng, **gen)
    specs = [pattern_spec(p) for p in cfg["patterns"]]
    P = len(specs)
    out = dict(cls=np.empty(shape + (P,), np.int32),
               bind=np.empty(shape + (P,), np.int32),
               open=np.empty(shape + (P,), bool))
    groups: dict[tuple, list[int]] = {}
    for p, sp in enumerate(specs):
        groups.setdefault(_class_key(sp, kind), []).append(p)
    util = np.zeros(shape)
    lane = np.arange(shape[0])[:, None]
    for ps in groups.values():
        cls, bind, opens, pot = _classify_one(specs[ps[0]], raw)
        for f, v in (("cls", cls), ("bind", bind), ("open", opens)):
            out[f][..., ps] = v[..., None]
        table = 0.0
        for p in ps:
            table = table + _ebl_table(specs[p], pot)
        util += table[lane, pot]
    top = np.maximum(util.max(axis=1, keepdims=True), 1e-9)
    out.update(id=raw["type_id"].astype(np.int32),
               rand=rng.random(shape).astype(np.float32),
               ebl=(1.0 - util / top).astype(np.float32))
    return out


def arrivals(n: int, rate: float) -> np.ndarray:
    """Evenly spaced arrival times at ``rate`` events/s (float32 s)."""
    return (np.arange(n) / rate).astype(np.float32)


def lane_rates(cell: dict, capacity: float) -> np.ndarray:
    """Lane l's rate: capacity × (rate_lo + (rate_hi - rate_lo)·l/(L-1))."""
    L = cell["lanes"]
    frac = np.arange(L) / max(L - 1, 1)
    return capacity * (cell["rate_lo"] +
                       (cell["rate_hi"] - cell["rate_lo"]) * frac)


def session_sets(cfg: dict, cell: dict, seed: int) -> list[dict]:
    """``session_sets`` sets of L lanes' events ((L, n, ...) arrays, no
    arrivals yet), set s from a generator seeded by (seed, s)."""
    return [streams(cfg, (cell["lanes"], cell["session_events"]),
                    np.random.default_rng([seed, s]))
            for s in range(cell["session_sets"])]


def warm_stream(cfg: dict, n: int) -> dict:
    """The model builder's warm-up: the first ``warm_frac`` of an
    ``n``-event stream drawn from the configuration's own ``warm_seed``,
    arriving one a second (no queueing).  Every run builds from the same
    warm-up, so every seed's lanes arrive at the same rates (the model's
    capacity × the cell's overload) and do the same amount of work."""
    k = int(n * cfg["warm_frac"])
    w = {f: v[0, :k] for f, v in streams(
        cfg, (1, n), np.random.default_rng([cfg["warm_seed"]])).items()}
    w["arrival"] = arrivals(k, 1.0)
    return w
