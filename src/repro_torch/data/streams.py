"""Synthetic event-stream generators shaped like the paper's three datasets
(§IV-A): NYSE intraday stock quotes, RTLS soccer positions (DEBS'13), and
Dublin public bus traffic (PLBT).

The container is offline, so we generate streams with the *statistical
structure* the queries care about (event-type mix, window-open rates,
matchable-event probabilities, distinct-id cardinalities) and control the
match probability the way the paper does — via window size (Q1/Q2) or pattern
size (Q3/Q4).

Each generator returns a RawStream; ``classify`` turns a RawStream + pattern
list into the engine's EventBatch (per-pattern class / bind / open arrays).

Port of ``repro.data.streams``: the generators and the per-pattern
classification stay NumPy (same RNG draw order, so identical seeds give
identical streams); ``classify`` hands the arrays to the engine as
tensors on the requested device.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import numpy as np
import torch

from repro_torch.cep import patterns as pat
from repro_torch.cep.engine import EventBatch
from repro_torch.device import resolve_device


@dataclasses.dataclass
class RawStream:
    """Dataset-agnostic event records (column-oriented)."""
    kind: str                 # 'stock' | 'soccer' | 'bus'
    n: int
    type_id: np.ndarray       # (n,) int32 — symbol / player / bus id
    attr: np.ndarray          # (n,) int32 — rise(1)/fall(0) | defend striker
                              #   id | delayed(1)/on-time(0)
    group: np.ndarray         # (n,) int32 — n/a | striker id | stop id
    num_types: int


# ---------------------------------------------------------------------------
# Generators
# ---------------------------------------------------------------------------

def gen_stock(n: int, num_symbols: int = 500, pattern_symbols: int = 10,
              hot_fraction: float = 0.9, p_class: float = 0.03,
              seed: int = 0) -> RawStream:
    """NYSE-like quote stream: `num_symbols` symbols; per-tick attr=1 when
    the quote rises strongly enough to count as a pattern event (RE_x).

    The 10 pattern symbols (ids 0..9) dominate tick volume (hot_fraction) —
    large caps dominate trading, and it creates the regime the paper's E-BL
    baseline faces: the droppable irrelevant pool is small, so event-level
    shedding must drop events of pattern symbols (whose matchable/
    non-matchable ticks it cannot tell apart at type granularity).
    p_class controls the per-tick probability that a pattern-symbol quote is
    a matchable rise — i.e. the completion-time scale, hence (via the window
    size) the match probability, the paper's Fig. 5 x-axis.

    The stationary special case of ``gen_stock_drift`` (same RNG draw
    order, so identical seeds give identical streams).
    """
    return gen_stock_drift(n, num_symbols=num_symbols,
                           pattern_symbols=pattern_symbols,
                           hot_fraction=hot_fraction,
                           p_class=p_class, p_class_end=p_class, seed=seed)


def gen_stock_drift(n: int, num_symbols: int = 500,
                    pattern_symbols: int = 10,
                    hot_fraction: float = 0.9,
                    hot_fraction_end: float | None = None,
                    p_class: float = 0.03, p_class_end: float = 0.10,
                    seed: int = 0) -> RawStream:
    """NYSE-like stream whose statistics DRIFT across the stream: the
    matchable-rise probability (and optionally the hot-symbol share) ramps
    linearly from its start to its end value.

    This is the regime an online model refresh exists for: a model built
    on the head of the stream has stale transition probabilities — hence
    stale completion probabilities and utilities — by the tail.  A
    one-shot builder keeps shedding by the head's statistics; a
    refreshing runtime tracks the ramp.
    """
    rng = np.random.default_rng(seed)
    t = np.arange(n) / max(n - 1, 1)
    hot_frac = hot_fraction if hot_fraction_end is None else \
        hot_fraction + (hot_fraction_end - hot_fraction) * t
    p_cls = p_class + (p_class_end - p_class) * t
    hot = rng.integers(0, pattern_symbols, size=n)
    cold = rng.integers(pattern_symbols, num_symbols, size=n)
    is_hot = rng.random(n) < hot_frac
    type_id = np.where(is_hot, hot, cold).astype(np.int32)
    rise = ((rng.random(n) < p_cls) & is_hot).astype(np.int32)
    return RawStream(kind="stock", n=n, type_id=type_id, attr=rise,
                     group=np.zeros(n, np.int32), num_types=num_symbols)


def drifting_arrivals(n: int, rate: float, rate_end: float) -> np.ndarray:
    """Arrival times for a linearly drifting event rate (events/second):
    the instantaneous rate ramps rate → rate_end over the stream, so the
    operator's load — and the overload detector's headroom — shifts under
    it mid-run."""
    t = np.arange(n) / max(n - 1, 1)
    inst = rate + (rate_end - rate) * t
    gaps = 1.0 / np.maximum(inst, 1e-9)
    arr = np.cumsum(gaps) - gaps[0]
    return arr.astype(np.float32)


def gen_soccer(n: int, num_players: int = 32, num_strikers: int = 2,
               p_striker: float = 0.004, p_defend: float = 0.05,
               seed: int = 0) -> RawStream:
    """RTLS-like stream: ball-possession events by strikers open windows;
    defend events (defender within distance of the striker) are class-1.

    attr = striker id a defend event refers to (the last striker in
    possession); group mirrors attr for binding.
    """
    rng = np.random.default_rng(seed)
    r = rng.random(n)
    is_striker = r < p_striker
    is_defend = (~is_striker) & (r < p_striker + p_defend)
    striker_ids = rng.integers(0, num_strikers, size=n).astype(np.int32)
    # Last striker in possession (binding for defend events).
    cur = np.maximum.accumulate(
        np.where(is_striker, np.arange(n), -1))
    last_striker = np.where(cur >= 0, striker_ids[np.maximum(cur, 0)], -1)
    defender = rng.integers(num_strikers, num_players, size=n).astype(np.int32)
    type_id = np.where(is_striker, striker_ids,
                       np.where(is_defend, defender, -1)).astype(np.int32)
    attr = np.where(is_striker, 2, np.where(is_defend, 1, 0)).astype(np.int32)
    group = np.where(is_striker, striker_ids, last_striker).astype(np.int32)
    return RawStream(kind="soccer", n=n, type_id=type_id, attr=attr,
                     group=group, num_types=num_players)


def gen_bus(n: int, num_buses: int = 911, num_stops: int = 48,
            p_delay: float = 0.08, burst_stops: int = 6,
            burst_boost: float = 4.0, seed: int = 0) -> RawStream:
    """PLBT-like stream: bus events at stops; delays cluster on a few
    'incident' stops (the correlated-delay structure Q4 detects)."""
    rng = np.random.default_rng(seed)
    bus = rng.integers(0, num_buses, size=n).astype(np.int32)
    stop = rng.integers(0, num_stops, size=n).astype(np.int32)
    p = np.full(n, p_delay)
    hot = rng.choice(num_stops, size=burst_stops, replace=False)
    p[np.isin(stop, hot)] = np.minimum(p_delay * burst_boost, 0.9)
    delayed = (rng.random(n) < p).astype(np.int32)
    return RawStream(kind="bus", n=n, type_id=bus, attr=delayed, group=stop,
                     num_types=num_buses)


# ---------------------------------------------------------------------------
# Classification: RawStream × patterns → EventBatch
# ---------------------------------------------------------------------------

def _classify_one(spec: pat.PatternSpec, raw: RawStream):
    """Per-pattern (class, bind, open, potential_class) arrays for one stream.

    ``potential_class`` is the class the event's TYPE could produce (e.g.
    any tick of pattern symbol j, rising or not, has potential class j+1).
    E-BL only sees type granularity — it cannot tell matchable from
    non-matchable events of the same type (paper §IV-A: "an event type
    (e.g., player Id or stock symbol)").
    """
    n = raw.n
    if raw.kind == "stock":
        # Class j (1..C) == strongly-rising quote of pattern symbol j-1.
        is_pat = raw.type_id < spec.num_classes
        pot = np.where(is_pat, raw.type_id + 1, 0)
        cls = np.where(is_pat & (raw.attr == 1), raw.type_id + 1, 0)
        opener = spec.class_sequence[0] if spec.class_sequence else 1
        opens = cls == opener
        bind = np.full(n, -1, np.int32)
    elif raw.kind == "soccer":
        cls = np.where(raw.attr == 1, 1, 0)          # defend events
        opens = raw.attr == 2                        # striker possession
        bind = raw.group                             # striker id
        # Any player event could be a defend (or striker) event.
        pot = np.where(raw.attr == 2, 2, np.where(raw.type_id >= 0, 1, 0))
    elif raw.kind == "bus":
        cls = np.where(raw.attr == 1, 1, 0)          # delayed bus
        # Slide-opened windows: every `slide` events.
        opens = (np.arange(n) % max(spec.slide, 1)) == 0
        bind = raw.group                             # stop id
        pot = np.ones(n, np.int32)                   # every bus could delay
    else:
        raise ValueError(raw.kind)
    return (cls.astype(np.int32), bind.astype(np.int32), opens.astype(bool),
            pot.astype(np.int32))


def ebl_event_priorities(specs: Sequence[pat.PatternSpec], raw: RawStream,
                         pot_per_pattern: np.ndarray) -> np.ndarray:
    """E-BL raw drop priority per event (paper §IV-A baseline 2).

    Event-TYPE utility ∝ repetition of the type's potential class across
    pattern definitions ÷ the type's frequency in windows; priority =
    1 − normalized utility (0 = never drop, 1 = drop first).  Types
    irrelevant to every pattern get priority 1 and are shed first; when the
    irrelevant pool can't cover the drop budget, the feedback controller in
    the engine pushes the drop fraction up until pattern-type events are
    dropped too — at type granularity, uniform sampling within a type then
    hits matchable events (the source of E-BL's false negatives).
    """
    n = raw.n
    util = np.zeros(n)
    for p, spec in enumerate(specs):
        pot = pot_per_pattern[:, p]
        if spec.kind == pat.KIND_SEQ:
            seq = np.array(spec.class_sequence)
            rep = np.bincount(seq, minlength=spec.num_classes + 1).astype(
                float)
        else:
            rep = np.zeros(3)
            rep[1] = spec.any_n
            rep[2] = 1.0  # the opener (e.g. striker) appears once
        freq = np.bincount(pot, minlength=len(rep)).astype(float) / n
        u = np.where(pot > 0, rep[pot] / np.maximum(freq[pot], 1e-9), 0.0)
        util += spec.weight * u
    umax = max(util.max(), 1e-9)
    return (1.0 - util / umax).astype(np.float32)


def classify(specs: Sequence[pat.PatternSpec], raw: RawStream, rate: float,
             seed: int = 0, rate_end: float | None = None,
             device=None) -> EventBatch:
    """Build the engine's EventBatch: per-pattern class/bind/open + arrival
    times for the given input event rate (events/second).  With
    ``rate_end`` the arrival rate ramps linearly rate → rate_end
    (``drifting_arrivals``).  The tensors land on ``device`` (default
    CUDA; see ``repro_torch.device``)."""
    dev = resolve_device(device)
    P = len(specs)
    cls = np.zeros((raw.n, P), np.int32)
    bind = np.zeros((raw.n, P), np.int32)
    opens = np.zeros((raw.n, P), bool)
    pot = np.zeros((raw.n, P), np.int32)
    for p, spec in enumerate(specs):
        cls[:, p], bind[:, p], opens[:, p], pot[:, p] = _classify_one(
            spec, raw)
    ebl_raw = ebl_event_priorities(specs, raw, pot)
    rng = np.random.default_rng(seed + 1234)
    arrival = (np.arange(raw.n) / rate).astype(np.float32) \
        if rate_end is None else drifting_arrivals(raw.n, rate, rate_end)
    arrays = (cls, bind, opens, raw.type_id.astype(np.int32),
              rng.random(raw.n).astype(np.float32), ebl_raw,
              arrival.astype(np.float32))
    return EventBatch(*(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                        for a in arrays))


# ---------------------------------------------------------------------------
# Scenario registry: the SEEDED evaluation scenarios (one per paper dataset)
# shared by the runner, the chip smoke run and the parity tests — so "the
# stock workload" means the same specs, generator parameters and seed
# everywhere, in both packages.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Scenario:
    """A named, fully-seeded evaluation workload: which queries run
    against which generated stream, plus the engine sizing the paper's
    configuration uses for it.  ``n`` scales the stream length (tests use
    short streams, sweeps long ones); everything else is pinned.

    The parameters put each dataset in the regime the paper evaluates:
    the operator's input is dominated by relevant event types (so
    event-level shedding cannot hide in an irrelevant-event pool), the
    PM store has real churn (so PM shedding acts as a continuous
    utility-driven filter, not a one-off wipe), and the latency bound
    sits within a small multiple of the store's processing time (so
    Algorithm 1 computes *partial* shed amounts).
    """
    name: str
    dataset: str                                   # generator family
    make_specs: Callable[[], list]                 # () -> [PatternSpec]
    gen: Callable[[int, int], RawStream]           # (n, seed) -> RawStream
    n_default: int                                 # full-sweep stream length
    n_quick: int                                   # CI --quick stream length
    seed: int = 7
    max_pms: int = 256
    bin_size: int = 64
    latency_bound: float = 0.05

    def specs(self) -> list:
        return self.make_specs()

    def raw(self, n: int | None = None, seed: int | None = None) -> RawStream:
        return self.gen(n if n is not None else self.n_default,
                        self.seed if seed is None else seed)


SCENARIOS: dict[str, Scenario] = {}


def register_scenario(sc: Scenario) -> Scenario:
    if sc.name in SCENARIOS:
        raise ValueError(f"duplicate scenario {sc.name!r}")
    SCENARIOS[sc.name] = sc
    return sc


def get_scenario(name: str) -> Scenario:
    try:
        return SCENARIOS[name]
    except KeyError:
        raise KeyError(f"unknown scenario {name!r}; "
                       f"have {sorted(SCENARIOS)}") from None


def scenario_names() -> list[str]:
    return sorted(SCENARIOS)


register_scenario(Scenario(
    name="stock", dataset="stock",
    # Q1 over the NYSE-like quote stream (§IV-A) as a multi-query grid —
    # the same 10-symbol rising-quote sequence at three window sizes
    # (the paper's Fig. 5 x-axis), sharing one PM store.
    make_specs=lambda: [pat.make_q1(window_size=w, num_symbols=10)
                        for w in (600, 1200, 2400)],
    gen=lambda n, seed: gen_stock(n, num_symbols=500, pattern_symbols=10,
                                  hot_fraction=0.95, p_class=0.1, seed=seed),
    n_default=30000, n_quick=12000))

register_scenario(Scenario(
    name="soccer", dataset="soccer",
    # Q3 over the RTLS-like position stream: striker possession opens a
    # window; any_n distinct defenders bound to the striker complete it.
    # The any_n grid is the paper's Fig. 5 pattern-size axis; defend
    # events dominate the stream, so E-BL's type-utility model must
    # choose between them and the (rarer, window-opening) striker events.
    make_specs=lambda: [pat.make_q3(any_n=a, window_size=150)
                        for a in range(2, 10)],
    gen=lambda n, seed: gen_soccer(n, num_players=14, num_strikers=2,
                                   p_striker=0.08, p_defend=0.88,
                                   seed=seed),
    n_default=30000, n_quick=12000))

register_scenario(Scenario(
    name="bus", dataset="bus",
    # Q4 over the Dublin-bus-like stream: any_n distinct delayed buses at
    # the same stop inside count-slid windows.  Every bus event is a
    # potential delay, so the stream has no irrelevant-event pool at all.
    make_specs=lambda: [pat.make_q4(any_n=3, window_size=600, slide=200)],
    gen=lambda n, seed: gen_bus(n, num_buses=911, num_stops=48,
                                p_delay=0.08, seed=seed),
    n_default=30000, n_quick=12000, max_pms=128))
