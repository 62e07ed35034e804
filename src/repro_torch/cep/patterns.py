"""CEP pattern/query definitions and compilation to dense transition tables.

A copy of ``repro.cep.patterns`` (pure NumPy), kept in the port so it
never imports the reference package.

We support the paper's four query families (§IV-A):
  Q1  seq(RE_1; ...; RE_k)                 — sequence operator
  Q2  seq with repetition (e.g. RE_1;RE_1;RE_2;...)
  Q3  seq(STR; any(n, DF_1..DF_n))         — sequence-with-any
  Q4  any(n, B_1..B_n)                     — any operator (slide windows)

All with skip-till-next-match semantics: a PM either advances on a matching
event or stays (see DESIGN.md §3 for the semantics note).  A pattern compiles
to:
  - an event classifier (dataset-specific; see repro_torch/data) that yields, per
    event: class c ∈ [0, C] (0 = irrelevant), binding value b (e.g. stop id,
    striker id; -1 = none), distinctness id (e.g. bus/defender id), and a
    window-open flag;
  - a dense transition table trans[m, C+1] for SEQ-kind patterns
    (states 0..m-1; 0 = φ initial, m-1 = final);
  - ANY-kind patterns count distinct ids: state = number matched.

States are 0-indexed here: state 0 = φ (never stored — PMs spawn at state 1),
final = m-1.  This matches the paper's s_1..s_m with an index shift.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

KIND_SEQ = 0
KIND_ANY = 1

SPAWN_AT_OPEN = 0      # PM spawns when the window-open event arrives (Q1-Q3)
SPAWN_IN_WINDOWS = 1   # PMs spawn inside slide-opened windows (Q4)


@dataclasses.dataclass(frozen=True)
class PatternSpec:
    """Static description of one query."""
    name: str
    kind: int                       # KIND_SEQ | KIND_ANY
    spawn_mode: int                 # SPAWN_AT_OPEN | SPAWN_IN_WINDOWS
    class_sequence: tuple[int, ...]  # SEQ: required class at each position
    num_classes: int                # C (classes 1..C; 0 = irrelevant)
    any_n: int                      # ANY: distinct matches required
    window_size: int                # ws, in events
    slide: int                      # SPAWN_IN_WINDOWS: window slide, in events
    weight: float = 1.0             # w_q (pattern importance)
    uses_binding: bool = False      # PM binding must equal event binding
    proc_cost: float = 1.0          # relative per-PM-per-event match cost
                                    # (the tau_Q1/tau_Q2 knob of Fig. 8)
    any_spawn_counts: bool = False  # ANY: does the spawning event itself
                                    # count as the first distinct match?
                                    # (Q4: yes — first delayed bus; Q3: no —
                                    # the opener is the striker, not a DF.)

    @property
    def num_states(self) -> int:
        if self.kind == KIND_SEQ:
            return len(self.class_sequence) + 1
        # ANY: φ, spawn state, then remaining distinct matches.
        return self.any_n + (1 if self.any_spawn_counts else 2)

    @property
    def final_state(self) -> int:
        return self.num_states - 1


def seq_pattern(name: str, class_sequence: Sequence[int], num_classes: int,
                window_size: int, weight: float = 1.0,
                proc_cost: float = 1.0,
                uses_binding: bool = False) -> PatternSpec:
    """Q1/Q2-style sequence (with repetition allowed in class_sequence)."""
    return PatternSpec(
        name=name, kind=KIND_SEQ, spawn_mode=SPAWN_AT_OPEN,
        class_sequence=tuple(class_sequence), num_classes=num_classes,
        any_n=0, window_size=window_size, slide=0, weight=weight,
        uses_binding=uses_binding, proc_cost=proc_cost)


def seq_any_pattern(name: str, any_n: int, window_size: int,
                    weight: float = 1.0,
                    proc_cost: float = 1.0) -> PatternSpec:
    """Q3: seq(OPEN; any(n, ...)) — window opens on the leading event (e.g.
    striker ball possession), then n distinct class-1 events bound to the
    opener complete the pattern."""
    return PatternSpec(
        name=name, kind=KIND_ANY, spawn_mode=SPAWN_AT_OPEN,
        class_sequence=(), num_classes=1, any_n=any_n,
        window_size=window_size, slide=0, weight=weight,
        uses_binding=True, proc_cost=proc_cost)


def any_pattern(name: str, any_n: int, window_size: int, slide: int,
                weight: float = 1.0, proc_cost: float = 1.0) -> PatternSpec:
    """Q4: any(n, ...) over count-based slide-opened windows; PMs spawn per
    distinct binding (e.g. bus stop) inside each open window."""
    return PatternSpec(
        name=name, kind=KIND_ANY, spawn_mode=SPAWN_IN_WINDOWS,
        class_sequence=(), num_classes=1, any_n=any_n,
        window_size=window_size, slide=slide, weight=weight,
        uses_binding=True, proc_cost=proc_cost, any_spawn_counts=True)


def build_transition_table(spec: PatternSpec,
                           max_states: int | None = None,
                           max_classes: int | None = None) -> np.ndarray:
    """Dense trans[m, C+1]: next state given current state and event class.

    SEQ: state j advances to j+1 iff class == class_sequence[j-1]... states
    are 0-indexed with state j meaning "j positions matched", so a PM at state
    j (1 <= j < m-1) needs class_sequence[j] to advance (position j, because
    the opener consumed position 0).  Final state is absorbing.

    ANY: state j advances on class 1 (distinctness enforced at runtime).
    """
    m = spec.num_states
    C = spec.num_classes
    M = max_states or m
    K = (max_classes or C) + 1
    trans = np.tile(np.arange(M, dtype=np.int32)[:, None], (1, K))
    if spec.kind == KIND_SEQ:
        for j in range(1, m - 1):
            needed = spec.class_sequence[j]
            trans[j, needed] = j + 1
    else:
        for j in range(1, m - 1):
            trans[j, 1] = j + 1
    # Final state absorbing; state 0 (φ) never advances via the table —
    # spawning is handled by the engine.
    return trans


@dataclasses.dataclass
class CompiledPatterns:
    """A batch of patterns compiled to padded dense arrays for the engine."""
    specs: tuple[PatternSpec, ...]
    trans: np.ndarray        # (P, M, C+1) int32
    kind: np.ndarray         # (P,) int32
    spawn_mode: np.ndarray   # (P,) int32
    window_size: np.ndarray  # (P,) int32
    slide: np.ndarray        # (P,) int32
    final_state: np.ndarray  # (P,) int32
    weight: np.ndarray       # (P,) float32
    uses_binding: np.ndarray  # (P,) bool
    proc_cost: np.ndarray    # (P,) float32
    spawn_counts: np.ndarray  # (P,) bool — ANY spawn consumes one match

    @property
    def num_patterns(self) -> int:
        return len(self.specs)

    @property
    def max_states(self) -> int:
        return self.trans.shape[1]


def compile_patterns(specs: Sequence[PatternSpec]) -> CompiledPatterns:
    M = max(s.num_states for s in specs)
    C = max(s.num_classes for s in specs)
    trans = np.stack([build_transition_table(s, M, C) for s in specs])
    return CompiledPatterns(
        specs=tuple(specs),
        trans=trans,
        kind=np.array([s.kind for s in specs], np.int32),
        spawn_mode=np.array([s.spawn_mode for s in specs], np.int32),
        window_size=np.array([s.window_size for s in specs], np.int32),
        slide=np.array([max(s.slide, 1) for s in specs], np.int32),
        final_state=np.array([s.final_state for s in specs], np.int32),
        weight=np.array([s.weight for s in specs], np.float32),
        uses_binding=np.array([s.uses_binding for s in specs], bool),
        proc_cost=np.array([s.proc_cost for s in specs], np.float32),
        spawn_counts=np.array([s.any_spawn_counts for s in specs], bool),
    )


# ---------------------------------------------------------------------------
# Paper queries (§IV-A), parameterized the way the evaluation varies them.
# ---------------------------------------------------------------------------

def make_q1(window_size: int, num_symbols: int = 10,
            weight: float = 1.0, proc_cost: float = 1.0) -> PatternSpec:
    """Q1: seq(RE_1; ...; RE_10).  Class j == rising quote of symbol j."""
    return seq_pattern("Q1", class_sequence=list(range(1, num_symbols + 1)),
                       num_classes=num_symbols, window_size=window_size,
                       weight=weight, proc_cost=proc_cost)


Q2_ORDER = (1, 1, 2, 3, 2, 4, 2, 5, 6, 7, 2, 8, 9, 10)


def make_q2(window_size: int, weight: float = 1.0,
            proc_cost: float = 1.0) -> PatternSpec:
    """Q2: sequence with repetition (paper's exact repetition order)."""
    return seq_pattern("Q2", class_sequence=list(Q2_ORDER), num_classes=10,
                       window_size=window_size, weight=weight,
                       proc_cost=proc_cost)


def make_q3(any_n: int, window_size: int, weight: float = 1.0,
            proc_cost: float = 1.0) -> PatternSpec:
    """Q3: seq(STR; any(n, DF...)) — n defenders against the striker."""
    return seq_any_pattern("Q3", any_n=any_n, window_size=window_size,
                           weight=weight, proc_cost=proc_cost)


def make_q4(any_n: int, window_size: int, slide: int = 500,
            weight: float = 1.0, proc_cost: float = 1.0) -> PatternSpec:
    """Q4: any(n, B...) — n distinct buses delayed at the same stop."""
    return any_pattern("Q4", any_n=any_n, window_size=window_size,
                       slide=slide, weight=weight, proc_cost=proc_cost)
