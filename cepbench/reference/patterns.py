"""The paper's queries (pSPICE, arXiv:2002.04436 §IV-A) compiled to the
dense tables the reference engine reads, from a configuration file's
``patterns`` list.  Written from the paper's definitions, with
skip-till-next-match semantics:

  Q1  seq(RE_1; ...; RE_k)            SEQ, the window opens on RE_1
  Q3  seq(STR; any(n, DF_1..DF_n))    ANY over distinct ids, bound to STR

States count positions matched: 0 is the empty match (never stored), a
PM spawns at 1 and completes at the final state m - 1.
"""
from __future__ import annotations

import numpy as np

SEQ, ANY = 0, 1


def spec(p: dict) -> dict:
    """One pattern of a configuration file as a flat description."""
    q = p["query"]
    weight, cost = float(p.get("weight", 1.0)), float(p.get("proc_cost", 1.0))
    base = dict(query=q, window_size=int(p["window_size"]), weight=weight,
                proc_cost=cost, any_n=0)
    if q == "Q1":
        k = int(p["num_symbols"])
        return dict(base, kind=SEQ, num_classes=k,
                    sequence=tuple(range(1, k + 1)), num_states=k + 1,
                    uses_binding=False)
    if q == "Q3":
        n = int(p["any_n"])
        return dict(base, kind=ANY, num_classes=1,
                    sequence=(), num_states=n + 2, any_n=n,
                    uses_binding=True)
    raise ValueError(f"unknown query {q!r}")


def compile_specs(patterns: list[dict]) -> dict:
    """Padded arrays over the patterns: ``trans`` (P, M, C+1), the final
    state, kind, window, binding, cost."""
    specs = [spec(p) for p in patterns]
    M = max(s["num_states"] for s in specs)
    C1 = max(s["num_classes"] for s in specs) + 1
    trans = np.tile(np.arange(M, dtype=np.int32)[None, :, None],
                    (len(specs), 1, C1))
    for k, s in enumerate(specs):
        for j in range(1, s["num_states"] - 1):
            # SEQ: position j needs class sequence[j]; ANY: class 1.
            c = s["sequence"][j] if s["kind"] == SEQ else 1
            trans[k, j, c] = j + 1
    col = lambda key, dt: np.array([s[key] for s in specs], dt)  # noqa: E731
    return dict(
        specs=specs, trans=trans, num_states=col("num_states", np.int32),
        final_state=col("num_states", np.int32) - 1,
        kind=col("kind", np.int32),
        window_size=col("window_size", np.int64),
        uses_binding=col("uses_binding", bool),
        proc_cost=col("proc_cost", np.float32),
        weight=col("weight", np.float32))
