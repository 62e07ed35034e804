"""The paper's whole quality grid in both packages, on the CPU.

{stock, soccer, bus} × {1.2, 1.4, 1.6} × {pspice, pmbl, ebl} at each
scenario's n_default (30 000 events), in jax's original threefry layout
(the committed ``BENCH_quality.json``'s): the port's
``run_quality_sweep`` (its own model builder, the ``torch`` backend)
equals the reference's in every key of every cell, and stock's cells
equal the committed file.  The other committed cells are compared and
counted, not held: run here, the reference itself gives soccer's and
bus's ``max_rate`` as the port does, not as the file (made with jax
0.4.37) does, and reproduces only the cells whose ``max_rate`` agrees.

Marked ``quality`` (deselected by default; about 8 minutes):

    PYTHONPATH=src python -m pytest -q -m quality -s \\
        tests/test_torch_quality_grid.py
"""
import json
import pathlib

import jax
import pytest

from repro.eval import sweep
from repro_torch import prng
from repro_torch.eval import sweep as tsweep

pytestmark = pytest.mark.quality

COMMITTED = pathlib.Path(__file__).resolve().parents[1] / \
    "BENCH_quality.json"


def _cells(bench):
    for ds, grid in bench["datasets"].items():
        for lv, cells in grid["levels"].items():
            for sh, cell in cells.items():
                yield (ds, lv, sh), cell


def test_whole_grid_port_equals_reference_original_layout():
    old = (jax.config.jax_threefry_partitionable, prng.PARTITIONABLE)
    jax.config.update("jax_threefry_partitionable", False)
    prng.PARTITIONABLE = False
    try:
        ref = sweep.run_quality_sweep()
        got = tsweep.run_quality_sweep(backend="torch", device="cpu")
    finally:
        jax.config.update("jax_threefry_partitionable", old[0])
        prng.PARTITIONABLE = old[1]
    committed = dict(_cells(json.loads(COMMITTED.read_text())))
    ref_cells, got_cells = dict(_cells(ref)), dict(_cells(got))
    assert got_cells == ref_cells
    assert got["violations"] == ref["violations"] == []
    exact = {key for key, cell in ref_cells.items()
             if (cell["fn"], cell["shed_calls"]) ==
             (committed[key]["fn"], committed[key]["shed_calls"])}
    rate_same = {key for key, cell in ref_cells.items()
                 if cell["max_rate"] == committed[key]["max_rate"]}
    print(f"cells equal to BENCH_quality.json (FN and fires): "
          f"{len(exact)} of {len(ref_cells)}; max_rate equal in "
          f"{len(rate_same)}; inexact: {sorted(set(ref_cells) - exact)}")
    stock = {key for key in ref_cells if key[0] == "stock"}
    assert stock <= exact and stock <= rate_same
