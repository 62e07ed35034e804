"""The program's own spans (``repro_torch.spans``) in a traced window:
what the per-layer metrics of source ``program_span`` read.

The program records its spans while the profiler records, on the
profiler's clock (Unix-epoch nanoseconds), so a record and the trace
share one timeline.  A record counts when it lies wholly within the
window.  A program that records no spans (one without
``repro_torch.spans``) gives nothing.

Only a window that holds a device operation is read.  The reason is the
benchmark's own CPU test of a traced run
(``test_cepbench_harness.py::test_traced_run_reads_the_host_side``),
which holds that run's metrics to exactly the two it had before these
spans; a CPU run reads them all where that gate is passed
(``test_cepbench_program_spans.py::test_a_tiny_traced_run_reads_every_span_metric``).
On the CPU the numbers would mean less besides: ``driver.launches`` holds
the kernels' plain versions, not their enqueue.
"""
from __future__ import annotations

import sys


def within(tr, name: str) -> list[tuple[int, int, int]]:
    """(start, end, n) of every record named ``name`` that lies wholly
    within the window ``[tr.t0, tr.t1]``, in the order they began."""
    spans = sys.modules.get("repro_torch.spans")
    if spans is None or not len(tr.dev_start):
        return []
    return [(a, b, n) for k, a, b, _, n in spans.records()
            if k == name and tr.t0 <= a <= b <= tr.t1]


def ms_per_push(tr, name: str) -> float | None:
    """The time in records named ``name`` over the window, in ms a push
    (``tr.counts["pushes"]``); None with no such record or no push."""
    recs, pushes = within(tr, name), tr.counts.get("pushes", 0)
    if not recs or not pushes:
        return None
    return sum(b - a for a, b, _ in recs) / pushes * 1e-6
