"""runtime.construct_ms: the mean duration of the program's
``runtime.construct`` spans (``StreamRuntime.__init__``: a session's
fresh runtime, its 128 carries made and stacked) in the traced window,
in milliseconds."""
from cepbench import program_spans


def read(tr):
    recs = program_spans.within(tr, "runtime.construct")
    if not recs:
        return None
    return sum(b - a for a, b, _ in recs) / len(recs) * 1e-6
