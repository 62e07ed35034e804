"""runtime.summarize_ms_per_push: the time in the program's
``runtime.summarize`` spans (``summarize_chunk``, the telemetry append,
the ladder and guard) in the traced window, in milliseconds a push: host
work after the card drained."""
from cepbench import program_spans


def read(tr):
    return program_spans.ms_per_push(tr, "runtime.summarize")
