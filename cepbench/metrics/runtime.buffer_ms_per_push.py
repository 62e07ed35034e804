"""runtime.buffer_ms_per_push: the time in the program's
``runtime.buffer`` spans (``ChunkBuffer.push_region``: the pushed events
joined to the buffered tail and cut into whole chunks) in the traced
window, in milliseconds a push."""
from cepbench import program_spans


def read(tr):
    return program_spans.ms_per_push(tr, "runtime.buffer")
