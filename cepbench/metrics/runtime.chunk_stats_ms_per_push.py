"""runtime.chunk_stats_ms_per_push: the time in the program's
``runtime.chunk_stats`` spans (``device_chunk_stats``: each chunk's
reductions issued to the card, with the quantiles' two copies to the
device, which wait for the card to drain what the push queued) in the
traced window, in milliseconds a push."""
from cepbench import program_spans


def read(tr):
    return program_spans.ms_per_push(tr, "runtime.chunk_stats")
