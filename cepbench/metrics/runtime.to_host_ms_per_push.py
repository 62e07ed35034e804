"""runtime.to_host_ms_per_push: the time in the program's
``runtime.to_host`` spans (the runtime's reads of the device: each
chunk's stats vector, a session's first counter snapshot) in the traced
window, in milliseconds a push.  A read waits for the card only for what
is still queued: where ``runtime.chunk_stats``' copies to the device
have drained the stream before it, as in the runtime's push, this is the
copy alone, and the wait for the card reads in
``runtime.chunk_stats_ms_per_push``."""
from cepbench import program_spans


def read(tr):
    return program_spans.ms_per_push(tr, "runtime.to_host")
