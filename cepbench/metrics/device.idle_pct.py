"""device.idle_pct: the share of the traced window in which no device
operation ran (kernels, copies and sets alike), in %."""
from cepbench import tracing


def read(tr):
    if not len(tr.dev_start):
        return None
    return 100.0 * (1.0 - tracing.busy_ns(tr) / (tr.t1 - tr.t0))
