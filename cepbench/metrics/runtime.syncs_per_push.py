"""runtime.syncs_per_push: the program's waits for the device's stream
in the traced window, divided by the window's pushes.  A wait is one
copy between pageable host memory and the card, each a span: the
runtime's reads (``runtime.to_host``), the quantiles' copies to the
device (``runtime.to_device``) and the engine's reads (``engine.read``)."""
from cepbench import program_spans

WAITS = ("runtime.to_host", "runtime.to_device", "engine.read")


def read(tr):
    n = sum(len(program_spans.within(tr, k)) for k in WAITS)
    pushes = tr.counts.get("pushes", 0)
    if not n or not pushes:
        return None
    return n / pushes
