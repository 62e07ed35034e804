"""runtime.host_ms_per_push: each push's wall time (the harness's
``push`` span) less the time inside it in which some device operation
ran, averaged over the traced window's pushes, in milliseconds: the
streaming runtime's host work that the card does not hide."""
from cepbench import tracing


def read(tr):
    pushes = tr.spans.get("push", [])
    if not pushes:
        return None
    busy = tracing.busy_within(tr, pushes)
    wall = sum(b - a for a, b in pushes)
    return (wall - int(busy.sum())) / len(pushes) * 1e-6
