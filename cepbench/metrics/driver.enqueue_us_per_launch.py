"""driver.enqueue_us_per_launch: the time in the program's
``driver.launches`` spans (the block driver's launch loop) in the traced
window divided by the launches they count, in microseconds: the host's
cost of issuing one launch of the block kernel."""
from cepbench import program_spans


def read(tr):
    recs = program_spans.within(tr, "driver.launches")
    launches = sum(n for _, _, n in recs)
    if not launches:
        return None
    return sum(b - a for a, b, _ in recs) / launches * 1e-3
