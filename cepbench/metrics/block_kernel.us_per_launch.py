"""block_kernel.us_per_launch: device time of the block kernel's
launches in the traced window (the profiler's ``block_step_kernel``
rows), divided by their count, in microseconds."""
from cepbench import roofline


def read(tr):
    t = roofline.kernel_launches(tr, "block_step_kernel")
    return None if t is None else t[0] / t[1] * 1e-3
