"""block_step_roofline: the least time one launch of the block
kernel's lane instance could take, its bytes (``roofline.block_bytes``:
each input byte read once, each output byte written once) at the card's
3.35 TB/s, as a share of its measured device time, in %.  It is bound
by bytes: the launch does no matrix work."""
from cepbench import roofline


def read(tr):
    t = roofline.kernel_launches(tr, "block_step_kernel")
    nbytes = roofline.block_bytes(tr)
    if t is None or nbytes is None:
        return None
    return 100.0 * nbytes / roofline.HBM_BYTES_PER_S / (t[0] / t[1] * 1e-9)
