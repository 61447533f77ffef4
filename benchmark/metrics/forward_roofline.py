"""forward_roofline: the least time the card could take for the window's
all-vs-all Forward scoring (roofline.py, from the fragments' and models'
real lengths) over the forward kernels' device time, in %."""

from ..readers import FORWARD_KERNELS, kernel_seconds
from ..roofline import bound_seconds


def read(run):
    s = kernel_seconds(run, FORWARD_KERNELS)
    if not s or run.forward_work is None:
        return None
    _, ops, nbytes = run.forward_work
    least, _ = bound_seconds(ops, nbytes)
    return 100.0 * least / s
