"""forward_kernel_ms_per_query: device time of the forward kernels
(readers.FORWARD_KERNELS) in the traced window, in ms a fragment."""

from ..readers import FORWARD_KERNELS, kernel_ms_per_query


def read(run):
    return kernel_ms_per_query(run, FORWARD_KERNELS)
