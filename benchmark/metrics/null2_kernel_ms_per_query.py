"""null2_kernel_ms_per_query: device time of the null2 kernels
(readers.NULL2_KERNELS) in the traced window, in ms a fragment."""

from ..readers import NULL2_KERNELS, kernel_ms_per_query


def read(run):
    return kernel_ms_per_query(run, NULL2_KERNELS)
