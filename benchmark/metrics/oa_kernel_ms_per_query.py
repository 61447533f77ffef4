"""oa_kernel_ms_per_query: device time of the oa kernels
(readers.OA_KERNELS) in the traced window, in ms a fragment."""

from ..readers import OA_KERNELS, kernel_ms_per_query


def read(run):
    return kernel_ms_per_query(run, OA_KERNELS)
