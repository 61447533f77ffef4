"""device_idle_pct: the share of the traced window in which no operation
ran on the card (the union of kernels, copies and sets), in %."""


def read(run):
    if run.busy_s is None or not run.window_s:
        return None
    return 100.0 * (1.0 - run.busy_s / run.window_s)
