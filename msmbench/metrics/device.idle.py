"""``device.idle``: the share of the traced window (the traced jobs,
first start to last end) in which rank 0's card runs no kernel, copy or
set: 100 minus the union of the profiler's device intervals over the
window."""


def read(trace):
    if trace.window_s <= 0 or not trace.gpu:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
