"""``assign.ms``: host milliseconds of the ``assign_device`` call over
every frame, the mean over the traced jobs."""


def read(trace):
    return trace.span_mean_ms('assign')
