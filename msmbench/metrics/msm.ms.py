"""``msm.ms``: host milliseconds of the MSM tail (counting and the
eigensolve), the mean over the traced jobs."""


def read(trace):
    return trace.span_mean_ms('msm')
