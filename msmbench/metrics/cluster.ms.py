"""``cluster.ms``: host milliseconds of the estimator's ``fit`` (a span
that ends in ``torch.cuda.synchronize()``), the mean over the traced
jobs."""


def read(trace):
    return trace.span_mean_ms('cluster')
