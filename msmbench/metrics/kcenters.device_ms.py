"""``kcenters.device_ms``: device milliseconds of the k-centers
iteration kernel (``kc_iter_skip``, kernel 4, on this card's shard) per
k-centers iteration, inside the estimator's ``fit``; a job runs
``n_clusters - 1`` iterations after its seeded first center."""


def read(trace):
    spans = trace.span_list('cluster')
    if not spans:
        return None
    kern = [e for e in trace.inside(trace.gpu, 'cluster')
            if 'kc_iter_skip' in e.name]
    if not kern:
        return None
    iters = len(spans) * (trace.config['cluster']['n_clusters'] - 1)
    return 1e-3 * sum(e.end - e.start for e in kern) / iters
