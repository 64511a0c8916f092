"""``kcenters.chunk_device_ms``: device milliseconds of kernel 1, the
one-card k-centers chunk kernel (``kc_begin_kernel``, which places a
chunk's first center, and ``kc_iter_kernel``, one iteration; not the
sharded loop's ``kc_iter_skip``), per k-centers iteration, inside the
estimator's ``fit``; a job runs ``n_clusters - 1`` iterations after its
seeded first center. None where no such kernel ran."""

NAMES = ('kc_begin_kernel', 'kc_iter_kernel')


def read(trace):
    spans = trace.span_list('cluster')
    if not spans:
        return None
    kern = [e for e in trace.inside(trace.gpu, 'cluster')
            if any(n in e.name for n in NAMES)
            and 'kc_iter_skip' not in e.name]
    if not kern:
        return None
    iters = len(spans) * (trace.config['cluster']['n_clusters'] - 1)
    return 1e-3 * sum(e.end - e.start for e in kern) / iters
