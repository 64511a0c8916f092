"""``collectives.host_ms``: host milliseconds that rank 0 spends inside
``torch.distributed`` collective calls during the estimator's ``fit``,
per k-centers iteration (``n_clusters - 1`` a job): the union of the
profiler's CPU events of the c10d collectives (``c10d::*``, and the
``record_param_comms``, ``nccl:*`` and ``gloo:*`` ranges inside them)
that start inside the ``cluster`` span."""


def is_collective(name):
    return (name.startswith(('c10d::', 'nccl:', 'gloo:'))
            or name == 'record_param_comms')


def read(trace):
    spans = trace.span_list('cluster')
    if not spans:
        return None
    evs = [e for e in trace.inside(trace.cpu, 'cluster')
           if is_collective(e.name)]
    if not evs:
        return None
    iters = len(spans) * (trace.config['cluster']['n_clusters'] - 1)
    return 1e-3 * trace.busy_union_us(evs) / iters
