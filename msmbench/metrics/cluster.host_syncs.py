"""``cluster.host_syncs``: the host's waits on the card inside the
estimator's ``fit``, per job: the profiler's CUDA runtime events
``cudaStreamSynchronize``, ``cudaDeviceSynchronize`` and
``cudaEventSynchronize`` that start inside the ``cluster`` span. Every
device-to-host read of a result (``.item()``, ``.cpu()``, ``.tolist()``)
waits in one of them; the harness's own synchronise at the span's end
lies outside the span's range and is not counted."""

SYNCS = ('cudaStreamSynchronize', 'cudaDeviceSynchronize',
         'cudaEventSynchronize')


def read(trace):
    spans = trace.span_list('cluster')
    if not spans or not trace.gpu:      # no card in the trace
        return None
    waits = [e for e in trace.inside(trace.cpu, 'cluster')
             if e.name in SYNCS]
    return len(waits) / len(spans)
