"""The reader of the card's idle time inside the k-centers warm start
(``enspara/kcenters.warm_start`` spans) on a made-up trace: the idle
clipped to the spans and averaged over the jobs, and nothing where the
program has no such span, as a program without the span reads."""

import pytest

from msmbench.harness import spec
from msmbench.harness.trace import Event, Span, Trace

NAME = 'kcenters.warm_start_idle_ms'


def made_up(warm_start=True):
    """Two jobs, a warm start each: the first 100 ms long with 30 ms of
    device work inside it (two overlapping kernels, and a copy that
    starts before the span and ends 10 ms into it); the second 50 ms
    with 45 ms of work and a kernel that runs on past its end. Device
    work outside the spans does not count."""
    spans = [Span('job', 0, 1e6, 1.0), Span('job', 1e6, 2e6, 1.0)]
    evs = [Event('enspara/kcenters.sharded', 3e5, 9e5)]
    if warm_start:
        evs += [Event('enspara/kcenters.warm_start', 1e5, 2e5),
                Event('enspara/kcenters.warm_start', 1.1e6, 1.15e6)]
    gpu = [Event('memcpy', 0.5e5, 1.1e5),
           Event('kc_a', 1.5e5, 1.6e5), Event('kc_b', 1.55e5, 1.65e5),
           Event('kc_c', 1.105e6, 1.2e6),
           Event('kc_iter', 3e5, 8e5)]
    return Trace(evs, gpu, spans, {'cluster': {'n_clusters': 1000}}, {})


def test_idle_clipped_to_the_span_per_job():
    # job 1: 100 - (10 + 15) = 75 ms; job 2: 50 - 45 = 5 ms
    assert spec.metric_reader(NAME).read(made_up()) == pytest.approx(40.0)


def test_nothing_without_the_span():
    assert spec.metric_reader(NAME).read(made_up(warm_start=False)) is None


def test_listed_for_both_cells():
    bench = spec.load_benchmark()
    metric = next(m for m in bench['per_layer'] if m['name'] == NAME)
    assert metric['workloads'] == ['ntl9.kcenters-msm-nccl4',
                                   'lambda.khybrid-reassign-its']
    assert metric['moves'] == 'job_s' and metric['unit'] == 'ms'
    assert metric['source'] == 'device_trace'
    assert metric['layer'] == 'cluster (k-centers warm start)'
