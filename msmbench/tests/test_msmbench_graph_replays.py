"""The reader of the sharded k-centers loop's CUDA graph replays
(``enspara/kcenters.replay`` spans inside ``enspara/kcenters.sharded``)
on a made-up trace: the per-loop count, and nothing where the program
replays no graph, as a program without the graph reads."""

import pytest

from msmbench.harness import spec
from msmbench.harness.trace import Event, Span, Trace

NAME = 'kcenters.graph_replays'


def made_up(replays=True):
    """Two jobs of one loop each: 15 replays in the first loop, 13 in
    the second, one capture a loop, and a replay span outside both."""
    spans = [Span('job', 0, 2e6, 2.0)]
    evs = [Event('enspara/kcenters.sharded', 1e5, 9e5),
           Event('enspara/kcenters.sharded', 1.1e6, 1.9e6),
           Event('enspara/kcenters.capture', 1.5e5, 2e5),
           Event('enspara/kcenters.capture', 1.15e6, 1.2e6),
           Event('enspara/mesh.all_reduce', 1.6e5, 1.61e5)]
    if replays:
        evs += [Event('enspara/kcenters.replay', 2e5 + 4e4 * i,
                      2e5 + 4e4 * i + 50) for i in range(15)]
        evs += [Event('enspara/kcenters.replay', 1.2e6 + 4e4 * i,
                      1.2e6 + 4e4 * i + 50) for i in range(13)]
        evs += [Event('enspara/kcenters.replay', 1.95e6, 1.96e6)]
    return Trace(evs, [], spans, {'cluster': {'n_clusters': 1000}}, {})


def test_replays_per_loop():
    assert spec.metric_reader(NAME).read(made_up()) == pytest.approx(14.0)


def test_nothing_without_replays():
    assert spec.metric_reader(NAME).read(made_up(replays=False)) is None


def test_listed_for_the_nccl_cell_alone():
    bench = spec.load_benchmark()
    metric = next(m for m in bench['per_layer'] if m['name'] == NAME)
    assert metric['workloads'] == ['ntl9.kcenters-msm-nccl4']
    assert metric['moves'] == 'job_s' and metric['unit'] == 'count'
    assert metric['layer'] == 'cluster (sharded k-centers loop)'
