"""The readers of the sharded k-centers cell's program spans
(``enspara/kcenters.sharded``, ``enspara/mesh.*``) on a made-up trace
whose values are worked out by hand; each reads nothing where the
program has no such span, as a program without them reads; and they are
listed for the cell with the cell's other readers."""

import pytest

from msmbench.harness import spec
from msmbench.harness.trace import Event, Span, Trace

CELL = 'ntl9.kcenters-msm-nccl4'
READERS = ('mesh.collective_ms', 'mesh.collectives', 'kcenters.sharded_idle')


def made_up(cpu=True, gpu=True):
    """One job of 1 s (profiler microseconds), 11 centers (10
    iterations). The loop runs from 100 to 600 ms; inside it 20
    collectives of 2 ms and 5 of 1 ms; one collective of 4 ms after the
    loop (the fetch of the results). The card works 100 ms inside the
    loop, and 50 ms more of it overlapping; a kernel past the loop's
    end."""
    spans = [Span('job', 0, 1e6, 1.0), Span('cluster', 1e4, 7e5, 0.69)]
    evs = [Event('enspara/kcenters.sharded', 1e5, 6e5)]
    evs += [Event('enspara/mesh.all_reduce', 1.1e5 + 1e4 * i,
                  1.1e5 + 1e4 * i + 2e3) for i in range(20)]
    evs += [Event('enspara/mesh.all_gather', 4e5 + 1e4 * i,
                  4e5 + 1e4 * i + 1e3) for i in range(5)]
    evs += [Event('enspara/mesh.all_gather', 6.5e5, 6.54e5),
            Event('aten::copy_', 2e5, 2.1e5)]
    dev = [Event('kc_iter_skip', 2e5, 3e5), Event('nccl', 2.5e5, 3e5),
           Event('kc_iter_skip', 5.8e5, 6.8e5)]
    cfg = {'cluster': {'n_clusters': 11}}
    return Trace(evs if cpu else [], dev if gpu else [], spans, cfg, {})


@pytest.mark.parametrize('name,value', [
    ('mesh.collective_ms', (20 * 2 + 5 * 1) / 10),
    ('mesh.collectives', 25 / 10),
    # the loop 500 ms; the card busy 100 ms and 20 ms of the last kernel
    ('kcenters.sharded_idle', 100 * (1 - 120 / 500)),
])
def test_reader_by_hand(name, value):
    assert spec.metric_reader(name).read(made_up()) == pytest.approx(value)


@pytest.mark.parametrize('name', READERS)
def test_reader_without_its_spans(name):
    assert spec.metric_reader(name).read(made_up(cpu=False)) is None


def test_idle_without_a_card():
    assert spec.metric_reader('kcenters.sharded_idle').read(
        made_up(gpu=False)) is None


def test_readers_are_listed_for_the_cell():
    bench = spec.load_benchmark()
    listed = {m['name'] for m in spec.per_layer(bench, CELL)}
    assert listed == set(READERS) | {'kcenters.device_ms',
                                     'collectives.host_ms'}
    cell = spec.workload(bench, CELL)
    assert cell['chips'] == 4
    assert spec.traffic(cell['traffic'])['job'] == 'kcenters_msm_sharded'
