"""The readers of the program's own spans (``enspara/...`` ranges of
``enspara_tpu_torch.util.log.trace_region``) on a made-up trace whose
values are worked out by hand, and a traced run on the CPU in which the
program's spans share the harness's clock and never reach the device's
timeline."""

import pytest
import torch

from msmbench.harness import cli, spec
from msmbench.harness.trace import Event, Span, Trace
from msmbench.tests import tiny

READERS = ('khybrid.kcenters_ms', 'khybrid.pam_ms', 'pam.host_reads',
           'pam.read_wait_ms', 'pam.device_idle', 'msm.prepare_ms')


@pytest.fixture(autouse=True)
def on_cpu(monkeypatch):
    monkeypatch.setenv('ENSPARA_TPU_PLATFORM', 'cpu')
    torch.set_num_threads(2)


def made_up(cpu=True, gpu=True):
    """Two jobs of 1 s (microseconds on the profiler's clock). Job 1:
    k-centers 100 ms, PAM 400 ms with reads of 50 and 30 ms, the MSM's
    preparation 20 ms; job 2: k-centers 140 ms, PAM 600 ms with one read
    of 120 ms, preparation 40 ms. Inside PAM the card works 10 ms, 90
    ms and 150 ms (overlapping by 50 ms) in job 1 and 200 ms and 50 ms
    in job 2; two kernels run on past PAM's ends."""
    spans = [Span('job', 0, 1e6, 1.0), Span('cluster', 1e4, 6e5, 0.59),
             Span('job', 1e6, 2e6, 1.0), Span('cluster', 1.01e6, 1.8e6,
                                              0.79)]
    evs = [Event('enspara/khybrid.kcenters', 1e4, 1.1e5),
           Event('enspara/khybrid.pam', 1.1e5, 5.1e5),
           Event('enspara/pam.read', 2e5, 2.5e5),
           Event('enspara/pam.read', 3e5, 3.3e5),
           Event('enspara/msm.prepare', 7e5, 7.2e5),
           Event('aten::copy_', 3e5, 3.1e5),
           Event('enspara/khybrid.kcenters', 1.01e6, 1.15e6),
           Event('enspara/khybrid.pam', 1.15e6, 1.75e6),
           Event('enspara/pam.read', 1.3e6, 1.42e6),
           Event('enspara/msm.prepare', 1.85e6, 1.89e6)]
    dev = [Event('kernel_a', 5e4, 1.2e5),        # 10 ms inside PAM
           Event('kernel_b', 1.5e5, 2.4e5),      # 90 ms
           Event('kernel_c', 1.9e5, 3.4e5),      # overlaps b by 50 ms
           Event('kernel_d', 1.2e6, 1.4e6),      # 200 ms
           Event('kernel_e', 1.7e6, 1.9e6)]      # 50 ms inside PAM
    return Trace(evs if cpu else [], dev if gpu else [], spans, {}, {})


@pytest.mark.parametrize('name,value', [
    ('khybrid.kcenters_ms', (100 + 140) / 2),
    ('khybrid.pam_ms', (400 + 600) / 2),
    ('pam.host_reads', 3 / 2),
    ('pam.read_wait_ms', (50 + 30 + 120) / 2),
    # PAM 1,000 ms in all; the card busy 10 + (90 + 150 - 50) + 200 + 50
    ('pam.device_idle', 100 * (1 - 450 / 1000)),
    ('msm.prepare_ms', (20 + 40) / 2),
])
def test_reader_by_hand(name, value):
    assert spec.metric_reader(name).read(made_up()) == pytest.approx(value)


@pytest.mark.parametrize('name', READERS)
def test_reader_without_its_events(name):
    assert spec.metric_reader(name).read(made_up(cpu=False)) is None


def test_pam_device_idle_without_a_card():
    assert spec.metric_reader('pam.device_idle').read(
        made_up(gpu=False)) is None
    assert spec.metric_reader('khybrid.pam_ms').read(
        made_up(gpu=False)) == pytest.approx(500)


def test_readers_are_listed_for_the_cell():
    bench = spec.load_benchmark()
    listed = {m['name'] for m in spec.per_layer(
        bench, 'lambda.khybrid-reassign-its')}
    assert set(READERS) <= listed


def test_traced_run_reads_the_program_spans(monkeypatch):
    """The program's spans are host events on the harness's clock: each
    k-hybrid stage lies inside the harness's ``cluster`` span, and no
    ``enspara/`` name is among the device's events."""
    traces = []

    def keep(*args):
        traces.append(real(*args))
        return traces[-1]
    real = cli.from_profiler
    monkeypatch.setattr(cli, 'from_profiler', keep)
    report, numbers, correct = tiny.run('lambda.khybrid-reassign-its',
                                        seed=13, trace=1)
    assert correct, numbers
    m = report['trace_metrics']
    for name in ('khybrid.kcenters_ms', 'khybrid.pam_ms', 'msm.prepare_ms',
                 'pam.host_reads', 'pam.read_wait_ms'):
        assert m[name]['value'] > 0, name
    assert 'pam.device_idle' not in m
    tr, = traces
    clusters = tr.span_list('cluster')
    stages = [e for e in tr.cpu if e.name.startswith('enspara/khybrid.')]
    assert len(stages) == 2 * len(clusters) == 4
    for e in stages:
        assert any(s.start <= e.start and e.end <= s.end for s in clusters)
    assert m['khybrid.kcenters_ms']['value'] + m['khybrid.pam_ms'][
        'value'] <= m['cluster.ms']['value']
    assert not [e for e in tr.gpu if e.name.startswith('enspara/')]
