"""The one-card WW cell (``ww.kcenters-msm``) at a tiny size on the CPU:
set-up, the window's jobs and the judge through the harness with
``correct`` true, a planted fault (a pick replaced by a nearer frame)
failing ``kcenters_pick_gap``, and the cell's three readers on made-up
traces whose values are worked out by hand, each reading nothing where
its span or kernel is absent, as a program without them reads.

The tiny copy of ``desres-ww.kcenters`` is this file's own."""

import copy
import types

import pytest
import torch

from msmbench.harness import cli, spec
from msmbench.harness.trace import Event, Span, Trace

CELL = 'ww.kcenters-msm'
READERS = ('kcenters.chunk_device_ms', 'kcenters.loop_idle',
           'kcenters.results_ms')


@pytest.fixture(autouse=True)
def on_cpu(monkeypatch):
    monkeypatch.setenv('ENSPARA_TPU_PLATFORM', 'cpu')
    torch.set_num_threads(2)


def tiny_config():
    """``desres-ww.kcenters`` at 6,000 frames of 35 atoms (40 basins,
    trajectories of 1,000), 24 centers; the rest as the cell has it."""
    bench = spec.load_benchmark()
    cell = spec.workload(bench, CELL)
    cfg = copy.deepcopy(spec.config(cell['config']))
    cfg['n_frames'] = 6000
    cfg['assumed']['traj_frames'] = 1000
    cfg['assumed']['generator']['n_basins'] = 40
    cfg['cluster']['n_clusters'] = 24
    return bench, cell, cfg


def run(seed=3, trace=0, change=None):
    """One run of the tiny cell through the harness on the CPU, each
    job's output passed through ``change(out)`` where given:
    ``(report, numbers, correct)``."""
    bench, cell, cfg = tiny_config()
    trf = spec.traffic(cell['traffic'])
    real = spec.job_kind(trf['job'])
    kind = real
    if change is not None:
        kind = types.SimpleNamespace(setup=real.setup, judge=real.judge,
                                     numbers=real.numbers)

        def changed(s, rs, spans):
            out = real.run(s, rs, spans)
            change(out)
            return out
        kind.run = changed
    args = types.SimpleNamespace(workload=CELL, seed=seed, seconds=0.0,
                                 trace=trace, rank=None, world=1)
    report = cli.run_rank(args, 0.0, bench, cell, cfg, trf, kind,
                          torch.device('cpu'))
    numbers, _ = cli.combine_numbers(kind, [report['partials']],
                                     trf['limits'])
    correct, _ = cli.verdict(numbers, trf['limits'])
    return report, numbers, correct


def test_traced_jobs_judged_correct():
    """Set-up, the two traced jobs and the judge: correct; the results'
    span reads in the traced run, the device readers read nothing on a
    trace with no card."""
    report, numbers, correct = run(seed=2200002501, trace=1)
    assert correct, numbers
    assert report['n_jobs'] == 2
    assert numbers['kcenters_first'] == 0 and numbers['msm_counts_gap'] == 0
    m = report['trace_metrics']
    assert m['kcenters.results_ms']['value'] > 0
    assert 'kcenters.chunk_device_ms' not in m
    assert 'kcenters.loop_idle' not in m


def test_pick_replaced_by_a_nearer_frame():
    """Center 5 replaced by the frame next to the first center (in its
    basin, far nearer to it than the farthest frame)."""
    def nearer(out):
        c = out['centers'].copy()
        c[5] = c[0] - 1 if c[0] > 0 else c[0] + 1
        out['centers'] = c
    _, numbers, correct = run(seed=7, change=nearer)
    assert not correct
    assert numbers['kcenters_pick_gap'] > 1e-4


def made_up(spans=True, kernels=True):
    """Two jobs of 1 s (profiler microseconds), 11 centers (10
    iterations a job). Each job's ``cluster`` span runs 100-700 ms, its
    loop 200-600 ms and its results' fetch 600-650 ms. Job 1: kernel 1
    busy 150 ms in its loop (a begin and two iteration kernels, one
    overlapping another); job 2: 100 ms, and one kernel that runs on 20
    ms past the loop's end. A sharded loop's kernel (``kc_iter_skip``)
    and an iteration kernel outside ``cluster`` do not count."""
    jobs = [Span('job', 0, 1e6, 1.0), Span('job', 1e6, 2e6, 1.0),
            Span('cluster', 1e5, 7e5, 0.6), Span('cluster', 1.1e6, 1.7e6,
                                                 0.6)]
    cpu = []
    if spans:
        for t in (0, 1e6):
            cpu += [Event('enspara/kcenters.loop', t + 2e5, t + 6e5),
                    Event('enspara/kcenters.results', t + 6e5, t + 6.5e5)]
    gpu = [Event('memcpy', 6.6e5, 6.7e5)]
    if kernels:
        gpu += [Event('void kc_begin_kernel<float>(...)', 2e5, 2.5e5),
                Event('void kc_iter_kernel<float>(...)', 3e5, 3.8e5),
                Event('void kc_iter_kernel<float>(...)', 3.6e5, 3.9e5),
                Event('void kc_iter_kernel<float>(...)', 1.5e6, 1.62e6),
                Event('void kc_iter_skip_kernel<float>(...)', 4e5, 4.5e5),
                Event('void kc_iter_kernel<float>(...)', 8e5, 9e5)]
    return Trace(cpu, gpu, jobs, {'cluster': {'n_clusters': 11}}, {})


@pytest.mark.parametrize('name,value', [
    # (50 + 80 + 30 + 120) ms of kernel 1 over 2 x 10 iterations
    ('kcenters.chunk_device_ms', 280 / 20),
    # 800 ms of loop; busy 50 + 90 + 50 (skip kernel) + 100 ms in it
    ('kcenters.loop_idle', 100 * (1 - 290 / 800)),
    # 2 x 50 ms over 2 jobs
    ('kcenters.results_ms', 50.0),
])
def test_reader_by_hand(name, value):
    assert spec.metric_reader(name).read(made_up()) == pytest.approx(value)


@pytest.mark.parametrize('name,absent', [
    ('kcenters.chunk_device_ms', dict(kernels=False)),
    ('kcenters.loop_idle', dict(spans=False)),
    ('kcenters.results_ms', dict(spans=False)),
])
def test_reader_without_its_span_or_kernel(name, absent):
    assert spec.metric_reader(name).read(made_up(**absent)) is None


@pytest.mark.parametrize('name,cells', [
    ('kcenters.chunk_device_ms', [CELL]),
    ('kcenters.loop_idle', [CELL]),
    ('kcenters.results_ms', [CELL, 'ntl9.kcenters-msm-nccl4']),
])
def test_listed_for_their_cells(name, cells):
    bench = spec.load_benchmark()
    metric = next(m for m in bench['per_layer'] if m['name'] == name)
    assert metric['workloads'] == cells and metric['moves'] == 'job_s'
    assert set(READERS) <= {m['name'] for m in spec.per_layer(bench, CELL)}
