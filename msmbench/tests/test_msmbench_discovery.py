"""A configuration, traffic mix, job kind and per-layer metric added as
new files (and entries in ``BENCHMARK.json``), in a copy of the
benchmark, with no file of ``msmbench/`` edited: the harness finds each
by name and runs the new cell through a run on the CPU."""

import hashlib
import json
import os
import shutil
import types

import torch

from msmbench.harness import cli, spec
from msmbench.harness.trace import Event, Span, Trace

JOB = '''
import torch


def setup(ctx):
    return {'x': torch.arange(ctx.config['n'], dtype=torch.float64)}


def run(s, random_state, spans):
    with spans('cluster'):
        total = float(s['x'].sum())
    return {'total': total, 'n': len(s['x'])}


def judge(s, out, ctx):
    return {'gap': abs(out['total'] - out['n'] * (out['n'] - 1) / 2)}


def numbers(parts):
    return {'sum_gap': parts[0]['gap']}
'''

METRIC = '''
def read(trace):
    spans = trace.span_list('cluster')
    return float(len(spans)) if spans else None
'''


def _digest(root):
    h = {}
    for d, _, files in os.walk(root):
        for f in files:
            if '__pycache__' in d:
                continue
            with open(os.path.join(d, f), 'rb') as fh:
                h[os.path.relpath(os.path.join(d, f), root)] = \
                    hashlib.sha256(fh.read()).hexdigest()
    return h


def test_new_cell_from_new_files_only(tmp_path):
    root = tmp_path
    shutil.copytree(spec.BENCH_DIR, root / 'msmbench',
                    ignore=shutil.ignore_patterns('__pycache__'))
    before = _digest(root / 'msmbench')
    bench = spec.load_benchmark()
    bd = str(root / 'msmbench')
    (root / 'msmbench' / 'configs' / 'toy.sum.json').write_text(
        json.dumps({'source': 'a test', 'n': 1000, 'reduced': []}))
    (root / 'msmbench' / 'traffic' / 'toy-sum.json').write_text(
        json.dumps({'job': 'toy_sum', 'trace_jobs': 2, 'check_jobs': 2,
                    'limits': {'sum_gap': 0}}))
    (root / 'msmbench' / 'jobs' / 'toy_sum.py').write_text(JOB)
    (root / 'msmbench' / 'metrics' / 'toy.spans.py').write_text(METRIC)
    bench['configs'].append({'name': 'toy.sum', 'source': 'a test',
                             'file': 'msmbench/configs/toy.sum.json',
                             'reduced': [], 'why': 'a test'})
    bench['workloads'].append({'name': 'toy.sum-cell', 'config': 'toy.sum',
                               'traffic': 'toy-sum', 'chips': 1,
                               'why': 'a test'})
    bench['per_layer'].append({'name': 'toy.spans', 'unit': 'count',
                               'better': 'lower', 'source': 'program_span',
                               'layer': 'cluster', 'moves': 'job_s',
                               'workloads': ['toy.sum-cell']})
    (root / 'BENCHMARK.json').write_text(json.dumps(bench))

    # every existing file of the benchmark unchanged
    after = _digest(root / 'msmbench')
    assert {k: v for k, v in after.items() if k in before} == before

    bench2 = spec.load_benchmark(str(root))
    cell = spec.workload(bench2, 'toy.sum-cell')
    cfg = spec.config(cell['config'], bd)
    trf = spec.traffic(cell['traffic'], bd)
    kind = spec.job_kind(trf['job'], bd)
    assert [m['name'] for m in spec.per_layer(bench2, cell['name'])] \
        == ['toy.spans']
    assert [m['name'] for m in spec.end_to_end(bench2, cell['name'])] \
        == ['job_s', 'peak_device_gib', 'setup_s']

    args = types.SimpleNamespace(workload=cell['name'], seed=8,
                                 seconds=0.05, trace=0, rank=None, world=1)
    report = cli.run_rank(args, 0.0, bench2, cell, cfg, trf, kind,
                          torch.device('cpu'))
    numbers, failed = cli.combine_numbers(kind, [report['partials']],
                                          trf['limits'])
    assert numbers == {'sum_gap': 0.0} and failed == 0
    assert report['n_jobs'] >= 1 and report['job_s'] > 0

    reader = spec.metric_reader('toy.spans', bd)
    tr = Trace([], [Event('k', 1, 2)], [Span('job', 0, 10, 1e-5),
                                        Span('cluster', 1, 3, 2e-6)],
               cfg, trf)
    assert reader.read(tr) == 1.0
