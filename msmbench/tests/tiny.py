"""Tiny copies of the cells for the CPU tests: the same job kinds,
references and harness, at sizes a test run holds."""

import copy
import types

import torch

from msmbench.harness import cli, spec

SIZES = {
    'desres-lambda.khybrid': dict(
        n_frames=6000, n_atoms=80, traj_frames=1000, n_basins=40,
        n_clusters=24, lag_times=[5, 30, 5]),
    'desres-ntl9.kcenters-4rank': dict(
        n_frames=8000, n_atoms=39, traj_frames=1000, n_basins=40,
        n_clusters=24),
}


def config(name):
    """The configuration ``name`` at its tiny size."""
    cfg = copy.deepcopy(spec.config(name))
    size = SIZES[name]
    cfg['n_frames'] = size['n_frames']
    cfg['n_atoms'] = size['n_atoms']
    cfg['assumed']['traj_frames'] = size['traj_frames']
    cfg['assumed']['generator']['n_basins'] = size['n_basins']
    cfg['cluster']['n_clusters'] = size['n_clusters']
    if 'lag_times' in size:
        cfg['msm']['lag_times'] = size['lag_times']
    return cfg


# cells whose files the benchmark holds though BENCHMARK.json does not
# list them (the NCCL cell waits on a fault of the program: PERF.md)
# cells whose configuration and job kind the benchmark holds though
# BENCHMARK.json does not list them (the NCCL cell waits on a fault of
# the program, PERF.md question 1), with a traffic mix of the tests'
UNLISTED = {
    'ntl9.kcenters-msm-nccl4': (
        {'name': 'ntl9.kcenters-msm-nccl4',
         'config': 'desres-ntl9.kcenters-4rank', 'chips': 4},
        {'job': 'kcenters_msm_sharded', 'trace_jobs': 1, 'check_jobs': 1,
         'limits': {'kcenters_first': 0, 'kcenters_pick_gap': 1e-4,
                    'kcenters_label_gap': 1e-4, 'kcenters_dist_gap': 1e-4,
                    'msm_counts_gap': 0, 'msm_its_gap': 1e-3}}),
}


def cell(workload):
    bench = spec.load_benchmark()
    try:
        c = spec.workload(bench, workload)
        trf = spec.traffic(c['traffic'])
    except KeyError:
        c, trf = UNLISTED[workload]
    return bench, c, config(c['config']), trf, spec.job_kind(trf['job'])


def run(workload, seed=3, seconds=0.0, trace=0, mesh=None, kind=None):
    """One run of a tiny cell on the CPU through the harness (the look
    for a card skipped): ``(report, numbers, correct)``."""
    bench, c, cfg, trf, real_kind = cell(workload)
    kind = kind or real_kind
    args = types.SimpleNamespace(workload=workload, seed=seed,
                                 seconds=seconds, trace=trace, rank=None,
                                 world=1)
    with DeviceSweeps():
        report = cli.run_rank(args, 0.0, bench, c, cfg, trf, kind,
                              torch.device('cpu'), mesh=mesh)
    numbers, _ = cli.combine_numbers(kind, [report['partials']],
                                     trf['limits'])
    correct, _ = cli.verdict(numbers, trf['limits'])
    return report, numbers, correct


class DeviceSweeps:
    """Within the block, PAM on CPU tensors takes the device sweeps, as
    data on a card does (off the card the estimator takes the host PAM
    path, whose proposals differ)."""

    def __enter__(self):
        import importlib
        self.mod = importlib.import_module(
            'enspara_tpu_torch.cluster.kmedoids')
        self.saved = self.mod.resolve_device
        self.mod.resolve_device = lambda X, device=None: types.SimpleNamespace(
            type='cuda')
        return self

    def __exit__(self, *exc):
        self.mod.resolve_device = self.saved


RANK_SCRIPT = '''
import json, os, sys, types
sys.path.insert(0, sys.argv[1])
import torch
from msmbench.harness import cli
from msmbench.tests import tiny
bench, c, cfg, trf, kind = tiny.cell(sys.argv[2])
args = types.SimpleNamespace(workload=sys.argv[2], seed=int(sys.argv[3]),
                             seconds=float(sys.argv[4]), trace=0,
                             rank=int(sys.argv[5]), world=int(sys.argv[6]))
report = cli.run_rank(args, 0.0, bench, c, cfg, trf, kind,
                      torch.device('cpu'))
print(json.dumps(report))
'''


def run_ranks(workload, world=4, seed=5, seconds=0.0, timeout=600):
    """One run of a tiny cell in ``world`` CPU processes joined over
    gloo, as the launcher lays a cell on several cards out: ``(reports,
    numbers, correct)``."""
    import json
    import os
    import subprocess
    import sys
    port = cli.free_port()
    procs = []
    for r in range(world):
        env = dict(os.environ, ENSPARA_TPU_PLATFORM='cpu',
                   ENSPARA_TPU_COORDINATOR='127.0.0.1:%d' % port,
                   ENSPARA_TPU_NUM_PROCESSES=str(world),
                   ENSPARA_TPU_PROCESS_ID=str(r), OMP_NUM_THREADS='1')
        env.pop('ENSPARA_TPU_LOCAL_SHARDS', None)
        procs.append(subprocess.Popen(
            [sys.executable, '-c', RANK_SCRIPT, spec.ROOT, workload,
             str(seed), str(seconds), str(r), str(world)], env=env,
            stdout=subprocess.PIPE, text=True))
    reports = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=timeout)
            assert p.returncode == 0, p.returncode
            reports.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    bench, c, cfg, trf, kind = cell(workload)
    numbers, _ = cli.combine_numbers(kind, [r['partials'] for r in reports],
                                     trf['limits'])
    correct, _ = cli.verdict(numbers, trf['limits'])
    return reports, numbers, correct
