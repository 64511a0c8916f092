"""Finding the benchmark's parts by name.

``BENCHMARK.json`` at the checkout's root names the cells and metrics;
everything that belongs to one configuration, traffic mix, job kind,
per-layer metric or roofline is a file of its own under ``msmbench/``,
found by the name the cell or metric gives:

- ``configs/<config>.json``: the deployment's sizes and guarantees;
- ``traffic/<traffic>.json``: the job kind (``"job"``), its parameters
  and the limits of the output check;
- ``jobs/<job>.py``: the job kind's code (set-up, one job, the judge);
- ``metrics/<metric>.py``: the reader of one per-layer metric;
- ``roofline/<metric>.py``: the operation and byte count of a roofline.

Adding a cell, a metric or a configuration is adding files: nothing
here names one.
"""

import importlib.util
import json
import os

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


def _read_json(path):
    with open(path) as fh:
        return json.load(fh)


def load_benchmark(root=ROOT):
    return _read_json(os.path.join(root, 'BENCHMARK.json'))


def workload(bench, name):
    for w in bench['workloads']:
        if w['name'] == name:
            return w
    raise KeyError('no workload %r in BENCHMARK.json (have %s)'
                   % (name, ', '.join(w['name'] for w in bench['workloads'])))


def config(name, bench_dir=BENCH_DIR):
    return _read_json(os.path.join(bench_dir, 'configs', name + '.json'))


def traffic(name, bench_dir=BENCH_DIR):
    return _read_json(os.path.join(bench_dir, 'traffic', name + '.json'))


def _load_module(kind, name, bench_dir):
    path = os.path.join(bench_dir, kind, name + '.py')
    mod_name = 'msmbench_%s_%s' % (kind, name.replace('.', '_')
                                   .replace('-', '_'))
    spec = importlib.util.spec_from_file_location(mod_name, path)
    if spec is None or not os.path.exists(path):
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def job_kind(name, bench_dir=BENCH_DIR):
    return _load_module('jobs', name, bench_dir)


def metric_reader(name, bench_dir=BENCH_DIR):
    return _load_module('metrics', name, bench_dir)


def roofline(name, bench_dir=BENCH_DIR):
    return _load_module('roofline', name, bench_dir)


def end_to_end(bench, workload_name):
    """The end-to-end metrics this cell reports (those without a
    ``workloads`` list are every cell's)."""
    return [m for m in bench['end_to_end']
            if workload_name in m.get('workloads', [workload_name])]


def per_layer(bench, workload_name):
    """The per-layer metrics this cell reports: those that list it, and
    those without a list whose end-to-end metric the cell reports."""
    e2e = {m['name'] for m in end_to_end(bench, workload_name)}
    out = []
    for m in bench['per_layer']:
        if 'workloads' in m:
            if workload_name in m['workloads']:
                out.append(m)
        elif m['moves'] in e2e:
            out.append(m)
    return out
