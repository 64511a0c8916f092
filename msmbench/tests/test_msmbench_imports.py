"""The import check: a run that holds ``jax``, ``jaxlib``, ``flax`` or
``enspara_tpu`` (whole top-level names) reports nothing; the harness,
its references and job kinds load none of them; without a card, or in a
checkout without the program, a run fails and prints no result."""

import json
import os
import shutil
import subprocess
import sys
import types

import pytest

from msmbench.harness import cli, spec


def test_whole_top_level_names(monkeypatch):
    assert cli.forbidden_modules() == [] or 'enspara_tpu' not in \
        cli.forbidden_modules()
    monkeypatch.setitem(sys.modules, 'enspara_tpu_torch_like',
                        types.ModuleType('enspara_tpu_torch_like'))
    monkeypatch.setitem(sys.modules, 'jaxish', types.ModuleType('jaxish'))
    assert 'jaxish' not in cli.forbidden_modules()
    monkeypatch.setitem(sys.modules, 'jax.numpy',
                        types.ModuleType('jax.numpy'))
    monkeypatch.setitem(sys.modules, 'enspara_tpu.cluster',
                        types.ModuleType('enspara_tpu.cluster'))
    assert cli.forbidden_modules() == ['enspara_tpu', 'jax']


def test_emit_refuses_a_run_that_loaded_jax(monkeypatch, capsys):
    monkeypatch.setitem(sys.modules, 'jax', types.ModuleType('jax'))
    bench = spec.load_benchmark()
    cell = spec.workload(bench, 'lambda.khybrid-reassign-its')
    args = types.SimpleNamespace(trace=0)
    report = {'forbidden': [], 'n_jobs': 1}
    rc = cli.emit(bench, cell, args, report, {}, 0, {}, 1)
    out = capsys.readouterr()
    assert rc != 0 and out.out == '' and 'jax' in out.err


def test_harness_loads_no_jax_or_jax_package():
    """Every module of the benchmark and the program's entry points it
    drives, imported in a fresh process."""
    code = '''
import sys
sys.path.insert(0, %r)
from msmbench.harness import cli, spec
import os
for kind, load in (('jobs', spec.job_kind), ('metrics', spec.metric_reader),
                   ('roofline', spec.roofline)):
    for f in os.listdir(os.path.join(spec.BENCH_DIR, kind)):
        if f.endswith('.py'):
            load(f[:-3])
import msmbench.control, msmbench.witness
import msmbench.reference.qcp, msmbench.reference.pam
import enspara_tpu_torch.cluster, enspara_tpu_torch.apps.cluster
import enspara_tpu_torch.msm.eigen_device
print(sorted({m.split('.')[0] for m in sys.modules}
             & {'jax', 'jaxlib', 'flax', 'enspara_tpu'}))
''' % spec.ROOT
    out = subprocess.run([sys.executable, '-c', code], capture_output=True,
                         text=True, timeout=300, env=dict(
                             os.environ, JAX_PLATFORMS='cpu'))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == '[]'


def test_reference_imports_nothing_of_the_program():
    ref = os.path.join(spec.BENCH_DIR, 'reference')
    for name in os.listdir(ref):
        if name.endswith('.py'):
            with open(os.path.join(ref, name)) as fh:
                text = fh.read()
            assert 'enspara' not in text.replace('enspara docs', ''), name
            assert 'import jax' not in text, name


def _run(root, extra_env=None):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES='', **(extra_env or {}))
    return subprocess.run(
        [sys.executable, 'msmbench/run.py', '--workload',
         'lambda.khybrid-reassign-its', '--seed', '1', '--seconds', '1',
         '--trace', '0'], cwd=root, capture_output=True, text=True,
        timeout=300, env=env)


def test_no_card_no_result():
    out = _run(spec.ROOT)
    assert out.returncode != 0
    assert not [x for x in out.stdout.splitlines() if x.startswith('{')]


def test_checkout_without_the_program_fails(tmp_path):
    shutil.copy(os.path.join(spec.ROOT, 'BENCHMARK.json'), tmp_path)
    shutil.copytree(spec.BENCH_DIR, tmp_path / 'msmbench',
                    ignore=shutil.ignore_patterns('__pycache__'))
    out = _run(str(tmp_path))
    assert out.returncode != 0
    assert not [x for x in out.stdout.splitlines() if x.startswith('{')]
    assert 'program is missing' in out.stderr
