"""Each fault that a cell can have, planted under the timed path at a
tiny size on the CPU, makes the judge's ``correct`` false; so does the
control, the reference one precision down in the program's place."""

import types

import numpy as np
import pytest
import torch

from msmbench.tests import tiny

LAMBDA = 'lambda.khybrid-reassign-its'
NTL9 = 'ntl9.kcenters-msm-nccl4'


@pytest.fixture(autouse=True)
def on_cpu(monkeypatch):
    monkeypatch.setenv('ENSPARA_TPU_PLATFORM', 'cpu')
    torch.set_num_threads(2)


def _wrapped(workload, change):
    """The cell's job kind with ``change(out, state)`` applied to each
    job's output where it is produced."""
    real = tiny.cell(workload)[-1]
    kind = types.SimpleNamespace(**{k: getattr(real, k) for k in (
        'setup', 'judge', 'numbers')})

    def run(s, rs, spans):
        out = real.run(s, rs, spans)
        change(out, s)
        return out
    kind.run = run
    return kind


def test_pam_state_left_unchanged(monkeypatch):
    import importlib
    km = importlib.import_module('enspara_tpu_torch.cluster.engine_kmedoids')

    def unchanged(X, metric, assignments, distances, medoid_inds, **kw):
        return (np.asarray(medoid_inds, np.int64),
                np.asarray(distances, np.float64),
                np.asarray(assignments, np.int64))
    monkeypatch.setattr(km, 'kmedoids_sweeps_device', unchanged)
    _, numbers, correct = tiny.run(LAMBDA)
    assert not correct and numbers['cluster_cost_gap'] > 1e-2


def test_half_of_the_frames_left_out(monkeypatch):
    import importlib
    eng = importlib.import_module('enspara_tpu_torch.cluster.engine')
    real = eng.assign_device

    def half(X, centers, metric='euclidean', **kw):
        if not isinstance(X, torch.Tensor):     # the k-centers warm start
            return real(X, centers, metric, **kw)
        n = X.shape[0]
        a, d = real(X[:n // 2], centers, metric, **kw)
        return (np.concatenate([a, np.zeros(n - n // 2, a.dtype)]),
                np.concatenate([d, np.full(n - n // 2, d.mean())]))
    monkeypatch.setattr(eng, 'assign_device', half)
    _, numbers, correct = tiny.run(LAMBDA)
    assert not correct and numbers['assign_label_gap'] > 1e-3


@pytest.mark.parametrize('workload,key', [(LAMBDA, 'labels'),
                                          (NTL9, 'labels')])
def test_one_answer_altered(workload, key):
    def alter(out, s):
        out[key] = out[key].copy()
        out[key][len(out[key]) // 3] += 1
    _, numbers, correct = tiny.run(workload, kind=_wrapped(workload, alter))
    assert not correct


def test_exchange_between_shards_left_out(monkeypatch):
    from enspara_tpu_torch.parallel import FrameMesh

    def lead_only(self, tensors, op='sum'):
        return tensors[0].to(self.lead).clone()
    monkeypatch.setattr(FrameMesh, 'reduce', lead_only)
    mesh = FrameMesh(['cpu'] * 4)
    _, numbers, correct = tiny.run(NTL9, mesh=mesh)
    assert not correct


def test_four_shards_without_a_fault_are_correct():
    from enspara_tpu_torch.parallel import FrameMesh
    _, numbers, correct = tiny.run(NTL9, mesh=FrameMesh(['cpu'] * 4))
    assert correct, numbers


@pytest.mark.parametrize('workload', [LAMBDA, NTL9])
def test_control_is_not_correct(workload):
    """TF32 products and a bfloat16 MSM in the program's place fail the
    judge (here TF32 rounding is emulated on the CPU operands, as the
    tensor cores take them)."""
    real = tiny.cell(workload)[-1]
    kind = types.SimpleNamespace(setup=real.setup, judge=real.judge,
                                 numbers=real.numbers)
    kind.run = lambda s, rs, spans: real.control(s, rs)
    _, numbers, correct = tiny.run(workload, kind=kind)
    assert not correct, numbers
