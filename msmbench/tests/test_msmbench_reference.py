"""The reference against ``enspara_tpu_torch`` at a tiny size on the
CPU: the harness drives each cell's job kind (the look for a card
skipped) and the judge finds the program correct; the frozen QCP RMSD
agrees with the port's plain QCP."""

import os

import numpy as np
import pytest
import torch

from msmbench.reference import qcp
from msmbench.tests import tiny


@pytest.fixture(autouse=True)
def on_cpu(monkeypatch):
    monkeypatch.setenv('ENSPARA_TPU_PLATFORM', 'cpu')
    torch.set_num_threads(2)


def test_frozen_qcp_agrees_with_the_port():
    from enspara_tpu_torch.ops.qcp import rmsd
    g = torch.Generator().manual_seed(0)
    X = torch.randn((50, 11, 3), generator=g)
    Y = X[:7] + 0.05 * torch.randn((7, 11, 3), generator=g)
    fr = qcp.Frames(X)
    cx, cg = qcp.center(Y)
    ref = qcp.rmsd_block(fr.x, fr.g, cx, cg)
    port = rmsd(X, Y).double()
    assert torch.allclose(ref ** 2, port ** 2, atol=1e-5)


def test_frozen_qcp_against_kabsch():
    from enspara_tpu_torch.ops.qcp import kabsch_rmsd_np
    g = torch.Generator().manual_seed(1)
    X = torch.randn((6, 9, 3), generator=g)
    fr = qcp.Frames(X)
    D = fr.rmsd(slice(None), torch.arange(6)).numpy()
    for i in range(6):
        for j in range(6):
            # squares: a float64 self-distance is the root of rounding
            assert D[i, j] ** 2 == pytest.approx(
                kabsch_rmsd_np(X[i].numpy(), X[j].numpy()) ** 2, abs=1e-12)


@pytest.mark.parametrize('workload,seed', [
    ('lambda.khybrid-reassign-its', 3),
    ('lambda.khybrid-reassign-its', 2 ** 31 + 5),
    ('ntl9.kcenters-msm-nccl4', 4),
])
def test_program_judged_correct(workload, seed):
    report, numbers, correct = tiny.run(workload, seed=seed)
    assert report['n_jobs'] == 1 and not report['forbidden']
    assert correct, numbers


def test_four_processes_over_gloo_judged_correct():
    reports, numbers, correct = tiny.run_ranks('ntl9.kcenters-msm-nccl4',
                                               world=4, seed=6)
    assert correct, numbers
    # every rank ran the same jobs; rank 0 alone holds the MSM's numbers
    assert len({r['n_jobs'] for r in reports}) == 1
    assert 'its_gap' in reports[0]['partials'][0]
    assert 'its_gap' not in reports[1]['partials'][0]


def test_judge_reads_every_frame_of_its_stripe():
    from msmbench.reference import kcenters as ref_kc
    g = torch.Generator().manual_seed(2)
    X = torch.randn((300, 5, 3), generator=g)
    fr = qcp.Frames(X)
    centers = np.array([0, 17, 150])
    cx, cg = fr.x[centers], fr.g[centers]
    D = fr.rmsd(slice(None), torch.as_tensor(centers))
    labels = D.argmin(dim=1).numpy()
    dists = D.min(dim=1).values.numpy()
    ok = ref_kc.judge_stripe(fr, 0, (centers, cx, cg), labels, dists,
                             picks=False)
    assert ok['label_gap'] == 0 and ok['dist_gap'] < 1e-12
    labels[299] = (labels[299] + 1) % 3
    bad = ref_kc.judge_stripe(fr, 0, (centers, cx, cg), labels, dists,
                              picks=False)
    assert bad['label_gap'] > 1e-3 and bad['dist_gap'] > 1e-3


def test_traced_run_reads_its_spans():
    """A traced run on the CPU: the spans' metrics are read; those that
    need the card's timeline find nothing and are left out."""
    report, numbers, correct = tiny.run('lambda.khybrid-reassign-its',
                                        seed=11, trace=1)
    assert correct, numbers
    m = report['trace_metrics']
    assert report['n_jobs'] == 2
    assert {'cluster.ms', 'assign.ms', 'msm.ms'} <= set(m)
    assert 'assign.roofline' not in m and 'device.idle' not in m
    assert all(v['value'] > 0 for v in m.values())
    assert report['window_s'] > 0 and report['busy_s'] == 0
