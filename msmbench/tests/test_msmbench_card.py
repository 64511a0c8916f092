"""On the card (``cuda``): the program's assignment (kernel 5) against
the frozen reference at a small size, and the reference's TF32 control
far outside the judge's limit; skipped where torch sees no card."""

import numpy as np
import pytest
import torch

from msmbench.data import basins
from msmbench.reference import kcenters as ref_kc
from msmbench.reference.qcp import Frames


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    return torch.device('cuda', 0)


@pytest.mark.cuda
def test_assignment_on_the_card_against_the_reference(card):
    from enspara_tpu_torch.cluster.engine import assign_device
    X = basins.frames(2 ** 31 + 9, 50_000, 80, n_basins=200, dwell=64,
                      noise=0.02, device=card)
    idx = np.arange(0, 50_000, 500)
    labels, dists = assign_device(X, X[idx].cpu().numpy(), metric='rmsd')
    fr = Frames(X)
    part = ref_kc.judge_stripe(fr, 0, (idx, fr.x[idx], fr.g[idx]), labels,
                               dists, picks=False)
    assert part['label_gap'] < 3e-5 and part['dist_gap'] < 1.5e-4, part
    tf32 = Frames(X, dtype=torch.float32, tf32=True)
    d = tf32.rmsd(slice(None), torch.as_tensor(idx, device=card))
    ctl = ref_kc.judge_stripe(fr, 0, (idx, fr.x[idx], fr.g[idx]),
                              d.argmin(dim=1).cpu().numpy(),
                              d.min(dim=1).values.double().cpu().numpy(),
                              picks=False)
    assert ctl['dist_gap'] > 1.5e-4, ctl
