"""The all-pairs QCP RMSD block of enspara_tpu_torch (ops/qcp_matrix.py)
held against the JAX package's TPU kernel, ``qcp_rmsd_matrix_pallas``,
run in interpret mode on the CPU.

The same seeded numpy structures go through both: the port's
``pairwise_rmsd`` (which pads to the kernel's contract and, on the CPU,
takes the plain version) and ``qcp_rmsd_matrix_pallas(...,
interpret=True)``; and the padded arguments of the JAX ``_call_pallas``
cross to the port's inputs through ``convert.qcp_inputs_from_pallas``,
so both sides compute the same padded block. Distances are held on the
msd bar of test_torch_port.py (rtol 1e-5 on the msd plus 16 ulp of
gsum / n_atoms); the argmin over centers is equal. Where the structures
barely align (random centers), the JAX package runs its Newton to
convergence (``jax_newton_converged``): 12 steps from u = 1 fall short
there, and the port starts from an upper bound near the root.

The CUDA kernel against the plain version is in test_torch_port.py
(marker ``cuda``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from enspara_tpu.ops import qcp as jqcp
from enspara_tpu.ops.qcp_pallas import _call_pallas, qcp_rmsd_matrix_pallas

from enspara_tpu_torch import convert
from enspara_tpu_torch.ops import qcp_matrix
from enspara_tpu_torch.ops.qcp import kabsch_rmsd_np

from test_torch_port import assert_rmsd_close
from test_torch_port import jax_newton_converged  # noqa: F401


@pytest.fixture(autouse=True)
def _cpu_platform(monkeypatch):
    """Host inputs run on the CPU in these tests: with no device named,
    the port sends them to the card. Torch runs on one thread: the
    tier-1 run puts several test workers on one host's cores."""
    monkeypatch.setenv('ENSPARA_TPU_PLATFORM', 'cpu')
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _structures(rng, n, a, scale=1.0):
    X = (scale * rng.normal(size=(n, a, 3))).astype(np.float32)
    return X - X.mean(axis=1, keepdims=True)


@pytest.mark.usefixtures('jax_newton_converged')
@pytest.mark.parametrize('C', [1, 37, 64, 300])
def test_pairwise_matches_pallas(C):
    rng = np.random.default_rng(C)
    F, A = 300, 13                     # F not a multiple of 256, A of 8
    frames = _structures(rng, F, A)
    centers = frames[rng.integers(0, F, C)] \
        + 0.05 * _structures(rng, C, A)
    centers -= centers.mean(axis=1, keepdims=True)
    ref = np.asarray(qcp_rmsd_matrix_pallas(frames, centers,
                                            interpret=True))
    port = qcp_matrix.pairwise_rmsd(frames, centers).numpy()
    assert port.shape == ref.shape == (F, C)
    gsum = 2 * float(max((frames ** 2).sum((1, 2)).max(),
                         (centers ** 2).sum((1, 2)).max()))
    assert_rmsd_close(port, ref, gsum, A)
    np.testing.assert_array_equal(port.argmin(axis=1), ref.argmin(axis=1))


@pytest.mark.parametrize('F,C,A', [(512, 64, 8), (256, 512, 5)])
def test_padded_block_matches_call_pallas(F, C, A):
    """The whole padded block in the JAX kernel's layout: the real pairs
    against float64 Kabsch (at 5 and 8 atoms some pairs lie near a
    double root of the quartic, where a float32 Newton, the JAX
    kernel's too, holds the root only to ~2e-4 in msd), the padding
    rows and columns against their exact value."""
    rng = np.random.default_rng(F + C + A)
    Fr, Cr, Np = F - 17, C - 5, 128
    frames = _structures(rng, Fr, A, 2.0)
    centers = _structures(rng, Cr, A, 2.0)
    ft = np.zeros((3, F, Np), np.float32)
    ft[:, :Fr, :A] = frames.transpose(2, 0, 1)
    ct = np.zeros((3, C, Np), np.float32)
    ct[:, :Cr, :A] = centers.transpose(2, 0, 1)
    gf = np.ones((F, 1), np.float32)
    gf[:Fr, 0] = (frames ** 2).sum((1, 2))
    gc = np.ones((C, 1), np.float32)
    gc[:Cr, 0] = (centers ** 2).sum((1, 2))
    ref = np.asarray(_call_pallas(jnp.asarray(ft), jnp.asarray(ct),
                                  jnp.asarray(gf), jnp.asarray(gc), A,
                                  interpret=True))
    ins = [torch.from_numpy(x) for x in
           convert.qcp_inputs_from_pallas(ft, ct, gf, gc)]
    assert tuple(ins[0].shape) == (3 * Np, F)
    assert tuple(ins[2].shape) == (3 * Np, C)
    before = qcp_matrix.qcp_rmsd_matrix_kernel.n_launches
    port = qcp_matrix.qcp_rmsd_matrix_block(*ins, A).numpy()
    assert qcp_matrix.qcp_rmsd_matrix_kernel.n_launches == before
    assert port.shape == ref.shape == (F, C)
    gsum = 2 * float(max(gf.max(), gc.max()))
    assert_rmsd_close(port[:Fr, :Cr],
                      kabsch_rmsd_np(frames[:, None], centers[None]), gsum, A)
    # padding rows and columns hold zero coordinates (S = 0, so
    # lambda_max = 0): the msd is (gf + gc) / A, which the port's start
    # (u0 = 0) reaches and Newton from u = 1 does not (a quadruple root
    # at 0, where each step takes a quarter off u)
    pad = np.ones((F, C), bool)
    pad[:Fr, :Cr] = False
    exact = np.sqrt((gf.astype(np.float64) + gc[:, 0]) / A)
    assert_rmsd_close(port[pad], exact[pad], gsum, A)


@pytest.mark.usefixtures('jax_newton_converged')
def test_plain_matches_xla_matrix(monkeypatch):
    """The plain version against the JAX XLA path (ops/qcp.py) on
    identical structures, self-distances 0 within the floor; its frame
    slabs change nothing."""
    rng = np.random.default_rng(5)
    X = _structures(rng, 70, 9)
    Xc, g = jqcp.center_coordinates(X)
    ref = np.asarray(jqcp.qcp_rmsd_matrix(Xc, Xc[:20], g, g[:20]))
    port = qcp_matrix.pairwise_rmsd(X, X[:20]).numpy()
    gsum = 2 * float(np.asarray(g).max())
    assert_rmsd_close(port, ref, gsum, 9)
    assert_rmsd_close(np.diag(port[:20]), np.zeros(20), gsum, 9)

    fr, gf = qcp_matrix.to_layout(_structures(rng, 200, 10), 256)
    cr, gc = qcp_matrix.to_layout(_structures(rng, 30, 10), 64)
    whole = qcp_matrix.qcp_rmsd_matrix_plain(fr, gf, cr, gc, 10)
    monkeypatch.setattr(qcp_matrix, '_PLAIN_PAIRS', 64 * 64)
    slabs = qcp_matrix.qcp_rmsd_matrix_plain(fr, gf, cr, gc, 10)
    np.testing.assert_array_equal(slabs.numpy(), whole.numpy())


def test_padding_contract():
    assert [qcp_matrix.pad_frames(n) for n in (1, 256, 257)] == \
        [256, 256, 512]
    assert [qcp_matrix.pad_centers(c) for c in (1, 64, 65, 255, 256, 300)] \
        == [64, 64, 128, 256, 256, 512]
    fr, g = qcp_matrix.to_layout(np.ones((3, 5, 3), np.float32), 64)
    assert tuple(fr.shape) == (24, 64) and tuple(g.shape) == (64,)
    assert (g[3:] == 1.0).all() and (g[:3] == 5 * 3).all()
    assert (fr.view(3, 8, 64)[:, 5:] == 0).all()
    assert (fr[:, 3:] == 0).all()


def _inputs(F=64, C=64, rows=24):
    return (torch.zeros(rows, F), torch.ones(F), torch.zeros(rows, C),
            torch.ones(C))


@pytest.mark.parametrize('bad', ['rows', 'F', 'C', 'float64', 'g_shape',
                                 'strided', 'device', 'meta'])
def test_block_rejects_what_the_kernel_does_not_take(bad):
    fr, gf, cr, gc = _inputs()
    if bad == 'rows':
        fr, cr = fr[:21], cr[:21]
    elif bad == 'F':
        fr, gf = _inputs(F=96)[:2]
    elif bad == 'C':
        cr, gc = _inputs(C=32)[2:]
    elif bad == 'float64':
        fr = fr.double()
    elif bad == 'g_shape':
        gf = gf[None]
    elif bad == 'strided':
        cr = torch.zeros(24, 128)[:, ::2]
    elif bad == 'device':
        gc = gc.to('meta')
    elif bad == 'meta':
        fr, gf, cr, gc = (t.to('meta') for t in (fr, gf, cr, gc))
    with pytest.raises(ValueError):
        qcp_matrix.qcp_rmsd_matrix_block(fr, gf, cr, gc, 8)


def test_kernel_wrapper_refuses_cpu_tensors():
    with pytest.raises(ValueError, match='CUDA'):
        qcp_matrix.qcp_rmsd_matrix_kernel(*_inputs(), 8)
