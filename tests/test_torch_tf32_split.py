"""The 3xTF32 arithmetic of enspara_tpu_torch's all-pairs QCP kernel
(``csrc/qcp_matrix.cu`` with ``csrc/mma_tf32.cuh``) emulated in torch on
the CPU, and held against the JAX package's ``qcp_rmsd_matrix``.

Each operand is split as the kernel splits it: ``hi = rna_tf32(x)``
(round to nearest, ties away from zero, onto the 11-bit significand of
TF32: half an ulp added to the magnitude, the low 13 bits cleared) and
``lo = rna_tf32(x - hi)``; each S component is then
``lo_f . hi_c + hi_f . lo_c + hi_f . hi_c`` summed in fp32, and the
port's QCP epilogue turns S into RMSDs. The result must hold the msd bar
of ``test_torch_port.assert_rmsd_close`` (rtol 1e-5 on the msd plus 16
ulp of gsum / n_atoms) against the JAX package with its Newton run to
convergence, self pairs included.
The emulation cannot show how the tensor cores round inside an mma;
``chip_smoke.py`` phase 4 and ``tests/test_torch_cuda_kernels.py`` hold
the kernel itself to the same bar on the card.
"""

import numpy as np
import pytest
import torch

from enspara_tpu.ops import qcp as jqcp

from enspara_tpu_torch.ops.qcp import rmsd_from_S_components_unrolled

from test_torch_port import assert_rmsd_close
from test_torch_port import jax_newton_converged  # noqa: F401

# the structures barely align: the JAX package runs its Newton to
# convergence, where 12 steps from u = 1 fall short (test_torch_port.py)
pytestmark = pytest.mark.usefixtures('jax_newton_converged')


@pytest.fixture(autouse=True)
def _one_thread():
    """Torch runs on one thread: the tier-1 run puts several test
    workers on one host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def rna_tf32(x):
    """float32 -> the nearest TF32 value (ties away from zero), as
    ``to_tf32`` of ``csrc/mma_tf32.cuh``."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split(x):
    hi = rna_tf32(x)
    return hi, rna_tf32(x - hi)


def rmsd_3xtf32(frames, centers, n_atoms, passes=3):
    """(F, C) RMSD of centered ``frames`` (F, A, 3) to ``centers``
    (C, A, 3) with the S components in emulated 3xTF32 (``passes=1``:
    hi . hi alone)."""
    fh, fl = split(frames)
    ch, cl = split(centers)

    def dot(a, b):
        return torch.einsum('fai,caj->ijfc', a, b)
    S = dot(fh, ch) if passes == 1 else \
        dot(fl, ch) + dot(fh, cl) + dot(fh, ch)
    gsum = (frames * frames).sum((1, 2))[:, None] \
        + (centers * centers).sum((1, 2))[None, :]
    return rmsd_from_S_components_unrolled(
        tuple(S[i, j] for i in range(3) for j in range(3)), gsum,
        float(n_atoms)).numpy()


def _centered(rng, n, a, scale=1.0):
    X = (scale * rng.normal(size=(n, a, 3))).astype(np.float32)
    return X - X.mean(axis=1, keepdims=True)


def _reference(frames, centers):
    """The JAX package's all-pairs RMSD and the msd bar's gsum bound."""
    Xc, gx = jqcp.center_coordinates(frames)
    Yc, gy = jqcp.center_coordinates(centers)
    ref = np.asarray(jqcp.qcp_rmsd_matrix(Xc, Yc, gx, gy))
    gsum = 2 * float(max(np.asarray(gx).max(), np.asarray(gy).max()))
    return ref, gsum


def test_rna_tf32_rounds_to_nearest_ties_away():
    one = torch.tensor([1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11),
                        1.0 + 2.0 ** -12, 1.0 + 3 * 2.0 ** -12, 0.0, -0.0])
    np.testing.assert_array_equal(
        rna_tf32(one).numpy(),
        np.float32([1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -10), 1.0,
                    1.0 + 2.0 ** -10, 0.0, -0.0]))
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=10_000).astype(np.float32) * 10.0 ** np.arange(-4, 6).repeat(
            1000).astype(np.float32))
    hi, lo = split(x)
    assert not (hi.view(torch.int32) & 0x1fff).any()
    assert not (lo.view(torch.int32) & 0x1fff).any()
    xd, hid, lod = x.double(), hi.double(), lo.double()
    assert ((xd - hid).abs() <= 2.0 ** -11 * xd.abs()).all()
    assert ((xd - hid - lod).abs() <= 2.0 ** -22 * xd.abs()).all()


def test_three_passes_keep_each_product_to_2_pow_minus_20():
    rng = np.random.default_rng(1)
    x, y = (torch.from_numpy(rng.normal(size=100_000).astype(np.float32))
            for _ in range(2))
    (xh, xl), (yh, yl) = split(x), split(y)
    got = (xl * yh + xh * yl + xh * yh).double()
    exact = x.double() * y.double()
    assert ((got - exact).abs() <= 2.0 ** -20 * exact.abs()).all()


@pytest.mark.parametrize('F,C,A', [(64, 64, 8), (320, 64, 61),
                                   (1024, 256, 64)])
def test_3xtf32_rmsd_within_msd_bar(F, C, A):
    rng = np.random.default_rng(F + C + A)
    frames = _centered(rng, F, A)
    centers = frames[rng.integers(0, F, C)] + 0.01 * _centered(rng, C, A)
    centers -= centers.mean(axis=1, keepdims=True)
    ref, gsum = _reference(frames, centers)
    got = rmsd_3xtf32(torch.from_numpy(frames), torch.from_numpy(centers), A)
    assert_rmsd_close(got, ref, gsum, A)


def test_3xtf32_self_pairs():
    """Centers taken exactly from the frames: the msd of a center's own
    frame cancels to within the floor of 0, and every frame's nearest
    center is its own."""
    rng = np.random.default_rng(7)
    F, C, A = 512, 64, 64
    base = _centered(rng, C, A)
    frames = base[np.arange(F) % C] + 0.01 * _centered(rng, F, A)
    frames -= frames.mean(axis=1, keepdims=True)
    centers = frames[:C].copy()
    ref, gsum = _reference(frames, centers)
    got = rmsd_3xtf32(torch.from_numpy(frames), torch.from_numpy(centers), A)
    assert_rmsd_close(got, ref, gsum, A)
    assert_rmsd_close(np.diag(got[:C]), np.zeros(C), gsum, A)
    np.testing.assert_array_equal(got.argmin(1), np.arange(F) % C)
    np.testing.assert_array_equal(got.argmin(1), ref.argmin(1))


def test_3xtf32_scaled_coordinates():
    """Coordinates x 100: the split's error is relative, so the bar
    (relative to gsum) holds at any scale."""
    rng = np.random.default_rng(11)
    F, C, A = 256, 64, 40
    frames = _centered(rng, F, A, scale=100.0)
    centers = frames[rng.integers(0, F, C)] + _centered(rng, C, A)
    centers -= centers.mean(axis=1, keepdims=True)
    ref, gsum = _reference(frames, centers)
    got = rmsd_3xtf32(torch.from_numpy(frames), torch.from_numpy(centers), A)
    assert_rmsd_close(got, ref, gsum, A)


def test_one_tf32_pass_misses_the_bar():
    """Why three passes: hi . hi alone (one TF32 pass, 2^-11 a product)
    leaves the msd far outside the bar."""
    rng = np.random.default_rng(3)
    F, C, A = 256, 64, 64
    frames = _centered(rng, F, A)
    centers = frames[rng.integers(0, F, C)] + 0.01 * _centered(rng, C, A)
    centers -= centers.mean(axis=1, keepdims=True)
    ref, gsum = _reference(frames, centers)
    got = rmsd_3xtf32(torch.from_numpy(frames), torch.from_numpy(centers), A,
                      passes=1)
    with pytest.raises(AssertionError, match='msd differs'):
        assert_rmsd_close(got, ref, gsum, A)
