"""enspara_tpu_torch.ops.qcp held against enspara_tpu.ops.qcp and the
float64 Kabsch/SVD oracle, on the same numpy inputs.

Bars: against the JAX functions rtol 1e-5, atol 1e-6 where the RMSD is
far from zero (both fp32, another summation order); against the oracle
the bars of tests/test_qcp.py. On structures that barely align the JAX
package runs its Newton to convergence (``jax_newton_converged``): the
port starts Newton from an upper bound near the root, the JAX package
from u = 1, where 12 steps fall short for such pairs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

from enspara_tpu.ops import qcp as jqcp

from enspara_tpu_torch.ops import qcp

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


def random_structs(rng, n_structs, n_atoms, scale=1.0):
    return (rng.normal(size=(n_structs, n_atoms, 3)) * scale) \
        .astype(np.float32)


def rotate(xyz, rng):
    """A random proper rotation plus a translation."""
    q = rng.normal(size=4)
    q /= np.linalg.norm(q)
    w, x, y, z = q
    R = np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
        [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
        [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
    ])
    return xyz @ R.T + rng.normal(size=3)


def test_center_and_prepare_match_jax():
    X = random_structs(np.random.default_rng(0), 7, 13) + 3.0
    c, g = qcp.center_coordinates(X)
    jc, jg = jqcp.center_coordinates(X)
    assert_allclose(c.numpy(), np.asarray(jc), rtol=1e-5, atol=1e-6)
    assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-5, atol=1e-6)
    p, pg, n = qcp.prepare_structures(X, n_atoms_pad=16)
    jp, jpg, jn = jqcp.prepare_structures(X, n_atoms_pad=16)
    assert n == jn == 13 and tuple(p.shape) == (7, 16, 3)
    assert_allclose(p.numpy(), np.asarray(jp), rtol=1e-5, atol=1e-6)
    assert (p.numpy()[:, 13:] == 0).all()


@pytest.mark.usefixtures('jax_newton_converged')
@pytest.mark.parametrize('shape', ['vector', 'matrix'])
def test_rmsd_matches_jax_and_oracle(shape):
    """Unit-normal structures, which barely align: the JAX package with
    its Newton run to convergence (from u = 1, 12 steps fall short)."""
    rng = np.random.default_rng(1)
    frames = random_structs(rng, 12, 37)
    refs = random_structs(rng, 1 if shape == 'vector' else 5, 37)
    ref = refs[0] if shape == 'vector' else refs
    got = qcp.rmsd(frames, ref).numpy()
    assert_allclose(got, np.asarray(jqcp.rmsd(frames, ref)), rtol=1e-5,
                    atol=1e-6)
    want = np.array([[jqcp.kabsch_rmsd_np(f, r) for r in refs]
                     for f in frames])
    assert_allclose(got.reshape(want.shape), want, rtol=1e-4, atol=1e-4)


def test_rmsd_zero_for_rotated_copy():
    rng = np.random.default_rng(2)
    A = random_structs(rng, 1, 50)[0]
    B = rotate(A, rng).astype(np.float32)
    d = qcp.rmsd(A[None], B).numpy()
    assert d.shape == (1,) and d[0] < 5e-3


def test_rmsd_similar_structures():
    rng = np.random.default_rng(3)
    A = random_structs(rng, 1, 64)[0]
    perturbed = np.stack([
        rotate(A + rng.normal(size=A.shape) * eps, rng)
        for eps in (1e-3, 1e-2, 0.1)]).astype(np.float32)
    got = qcp.rmsd(perturbed, A).numpy()
    want = np.array([jqcp.kabsch_rmsd_np(p, A) for p in perturbed])
    assert_allclose(got, want, rtol=1e-3, atol=5e-5)


def test_atom_padding_is_exact():
    rng = np.random.default_rng(4)
    frames = random_structs(rng, 6, 30)
    refs = random_structs(rng, 3, 30)
    plain = qcp.rmsd(frames, refs).numpy()
    fc, gf, n = qcp.prepare_structures(frames, n_atoms_pad=64)
    rc, gr, _ = qcp.prepare_structures(refs, n_atoms_pad=64)
    padded = qcp.qcp_rmsd_matrix(fc, rc, gf, gr, n_atoms=n).numpy()
    assert_allclose(plain, padded, rtol=1e-5, atol=1e-6)
    jfc, jgf, _ = jqcp.prepare_structures(frames, n_atoms_pad=64)
    jrc, jgr, _ = jqcp.prepare_structures(refs, n_atoms_pad=64)
    assert_allclose(padded, np.asarray(jqcp.qcp_rmsd_matrix(
        jfc, jrc, jgf, jgr, n_atoms=n)), rtol=1e-5, atol=1e-6)


def test_precentered_flag():
    rng = np.random.default_rng(5)
    frames = random_structs(rng, 4, 25)
    refs = random_structs(rng, 2, 25)
    fc, _ = qcp.center_coordinates(frames)
    rc, _ = qcp.center_coordinates(refs)
    assert_allclose(qcp.rmsd(frames, refs).numpy(),
                    qcp.rmsd(fc, rc, precentered=True).numpy(),
                    rtol=1e-5, atol=1e-6)


def test_degenerate_zero_g_structures():
    """G = 0 structures: the lambda0 clamp keeps the scaled quartic
    finite (no 0 * inf = NaN)."""
    X = np.zeros((6, 1, 3), np.float32)
    g = np.zeros(6, np.float32)
    d = qcp.qcp_rmsd_matrix(X, X[:2], g, g[:2]).numpy()
    assert np.all(np.isfinite(d))
    assert_allclose(d, 0.0, atol=1e-6)
    Sc = tuple(torch.zeros((1, 4)) for _ in range(9))
    out = qcp.rmsd_from_S_components_unrolled(Sc, torch.zeros((1, 4)), 1.0)
    assert torch.isfinite(out).all()


def test_epilogue_matches_jax():
    """The Newton epilogue alone, on S components and G sums of real
    structure pairs: the same operations as the JAX form with exact
    division."""
    rng = np.random.default_rng(6)
    A = random_structs(rng, 64, 20)
    B = random_structs(rng, 64, 20) + 0.5 * A
    A -= A.mean(1, keepdims=True)
    B -= B.mean(1, keepdims=True)
    S = np.einsum('fni,fnj->ijf', A, B).astype(np.float32)
    gsum = ((A * A).sum((1, 2)) + (B * B).sum((1, 2))).astype(np.float32)
    Sc = [S[i, j] for i in range(3) for j in range(3)]
    got = qcp.rmsd_from_S_components_unrolled(
        tuple(torch.from_numpy(s) for s in Sc), torch.from_numpy(gsum),
        20.0).numpy()
    want = np.asarray(jqcp.rmsd_from_S_components_unrolled(
        tuple(jnp.asarray(s) for s in Sc), jnp.asarray(gsum), 20.0))
    assert_allclose(got, want, rtol=1e-6, atol=1e-6)
