"""Theobald QCP RMSD in PyTorch (counterpart of ``enspara_tpu/ops/qcp.py``).

RMSD comes from the largest eigenvalue lambda_max of the QCP key matrix,
``rmsd = sqrt(max(0, ga + gb - 2*lambda_max) / n_atoms)``; lambda_max is
the largest root of a quartic, found by Newton on the scaled variable
``u = lambda / lambda0`` with ``lambda0 = (ga + gb) / 2`` so every
quantity stays O(1). Theobald (2005), Acta Cryst. A61 478-480; Liu,
Agrafiotis & Theobald (2010), J. Comput. Chem. 31 1561-1563.

Everything here is plain torch on any device and in float32, with the
same operation order as the JAX module but for Newton's start. The
CUDA kernels inline the same epilogue (``csrc/qcp_rmsd.cuh``).

Newton's start. The JAX module starts from ``u = 1`` (lambda0 bounds
lambda_max from above); for structures that barely align, 12 steps from
there stop short of the root, by up to ~0.08 in msd on unit-normal
structures, and farthest-first k-centers picks exactly such pairs.
Here Newton starts from ``u0 = min(1, START_MARGIN * sqrt(3) |S|_F /
lambda0)``. lambda_max is at most the nuclear norm of S, at most
``sqrt(3) |S|_F``, and at least S's largest singular value, so ``u0``
lies above the largest root and within a factor 3 * 1.01 of it; Newton
from above the largest root of a polynomial with real roots falls to
it monotonically. The margin keeps the rounded bound above the root
where it is tight (equal singular values: rotated cube or octahedron
vertices). Each step divides ``p + TINY``: a converged root leaves
``p = 0``, which sends the kernels' exact division to its slow path;
``TINY`` lies below half an ulp of any ``p`` whose step moves ``u``.

Near a double root (a reflection whose two smaller singular values
nearly agree) Newton only halves its error a step, and the float32
coefficients hold the root only to ~1e-4 in msd, whatever the steps: two
float32 sums of the same S then disagree by that much. Such a pair
(``|p'(u)| < NEAR_DOUBLE u^3``, about 5e-5 of unit-normal pairs) is
finished in float64 from the same S, where the key matrix's eigenvalue
is as well conditioned as S: here, and in the all-pairs kernel's library
by a second kernel (``csrc/qcp_matrix.cu :: qcp_matrix_kernel_finish``). The
k-centers kernels and their plain versions take no such finish
(``float64_finish=False``): a pair near a double root is rarely a
frame's nearest or its farthest. Where ``u0`` clamps to 1 and the root
is not near a double one (well-aligned pairs) the arithmetic is the JAX
module's, bit for bit.
"""

import numpy as np
import torch

from ..citation import cite
from ..util.device import full_fp32_matmul

__all__ = [
    'center_coordinates', 'qcp_rmsd_matrix', 'qcp_rmsd_vector',
    'rmsd', 'prepare_structures', 'rmsd_from_S_components_unrolled',
    'kabsch_rmsd_np', 'NEWTON_ITERS',
]

NEWTON_ITERS = 12
# Newton's start over the bound sqrt(3) |S|_F / lambda0, and what each
# step adds to p before it divides (module docstring)
START_MARGIN = 1.01
TINY = 1e-30
# a root with |p'(u)| below NEAR_DOUBLE * u^3 lies near a double root;
# the all-pairs path finishes its pair in float64, FLOAT64_ITERS steps
# from the bound
NEAR_DOUBLE = 0.03
FLOAT64_ITERS = 24


def _f32(x):
    return torch.as_tensor(x, dtype=torch.float32)


def _einsum_fp32(equation, a, b):
    """``torch.einsum`` in full float32: TF32 keeps about three decimal
    digits, far outside the 1e-5 distance bar."""
    with full_fp32_matmul():
        return torch.einsum(equation, a, b)


def center_coordinates(xyz):
    """Remove the centroid from each structure.

    ``xyz`` is (..., n_atoms, 3). Returns ``(centered, g)`` with ``g``
    (...,) the sum of squared centered coordinates (the QCP G value).
    """
    xyz = _f32(xyz)
    centered = xyz - xyz.mean(dim=-2, keepdim=True)
    g = (centered * centered).sum(dim=(-2, -1))
    return centered, g


def _poly_coeffs_scaled_components(Sc, lam0):
    """Quartic coefficients ``(c2, c1, c0)`` of ``u^4 + c2 u^2 + c1 u +
    c0`` from the nine inner-product components, scaled by lambda0, and
    Newton's start ``u0``."""
    (Sxx, Sxy, Sxz, Syx, Syy, Syz, Szx, Szy, Szz) = Sc

    Sxx2, Sxy2, Sxz2 = Sxx * Sxx, Sxy * Sxy, Sxz * Sxz
    Syx2, Syy2, Syz2 = Syx * Syx, Syy * Syy, Syz * Syz
    Szx2, Szy2, Szz2 = Szx * Szx, Szy * Szy, Szz * Szz

    fnorm2 = (Sxx2 + Sxy2 + Sxz2 + Syx2 + Syy2 + Syz2
              + Szx2 + Szy2 + Szz2)
    det = (Sxx * (Syy * Szz - Syz * Szy)
           - Sxy * (Syx * Szz - Syz * Szx)
           + Sxz * (Syx * Szy - Syy * Szx))

    C2 = -2.0 * fnorm2
    C1 = -8.0 * det

    SxzpSzx = Sxz + Szx
    SxzmSzx = Sxz - Szx
    SyzpSzy = Syz + Szy
    SyzmSzy = Syz - Szy
    SxypSyx = Sxy + Syx
    SxymSyx = Sxy - Syx
    SxxpSyy = Sxx + Syy
    SxxmSyy = Sxx - Syy

    D = (Sxy2 + Sxz2 - Syx2 - Szx2)
    D = D * D
    E = ((-Sxx2 + Syy2 + Szz2 + Syz2 + Szy2)
         - 2.0 * (Syy * Szz - Syz * Szy)) \
        * ((-Sxx2 + Syy2 + Szz2 + Syz2 + Szy2)
           + 2.0 * (Syy * Szz - Syz * Szy))
    F = (-(SxzpSzx) * (SyzmSzy) + (SxymSyx) * (SxxmSyy - Szz)) \
        * (-(SxzmSzx) * (SyzpSzy) + (SxymSyx) * (SxxmSyy + Szz))
    G = (-(SxzpSzx) * (SyzpSzy) - (SxypSyx) * (SxxpSyy - Szz)) \
        * (-(SxzmSzx) * (SyzmSzy) - (SxypSyx) * (SxxpSyy + Szz))
    H = ((SxypSyx) * (SyzpSzy) + (SxzpSzx) * (SxxmSyy + Szz)) \
        * (-(SxymSyx) * (SyzmSzy) + (SxzpSzx) * (SxxpSyy + Szz))
    I = ((SxypSyx) * (SyzmSzy) + (SxzmSzx) * (SxxmSyy - Szz)) \
        * (-(SxymSyx) * (SyzpSzy) + (SxzmSzx) * (SxxpSyy - Szz))
    C0 = D + E + F + G + H + I

    # the clamp keeps inv**4 finite in fp32: G = 0 structures (all
    # identical atoms, single atoms) would otherwise give 0 * inf = NaN
    inv = 1.0 / torch.clamp(lam0, min=1e-9)
    inv2 = inv * inv
    u0 = torch.clamp(START_MARGIN * torch.sqrt(3.0 * fnorm2) * inv, max=1.0)
    return C2 * inv2, C1 * inv2 * inv, C0 * inv2 * inv2, u0


def _newton_steps(u, c2, c1, c0, n):
    """``n`` Newton steps on ``u^4 + c2 u^2 + c1 u + c0``, each clipped
    to +-0.5, with exact division of ``p + TINY``."""
    for _ in range(n):
        u2 = u * u
        p = u2 * u2 + c2 * u2 + c1 * u + c0
        dp = u * (4.0 * u2 + 2.0 * c2) + c1
        dp = torch.where(dp.abs() < 1e-12, torch.full_like(dp, 1e-12), dp)
        u = u - torch.clamp((p + TINY) / dp, -0.5, 0.5)
    return u


def _near_double_root(u, c2, c1):
    """Where Newton's ``u`` lies near a double root of the quartic: the
    float32 coefficients then hold the root only to ~1e-4 in msd."""
    u2 = u * u
    dp = u * (4.0 * u2 + 2.0 * c2) + c1
    return dp.abs() < NEAR_DOUBLE * u2 * u


def _rmsd_float64(Sc, gsum, n_atoms_real):
    """The epilogue in float64 (the pairs near a double root): the same
    coefficients, and FLOAT64_ITERS Newton steps from the bound."""
    Sc = tuple(s.double() for s in Sc)
    gsum = gsum.double()
    lam0 = gsum * 0.5
    c2, c1, c0, u0 = _poly_coeffs_scaled_components(Sc, lam0)
    u = torch.clamp(_newton_steps(u0, c2, c1, c0, FLOAT64_ITERS), 0.0, 1.0)
    return torch.sqrt(torch.clamp(gsum - 2.0 * u * lam0, min=0.0)
                      / n_atoms_real)


def rmsd_from_S_components_unrolled(Sc, gsum, n_atoms_real,
                                    float64_finish=True):
    """Nine inner-product components + G sums (``ga + gb``) -> RMSD,
    elementwise on tensors of one shape: 12 Newton steps from ``u0`` (at
    or above the largest root); with ``float64_finish`` (the all-pairs
    kernel's twin) a pair near a double root again in float64. The
    k-centers kernels' plain versions take ``float64_finish=False``, as
    their kernels do."""
    lam0 = gsum * 0.5
    c2, c1, c0, u0 = _poly_coeffs_scaled_components(Sc, lam0)
    u = _newton_steps(u0, c2, c1, c0, NEWTON_ITERS)
    out = torch.sqrt(torch.clamp(gsum - 2.0 * torch.clamp(u, 0.0, 1.0)
                                 * lam0, min=0.0) / n_atoms_real)
    if not float64_finish:
        return out
    near = _near_double_root(u, c2, c1)
    if bool(near.any()):
        gsum = torch.broadcast_to(gsum, out.shape)
        out[near] = _rmsd_float64(
            tuple(torch.broadcast_to(s, out.shape)[near] for s in Sc),
            gsum[near], n_atoms_real).to(out.dtype)
    return out


def qcp_rmsd_matrix(frames, centers, g_frames, g_centers, n_atoms=None):
    """All-pairs minimum RMSD between two sets of *pre-centered*
    structures: ``frames`` (F, N, 3), ``centers`` (C, N, 3), their G
    values (F,) and (C,). ``n_atoms`` is the real atom count when N
    includes zero padding rows. Returns (F, C) float32."""
    frames, centers = _f32(frames), _f32(centers)
    if n_atoms is None:
        n_atoms = frames.shape[-2]
    S = _einsum_fp32('fni,cnj->ijfc', frames, centers)
    Sc = tuple(S[i, j] for i in range(3) for j in range(3))
    gsum = _f32(g_frames)[:, None] + _f32(g_centers)[None, :]
    return rmsd_from_S_components_unrolled(Sc, gsum, float(n_atoms))


def qcp_rmsd_vector(frames, center, g_frames, g_center, n_atoms=None):
    """RMSD of every pre-centered frame (F, N, 3) to one center (N, 3).
    Returns (F,) float32."""
    frames, center = _f32(frames), _f32(center)
    if n_atoms is None:
        n_atoms = frames.shape[-2]
    S = _einsum_fp32('fni,nj->ijf', frames, center)
    Sc = tuple(S[i, j] for i in range(3) for j in range(3))
    gsum = _f32(g_frames) + _f32(g_center)
    return rmsd_from_S_components_unrolled(Sc, gsum, float(n_atoms))


def prepare_structures(xyz, n_atoms_pad=None):
    """Center structures and zero-pad the atom axis to ``n_atoms_pad``
    (exact for QCP: padding atoms add nothing to S or G). Returns
    ``(centered_padded, g, n_real_atoms)``."""
    xyz = _f32(xyz)
    n_real = xyz.shape[-2]
    centered, g = center_coordinates(xyz)
    if n_atoms_pad is not None and n_atoms_pad > n_real:
        centered = torch.nn.functional.pad(
            centered, (0, 0, 0, n_atoms_pad - n_real))
    return centered, g, n_real


@cite('qcp')
def rmsd(target_xyz, reference_xyz, precentered=False):
    """Minimum RMSD of each frame of ``target_xyz`` (F, N, 3) to one
    reference (N, 3), giving (F,), or to each of (C, N, 3), giving
    (F, C)."""
    target_xyz, reference_xyz = _f32(target_xyz), _f32(reference_xyz)
    if not precentered:
        target_xyz, g_t = center_coordinates(target_xyz)
        reference_xyz, g_r = center_coordinates(reference_xyz)
    else:
        g_t = (target_xyz ** 2).sum(dim=(-2, -1))
        g_r = (reference_xyz ** 2).sum(dim=(-2, -1))
    if reference_xyz.ndim == 2:
        return qcp_rmsd_vector(target_xyz, reference_xyz, g_t, g_r)
    return qcp_rmsd_matrix(target_xyz, reference_xyz, g_t, g_r)


def kabsch_rmsd_np(A, B):
    """The float64 host oracle: the minimum RMSD of two ``(N, 3)``
    structures by Kabsch's SVD (with the reflection fix), for holding
    the QCP functions and kernels to it; ``(..., N, 3)`` stacks of pairs
    (broadcast) give an array of RMSDs."""
    A = np.asarray(A, np.float64)
    B = np.asarray(B, np.float64)
    A = A - A.mean(-2, keepdims=True)
    B = B - B.mean(-2, keepdims=True)
    U, s, Vt = np.linalg.svd(np.swapaxes(A, -1, -2) @ B)
    s[..., -1] *= np.sign(np.linalg.det(U @ Vt))
    msd = ((A * A).sum((-2, -1)) + (B * B).sum((-2, -1))
           - 2.0 * s.sum(-1)) / A.shape[-2]
    rmsd = np.sqrt(np.maximum(msd, 0.0))
    return float(rmsd) if rmsd.ndim == 0 else rmsd
