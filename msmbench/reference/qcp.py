"""Plain QCP RMSD, frozen for the benchmark's reference.

Theobald (2005), Acta Cryst. A61 478-480; Liu, Agrafiotis & Theobald
(2010), J. Comput. Chem. 31 1561-1563. The minimum RMSD of two centered
structures is ``sqrt(max(0, ga + gb - 2 lambda_max) / n_atoms)``, with
``g`` the sum of squared coordinates and ``lambda_max`` the largest
root of the quartic of the QCP key matrix, found by Newton's method on
``u = lambda / lambda0``, ``lambda0 = (ga + gb) / 2``, from ``u = 1``
until every step of a block is below rounding.

Plain torch, in the dtype of the inputs: the reference runs it in
float64. The control runs it on float32 frames with the operands of the
cross-covariance rounded to TF32 (``tf32=True``), as a TF32 tensor-core
product takes them. Nothing here imports the program.
"""

import torch

# Newton's steps: at least MIN_NEWTON, then until the largest step is
# within STEP_ULPS roundings of u ~ 1 in the dtype, at most MAX_NEWTON
MIN_NEWTON = 8
MAX_NEWTON = 40
STEP_ULPS = 8


def tf32_round(x):
    """``x`` (float32) rounded to TF32's 10-bit mantissa, to nearest."""
    bits = x.contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


def center(xyz, dtype=torch.float64):
    """Centered structures ``(n, A, 3)`` in ``dtype`` and their G ``(n,)``."""
    x = xyz.to(dtype)
    x = x - x.mean(dim=1, keepdim=True)
    return x, (x * x).sum(dim=(1, 2))


def _components(frames, centers, tf32):
    """The nine cross-covariance components ``S_ij`` of every pair,
    each ``(F, C)``: ``S_ij = sum_a frames[f, a, i] * centers[c, a, j]``."""
    if tf32:
        frames, centers = tf32_round(frames), tf32_round(centers)
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return [frames[:, :, i] @ centers[:, :, j].T
                for i in range(3) for j in range(3)]
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def _lambda_max_scaled(S, lam0, fixed_steps=None):
    """Largest root ``u`` of ``u^4 + c2 u^2 + c1 u + c0`` (the key
    matrix's characteristic polynomial over lambda0), elementwise.
    ``fixed_steps`` instead takes that many steps from ``u = 1`` (the
    scheme of the program's kernels, for :mod:`msmbench.witness`)."""
    (Sxx, Sxy, Sxz, Syx, Syy, Syz, Szx, Szy, Szz) = S
    Sxx2, Sxy2, Sxz2 = Sxx * Sxx, Sxy * Sxy, Sxz * Sxz
    Syx2, Syy2, Syz2 = Syx * Syx, Syy * Syy, Syz * Syz
    Szx2, Szy2, Szz2 = Szx * Szx, Szy * Szy, Szz * Szz
    fnorm2 = Sxx2 + Sxy2 + Sxz2 + Syx2 + Syy2 + Syz2 + Szx2 + Szy2 + Szz2
    m_yz = Syy * Szz - Syz * Szy
    det = (Sxx * m_yz - Sxy * (Syx * Szz - Syz * Szx)
           + Sxz * (Syx * Szy - Syy * Szx))
    c2 = -2.0 * fnorm2
    c1 = -8.0 * det
    SxzpSzx, SxzmSzx = Sxz + Szx, Sxz - Szx
    SyzpSzy, SyzmSzy = Syz + Szy, Syz - Szy
    SxypSyx, SxymSyx = Sxy + Syx, Sxy - Syx
    SxxpSyy, SxxmSyy = Sxx + Syy, Sxx - Syy
    D = (Sxy2 + Sxz2 - Syx2 - Szx2) ** 2
    base = -Sxx2 + Syy2 + Szz2 + Syz2 + Szy2
    E = (base - 2.0 * m_yz) * (base + 2.0 * m_yz)
    F = (-SxzpSzx * SyzmSzy + SxymSyx * (SxxmSyy - Szz)) \
        * (-SxzmSzx * SyzpSzy + SxymSyx * (SxxmSyy + Szz))
    G = (-SxzpSzx * SyzpSzy - SxypSyx * (SxxpSyy - Szz)) \
        * (-SxzmSzx * SyzmSzy - SxypSyx * (SxxpSyy + Szz))
    H = (SxypSyx * SyzpSzy + SxzpSzx * (SxxmSyy + Szz)) \
        * (-SxymSyx * SyzmSzy + SxzpSzx * (SxxpSyy + Szz))
    I = (SxypSyx * SyzmSzy + SxzmSzx * (SxxmSyy - Szz)) \
        * (-SxymSyx * SyzpSzy + SxzmSzx * (SxxpSyy - Szz))
    c0 = D + E + F + G + H + I
    inv = 1.0 / torch.clamp(lam0, min=1e-12)
    inv2 = inv * inv
    c2, c1, c0 = c2 * inv2, c1 * inv2 * inv, c0 * inv2 * inv2
    # start above the largest root: lambda_max is at most the nuclear
    # norm of S, at most sqrt(3) times its Frobenius norm, and twice that
    # keeps the start above the root of the rounded quartic where the
    # bound is tight (equal singular values); Newton from above the
    # largest root of a polynomial with real roots falls to it
    # monotonically
    u = torch.clamp(2.0 * torch.sqrt(3.0 * fnorm2) * inv, max=1.0)
    tol = STEP_ULPS * torch.finfo(u.dtype).eps
    if fixed_steps is not None:
        u = torch.ones_like(u)
        tol = -1.0
    c2x2 = 2.0 * c2
    for it in range(fixed_steps or MAX_NEWTON):
        u2 = u * u
        p = torch.addcmul(c0, c1, u).addcmul_(u2 + c2, u2)
        dp = torch.addcmul(c1, u, torch.add(c2x2, u2, alpha=4.0))
        step = p.div_(dp.clamp_min_(1e-30)).clamp_(-0.5, 0.5)
        u.sub_(step)
        if it >= MIN_NEWTON - 1 and it % 2 and \
                bool(step.abs().max() <= tol):
            break
    return torch.clamp(u, 0.0, 1.0)


def rmsd_block(frames, g_frames, centers, g_centers, tf32=False,
               fixed_steps=None):
    """RMSD ``(F, C)`` between centered ``frames`` ``(F, A, 3)`` and
    centered ``centers`` ``(C, A, 3)`` with their G values. With
    ``tf32`` the nine products come from TF32 operands with float32
    sums, as a TF32 tensor-core product makes them; the root is then
    found in float64, so that the distances carry the products' error
    alone (in float32, the quartic of such products can lose its
    largest root for structures that barely align), and come back in
    float32."""
    S = _components(frames, centers, tf32)
    gsum = g_frames[:, None] + g_centers[None, :]
    if tf32:
        S = [s.double() for s in S]
        gsum = gsum.double()
    lam0 = 0.5 * gsum
    u = _lambda_max_scaled(S, lam0, fixed_steps)
    msd = torch.clamp(gsum - 2.0 * u * lam0, min=0.0) / frames.shape[1]
    return torch.sqrt(msd).to(frames.dtype)


class Frames:
    """Centered frames in the reference's dtype, kept for many blocks."""

    def __init__(self, xyz, dtype=torch.float64, tf32=False):
        self.x, self.g = center(xyz, dtype)
        self.tf32 = tf32

    def __len__(self):
        return self.x.shape[0]

    def rmsd(self, rows, cols):
        """RMSD of frames ``rows`` (a slice or index tensor) to frames
        ``cols`` (indices), ``(len(rows), len(cols))``."""
        return rmsd_block(self.x[rows], self.g[rows], self.x[cols],
                          self.g[cols], self.tf32)
