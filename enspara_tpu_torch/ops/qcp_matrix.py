"""All-pairs minimum RMSD block by QCP (counterpart of
``enspara_tpu/ops/qcp_pallas.py :: qcp_rmsd_matrix_pallas``).

The block takes pre-centered structures in the package's frame-minor
layout: ``(3*A_pad, n)`` float32 with row ``i*A_pad + a`` holding
coordinate ``i`` of atom ``a``, and their G values (sums of squares).
The padding contract is the TPU kernel's: frames pad to a multiple of
``TILE_F`` (256), centers to a multiple of ``TILE_C`` (256), or of
``NARROW_C`` (64) when there are fewer than 256 (the narrow tile of PAM
proposal blocks and cache-init chunks); atoms pad with zeros to a
multiple of 8; padded structures carry G = 1.0 and their rows and
columns are sliced away.

:func:`qcp_rmsd_matrix_kernel` launches ``csrc/qcp_matrix.cu`` on CUDA
tensors (the all-pairs kernel, then its finish in double of the pairs
near a double root of the QCP quartic, as the plain version finishes
them in float64); :func:`qcp_rmsd_matrix_plain` is the plain PyTorch
version (``ops/qcp.py``'s einsum and epilogue); :func:`qcp_rmsd_matrix_block`
takes the kernel for CUDA tensors and the plain version for CPU
tensors. :func:`pairwise_rmsd` is the ``(F, N, 3) x (C, N, 3)`` entry
point with the padding done for the caller.
"""

import ctypes
import functools

import torch

from ..util.device import resolve_device
from . import _build
from .qcp import _einsum_fp32, _f32, rmsd_from_S_components_unrolled

__all__ = ['TILE_F', 'TILE_C', 'NARROW_C', 'pad_frames', 'pad_centers',
           'to_layout', 'qcp_rmsd_matrix_plain', 'qcp_rmsd_matrix_kernel',
           'qcp_rmsd_matrix_block', 'pairwise_rmsd']

TILE_F = 256
TILE_C = 256
NARROW_C = 64

# F and C multiples of this (the CUDA kernel's tiles are 64 frames x 32
# centers)
_KERNEL_TILE = 64
# pairs per pass of the plain version: bounds its (3, 3, F, C) S tensor
_PLAIN_PAIRS = 1 << 24


def _round_up(x, m):
    return -(-int(x) // m) * m


def pad_frames(n):
    """Padded frame count of the contract: a multiple of 256."""
    return _round_up(max(n, 1), TILE_F)


def pad_centers(c):
    """Padded center count of the contract: a multiple of 64 below 256
    centers, else a multiple of 256."""
    return _round_up(max(c, 1), NARROW_C if c < TILE_C else TILE_C)


def to_layout(xyz, n_pad, a_pad=None, g=None):
    """``(n, A, 3)`` structures (used as given: not centered here) ->
    ``((3*a_pad, n_pad) layout, (n_pad,) G)`` on ``xyz``'s device, zero
    padded, G = 1.0 past ``n``. ``a_pad`` defaults to A rounded up to a
    multiple of 8; ``g`` to the sums of squares."""
    xyz = _f32(xyz)
    n, A = int(xyz.shape[0]), int(xyz.shape[1])
    a_pad = _round_up(A, 8) if a_pad is None else int(a_pad)
    layout = torch.zeros((3, a_pad, n_pad), dtype=torch.float32,
                         device=xyz.device)
    layout[:, :A, :n] = xyz.permute(2, 1, 0)
    g_out = torch.ones(n_pad, dtype=torch.float32, device=xyz.device)
    g_out[:n] = (xyz * xyz).sum(dim=(1, 2)) if g is None \
        else torch.as_tensor(g, dtype=torch.float32, device=xyz.device)
    return layout.view(3 * a_pad, n_pad), g_out


def _check(frames_r, g_f, centers_r, g_c):
    rows, F = frames_r.shape if frames_r.ndim == 2 else (0, 0)
    if frames_r.ndim != 2 or rows % 24 or rows == 0:
        raise ValueError('frames need the (3*A_pad, F) layout with A_pad a '
                         'multiple of 8, got %s' % (tuple(frames_r.shape),))
    if centers_r.ndim != 2 or centers_r.shape[0] != rows:
        raise ValueError('centers need the (%d, C) layout, got %s'
                         % (rows, tuple(centers_r.shape)))
    C = centers_r.shape[1]
    if F % _KERNEL_TILE or C % _KERNEL_TILE or F == 0 or C == 0:
        raise ValueError('F and C must be positive multiples of %d, got '
                         'F=%d, C=%d' % (_KERNEL_TILE, F, C))
    if F >= 2 ** 31 or C >= 2 ** 31:
        raise ValueError('at most 2**31 - 1 structures a side')
    want = ((frames_r, (rows, F)), (g_f, (F,)), (centers_r, (rows, C)),
            (g_c, (C,)))
    for k, (t, shape) in enumerate(want):
        if t.dtype != torch.float32 or tuple(t.shape) != shape:
            raise ValueError('argument %d: want float32 %s, got %s %s'
                             % (k, shape, t.dtype, tuple(t.shape)))
        if not t.is_contiguous():
            raise ValueError('argument %d must be contiguous' % k)
        if t.device != frames_r.device:
            raise ValueError('argument %d lies on %s, frames on %s'
                             % (k, t.device, frames_r.device))


def qcp_rmsd_matrix_plain(frames_r, g_f, centers_r, g_c, n_atoms_real):
    """The plain PyTorch version on any device: ``(F, C)`` float32 RMSD
    of every frame to every center, from the same inputs as the kernel
    (einsum in full fp32, then ``ops/qcp.py``'s epilogue), a slab of
    frames at a time to bound the S tensor."""
    _check(frames_r, g_f, centers_r, g_c)
    rows, F = frames_r.shape
    C = centers_r.shape[1]
    fr = frames_r.view(3, rows // 3, F)
    cr = centers_r.view(3, rows // 3, C)
    out = torch.empty((F, C), dtype=torch.float32, device=frames_r.device)
    step = max(1, _PLAIN_PAIRS // C)
    for lo in range(0, F, step):
        hi = min(F, lo + step)
        S = _einsum_fp32('iaf,jac->ijfc', fr[:, :, lo:hi], cr)
        out[lo:hi] = rmsd_from_S_components_unrolled(
            tuple(S[i, j] for i in range(3) for j in range(3)),
            g_f[lo:hi, None] + g_c[None, :], float(n_atoms_real))
    return out


@functools.lru_cache(maxsize=None)
def _kernel():
    lib = _build.load_library('qcp_matrix')
    p = ctypes.c_void_p
    lib.qcp_matrix.argtypes = [p, p, ctypes.c_longlong, p, p, ctypes.c_int,
                               ctypes.c_int, ctypes.c_float, p, p]
    lib.qcp_matrix.restype = ctypes.c_int
    lib.qcp_matrix_error_string.argtypes = [ctypes.c_int]
    lib.qcp_matrix_error_string.restype = ctypes.c_char_p
    return lib


def qcp_rmsd_matrix_kernel(frames_r, g_f, centers_r, g_c, n_atoms_real):
    """``(F, C)`` float32 RMSD block by ``csrc/qcp_matrix.cu``: one call
    of its entry point on the current stream (the all-pairs kernel, the
    contraction in 3xTF32 on the tensor cores, then its finish of the
    pairs near a double root in double). CUDA tensors only; raises if
    the build or a launch fails."""
    _check(frames_r, g_f, centers_r, g_c)
    device = frames_r.device
    if device.type != 'cuda':
        raise ValueError('qcp_rmsd_matrix_kernel runs on CUDA tensors, '
                         'got %s' % device)
    for k, t in enumerate((frames_r, g_f, centers_r, g_c)):
        if t.data_ptr() % 16:
            raise ValueError('argument %d is not 16-byte aligned (the '
                             'kernel loads float4)' % k)
    lib = _kernel()
    rows, F = frames_r.shape
    C = centers_r.shape[1]
    out = torch.empty((F, C), dtype=torch.float32, device=device)

    def ptr(t):
        return ctypes.c_void_p(t.data_ptr())

    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.qcp_matrix(ptr(frames_r), ptr(g_f), F, ptr(centers_r),
                             ptr(g_c), C, rows // 3, float(n_atoms_real),
                             ptr(out), ctypes.c_void_p(stream))
    if err:
        raise RuntimeError('qcp_matrix launch failed: %s (cudaError %d)'
                           % (lib.qcp_matrix_error_string(err).decode(), err))
    qcp_rmsd_matrix_kernel.n_launches += 1
    return out


# calls of csrc/qcp_matrix.cu made by qcp_rmsd_matrix_kernel (each the
# all-pairs kernel and its finish)
qcp_rmsd_matrix_kernel.n_launches = 0


def qcp_rmsd_matrix_block(frames_r, g_f, centers_r, g_c, n_atoms_real):
    """The (F, C) RMSD block where the inputs lie: the CUDA kernel for
    CUDA tensors, the plain version for CPU tensors; any other device
    raises."""
    device = frames_r.device
    if device.type == 'cuda':
        return qcp_rmsd_matrix_kernel(frames_r, g_f, centers_r, g_c,
                                      n_atoms_real)
    if device.type == 'cpu':
        return qcp_rmsd_matrix_plain(frames_r, g_f, centers_r, g_c,
                                     n_atoms_real)
    raise ValueError('qcp_rmsd_matrix_block runs on CUDA or CPU tensors, '
                     'got %s' % device)


def pairwise_rmsd(frames, centers, g_frames=None, g_centers=None,
                  n_atoms=None):
    """All-pairs minimum RMSD of pre-centered ``frames`` (F, N, 3) to
    pre-centered ``centers`` (C, N, 3); the arguments of
    ``qcp_rmsd_matrix_pallas``. Pads to the contract, runs the block
    where a tensor ``frames`` lies (the card for host data) and returns
    (F, C) float32."""
    frames = _f32(frames).to(resolve_device(frames))
    centers = _f32(centers).to(frames.device)
    F, C = int(frames.shape[0]), int(centers.shape[0])
    a_pad = _round_up(frames.shape[1], 8)
    fr, gf = to_layout(frames, pad_frames(F), a_pad, g_frames)
    cr, gc = to_layout(centers, pad_centers(C), a_pad, g_centers)
    out = qcp_rmsd_matrix_block(fr, gf, cr, gc,
                                frames.shape[1] if n_atoms is None
                                else n_atoms)
    return out[:F, :C]
