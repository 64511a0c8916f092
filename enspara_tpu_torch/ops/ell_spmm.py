"""ELL sparse-times-dense product ``Y = A @ X + shift * X`` (kernel 6,
counterpart of ``enspara_tpu/ops/spmm_pallas.py :: ell_spmm_pallas`` and
of the XLA ``enspara_tpu/ops/sparse.py :: ell_spmm`` that the filtered
eigensolver calls).

A is in ELL form: ``cols`` (n, w) int32 and ``vals`` (n, w) float32,
every column index in ``[0, n)``; pad slots index their own row and
hold 0. ``X`` is (n, k) float32, row-major. Both versions compute
``acc = shift * x`` (or 0 when ``shift`` is 0), then
``acc = acc + vals[i, j] * X[cols[i, j]]`` for j = 0 .. w-1, each
product and each sum rounded to float32 on its own (no fused
multiply-add). The kernel skips the slots whose value is 0, which adds
+-0 for finite X, so the two are equal under ``torch.equal``; a NaN or
inf in an X row reached only through a zero slot makes NaN in the plain
version and nothing in the kernel.

:func:`ell_spmm_kernel` launches ``csrc/ell_spmm.cu`` on CUDA tensors;
:func:`ell_spmm_plain` is the plain PyTorch version, the loop of the
JAX package's ``ell_spmm``. The dispatcher is
:func:`enspara_tpu_torch.ops.sparse.ell_spmm`.
"""

import ctypes
import functools

import torch

from . import _build

__all__ = ['ell_spmm_plain', 'ell_spmm_kernel']


def _check(cols, vals, X):
    if cols.ndim != 2 or vals.shape != cols.shape:
        raise ValueError('cols and vals must be (n, w) of one shape, got %s '
                         'and %s' % (tuple(cols.shape), tuple(vals.shape)))
    if X.ndim != 2 or X.shape[0] != cols.shape[0]:
        raise ValueError('X must be (n, k) with n = %d, got %s'
                         % (cols.shape[0], tuple(X.shape)))
    if cols.shape[0] >= 2 ** 31 or cols.shape[1] >= 2 ** 31 \
            or X.shape[1] >= 2 ** 31:
        raise ValueError('n, w and k must each be below 2**31')
    for name, t, dtype in (('cols', cols, torch.int32),
                           ('vals', vals, torch.float32),
                           ('X', X, torch.float32)):
        if t.dtype != dtype:
            raise ValueError('%s must be %s, got %s' % (name, dtype, t.dtype))
        if not t.is_contiguous():
            raise ValueError('%s must be contiguous' % name)
        if t.device != X.device:
            raise ValueError('%s lies on %s, X on %s'
                             % (name, t.device, X.device))


def ell_spmm_plain(cols, vals, X, shift=0.0):
    """The plain PyTorch version on any device: one gather of X rows per
    ELL column, accumulated in column order."""
    _check(cols, vals, X)
    Y = shift * X if shift else torch.zeros_like(X)
    for j in range(cols.shape[1]):
        Y = Y + vals[:, j, None] * X[cols[:, j].long()]
    return Y


@functools.lru_cache(maxsize=None)
def _kernel():
    lib = _build.load_library('ell_spmm')
    p = ctypes.c_void_p
    lib.ell_spmm.argtypes = [p, p, p, p, ctypes.c_longlong, ctypes.c_int,
                             ctypes.c_int, ctypes.c_float, ctypes.c_int,
                             ctypes.c_int, ctypes.c_int, p]
    lib.ell_spmm.restype = ctypes.c_int
    lib.ell_spmm_error_string.argtypes = [ctypes.c_int]
    lib.ell_spmm_error_string.restype = ctypes.c_char_p
    return lib


def _lane_layout(k, *tensors):
    """``(vec, group)``: the columns a lane loads at once, 4 (float4)
    when k is a multiple of 4, else 2 or 1, less when a pointer is not
    aligned to it; and the lanes that serve a row, 16 when the row is
    at most 16 vectors wide (a half-warp a row at k = 64), else 32."""
    vec = 4 if k % 4 == 0 else 2 if k % 2 == 0 else 1
    while vec > 1 and any(t.data_ptr() % (4 * vec) for t in tensors):
        vec //= 2
    return vec, 16 if k // vec <= 16 else 32


def ell_spmm_kernel(cols, vals, X, shift=0.0):
    """``A @ X + shift * X`` by ``csrc/ell_spmm.cu``: one launch on the
    current stream, a warp or a half-warp per row, gathering only the
    slots whose value is not 0. CUDA tensors only; raises if the
    build or the launch fails. A column index outside ``[0, n)`` traps
    the kernel, which the next synchronisation reports as an error."""
    _check(cols, vals, X)
    device = X.device
    if device.type != 'cuda':
        raise ValueError('ell_spmm_kernel runs on CUDA tensors, got %s'
                         % device)
    n, w = cols.shape
    k = X.shape[1]
    Y = torch.empty_like(X)
    if n == 0 or k == 0:
        return Y
    lib = _kernel()
    vec, group = _lane_layout(k, X, Y)

    def ptr(t):
        return ctypes.c_void_p(t.data_ptr())

    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.ell_spmm(ptr(cols), ptr(vals), ptr(X), ptr(Y), n, w, k,
                           float(shift), int(bool(shift)), vec, group,
                           ctypes.c_void_p(stream))
    if err:
        raise RuntimeError('ell_spmm launch failed: %s (cudaError %d)'
                           % (lib.ell_spmm_error_string(err).decode(), err))
    ell_spmm_kernel.n_launches += 1
    return Y


# CUDA kernel launches made by ell_spmm_kernel
ell_spmm_kernel.n_launches = 0
