"""Sparse operands on a device: dense materialization and the ELL
sparse-times-dense product (counterpart of ``enspara_tpu/ops/sparse.py``).

Scattering a scipy matrix's COO triplets on the device moves O(nnz)
bytes instead of a host-densified n^2 array. For iterated sparse
products (the filtered eigensolver's Chebyshev sweeps) ELL form turns
``Y = A @ X`` into ``w`` fixed-width row gathers of the dense operand
(``Y = sum_j vals[:, j, None] * X[cols[:, j]]``); padding rows to the
max width costs only zero-multiplies. MSM graphs are near-regular, so
the pad waste is small; callers take CSR instead when
``w_max >> mean nnz/row`` (hub-dominated graphs).
"""

import numpy as np
import torch

from ..util.device import resolve_device
from .ell_spmm import ell_spmm_kernel, ell_spmm_plain

__all__ = ['dense_on_device', 'round_up', 'ell_from_sparse', 'ell_spmm']


def dense_on_device(sp, scale_rows=None, scale_cols=None, device=None):
    """``sp`` (scipy sparse) as a dense float32 tensor on ``device``
    (default: the card, see :func:`~enspara_tpu_torch.util.device.
    resolve_device`), scattered from its COO triplets. The optional
    per-row and per-column scaling vectors are applied to the values on
    the host in float64 (O(nnz)), so this computes ``D_r @ sp @ D_c``
    without a dense host array."""
    coo = sp.tocoo()
    coo.sum_duplicates()                # one value per cell
    n, m = coo.shape

    vals = coo.data.astype(np.float64)
    if scale_rows is not None:
        vals = vals * np.asarray(scale_rows, np.float64)[coo.row]
    if scale_cols is not None:
        vals = vals * np.asarray(scale_cols, np.float64)[coo.col]

    device = resolve_device(sp, device)
    out = torch.zeros((n, m), dtype=torch.float32, device=device)
    rows = torch.as_tensor(coo.row.astype(np.int64), device=device)
    cols = torch.as_tensor(coo.col.astype(np.int64), device=device)
    out[rows, cols] = torch.as_tensor(vals.astype(np.float32), device=device)
    return out


def round_up(x, q):
    """Smallest multiple of ``q`` >= ``x`` (the shape-bucket helper of
    the ELL layout and the filtered eigensolver)."""
    return int(-(-x // q) * q)


def ell_from_sparse(sp, dtype=np.float32):
    """Convert scipy sparse ``sp`` to padded ELL arrays
    ``(cols (n, w) int32, vals (n, w) dtype)`` with ``w`` the max row
    occupancy. Pad slots carry the row's own index with value 0, so
    gathers stay in bounds and contribute nothing.
    """
    csr = sp.tocsr()
    csr.sum_duplicates()
    n = csr.shape[0]
    nnz_row = np.diff(csr.indptr)
    w = int(nnz_row.max()) if n else 0

    cols = np.repeat(np.arange(n, dtype=np.int32)[:, None], w, axis=1)
    vals = np.zeros((n, w), dtype=dtype)
    rows = np.repeat(np.arange(n), nnz_row)
    pos = np.arange(csr.nnz) - np.repeat(csr.indptr[:-1], nnz_row)
    cols[rows, pos] = csr.indices
    vals[rows, pos] = csr.data
    return cols, vals


def ell_spmm(cols, vals, X, shift=0.0):
    """``A @ X + shift * X`` with A in ELL form (see
    :func:`ell_from_sparse`), where ``X`` lies: the CUDA kernel of
    :mod:`~enspara_tpu_torch.ops.ell_spmm` for a CUDA tensor, its plain
    version for a CPU tensor; any other device raises. The three
    tensors lie on one device; other float types are cast to float32
    and other integer types to int32 first (the kernel's types)."""
    cols = cols.to(torch.int32).contiguous()
    vals = vals.to(torch.float32).contiguous()
    X = X.to(torch.float32).contiguous()
    if X.device.type == 'cuda':
        return ell_spmm_kernel(cols, vals, X, shift)
    if X.device.type == 'cpu':
        return ell_spmm_plain(cols, vals, X, shift)
    raise ValueError('ell_spmm runs on CUDA or CPU tensors, got %s'
                     % X.device)
