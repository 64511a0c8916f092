"""Device views of ragged data.

Ragged trajectory collections are presented to device code in one of
two canonical forms:

* **padded**: ``(n_rows, max_len, ...)`` dense array + ``(n_rows, max_len)``
  boolean validity mask. Right shape for per-trajectory scans (rotamer
  hysteresis, lag-time transition counting) — padding never crosses a
  trajectory boundary.
* **flat + segment_ids**: the concatenated ``(total, ...)`` array plus an
  int32 row id per element. Right shape for frame-parallel work (distance
  kernels, assignment) where trajectory identity only matters for
  bookkeeping.

This replaces the reference's approach of iterating Python rows
(e.g. enspara/msm/transition_matrices.py:161-164) with masked dense forms
that shard cleanly over a device mesh.
"""

from dataclasses import dataclass
from typing import Optional

import numpy as np

__all__ = ['pad_ragged', 'unpad_ragged', 'PaddedRagged', 'to_padded']


def pad_ragged(flat_data, lengths, max_len=None, fill=0, dtype=None):
    """Pack concatenated rows into a dense padded array + mask.

    Parameters
    ----------
    flat_data : (total, ...) array
    lengths : (n_rows,) int array
    max_len : int, optional. Pad target; defaults to ``max(lengths)``.
    fill : scalar pad value.

    Returns
    -------
    (padded, mask) : ((n_rows, max_len, ...), (n_rows, max_len) bool)
    """
    flat_data = np.asarray(flat_data)
    lengths = np.asarray(lengths, dtype=np.int64)
    n_rows = len(lengths)
    if max_len is None:
        max_len = int(lengths.max()) if n_rows else 0
    inner = flat_data.shape[1:]
    if dtype is None:
        dtype = flat_data.dtype
    padded = np.full((n_rows, max_len) + inner, fill, dtype=dtype)
    mask = np.zeros((n_rows, max_len), dtype=bool)
    start = 0
    for i, ln in enumerate(lengths):
        ln = int(min(ln, max_len))
        padded[i, :ln] = flat_data[start:start + ln]
        mask[i, :ln] = True
        start += int(lengths[i])
    return padded, mask


def unpad_ragged(padded, lengths):
    """Inverse of :func:`pad_ragged`: back to the flat concatenated form."""
    padded = np.asarray(padded)
    lengths = np.asarray(lengths, dtype=np.int64)
    pieces = [padded[i, :int(ln)] for i, ln in enumerate(lengths)]
    if not pieces:
        return np.array([], dtype=padded.dtype)
    return np.concatenate(pieces)


@dataclass
class PaddedRagged:
    """A ragged collection in its device-friendly padded form."""
    data: np.ndarray           # (n_rows, max_len, ...) — may be a tensor
    mask: np.ndarray           # (n_rows, max_len) bool
    lengths: np.ndarray        # (n_rows,) int — host-side metadata

    @property
    def n_rows(self):
        return self.data.shape[0]

    @property
    def max_len(self):
        return self.data.shape[1]

    def to_ragged(self):
        from .ra import RaggedArray
        return RaggedArray(unpad_ragged(np.asarray(self.data),
                                        self.lengths),
                           lengths=self.lengths)


def to_padded(ra_or_list, max_len=None, fill=0, dtype=None):
    """Build a :class:`PaddedRagged` from a RaggedArray or list of rows."""
    from .ra import RaggedArray
    if not isinstance(ra_or_list, RaggedArray):
        ra_or_list = RaggedArray([np.asarray(r) for r in ra_or_list])
    padded, mask = pad_ragged(ra_or_list._data, ra_or_list.lengths,
                              max_len=max_len, fill=fill, dtype=dtype)
    return PaddedRagged(padded, mask, np.asarray(ra_or_list.lengths))
