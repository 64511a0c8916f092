"""RaggedArray: a 2-D "array of arrays" with rows of differing lengths.

The host-side core data structure of the framework (reference:
enspara/ra/ra.py:487). Rows are stored concatenated in one flat numpy
array ``_data`` together with per-row ``lengths``; the class provides
numpy-like indexing — ``ra[i]``, ``ra[rows]``, ``ra[i, j]``,
``ra[:, ::stride]``, boolean-mask indexing — and elementwise arithmetic
that broadcasts over the flat data.

This container is deliberately numpy/host-only. The padded view
(``(n_rows, max_len, ...)`` + mask, and flat ``segment_ids``) lives in
:mod:`enspara_tpu_torch.ra.device`; every device kernel consumes that
view, never this class.
"""

import itertools
import numbers

import numpy as np

from ..exception import DataInvalid, ImproperlyConfigured

__all__ = [
    'RaggedArray', 'where', 'zeros_like', 'partition_list',
    'partition_indices', 'save', 'load',
]


def _is_iterable(obj):
    """True for list/array-like, False for scalars, strings and bytes."""
    return hasattr(obj, '__iter__') and not isinstance(obj, (str, bytes))


def _starts_from_lengths(lengths):
    lengths = np.asarray(lengths, dtype=np.int64)
    starts = np.zeros(len(lengths), dtype=np.int64)
    if len(lengths) > 1:
        np.cumsum(lengths[:-1], out=starts[1:])
    return starts


def partition_list(list_to_partition, partition_lengths):
    """Cut a concatenated sequence into consecutive pieces of the given
    lengths. Pieces are views when the input supports slicing-as-view.

    (reference: ra/ra.py:361)
    """
    bounds = np.cumsum(np.asarray(partition_lengths, dtype=np.int64))
    total = int(bounds[-1]) if bounds.size else 0
    if total != len(list_to_partition):
        raise DataInvalid(
            "Number of elements in list (%d) does not equal the sum of "
            "the lengths to partition (%d)"
            % (len(list_to_partition), total))
    return [list_to_partition[lo:hi]
            for lo, hi in zip(np.r_[0, bounds[:-1]], bounds)]


def partition_indices(indices, traj_lengths):
    """Convert concatenated (1-D) frame indices into (row, offset) pairs
    given per-row lengths. (reference: ra/ra.py:223)
    """
    starts = _starts_from_lengths(traj_lengths)
    ends = starts + np.asarray(traj_lengths, dtype=np.int64)
    out = []
    for index in indices:
        row = int(np.searchsorted(ends, index, side='right'))
        if row >= len(starts):
            continue
        out.append((row, int(index - starts[row])))
    return out


def _convert_from_1d(iis_flat, lengths=None, starts=None):
    """1-D (flat) indices -> (rows, offsets). (reference: ra/ra.py:245)"""
    if lengths is None and starts is None:
        raise ImproperlyConfigured('No lengths or starts supplied')
    if starts is None:
        starts = _starts_from_lengths(lengths)
    starts = np.asarray(starts, dtype=np.int64)
    flat = np.asarray(iis_flat[0], dtype=np.int64)
    rows = np.searchsorted(starts, flat, side='right') - 1
    offs = flat - starts[rows]
    return rows.astype(np.int64), offs.astype(np.int64)


def _resolve_negative(rows, offs, lengths, n_rows):
    """Map negative row/offset indices to their positive equivalents."""
    rows = np.asarray(rows)
    offs = np.asarray(offs)
    scalar_rows = rows.ndim == 0
    rows = np.atleast_1d(rows).astype(np.int64).copy()
    offs = np.atleast_1d(offs).astype(np.int64).copy()
    neg_r = rows < 0
    if neg_r.any():
        rows[neg_r] += n_rows
        if (rows < 0).any():
            raise IndexError('row index out of range')
    neg_o = offs < 0
    if neg_o.any():
        if lengths is None:
            raise ImproperlyConfigured(
                'Must supply lengths if indices are negative.')
        lengths = np.asarray(lengths, dtype=np.int64)
        if rows.size == offs.size:
            offs[neg_o] += lengths[rows[neg_o]]
        elif rows.size == 1:
            offs[neg_o] += lengths[rows[0]]
        else:
            offs = offs + 0  # broadcast later
            offs[neg_o] += lengths[rows[neg_o]]
        if (offs < 0).any():
            raise IndexError('column index out of range')
    return (rows, offs, scalar_rows)


def _convert_from_2d(iis_ragged, lengths=None, starts=None,
                     error_check=True):
    """(rows, offsets) -> flat 1-D indices. (reference: ra/ra.py:305)"""
    if lengths is None and starts is None:
        raise ImproperlyConfigured('No lengths or starts supplied')
    if starts is None:
        starts = _starts_from_lengths(lengths)
    starts = np.asarray(starts, dtype=np.int64)
    rows, offs = iis_ragged
    rows = np.asarray(rows)
    offs = np.asarray(offs)
    # broadcast ([0,1,2], 4) -> offsets repeated
    if rows.size > 1 and offs.size == 1:
        offs = np.full(rows.shape, offs.reshape(-1)[0])
    rows, offs, _ = _resolve_negative(rows, offs, lengths, len(starts))
    if lengths is not None and error_check:
        lengths = np.asarray(lengths, dtype=np.int64)
        if np.any(lengths[rows] <= offs):
            raise IndexError(
                "Length of row %s (%s) is out of range for index %s"
                % (rows, lengths[rows], offs))
    return (starts[rows] + offs,)


def _rows_from_slice(sl, n_rows):
    return np.arange(n_rows)[sl]


def _iis_from_slices(row_iis, col_slice, lengths):
    """Expand ``(rows, colslice)`` into explicit 2-D indices plus the new
    per-row lengths. Column slices clamp to each row's length
    (reference: ra/ra.py:439)."""
    lengths = np.asarray(lengths, dtype=np.int64)
    start = col_slice.start or 0
    step = col_slice.step or 1
    stop = col_slice.stop
    if stop is None:
        stops = lengths.copy()
    elif stop < 0:
        stops = lengths + stop
    else:
        stops = np.minimum(np.full(len(lengths), stop, dtype=np.int64),
                           lengths)
    stops = np.minimum(stops, lengths)
    rows_rep, cols, new_lengths = [], [], []
    for r in row_iis:
        c = np.arange(start, stops[r], step, dtype=np.int64)
        cols.append(c)
        new_lengths.append(len(c))
        rows_rep.append(np.full(len(c), r, dtype=np.int64))
    if len(cols) == 0:
        return (np.array([], dtype=np.int64),) * 2, np.array([], int)
    return ((np.concatenate(rows_rep), np.concatenate(cols)),
            np.asarray(new_lengths, dtype=np.int64))


def _iis_from_list(row_iis, col_iis):
    """Cartesian product of explicit row and column index lists
    (reference: ra/ra.py:476)."""
    pairs = np.array(list(itertools.product(row_iis, col_iis))).T
    new_lengths = [len(col_iis)] * len(row_iis)
    return pairs, new_lengths


class RaggedArray(object):
    """See module docstring. Attributes: ``_data`` (flat concatenated
    array), ``lengths`` (row lengths), ``starts`` (row offsets into
    ``_data``), ``_array`` (row-view object/2-D array)."""

    __slots__ = ('_data', '_array', 'lengths')

    def __init__(self, array, lengths=None, error_checking=True, copy=True):
        # NOTE on error_checking: accepted for reference API
        # compatibility (there it gates an input-structure scan that
        # auto-disables above 20k rows); here the cheap validations
        # (lengths-vs-data size) run unconditionally and inner-shape
        # mismatches in row inputs are NOT an error in either codebase
        # — mismatched rows store as per-element object arrays with
        # shape (n, None, None) (reference test_ra.py:60-62), a
        # carrying/indexing form; compute kernels require homogeneous
        # inner dims and fail on the object dtype when misused.
        if lengths is None:
            if len(array) > 0 and _is_iterable(array[0]):
                # list/array of rows
                rows, homogeneous = [], True
                for r in array:
                    try:
                        rr = np.asarray(r)
                    except ValueError:      # inhomogeneous inner dims
                        homogeneous = False
                        break
                    if rr.dtype == object:
                        homogeneous = False
                        break
                    rows.append(rr)
                if homogeneous and len(rows) > 1 and \
                        len(set(r.shape[1:] for r in rows)) > 1:
                    homogeneous = False
                self.lengths = np.array([len(r) for r in array],
                                        dtype=np.int64)
                if homogeneous:
                    if len(rows):
                        self._data = np.concatenate(rows)
                    else:
                        self._data = np.array([])
                else:
                    # doubly-ragged input (rows whose elements differ
                    # in shape): stored per-element as an object
                    # array, shape reports (n, None, None) — matching
                    # the reference's nested-object contract
                    # (test_ra.py:60-62). Compute kernels require
                    # homogeneous inner dims; this form is for
                    # carrying/indexing only.
                    obj = np.empty(int(self.lengths.sum()),
                                   dtype=object)
                    k = 0
                    for r in array:
                        for item in r:
                            obj[k] = np.asarray(item)
                            k += 1
                    self._data = obj
            elif len(array) > 0:
                # flat array of scalars -> single row
                self._data = np.array(array, copy=copy)
                self.lengths = np.array([len(array)], dtype=np.int64)
            else:
                self._data = np.array([])
                self.lengths = np.array([], dtype=np.int64)
        else:
            self.lengths = np.asarray(lengths, dtype=np.int64).reshape(-1)
            self._data = np.array(array, copy=copy)
            if np.sum(self.lengths) != len(self._data):
                raise DataInvalid(
                    "Sum of lengths (%s) didn't match data shape (%s)."
                    % (np.sum(self.lengths), self._data.shape))
        self._rebuild_array_view()

    # -- internal -----------------------------------------------------

    def _rebuild_array_view(self):
        if len(self.lengths) == 0:
            self._array = []
        elif np.all(self.lengths == self.lengths[0]):
            self._array = self._data.reshape(
                (len(self.lengths), self.lengths[0])
                + self._data.shape[1:])
        else:
            arr = np.empty(len(self.lengths), dtype=object)
            for i, piece in enumerate(
                    partition_list(self._data, self.lengths)):
                arr[i] = piece
            self._array = arr

    # -- basic properties ----------------------------------------------

    @property
    def dtype(self):
        return self._data.dtype

    @property
    def shape(self):
        if len(self.lengths) and np.any(self.lengths != self.lengths[0]):
            second = None
        elif len(self.lengths):
            second = int(self.lengths[0])
        else:
            second = 0
        if self._data.ndim > 1:
            return (len(self.lengths), second) + self._data.shape[1:]
        if self._data.dtype == object and len(self._data):
            # doubly-ragged storage: one more unknown axis
            return (len(self.lengths), second, None)
        return (len(self.lengths), second)

    @property
    def size(self):
        return self._data.size

    @property
    def starts(self):
        return _starts_from_lengths(self.lengths)

    def __len__(self):
        return len(self.lengths)

    def __iter__(self):
        for i in range(len(self.lengths)):
            yield self._array[i]

    def __repr__(self):
        rows = [np.array2string(self._array[i], separator=', ')
                for i in (range(len(self)) if len(self) <= 6
                          else [0, 1, 2, -3, -2, -1])]
        if len(self) > 6:
            rows = rows[:3] + ['...'] + rows[3:]
        return 'RaggedArray([\n      ' + ',\n      '.join(rows) + '])'

    def __str__(self):
        return self.__repr__()

    # -- indexing -------------------------------------------------------

    def __getitem__(self, iis):
        if isinstance(iis, numbers.Integral):
            return self._array[iis]
        if isinstance(iis, (slice, list, np.ndarray)):
            if isinstance(iis, np.ndarray) and iis.dtype == bool:
                return RaggedArray([self._array[i]
                                    for i in np.where(iis)[0]])
            sel = self._array[iis] if not isinstance(iis, list) \
                else [self._array[i] for i in iis]
            return RaggedArray([np.asarray(r) for r in sel])
        if isinstance(iis, tuple):
            first, second = iis
            if (isinstance(first, numbers.Integral)
                    and isinstance(second, slice)):
                return self._array[first][second]
            flat, new_lengths = self._tuple_to_flat(iis)
            if new_lengths is None:
                return self._data[flat]
            return RaggedArray(self._data[flat], lengths=new_lengths)
        if isinstance(iis, RaggedArray):
            return self.__getitem__(where(iis))
        raise TypeError('Cannot index RaggedArray with %r' % (iis,))

    def _tuple_to_flat(self, iis):
        """Resolve a 2-tuple index into flat indices; second return is
        per-row lengths when the result is ragged, else None (scalarish)."""
        first, second = iis
        if isinstance(first, slice):
            row_iis = _rows_from_slice(first, len(self.lengths))
            if isinstance(second, slice):
                pairs, new_lengths = _iis_from_slices(
                    row_iis, second, self.lengths)
            elif isinstance(second, numbers.Integral):
                pairs, new_lengths = _iis_from_list(row_iis, [second])
            else:
                pairs, new_lengths = _iis_from_list(row_iis, second)
            flat = _convert_from_2d(
                pairs, lengths=self.lengths, starts=self.starts)
            return flat, new_lengths
        elif isinstance(second, slice):
            if isinstance(first, numbers.Integral):
                return None, None  # handled by caller below
            pairs, new_lengths = _iis_from_slices(
                np.asarray(first).reshape(-1), second, self.lengths)
            flat = _convert_from_2d(
                pairs, lengths=self.lengths, starts=self.starts)
            return flat, new_lengths
        else:
            flat = _convert_from_2d(
                (first, second), lengths=self.lengths, starts=self.starts)
            return flat, None

    def __setitem__(self, iis, value):
        if isinstance(value, RaggedArray):
            value = [value._array[i] for i in range(len(value))]
        if isinstance(iis, numbers.Integral):
            rows = [np.asarray(self._array[i]) for i in range(len(self))]
            rows[iis] = np.asarray(value)
            self.__init__(rows)
            return
        if isinstance(iis, (slice, list, np.ndarray)):
            rows = [np.asarray(self._array[i]) for i in range(len(self))]
            sel = np.arange(len(rows))[iis] if isinstance(iis, slice) \
                else np.asarray(iis).reshape(-1)
            if isinstance(iis, np.ndarray) and iis.dtype == bool:
                sel = np.where(iis)[0]
            for k, r in enumerate(sel):
                rows[r] = np.asarray(value[k]) if _is_iterable(value) \
                    else np.asarray(value)
            self.__init__(rows)
            return
        if isinstance(iis, tuple):
            first, second = iis
            if (isinstance(first, numbers.Integral)
                    and isinstance(second, slice)):
                rows = [np.asarray(self._array[i], dtype=self._data.dtype)
                        for i in range(len(self))]
                row = rows[first].copy()
                row[second] = value
                rows[first] = row
                self.__init__(rows)
                return
            flat, _ = self._tuple_to_flat(iis)
            if _is_iterable(value) and len(value) and _is_iterable(value[0]):
                value = np.concatenate([np.asarray(v) for v in value])
            self._data[flat] = value
            self._rebuild_array_view()
            return
        if isinstance(iis, RaggedArray):
            self.__setitem__(where(iis), value)
            return
        raise TypeError('Cannot index RaggedArray with %r' % (iis,))

    # -- operators -------------------------------------------------------

    def map_operator(self, operator, other):
        if isinstance(other, RaggedArray):
            other = other._data
        new_data = getattr(self._data, operator)(other)
        if new_data is NotImplemented:
            return NotImplemented
        return RaggedArray(array=new_data, lengths=self.lengths,
                           error_checking=False)

    def __invert__(self):
        return RaggedArray(self._data.__invert__(), lengths=self.lengths)

    def __neg__(self):
        return RaggedArray(-self._data, lengths=self.lengths)

    def __abs__(self):
        return RaggedArray(np.abs(self._data), lengths=self.lengths)

    def all(self):
        return np.all(self._data)

    def any(self):
        return np.any(self._data)

    def max(self):
        return self._data.max()

    def min(self):
        return self._data.min()

    def sum(self):
        return self._data.sum()

    def mean(self):
        return self._data.mean()

    def astype(self, dtype):
        return RaggedArray(self._data.astype(dtype), lengths=self.lengths)

    def copy(self):
        return RaggedArray(self._data.copy(), lengths=self.lengths.copy())

    def append(self, values):
        """Append new rows (an array of rows, one flat row, or another
        RaggedArray). (reference: ra/ra.py:828)"""
        if isinstance(values, RaggedArray):
            values = [values._array[i] for i in range(len(values))]
        if len(self._data) == 0:
            self.__init__(values)
            return
        if not _is_iterable(values):
            raise DataInvalid('Expected an array of values or a ragged '
                              'array')
        if len(values) and _is_iterable(values[0]):
            new_rows = [np.asarray(v) for v in values]
        else:
            new_rows = [np.asarray(values)]
        self._data = np.concatenate([self._data] + new_rows)
        self.lengths = np.append(self.lengths,
                                 [len(r) for r in new_rows])
        self._rebuild_array_view()

    def flatten(self):
        return self._data.flatten()

    # -- device views ----------------------------------------------------

    def padded(self, max_len=None, fill=0, dtype=None):
        """Return ``(padded, mask)``: a dense ``(n_rows, max_len, ...)``
        array with rows front-aligned plus a boolean validity mask — the
        canonical device-side representation of ragged data."""
        from .device import pad_ragged
        return pad_ragged(self._data, self.lengths, max_len=max_len,
                          fill=fill, dtype=dtype)

    def segment_ids(self):
        """Flat ``(sum(lengths),)`` int32 row-id per element, for
        segment ops on the concatenated view."""
        return np.repeat(np.arange(len(self.lengths), dtype=np.int32),
                         self.lengths)


_comparison_ops = [
    '__eq__', '__lt__', '__le__', '__gt__', '__ge__', '__ne__',
    '__add__', '__radd__', '__sub__', '__rsub__', '__mul__', '__rmul__',
    '__truediv__', '__rtruediv__', '__floordiv__', '__rfloordiv__',
    '__pow__', '__rpow__', '__mod__', '__rmod__', '__or__', '__xor__',
    '__and__',
]


def _make_op(name):
    def op(self, other):
        return self.map_operator(name, other)
    op.__name__ = name
    return op


for _name in _comparison_ops:
    setattr(RaggedArray, _name, _make_op(_name))
RaggedArray.__hash__ = None


def where(mask):
    """np.where generalized to RaggedArrays: returns (rows, offsets).
    (reference: ra/ra.py:27)"""
    if isinstance(mask, RaggedArray):
        flat = np.where(mask._data)
        return _convert_from_1d(flat, starts=mask.starts)
    return np.where(mask)


def zeros_like(array):
    """(reference: ra/ra.py:18)"""
    if isinstance(array, RaggedArray):
        return RaggedArray(np.zeros_like(array._data),
                           lengths=array.lengths)
    return np.zeros_like(array)


# -- HDF5 persistence ----------------------------------------------------

def save(filename, array, compression_level=1, tag='arr'):
    """Save a RaggedArray (or ndarray) as HDF5 with one dataset per row
    named ``arr_00``, ``arr_01``, ... — byte-compatible with the
    reference's new-style format (reference: ra/ra.py:45). Uses h5py with
    zlib/gzip + shuffle like the reference's pytables filters."""
    import h5py

    if isinstance(array, RaggedArray):
        rows = [array._array[i] for i in range(len(array))]
        n_zeros = len(str(len(array.lengths))) + 1
    elif isinstance(array, np.ndarray):
        rows = [array]
        n_zeros = 1
    else:  # list of arrays
        rows = [np.asarray(r) for r in array]
        n_zeros = len(str(len(rows))) + 1

    kwargs = {}
    if compression_level and compression_level > 0:
        kwargs = dict(compression='gzip',
                      compression_opts=int(compression_level),
                      shuffle=True)

    with h5py.File(filename, 'w') as handle:
        for i, row in enumerate(rows):
            name = tag + '_' + str(i).zfill(n_zeros)
            row = np.asarray(row)
            ck = kwargs if row.size else {}
            handle.create_dataset(name, data=row, **ck)
    return filename


def load(input_name, keys=..., stride=1):
    """Load a RaggedArray (or plain ndarray when only one key exists).
    Understands both the new style (``arr_*`` keys) and the deprecated
    old style (``/array`` + ``/lengths``). (reference: ra/ra.py:117)"""
    import h5py

    with h5py.File(input_name, 'r') as handle:
        if keys is None:
            if 'lengths' in handle:
                a = RaggedArray(
                    np.asarray(handle['array']),
                    lengths=np.asarray(handle['lengths']))
                return a[::stride]
            return np.asarray(handle['arr_0'])[::stride]

        if keys is Ellipsis:
            if 'lengths' in handle and 'array' in handle:
                a = RaggedArray(
                    np.asarray(handle['array']),
                    lengths=np.asarray(handle['lengths']))
                return a[:, ::stride] if stride != 1 else a
            keys = sorted(handle.keys())

        if len(keys) == 1:
            return np.asarray(handle[keys[0]])[::stride]

        shapes = [handle[k].shape for k in keys]
        if not all(len(shapes[0]) == len(s) for s in shapes):
            raise DataInvalid(
                'Loading a RaggedArray using HDF5 file keys requires that '
                'all input arrays have the same dimension. Got shapes: %s'
                % (shapes,))
        for dim in range(1, len(shapes[0])):
            if not all(shapes[0][dim] == s[dim] for s in shapes):
                raise DataInvalid(
                    'Loading a RaggedArray using HDF5 file keys requires '
                    'that all input arrays share nonragged dimensions. '
                    'Dimension %s didn\'t match. Got shapes: %s'
                    % (dim, shapes))
        dtypes = set(handle[k].dtype for k in keys)
        if len(dtypes) > 1:
            raise DataInvalid(
                "Can't load keys because the keys didn't all have the "
                "same dtype. Got: %s" % dtypes)

        lengths = [(s[0] + stride - 1) // stride for s in shapes]
        concat = np.empty((sum(lengths),) + tuple(shapes[0][1:]),
                          dtype=handle[keys[0]].dtype)
        start = 0
        for k in keys:
            block = handle[k][::stride]
            concat[start:start + len(block)] = block
            start += len(block)
        return RaggedArray(concat, lengths=lengths, copy=False)
