"""Host parallelism helpers. (reference: enspara/util/parallel.py)"""

import ctypes
import functools
import itertools
import multiprocessing as mp
import os

import numpy as np

__all__ = ['auto_nprocs', 'pool_dense2d', 'pool_sparse2d']


def auto_nprocs():
    """Number of worker threads/processes to use: OMP_NUM_THREADS if
    set, else the CPU count. (reference: util/parallel.py:20)"""
    env = os.environ.get('OMP_NUM_THREADS')
    if env:
        try:
            return int(env)
        except ValueError:
            pass
    return mp.cpu_count()


# ---------------------------------------------------------------------
# read-only shared-memory process pools (reference:
# util/parallel.py:24/46). Workers retrieve the shared matrix with the
# returned zero-argument function; no lock, read-only by convention.
# ---------------------------------------------------------------------

_SHARED = {}
_POOL_SEQ = itertools.count()


def _pool_init(key, buf):
    _SHARED[key] = buf


def _get_dense2d(key, shape):
    arr = np.frombuffer(_SHARED[key])
    return arr.reshape(shape)


def _get_sparse2d(key, nnz, shape):
    import scipy.sparse

    flat = np.frombuffer(_SHARED[key])
    data, i, j = flat[:nnz], flat[nnz:2 * nnz], flat[2 * nnz:]
    return scipy.sparse.coo_matrix(
        (data, (i.astype(np.int64), j.astype(np.int64))), shape=shape)


def pool_dense2d(arr, processes=None):
    """Process pool sharing a read-only dense 2-D float64 matrix.
    Returns ``(pool, retrieve)`` where workers call ``retrieve()`` for
    the shared array (reference: util/parallel.py:24)."""
    arr = np.asarray(arr)
    buf = mp.Array(ctypes.c_double, arr.size, lock=False)
    buf[:] = arr.astype(np.float64).ravel()
    # unique per pool: a fixed key would let a second pool clobber the
    # parent-side buffer behind the first pool's retrieve()
    key = 'dense2d-%d' % next(_POOL_SEQ)
    pool = mp.Pool(processes=processes, initializer=_pool_init,
                   initargs=(key, buf))
    _pool_init(key, buf)  # parent can retrieve too
    return pool, functools.partial(_get_dense2d, key, arr.shape)


def pool_sparse2d(arr, processes=None):
    """Process pool sharing a read-only sparse 2-D matrix as
    (data, row, col) float64 triplets (reference:
    util/parallel.py:46)."""
    coo = arr.tocoo()
    nnz = coo.nnz
    buf = mp.Array(ctypes.c_double, 3 * nnz, lock=False)
    buf[:nnz] = coo.data.astype(np.float64)
    buf[nnz:2 * nnz] = coo.row.astype(np.float64)
    buf[2 * nnz:] = coo.col.astype(np.float64)
    key = 'sparse2d-%d' % next(_POOL_SEQ)
    pool = mp.Pool(processes=processes, initializer=_pool_init,
                   initargs=(key, buf))
    _pool_init(key, buf)
    return pool, functools.partial(_get_sparse2d, key, nnz, coo.shape)
