"""Prinz detailed-balance MLE host kernel.

``_mle_prinz_dense`` matches the reference Cython kernel
(enspara/msm/libmsm.pyx:15) operation-for-operation: Gauss-Seidel sweep
over the diagonal, then all (i, j>i) pairs with the quadratic-root
update, log-likelihood-change stopping. The fast path is the C++ kernel
in enspara_tpu_torch/native/prinz.cpp via ctypes; the pure-Python mirror below
is the fallback and the parity oracle.
"""

import ctypes
import warnings

import numpy as np

from ..exception import ConvergenceWarning
from ..native import load_library

__all__ = ['_mle_prinz_dense', '_mle_prinz_dense_py']

_lib = None
_lib_checked = False


def _get_lib():
    global _lib, _lib_checked
    if not _lib_checked:
        _lib = load_library('prinz')
        if _lib is not None:
            _lib.mle_prinz_dense.restype = ctypes.c_long
            _lib.mle_prinz_dense.argtypes = [
                ctypes.POINTER(ctypes.c_double), ctypes.c_long,
                ctypes.c_double, ctypes.c_long,
                ctypes.POINTER(ctypes.c_double),
                ctypes.POINTER(ctypes.c_double),
            ]
        _lib_checked = True
    return _lib


def _mle_prinz_dense(C, tol=1e-10, max_iter=10**5):
    """Reversible MLE transition matrix from dense counts ``C``.
    Returns ``(T, pi)``."""
    C = np.ascontiguousarray(C, dtype=np.float64)
    n = len(C)

    lib = _get_lib()
    if lib is not None:
        T = np.empty((n, n), dtype=np.float64)
        pi = np.empty(n, dtype=np.float64)
        dptr = ctypes.POINTER(ctypes.c_double)
        n_iter = lib.mle_prinz_dense(
            C.ctypes.data_as(dptr), n, tol, max_iter,
            T.ctypes.data_as(dptr), pi.ctypes.data_as(dptr))
        if n_iter < 0:
            raise ValueError(
                'Prinz MLE requires every state to have at least one '
                'transition (all row sums of C and C+C.T positive). '
                'Trim disconnected states first.')
        if n_iter == max_iter - 1:
            warnings.warn('Prinz MLE did not converge after %s '
                          'iterations.' % n_iter, ConvergenceWarning)
        return T, pi

    return _mle_prinz_dense_py(C, tol=tol, max_iter=max_iter)


def _mle_prinz_dense_py(C, tol=1e-10, max_iter=10**5):
    """Pure-Python mirror (reference keeps the same mirror as
    builders._prinz_mle_py:215 for parity testing)."""
    C = np.array(C, dtype=float, copy=True)
    X = C + C.T

    X_rs = X.sum(axis=1)
    C_rs = C.sum(axis=1)

    if not (np.all(X_rs > 0) and np.all(C_rs > 0)):
        raise ValueError(
            'Prinz MLE requires every state to have at least one '
            'transition. Trim disconnected states first.')

    n = len(C)
    oldlogl = 0.0
    n_iter = 0
    for n_iter in range(max_iter):
        logl = 0.0

        # diagonal pass (each i independent -> vectorizable, but kept
        # loop-exact with the reference)
        for i in range(n):
            tmp = X[i, i]
            denom = C_rs[i] - C[i, i]
            if denom > 0:
                X[i, i] = C[i, i] * (X_rs[i] - X[i, i]) / denom
            X_rs[i] += (X[i, i] - tmp)
            if X[i, i] > 0:
                # reference uses log10 for the stopping metric
                # (libmsm.pyx:46) — the base changes which sweep
                # crosses tol, so match it exactly
                logl += C[i, i] * np.log10(X[i, i] / X_rs[i])

        for i in range(n - 1):
            for j in range(i + 1, n):
                a = (C_rs[i] - C[i, j]) + (C_rs[j] - C[j, i])
                b = (C_rs[i] * (X_rs[j] - X[i, j])
                     + C_rs[j] * (X_rs[i] - X[i, j])
                     - (C[i, j] + C[j, i])
                     * (X_rs[i] + X_rs[j] - 2 * X[i, j]))
                c = -(C[i, j] + C[j, i]) \
                    * (X_rs[i] - X[i, j]) * (X_rs[j] - X[i, j])

                if a == 0:
                    v = X[j, i]
                else:
                    v = (-b + np.sqrt(b * b - 4 * a * c)) / (2 * a)

                X_rs[i] += (v - X[i, j])
                X_rs[j] += (v - X[j, i])
                X[i, j] = v
                X[j, i] = v

                if v > 0:
                    logl += (C[i, j] * np.log10(v) / X_rs[i]
                             + C[j, i] * np.log10(v) / X_rs[j])

        if abs(logl - oldlogl) > tol:
            oldlogl = logl
        else:
            break

    if n_iter == max_iter - 1:
        warnings.warn('Prinz MLE did not converge after %s iterations.'
                      % n_iter, ConvergenceWarning)

    T = X / X.sum(axis=-1).reshape(n, 1)
    pi = X_rs / X_rs.sum()
    return T, pi
