"""Point-against-set distances with the reference's libdist API (a copy
of ``enspara_tpu/geometry/libdist.py:18-73``).

``euclidean(X, y, out=None)``, ``manhattan`` and ``hamming`` return
float64 and may write into a float64 ``out``. Host numpy: these are the
small-data entry points and the callables of the host clustering loops;
the device loops use :mod:`enspara_tpu_torch.ops.distances`.
"""

import numpy as np

from ..exception import DataInvalid

__all__ = ['euclidean', 'manhattan', 'hamming']


def _prepare(X, y, out):
    X = np.asarray(X)
    y = np.asarray(y)
    if X.ndim != 2:
        raise DataInvalid(
            'Data array dimension must be two, got shape %s.'
            % str(X.shape))
    if y.ndim != 1:
        raise DataInvalid(
            'Target point dimension must be one, got shape %s.'
            % str(y.shape))
    if X.shape[1] != y.shape[0]:
        raise DataInvalid(
            'Target data point dimension (%s) must match data array '
            'dimension (%s)' % (y.shape[0], X.shape[1]))
    if out is None:
        out = np.zeros(X.shape[0], dtype=np.float64)
    else:
        if out.dtype != np.float64:
            raise DataInvalid(
                "In-place output array must be np.float64, got '%s'."
                % out.dtype)
        if out.ndim != 1:
            raise DataInvalid(
                'In-place output array must be one-dimensional, got '
                'shape %s' % (out.shape,))
        if out.shape[0] != X.shape[0]:
            raise DataInvalid(
                'In-place output array dimension (%s) must match number '
                'of samples in data array (%s)'
                % (out.shape[0], X.shape[0]))
    return X, y, out


def euclidean(X, y, out=None):
    """Euclidean distance from each row of ``X`` (n, d) to ``y`` (d,)."""
    X, y, out = _prepare(X, y, out)
    diff = X.astype(np.float64) - y.astype(np.float64)
    np.sqrt(np.einsum('ij,ij->i', diff, diff), out=out)
    return out


def manhattan(X, y, out=None):
    """Manhattan (L1) distance from each row of ``X`` to ``y``."""
    X, y, out = _prepare(X, y, out)
    np.sum(np.abs(X.astype(np.float64) - y.astype(np.float64)),
           axis=1, out=out)
    return out


def hamming(X, y, out=None):
    """Fraction of positions differing between each row of ``X`` and
    ``y``."""
    X, y, out = _prepare(X, y, out)
    np.mean(X != y, axis=1, dtype=np.float64, out=out)
    return out
