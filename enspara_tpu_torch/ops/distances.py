"""Distances between feature vectors in PyTorch (counterpart of
``enspara_tpu/ops/distances.py:23-118``).

Euclidean, manhattan (cityblock) and hamming, point against set and
set against set, on whatever device the tensors lie. The set-against-set
euclidean form is the Gram identity ``|x-y|^2 = |x|^2 + |y|^2 - 2 x.y``
with a ``max(., 0)`` clamp, its product in full float32 (never TF32, as
the JAX module asks for ``Precision.HIGHEST``). Manhattan and hamming
reduce the broadcast difference a few centers at a time, so that no
``(n, m, d)`` temporary larger than ``_BROADCAST_ELEMS`` elements is
built: at 1M frames x 512 centers x 64 features the whole one would be
128 GB. Hamming counts differing elements of any dtype exactly and
scales the count by the float32 ``1/d``, as XLA lowers the JAX mean, so
the two agree bit for bit.

Inputs are tensors, or host arrays that go to ``device=`` (default: the
card; ``$ENSPARA_TPU_PLATFORM=cpu`` keeps them on the CPU).
"""

import numpy as np
import torch

from ..util.device import full_fp32_matmul, resolve_device

__all__ = [
    'euclidean_to_point', 'manhattan_to_point', 'hamming_to_point',
    'pairwise_euclidean', 'pairwise_manhattan', 'pairwise_hamming',
    'pairwise_distance', 'distance_to_point', 'pairwise_distance_np',
]

# elements of the broadcast (n, chunk, d) difference one pass may hold
_BROADCAST_ELEMS = 1 << 28


def _tensors(X, y, float32=True):
    """``X`` and ``y`` as tensors on the device of the first that is a
    tensor (float32 unless ``float32=False``, which keeps their dtype)."""
    dev = resolve_device(X if isinstance(X, torch.Tensor) else y)
    kw = {'dtype': torch.float32} if float32 else {}
    return (torch.as_tensor(X, device=dev, **kw),
            torch.as_tensor(y, device=dev, **kw))


def euclidean_to_point(X, y):
    """Distance from each row of ``X`` (n, d) to point ``y`` (d,), in
    the difference form ``sqrt(sum((X - y)^2))``."""
    X, y = _tensors(X, y)
    return torch.linalg.vector_norm(X - y[None, :], dim=-1)


def manhattan_to_point(X, y):
    X, y = _tensors(X, y)
    return torch.linalg.vector_norm(X - y[None, :], ord=1, dim=-1)


def hamming_to_point(X, y):
    """Fraction of the ``d`` positions where each row of ``X`` differs
    from ``y``: an exact count times the float32 ``1/d``."""
    X, y = _tensors(X, y, float32=False)
    return _hamming(X, y[None, :])


def _hamming(a, b):
    """The fraction of the last axis where ``a`` and ``b`` differ, as
    XLA computes the JAX ``mean``: an exact count times the float32
    ``1/d``. The differences go through float16 (exact for 0 and 1),
    whose sum the CUDA reduction accumulates in float32 without a copy:
    summing the bools themselves first copies them into int64, eight
    times their size."""
    count = (a != b).to(torch.float16).sum(-1, dtype=torch.float32)
    return count.mul_(float(np.float32(1.0) / np.float32(a.shape[-1])))


def pairwise_euclidean(X, Y, squared=False):
    """All-pairs euclidean distances (n, m) via the Gram identity, the
    clamp guarding fp32 cancellation for near-identical points. The
    product runs in full float32; ``addmm`` forms ``(|x|^2 + |y|^2) -
    2 x.y`` in the JAX module's order in one (n, m) buffer."""
    X, Y = _tensors(X, Y)
    xx = (X * X).sum(-1)
    yy = (Y * Y).sum(-1)
    with full_fp32_matmul():
        d2 = torch.addmm(xx[:, None] + yy[None, :], X, Y.t(), alpha=-2.0)
    d2.clamp_(min=0.0)
    return d2 if squared else d2.sqrt_()


def _by_center_chunks(X, Y, fn):
    """``fn(X[:, None, :], Y[None, chunk, :])`` over chunks of ``Y``'s
    rows, each chunk's broadcast at most ``_BROADCAST_ELEMS`` elements,
    into one (n, m) float32 result."""
    n, d = X.shape
    m = Y.shape[0]
    step = max(1, _BROADCAST_ELEMS // max(n * d, 1))
    if step >= m:
        return fn(X[:, None, :], Y[None, :, :])
    out = torch.empty((n, m), dtype=torch.float32, device=X.device)
    for lo in range(0, m, step):
        out[:, lo:lo + step] = fn(X[:, None, :], Y[None, lo:lo + step, :])
    return out


def pairwise_manhattan(X, Y):
    """All-pairs L1 distances (n, m)."""
    X, Y = _tensors(X, Y)
    return _by_center_chunks(X, Y, lambda a, b: torch.linalg.vector_norm(
        a - b, ord=1, dim=-1))


def pairwise_hamming(X, Y):
    """All-pairs hamming distances (n, m): exact differing-element
    counts of any dtype, times the float32 ``1/d``."""
    X, Y = _tensors(X, Y, float32=False)
    return _by_center_chunks(X, Y, _hamming)


_PAIRWISE = {
    'euclidean': pairwise_euclidean,
    'manhattan': pairwise_manhattan,
    'cityblock': pairwise_manhattan,
    'hamming': pairwise_hamming,
}

_TO_POINT = {
    'euclidean': euclidean_to_point,
    'manhattan': manhattan_to_point,
    'cityblock': manhattan_to_point,
    'hamming': hamming_to_point,
}


def pairwise_distance(X, Y, metric='euclidean'):
    """(n, m) distances between row sets under the named metric."""
    try:
        fn = _PAIRWISE[metric]
    except KeyError:
        raise ValueError('Unknown metric %r; choose from %s'
                         % (metric, sorted(_PAIRWISE))) from None
    return fn(X, Y)


def distance_to_point(X, y, metric='euclidean'):
    try:
        fn = _TO_POINT[metric]
    except KeyError:
        raise ValueError('Unknown metric %r; choose from %s'
                         % (metric, sorted(_TO_POINT))) from None
    return fn(X, y)


def pairwise_distance_np(X, Y, metric='euclidean'):
    """Host/numpy mirror used by small host-side paths and tests."""
    X = np.asarray(X)
    Y = np.asarray(Y)
    if metric == 'euclidean':
        d2 = (np.sum(X * X, -1)[:, None] + np.sum(Y * Y, -1)[None, :]
              - 2.0 * X @ Y.T)
        return np.sqrt(np.maximum(d2, 0.0))
    if metric in ('manhattan', 'cityblock'):
        return np.abs(X[:, None, :] - Y[None, :, :]).sum(-1)
    if metric == 'hamming':
        return (X[:, None, :] != Y[None, :, :]).mean(-1)
    raise ValueError('Unknown metric %r' % metric)
