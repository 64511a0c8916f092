"""Joint-count histograms, the CARDS hot loop (counterpart of
``enspara_tpu/info_theory/libinfo.py``; reference:
enspara/info_theory/libinfo.pyx:30,50).

The 4-D joint-count tensor ``jc[fa, fb, i, j]`` is one one-hot product a
chunk of frames,

    jc += onehot(a)ᵀ @ onehot(b),   onehot(a): (t, Fa*n_a) float32,

summed into int64. The operands are float32 so that the product is
float32: the one-hot values 0 and 1 are exact in float32, TF32 and
bf16, and the sums stay exact in the float32 accumulator up to 2^24, so
the counts are exact whatever the caller set for TF32. (A product of two
bf16 tensors is bf16 in torch, which would round every count above 256.)
A chunk holds at most 2^23 frames and its two one-hots at most
``_CHUNK_ELEMENTS`` values.

It runs on the device of its input, or of ``device=``; host input goes to
the card (:func:`~enspara_tpu_torch.util.device.resolve_device`). With
``mesh=`` (a :class:`~enspara_tpu_torch.parallel.FrameMesh`) each chunk's
frames are cut into one contiguous block a shard, counted on the shard's
device and summed by ``FrameMesh.reduce``. Blocks may differ in length by
a frame, so nothing is padded.
"""

import numpy as np
import torch

from ..util.device import resolve_device

__all__ = ['bincount2d', 'matrix_bincount2d', 'matrix_bincount2d_np']

# float32 one-hot values of both operands a chunk (1 GiB)
_CHUNK_ELEMENTS = 1 << 28
# frames a chunk at most: float32 sums of 0/1 are exact below 2^24
_MAX_CHUNK_FRAMES = 1 << 23


def bincount2d(a, b, n_a, n_b):
    """2-D histogram of paired integer sequences, uint32.
    (reference: libinfo.pyx:30)"""
    a = np.asarray(a).reshape(-1)
    b = np.asarray(b).reshape(-1)
    assert a.shape[0] == b.shape[0]
    H = np.bincount(a.astype(np.int64) * n_b + b.astype(np.int64),
                    minlength=n_a * n_b)
    return H.reshape(n_a, n_b).astype(np.uint32)


def chunk_frames(width):
    """Frames a chunk of one-hot rows ``width`` values wide."""
    return int(min(_MAX_CHUNK_FRAMES,
                   max(1, _CHUNK_ELEMENTS // max(int(width), 1))))


def as_label_tensor(x):
    """``x`` as an integer tensor torch can compare: numpy input keeps
    its integer width where torch has it (int8, uint8, int16, int32,
    int64), other unsigned and bool labels become int64 and uint8."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.uint8) if x.dtype == torch.bool else x
    x = np.asarray(x)
    if x.dtype == np.bool_:
        x = x.astype(np.uint8)
    elif x.dtype.kind == 'u' and x.dtype.itemsize > 1:
        x = x.astype(np.int64)
    return torch.from_numpy(np.ascontiguousarray(x))


def onehot(x, n, dtype=torch.float32):
    """(t, F) labels -> (t, F*n) one-hot rows of ``dtype``; labels outside
    [0, n) give zero rows."""
    iota = torch.arange(n, device=x.device)
    return (x.unsqueeze(-1) == iota).to(dtype).reshape(x.shape[0], -1)


def _count(ac, bc, n_a, n_b, same):
    """Joint counts of one block of frames, (Fa*n_a, Fb*n_b) int64."""
    A = onehot(ac, n_a)
    B = A if same else onehot(bc, n_b)
    return (A.T @ B).to(torch.int64)


def matrix_bincount2d(a, b, n_a, n_b, mesh=None, device=None):
    """All-feature-pairs joint counts:
    ``jc[fa, fb, i, j] = #{t : a[t, fa] == i and b[t, fb] == j}``.
    (reference: libinfo.pyx:50)

    ``a`` (T, Fa) and ``b`` (T, Fb) are integer labels, numpy or tensors.
    Returns an (Fa, Fb, n_a, n_b) numpy uint32 (int64 when a count
    reaches 2^32)."""
    if mesh is not None and device is not None:
        raise ValueError('pass device= or mesh=, not both')
    lead = mesh.lead if mesh is not None else resolve_device(a, device)
    same = a is b
    a = as_label_tensor(a)
    b = a if same else as_label_tensor(b)
    assert a.shape[0] == b.shape[0], \
        'Feature arrays a and b must match in length'
    # as Python ints: a uint8 tensor would compare against 256 wrapped to 0
    assert int(a.max()) < n_a, 'States indices must be contiguous.'
    assert int(b.max()) < n_b, 'States indices must be contiguous.'
    # a negative label (e.g. a -1 unassigned sentinel) would one-hot to a
    # zero row and be dropped silently
    assert int(a.min()) >= 0 and int(b.min()) >= 0, \
        'State indices must be non-negative (mask or trim unassigned '\
        'frames before joint counting).'
    n_a, n_b = int(n_a), int(n_b)

    T, Fa = a.shape
    Fb = b.shape[1]
    chunk = chunk_frames(Fa * n_a + (0 if same else Fb * n_b))
    total = torch.zeros((Fa * n_a, Fb * n_b), dtype=torch.int64,
                        device=lead)
    for lo in range(0, T, chunk):
        hi = min(T, lo + chunk)
        if mesh is None:
            ac = a[lo:hi].to(lead)
            total += _count(ac, ac if same else b[lo:hi].to(lead), n_a,
                            n_b, same)
            continue
        # shard s of the job holds frames [edge[s], edge[s+1]) of the chunk
        edge = [lo + (hi - lo) * s // mesh.size
                for s in range(mesh.size + 1)]
        parts = []
        for k, dev in enumerate(mesh.devices):
            s = mesh.first_shard + k
            ac = a[edge[s]:edge[s + 1]].to(dev)
            bc = ac if same else b[edge[s]:edge[s + 1]].to(dev)
            parts.append(_count(ac, bc, n_a, n_b, same))
        total += mesh.reduce(parts)
    jc = total.reshape(Fa, n_a, Fb, n_b).permute(0, 2, 1, 3).cpu().numpy()
    if jc.max(initial=0) < 2 ** 32:
        return jc.astype(np.uint32)
    return jc


def matrix_bincount2d_np(a, b, n_a, n_b):
    """The plain version on the host: a flat bincount per feature pair,
    int64."""
    a = np.asarray(a)
    b = np.asarray(b)
    T, Fa = a.shape
    Fb = b.shape[1]
    jc = np.zeros((Fa, Fb, n_a, n_b), dtype=np.int64)
    a64 = a.astype(np.int64)
    b64 = b.astype(np.int64)
    for fa in range(Fa):
        base = a64[:, fa] * n_b
        for fb in range(Fb):
            h = np.bincount(base + b64[:, fb], minlength=n_a * n_b)
            jc[fa, fb] = h.reshape(n_a, n_b)
    return jc
