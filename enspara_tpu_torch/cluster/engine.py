"""Device clustering engine for metric 'rmsd' (counterpart of the
single-device paths of ``enspara_tpu/cluster/engine.py``): k-centers
and the batched nearest-center assignment.

Frames are ingested once into the kernels' layout: ``(3*A_pad, n_pad)``
float32 with row ``i*A_pad + a`` holding coordinate ``i`` of atom ``a``
and the frame axis minor, plus a per-frame G row. A host loop then runs
the k-centers chunk (:mod:`enspara_tpu_torch.ops.kcenters_step`, the
tri-skip CUDA kernel on the card) ``CHUNK`` centers at a time, reading
32 bytes of state back after each chunk to decide whether to go on.

Padding frames carry ``g = 1.0`` and ``distance = -inf``: they are
never chosen as a center, never count toward the stop rule and keep
assignment -1.

Nearest-center assignment (:func:`assign_device`) and the PAM sweeps
(``engine_kmedoids``) take their RMSD blocks from
:mod:`enspara_tpu_torch.ops.qcp_matrix`: on the card, the all-pairs
CUDA kernel.
"""

import math
from typing import NamedTuple

import numpy as np
import torch

from ..ops.kcenters_step import kcenters_chunk, start_state
from ..ops.qcp_matrix import (TILE_C, pad_centers, pad_frames,
                              qcp_rmsd_matrix_block, to_layout)
from ..util.device import resolve_device

__all__ = ['KCentersDeviceResult', 'PreparedRMSDFrames',
           'prepare_rmsd_frames', 'kcenters_device_fused', 'assign_device']

METRIC_TODO = ("only metric 'rmsd' is ported, got %r: the euclidean, "
               'manhattan and hamming metrics are ROADMAP.md queue 1 '
               'step 5b')

# frames per tile: one CUDA block of one thread per frame
TILE = 256
# centers per chunk: the host reads the loop state once per chunk
CHUNK = 64


class KCentersDeviceResult(NamedTuple):
    distances: np.ndarray       # (n,) float64
    assignments: np.ndarray     # (n,) int64
    center_indices: np.ndarray  # (n_found,) int64 frame indices
    n_found: int


class PreparedRMSDFrames(NamedTuple):
    """Frames ingested once into the k-centers layout on one device;
    build with :func:`prepare_rmsd_frames` and pass to
    :func:`kcenters_device_fused` in place of coordinates to reuse the
    layout across runs (warm starts, cutoff scans)."""
    frames_r: torch.Tensor     # (3*A_pad, n_pad) float32
    g: torch.Tensor            # (1, n_pad) float32; 1.0 past n
    n: int                     # real frame count
    n_atoms: int               # real atom count
    tile: int


def prepare_rmsd_frames(X, tile=TILE, device=None):
    """Ingest ``(n, n_atoms, 3)`` coordinates (numpy or a tensor) into
    the k-centers layout on ``device`` (default: where a tensor ``X``
    lies, the card for host data).
    Frames are centered here; ``A_pad`` is the atom count rounded up to
    a multiple of 8 and ``n_pad`` the frame count rounded up to a
    multiple of ``tile``."""
    device = resolve_device(X, device)
    X = torch.as_tensor(X, dtype=torch.float32, device=device)
    if X.ndim != 3 or X.shape[-1] != 3:
        raise ValueError('prepare_rmsd_frames requires (n, n_atoms, 3) '
                         'coordinates, got %s' % (tuple(X.shape),))
    n, A = int(X.shape[0]), int(X.shape[1])
    n_pad = -(-n // tile) * tile
    A_pad = -(-A // 8) * 8
    centered = X - X.mean(dim=1, keepdim=True)
    g = torch.ones((1, n_pad), dtype=torch.float32, device=device)
    g[0, :n] = (centered * centered).sum(dim=(1, 2))
    frames = torch.zeros((3, A_pad, n_pad), dtype=torch.float32,
                         device=device)
    frames[:, :A, :n] = centered.permute(2, 1, 0)
    return PreparedRMSDFrames(frames.view(3 * A_pad, n_pad), g, n, A,
                              int(tile))


def _kcenters_loop(prep, dist, assig, n_start, n_clusters, dist_cutoff,
                   k_max):
    """Chunked k-centers from the (1, n_pad) ``dist``/``assig`` state
    (updated in place). Returns ``(ctr (k_max,), n_found)``; ``ctr``
    holds -1 in the warm-start slots."""
    G = int(min(CHUNK, k_max))
    state = start_state(dist, assig, prep.frames_r.shape[0], prep.tile,
                        n_start, n_clusters, dist_cutoff)
    ctr = torch.full((k_max + G,), -1, dtype=torch.int32, device=dist.device)
    _, md, i = state.scalars()
    while i < n_clusters and md > dist_cutoff:
        ctr[i:i + G] = kcenters_chunk(prep, state, G)[0]
        _, md, i = state.scalars()
    return ctr[:k_max], i


def kcenters_device_fused(X, n_clusters=None, dist_cutoff=None,
                          k_max=None, init_distances=None,
                          init_assignments=None, n_init_centers=0,
                          init_center_indices=None, tile=None,
                          device=None):
    """K-centers by QCP RMSD on one device.

    ``X`` is a :class:`PreparedRMSDFrames`, which clusters where its
    frames lie, or ``(n, n_atoms, 3)`` coordinates, prepared on
    ``device`` (default: where a tensor ``X`` lies, the card for host
    data).
    Stops at ``n_clusters`` centers or once the max distance is
    ``<= dist_cutoff``. A warm start passes the previous run's
    ``init_distances``/``init_assignments`` with ``n_init_centers``
    (and optionally ``init_center_indices``). On CUDA the loop runs the
    tri-skip kernel; on the CPU its plain version.

    Returns a :class:`KCentersDeviceResult` of host arrays.
    """
    if isinstance(X, PreparedRMSDFrames):
        prep = X
        if tile is not None and tile != prep.tile:
            raise ValueError('prepared frames use tile=%d, got tile=%d'
                             % (prep.tile, tile))
    else:
        prep = prepare_rmsd_frames(X, tile=tile or TILE, device=device)
    n, n_pad = prep.n, prep.frames_r.shape[1]
    dev = prep.frames_r.device

    if k_max is None:
        k_max = int(n_clusters) if n_clusters is not None else n
    k_max = int(min(k_max, n))
    n_clusters_eff = int(min(n_clusters or n, k_max))
    cutoff_eff = float(np.float32(dist_cutoff if dist_cutoff is not None
                                  else 0.0))

    dist = np.full((1, n_pad), np.inf, np.float32)
    assig = np.full((1, n_pad), -1, np.int32)
    if init_distances is not None:
        dist[0, :n] = init_distances
        assig[0, :n] = init_assignments
    dist[0, n:] = -math.inf
    dist_t = torch.from_numpy(dist).to(dev)
    assig_t = torch.from_numpy(assig).to(dev)

    ctr, n_found = _kcenters_loop(prep, dist_t, assig_t,
                                  int(n_init_centers), n_clusters_eff,
                                  cutoff_eff, k_max)
    dists = dist_t[0, :n].cpu().numpy().astype(np.float64)
    assigs = assig_t[0, :n].cpu().numpy().astype(np.int64)
    ctr_inds = ctr[:n_found].cpu().numpy().astype(np.int64)
    if init_center_indices is not None:
        ctr_inds[:n_init_centers] = init_center_indices
    return KCentersDeviceResult(dists, assigs, ctr_inds, n_found)


def require_rmsd(metric):
    """Raise ``NotImplementedError`` for any metric but 'rmsd'."""
    if metric != 'rmsd':
        raise NotImplementedError(METRIC_TODO % (metric,))


# ---------------------------------------------------------------------
# all-pairs RMSD blocks and the batched nearest-center assignment
# ---------------------------------------------------------------------

def _center_structures(X):
    """Remove each structure's centroid: ``(n, n_atoms, 3)`` tensor."""
    return X - X.mean(dim=1, keepdim=True)


def _all_frames(prep):
    """``prep``'s layout and G as the matrix block takes them: the frame
    axis padded to a multiple of 256 if its tile left it shorter."""
    fr, g = prep.frames_r, prep.g[0]
    n_pad = fr.shape[1]
    if n_pad % 256:
        want = pad_frames(n_pad)
        fr = torch.nn.functional.pad(fr, (0, want - n_pad))
        g = torch.nn.functional.pad(g, (0, want - n_pad), value=1.0)
    return fr, g


def _gather(prep, idx, width):
    """Frames ``idx`` of ``prep`` as ``width`` layout columns and their
    G, zero columns with G = 1.0 past ``len(idx)``."""
    idx = torch.as_tensor(idx, dtype=torch.long, device=prep.g.device)
    cols = torch.zeros((prep.frames_r.shape[0], width), dtype=torch.float32,
                       device=prep.g.device)
    cols[:, :len(idx)] = prep.frames_r[:, idx]
    g = torch.ones(width, dtype=torch.float32, device=prep.g.device)
    g[:len(idx)] = prep.g[0, idx]
    return cols, g


def _pairwise_block(prep, cols, rows=None, metric='rmsd'):
    """RMSD of frames ``rows`` (default: all ``n_pad`` of them) to
    frames ``cols`` of ``prep``, ``(n_rows, len(cols))`` float32: one
    all-pairs block, the CUDA kernel on the card."""
    require_rmsd(metric)
    if rows is None:
        fr, gf = _all_frames(prep)
        n_rows = prep.frames_r.shape[1]
    else:
        n_rows = len(rows)
        fr, gf = _gather(prep, rows, pad_frames(n_rows))
    cr, gc = _gather(prep, cols, pad_centers(len(cols)))
    return qcp_rmsd_matrix_block(fr, gf, cr, gc, prep.n_atoms)[
        :n_rows, :len(cols)]


def _assign_all_rmsd(prep, centers):
    """Every frame of ``prep`` to its nearest of ``centers`` (k, A, 3),
    centered, on ``prep``'s device: a loop over 256-wide center blocks
    (one 64-multiple block below 256 centers) carrying the running
    (min, argmin). First-min ties: ``min`` keeps the lowest index
    inside a block and a strict ``<`` the earlier block; padded centers
    are masked to +inf. Returns ``(assigs (n_pad,) int32, dists (n_pad,)
    float32)``."""
    k = int(centers.shape[0])
    fr, gf = _all_frames(prep)
    n_pad = prep.frames_r.shape[1]
    a_pad = fr.shape[0] // 3
    width = pad_centers(k) if k < TILE_C else TILE_C
    best_d = torch.full((n_pad,), math.inf, dtype=torch.float32,
                        device=fr.device)
    best_i = torch.zeros((n_pad,), dtype=torch.int32, device=fr.device)
    for lo in range(0, k, width):
        cr, gc = to_layout(centers[lo:lo + width], width, a_pad)
        d = qcp_rmsd_matrix_block(fr, gf, cr, gc, prep.n_atoms)[:n_pad]
        if lo + width > k:
            d[:, k - lo:] = math.inf
        local_min, local_arg = d.min(dim=1)
        upd = local_min < best_d
        best_d = torch.where(upd, local_min, best_d)
        best_i = torch.where(upd, (local_arg + lo).to(torch.int32), best_i)
    return best_i, best_d


def assign_device(X, centers, metric='rmsd', device=None):
    """Assign every frame to its nearest center: the batched device
    form of ``assign_to_nearest_center``.

    ``X`` is ``(n, n_atoms, 3)`` coordinates (numpy or a tensor),
    prepared on ``device`` (default: where a tensor ``X`` lies, the card
    for host data), or a
    :class:`PreparedRMSDFrames`; ``centers`` is ``(k, n_atoms, 3)``.
    Frames and centers are centered on the device. Only
    ``metric='rmsd'`` is ported.

    Returns ``(assignments (n,) int64, distances (n,) float64)`` as
    numpy arrays.
    """
    require_rmsd(metric)
    prep = X if isinstance(X, PreparedRMSDFrames) \
        else prepare_rmsd_frames(X, device=device)
    C = torch.as_tensor(np.asarray(centers) if not isinstance(
        centers, torch.Tensor) else centers, dtype=torch.float32,
        device=prep.g.device)
    if C.ndim != 3 or C.shape[1:] != (prep.n_atoms, 3):
        raise ValueError('centers must be (k, %d, 3), got %s'
                         % (prep.n_atoms, tuple(C.shape)))
    assigs, dists = _assign_all_rmsd(prep, _center_structures(C))
    return (assigs[:prep.n].cpu().numpy().astype(np.int64),
            dists[:prep.n].cpu().numpy().astype(np.float64))
