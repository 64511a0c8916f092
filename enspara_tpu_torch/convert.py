"""Carry kernel inputs and state between the JAX package and this one.

The two share the frame layout (``(3*A_pad, n_pad)`` float32 or
bfloat16, rows ``i*A_pad + a``, frame axis minor) and the state layout
of the chunk kernel, so a JAX ``PreparedRMSDFrames`` and the arguments and results
of ``kcenters_chunk_skip_pallas`` cross as numpy arrays. The arguments
of the all-pairs TPU kernel (``qcp_pallas._call_pallas``) cross to the
inputs of ``ops.qcp_matrix``. An ``MSM`` manifest the JAX package saved
loads as the port's ``MSM``.
"""

import numpy as np
import torch

from .cluster.engine import TILE, PreparedRMSDFrames, ShardedRMSDFrames
from .msm.msm import MSM
from .ops.kcenters_step import make_state
from .util.device import resolve_device

__all__ = ['prepared_from_numpy', 'sharded_from_numpy', 'state_from_numpy',
           'result_to_numpy', 'qcp_inputs_from_pallas', 'msm_from_manifest']


def _frames_tensor(frames, precision, device):
    """float32 numpy frames as a tensor of the precision's dtype: a
    JAX bf16 layout crosses as float32 (exact) and is stored back in
    bfloat16 (exact too)."""
    dtype = {'fp32': torch.float32, 'bf16': torch.bfloat16}[precision]
    return torch.from_numpy(frames).to(device=device, dtype=dtype)


def prepared_from_numpy(frames_r, g, n, n_atoms, tile=TILE, device=None,
                        precision='fp32'):
    """The port's prepared frames from the numpy arrays of a JAX
    ``PreparedRMSDFrames`` (``precision`` its own: 'fp32', or 'bf16' for
    a bfloat16 layout). Only the frame axis is re-padded, to a multiple
    of ``tile``; rows, ``A_pad`` and the ``g = 1.0`` padding stay as
    they are."""
    device = resolve_device(frames_r, device)
    frames_r = np.asarray(frames_r, np.float32)
    g = np.asarray(g, np.float32).reshape(1, -1)
    rows = frames_r.shape[0]
    n_pad = -(-int(n) // tile) * tile
    frames = np.zeros((rows, n_pad), np.float32)
    frames[:, :n] = frames_r[:, :n]
    g_out = np.ones((1, n_pad), np.float32)
    g_out[:, :n] = g[:, :n]
    return PreparedRMSDFrames(_frames_tensor(frames, precision, device),
                              torch.from_numpy(g_out).to(device),
                              int(n), int(n_atoms), int(tile), precision)


def sharded_from_numpy(frames_r, g, n, n_atoms, tile, mesh,
                       precision='fp32'):
    """The port's sharded frames from the numpy arrays of a JAX
    ``PreparedRMSDFrames`` laid out for a mesh of ``mesh.size`` devices
    (``precision`` its own): the frame axis is cut into the mesh's
    contiguous blocks as it is, and this process's blocks go to their
    devices."""
    frames_r = np.asarray(frames_r, np.float32)
    g = np.asarray(g, np.float32).reshape(1, -1)
    n_local = frames_r.shape[1] // mesh.size
    shards = []
    for s, dev in enumerate(mesh.devices):
        lo = (mesh.first_shard + s) * n_local
        shards.append(PreparedRMSDFrames(
            _frames_tensor(frames_r[:, lo:lo + n_local].copy(), precision,
                           dev),
            torch.from_numpy(g[:, lo:lo + n_local].copy()).to(dev),
            int(min(max(n - lo, 0), n_local)), int(n_atoms), int(tile),
            precision))
    return ShardedRMSDFrames(tuple(shards), int(n), int(n_atoms), int(tile),
                             mesh.size, mesh.first_shard, precision)


def state_from_numpy(dist, assig, tmax, rows, gidx0, max0, i_offset,
                     n_total, dist_cutoff, device=None):
    """The chunk state from the arguments of the JAX chunk kernel:
    (1, n_pad) ``dist``/``assig`` with -inf pad distances, the (1,
    t_pad) ``tmax`` carry and the scalars."""
    device = resolve_device(dist, device)

    def tensor(x, dtype):
        return torch.from_numpy(np.array(x, dtype=dtype)).to(device)
    return make_state(tensor(dist, np.float32), tensor(assig, np.int32),
                      tensor(tmax, np.float32), rows,
                      int(np.asarray(gidx0).reshape(())),
                      float(np.asarray(max0).reshape(())),
                      int(np.asarray(i_offset).reshape(())),
                      int(np.asarray(n_total).reshape(())),
                      float(np.asarray(dist_cutoff).reshape(())))


def result_to_numpy(state, ctr, skipcnt):
    """A chunk's outcome in the return layout of the JAX chunk kernel:
    ``(dist (1, n_pad), assig (1, n_pad), ctr (n_iters, 1), next_gidx
    (1, 1), next_max (1, 1), tmax (1, t_pad), skipcnt (n_iters, 1))``."""
    gidx, md, _ = state.scalars()
    return (state.dist.cpu().numpy(), state.assig.cpu().numpy(),
            ctr.cpu().numpy().reshape(-1, 1),
            np.full((1, 1), gidx, np.int32),
            np.full((1, 1), md, np.float32),
            state.tmax.cpu().numpy(), skipcnt.cpu().numpy().reshape(-1, 1))


def qcp_inputs_from_pallas(frames_t, centers_t, g_f, g_c):
    """The inputs of ``ops.qcp_matrix.qcp_rmsd_matrix_block`` as numpy
    arrays, from the arguments of the JAX ``_call_pallas``: ``(3, F_pad,
    N_pad)`` frames and centers become the ``(3*N_pad, F_pad)`` and
    ``(3*N_pad, C_pad)`` layout (row ``i*N_pad + a``), the ``(F_pad,
    1)``/``(C_pad, 1)`` G columns ``(F_pad,)``/``(C_pad,)`` vectors.
    Padding is carried over as it is."""
    def layout(t):
        t = np.asarray(t, np.float32)
        return np.ascontiguousarray(
            t.transpose(0, 2, 1).reshape(3 * t.shape[2], t.shape[1]))

    def column(g):
        return np.ascontiguousarray(np.asarray(g, np.float32).reshape(-1))
    return layout(frames_t), column(g_f), layout(centers_t), column(g_c)


def msm_from_manifest(path):
    """The port's :class:`~enspara_tpu_torch.msm.MSM` from a manifest
    directory, or a zip archive of one, that the JAX package's
    ``MSM.save`` (or this package's) wrote: ``MSM.load``, whose
    unpickler maps the pickled ``enspara_tpu.msm.builders.<name>`` to
    this package's builder of that name."""
    return MSM.load(path)
