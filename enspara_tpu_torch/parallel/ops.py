"""The collective vocabulary of the frame mesh (counterpart of
``enspara_tpu/parallel/ops.py``; reference: enspara/mpi/ops.py).

Device level: each function takes this process's per-shard tensors (a
list, one per ``mesh.devices`` entry, the frame axis first), reduces
them on the lead device with torch ops and then over the processes of
the mesh, and returns the global result.

================================  =====================================
reference (mpi4py)                here
================================  =====================================
allreduce(MAX) striped max        ``striped_max``
allreduce(SUM) striped mean       ``striped_mean`` (sums and counts)
allgather of local argmax/max     ``global_argmax`` (ties go to the
                                  smallest global index: np.argmax;
                                  also row by row of a block)
Bcast frame from owner rank       ``distribute_frame`` (owner-masked
                                  sum, dtype kept); ``distribute_frames``
                                  for a vector of global indices, in
                                  one collective
================================  =====================================

Host level, by the reference's names (``striped_array_max``,
``striped_array_mean``, ``assemble_striped_array``,
``assemble_striped_ragged_array``, ``convert_local_indices``,
``randind``): each works on this *process's* stripe (item i lives on
process i % n_processes, as in :mod:`enspara_tpu_torch.parallel.io`)
over ``torch.distributed``, and has the exact single-process semantics
when there is one process.
"""

import numpy as np
import torch

from .io import _process_info as _proc_info

__all__ = ['striped_max', 'striped_mean', 'global_argmax',
           'argmax_over_shards',
           'distribute_frame', 'distribute_frames', 'owned_rows',
           'local_shard_bounds',
           'striped_array_max', 'striped_array_mean',
           'assemble_striped_array', 'assemble_striped_ragged_array',
           'convert_local_indices', 'randind']


def local_shard_bounds(n_local, shard):
    """``(start, stop)`` global indices of shard ``shard``'s rows under
    contiguous block striping."""
    start = shard * n_local
    return start, start + n_local


def striped_max(xs, mesh):
    """Global max of a frame-sharded vector (reference mpi/ops.py:128)."""
    return mesh.reduce([x.max() for x in xs], 'max')


def striped_mean(xs, mesh, weights=None):
    """Global mean of a frame-sharded vector, optionally weighted
    (reference mpi/ops.py:143): sums and counts are reduced apart."""
    if weights is None:
        s = mesh.reduce([x.sum() for x in xs])
        n = mesh.reduce([torch.tensor(float(x.numel()), dtype=s.dtype,
                                      device=x.device) for x in xs])
    else:
        s = mesh.reduce([(x * w).sum() for x, w in zip(xs, weights)])
        n = mesh.reduce([w.sum().to(s.dtype) for w in weights])
    return s / n


def global_argmax(xs, mesh):
    """``(value, global index)`` of the global max of a frame-sharded
    array along its frame axis (the first), ties to the smallest global
    index, so results equal the serial ``np.argmax``. For per-shard
    ``(n_local, *batch)`` tensors each column of the batch is reduced on
    its own (the sampling argmax of a PAM proposal block). Both results
    have the batch shape (0-d for vectors) and lie on the lead device."""
    n_local = xs[0].shape[0]
    vals, args = [], []
    for s, x in enumerate(xs):
        v, la = x.max(0)
        start = local_shard_bounds(n_local, mesh.first_shard + s)[0]
        vals.append(v)
        args.append(la + start if start else la)
    return argmax_over_shards(vals, args, mesh)


def argmax_over_shards(vals, args, mesh):
    """The global step of :func:`global_argmax`, from each local
    shard's max ``vals`` and the global index ``args`` of its first
    frame holding it (one same-shaped pair per shard): the max over the
    mesh and the smallest global index holding it, on the lead device,
    in the dtypes of ``vals`` and ``args``. Over processes each value
    and its index cross as one float64 pair, in one collective: float64
    holds float32 values, integers below 2**53 (int32 indices, PAM's
    uint32 priorities, global indices) and their order exactly. No host
    read: a CUDA graph can capture it. A mesh of one shard returns its
    pair as it is."""
    if len(vals) == 1 and not mesh.spans_processes:
        return vals[0].to(mesh.lead), args[0].to(mesh.lead)
    vals = torch.stack([v.to(mesh.lead) for v in vals])
    args = torch.stack([a.to(mesh.lead) for a in args])
    if mesh.spans_processes:
        both = mesh.all_gather(torch.stack((vals.double(), args.double()),
                                           dim=1))
        vals, args = both[:, 0].to(vals.dtype), both[:, 1].to(args.dtype)
    best = vals.amax(0)
    return best, torch.where(vals == best, args,
                             torch.iinfo(args.dtype).max).amin(0)


def owned_rows(global_indices, n_local, shard):
    """``(local index, owned)`` of global frame indices on shard
    ``shard`` under contiguous block striping: the local index clamped
    into the shard, and whether the shard holds the frame."""
    start, stop = local_shard_bounds(n_local, shard)
    owned = (global_indices >= start) & (global_indices < stop)
    return (global_indices - start).clamp(0, n_local - 1), owned


def distribute_frames(xs, global_indices, mesh, dim=0):
    """Frames ``global_indices`` (a 1-D index vector) of a frame-sharded
    array on every shard, along ``dim`` in the order of the indices:
    each shard picks the frames it owns and zeros for the rest, and one
    owner-masked sum over the mesh completes them (the reference's Bcast
    from the owner, for the whole vector at once; the dtype is kept).
    Returns one tensor per local shard, on its device; a mesh of one
    shard picks the frames, with no mask and no sum."""
    gi = torch.as_tensor(global_indices, device=mesh.lead).long()
    if len(xs) == 1 and not mesh.spans_processes:
        return [xs[0].index_select(dim, gi.to(xs[0].device))]
    n_local = xs[0].shape[dim]
    # every shard picks the owner's local row; the owner's alone counts
    owner = torch.div(gi, n_local, rounding_mode='floor')
    li = gi - owner * n_local
    shape = [1] * xs[0].ndim
    shape[dim] = -1
    parts = []
    for s, x in enumerate(xs):
        own = (owner == mesh.first_shard + s).to(x.device).view(shape)
        picked = x.index_select(dim, li.to(x.device))
        parts.append(torch.where(own, picked, 0).to(picked.dtype))
    out = mesh.reduce(parts)
    return [out.to(d) for d in mesh.devices]


def distribute_frame(xs, global_index, mesh):
    """Row ``global_index`` of a frame-sharded array on every shard
    (reference mpi/ops.py:169, a Bcast from the owner): an owner-masked
    sum that keeps the input's dtype. Returns one tensor per local
    shard, on its device."""
    gi = torch.as_tensor(global_index).reshape(1)
    return [r[0] for r in distribute_frames(xs, gi, mesh)]


# ---------------------------------------------------------------------
# host level: process-striped arrays over torch.distributed
# ---------------------------------------------------------------------

def _allgather_obj(obj):
    """Every process's array, in rank order; each keeps its owner's
    shape and dtype (a process with an empty stripe holds a 1-D float64
    ``np.array([])`` that must not decide the others' type)."""
    _, size = _proc_info()
    obj = np.asarray(obj)
    if size == 1:
        return [obj]
    import torch.distributed as dist
    out = [None] * size
    dist.all_gather_object(out, obj)
    return out


def striped_array_max(local_array):
    """Global max of a process-striped array (reference
    mpi/ops.py:128)."""
    return max(np.max(s) for s in _allgather_obj(np.max(local_array)))


def striped_array_mean(local_array):
    """Global mean of a process-striped array: sums and counts are
    reduced apart, then divided (reference mpi/ops.py:143)."""
    _, size = _proc_info()
    if size == 1:
        return np.sum(local_array) / len(local_array)
    parts = _allgather_obj(np.array([np.sum(local_array),
                                     len(local_array)], np.float64))
    total = np.sum(parts, axis=0)
    return float(total[0] / total[1])


def _owner_proto(stripes, local):
    return next((np.asarray(s) for s in stripes if len(s)),
                np.asarray(local))


def assemble_striped_array(local_arr):
    """Assemble an array whose element i lives on process i % size
    (reference mpi/ops.py:42). One process: the identity."""
    _, size = _proc_info()
    if size == 1:
        return local_arr
    stripes = _allgather_obj(local_arr)
    proto = _owner_proto(stripes, local_arr)
    out = np.zeros((sum(len(s) for s in stripes),) + proto.shape[1:],
                   dtype=proto.dtype)
    for r, stripe in enumerate(stripes):
        if len(stripe):
            out[r::size] = stripe
    return out


def assemble_striped_ragged_array(local_array, global_lengths):
    """Assemble a ragged array whose rows are striped over processes
    (row i on process i % size), given every row's global length
    (reference mpi/ops.py:82). Returns the flat concatenated data."""
    from .. import ra as ra_mod

    _, size = _proc_info()
    global_lengths = np.asarray(global_lengths)
    if size == 1:
        return np.asarray(local_array)
    out = ra_mod.RaggedArray(np.zeros(int(global_lengths.sum())) - 1,
                             lengths=global_lengths)
    stripes = _allgather_obj(local_array)
    for r, stripe in enumerate(stripes):
        out[r::size] = ra_mod.RaggedArray(stripe,
                                          lengths=global_lengths[r::size])
    return out._data.astype(_owner_proto(stripes, local_array).dtype)


def convert_local_indices(local_ctr_inds, global_lengths):
    """``(owner_rank, local_frame)`` pairs -> global frame indices, from
    the global per-trajectory lengths (reference mpi/ops.py:14)."""
    from .. import ra as ra_mod

    _, size = _proc_info()
    global_lengths = np.asarray(global_lengths)
    origin = ra_mod.RaggedArray(np.arange(int(global_lengths.sum())),
                                lengths=global_lengths)
    return [origin[int(rank)::size].flatten()[int(local_fid)]
            for rank, local_fid in local_ctr_inds]


def randind(local_array, random_state=None):
    """A uniformly random element of a process-striped array, as
    ``(owner_rank, local_index)`` (reference mpi/ops.py:215). Process 0
    draws the global index and broadcasts it, so every process agrees."""
    from .. import ra as ra_mod
    from ..exception import DataInvalid
    from ..util.backend import check_random_state

    _, size = _proc_info()
    random_state = check_random_state(random_state)
    if size == 1:
        if len(local_array) < 1:
            raise DataInvalid('Random choice requires a non-empty array.')
        return (0, random_state.randint(len(local_array)))

    import torch.distributed as dist
    n_states = np.array([int(s) for s in _allgather_obj(len(local_array))])
    if n_states.sum() < 1:
        raise DataInvalid('Random choice requires a non-empty array. '
                          'Got shapes: %s' % n_states)
    pick = [random_state.randint(int(n_states.sum()))]
    dist.broadcast_object_list(pick, src=0)
    concat = np.concatenate([np.arange(int(n_states.sum()))[r::size]
                             for r in range(size)])
    owners = ra_mod.RaggedArray(concat, lengths=list(n_states))
    owner_rank, local_index = ra_mod.where(owners == int(pick[0]))
    return (int(owner_rank[0]), int(local_index[0]))
