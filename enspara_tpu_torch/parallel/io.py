"""Striped data loading across processes (counterpart of
``enspara_tpu/parallel/io.py``; reference: enspara/mpi/io.py, where rank
i loads file or row i % size).

Process ``r`` of a ``torch.distributed`` job loads items ``r, r + size,
..``; the shards of the frame mesh then split what each process holds.
A single process loads everything, the reference's 1-rank behaviour.
"""

import numpy as np

from ..exception import DataInvalid

__all__ = ['load_h5_as_striped', 'load_npy_as_striped',
           'load_trajectory_as_striped', 'striped_range']


def _process_info():
    """``(rank, world size)`` of the ``torch.distributed`` job, or
    ``(0, 1)`` when none is initialized."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def striped_range(n_items):
    """Indices of the items this process owns (``i % size`` striping,
    reference mpi/io.py:16)."""
    rank, size = _process_info()
    return list(range(rank, n_items, size))


def load_h5_as_striped(filename, stride=1):
    """This process's stripe of rows of a RaggedArray h5 file
    (reference mpi/io.py:16). Returns ``(global_lengths,
    local_data_concatenated)``."""
    import h5py

    with h5py.File(filename, 'r') as f:
        keys = sorted(k for k in f.keys() if k not in ('array', 'lengths'))
        if not keys:
            raise DataInvalid('No ragged-array keys in %s' % filename)
        shapes = [f[k].shape for k in keys]
        global_lengths = [(s[0] + stride - 1) // stride for s in shapes]
        rows = [f[keys[i]][::stride] for i in striped_range(len(keys))]

    local = np.concatenate(rows) if rows else np.array([])
    return global_lengths, local


def load_npy_as_striped(filenames, stride=1):
    """Stripe .npy feature files across processes (reference
    mpi/io.py:74). Strided reads go through a memory map, so only the
    kept rows are read."""
    filenames = list(filenames)
    shapes = [np.load(fn, mmap_mode='r').shape for fn in filenames]
    inner = set(s[1:] for s in shapes)
    if len(inner) > 1:
        raise DataInvalid('Feature files disagree on inner shape: %s'
                          % inner)
    global_lengths = [(s[0] + stride - 1) // stride for s in shapes]
    rows = [np.asarray(np.load(filenames[i], mmap_mode='r')[::stride])
            for i in striped_range(len(filenames))]
    local = np.concatenate(rows) if rows else np.array([])
    return global_lengths, local


def load_trajectory_as_striped(filenames, args=None, processes=None):
    """Stripe trajectory files across processes, with per-file load
    arguments as in the reference (mpi/io.py:142). Returns
    ``(global_lengths, local_xyz)``."""
    from ..util.load import load_as_concatenated, sound_trajectory

    filenames = list(filenames)
    if args is None:
        args = [{}] * len(filenames)
    global_lengths = [sound_trajectory(fn, stride=a.get('stride', 1) or 1)
                      for fn, a in zip(filenames, args)]
    own = striped_range(len(filenames))
    if not own:
        return global_lengths, np.array([])
    _, xyz = load_as_concatenated([filenames[i] for i in own],
                                  args=[args[i] for i in own],
                                  processes=processes)
    return global_lengths, xyz
