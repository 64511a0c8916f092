"""Parallel host trajectory loading. (reference: enspara/util/load.py)

The reference loads through a process pool writing into POSIX shared
memory (load.py:140-160); our loaders are numpy-native (the C++ XTC
codec releases the GIL inside fread/decode), so a thread pool writing
into slices of one preallocated array gives the same parallelism with
no shared-memory machinery. This is the host-side feeder of the
device arrays.
"""

import math
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from .. import exception
from ..io import trajectory as io_traj
from .parallel import auto_nprocs

__all__ = ['sound_trajectory', 'load_as_concatenated',
           'concatenate_trjs', 'shared_array_like_trj']


def shared_array_like_trj(lengths, example_trj):
    """Preallocate the xyz buffer for a concatenated trajectory of
    ``sum(lengths)`` frames shaped like ``example_trj`` (reference:
    util/load.py:206). The reference needs a ``multiprocessing.Array``
    because its loader workers are processes; ours are threads sharing
    the interpreter, so a plain float32 ndarray serves the same role.
    """
    shape = example_trj.xyz.shape
    full_shape = (int(np.sum(lengths)), shape[1], shape[2])
    try:
        return np.zeros(full_shape, dtype=np.float32)
    except MemoryError:
        raise exception.InsufficientResourceError(
            "Couldn't allocate array of %.2f GB while loading "
            "trajectories." % (np.prod(full_shape) * 4 / 1024 ** 3))


def sound_trajectory(trj, stride=1, frame=None):
    """Frame count of a trajectory on disk (without loading
    coordinates where the format allows). (reference: util/load.py:20)
    """
    ext = os.path.splitext(str(trj))[1].lower()
    if ext == '.xtc':
        from ..io.xtc import scan_xtc
        n_frames, _ = scan_xtc(trj)
    elif ext == '.dcd':
        from ..io.dcd import scan_dcd
        n_frames, _ = scan_dcd(trj)
    elif ext == '.trr':
        from ..io.trr import scan_trr
        n_frames, _ = scan_trr(trj)
    elif ext in ('.h5', '.hdf5'):
        import h5py
        with h5py.File(trj, 'r') as f:
            n_frames = f['coordinates'].shape[0]
    else:
        n_frames = io_traj.load(trj).n_frames
    if frame is not None:
        # a trajectory loaded with frame=k contributes exactly one
        # frame (reference: util/load.py:120-126 treats 'frame' files
        # as length 1)
        return 1 if frame < n_frames else 0
    return math.ceil(n_frames / stride)


def load_as_concatenated(filenames, lengths=None, processes=None,
                         args=None, **kwargs):
    """Load many trajectory files into one (sum(lengths), n_atoms, 3)
    float32 array, in parallel. (reference: util/load.py:52)

    Per-file load options can be given via ``args`` (list of kwarg
    dicts, one per file) XOR global ``**kwargs``.

    Returns
    -------
    (lengths, xyz) : (list of int, np.ndarray)
    """
    filenames = list(filenames)

    if args and kwargs:
        raise exception.ImproperlyConfigured(
            'Additional unnamed args can be supplied iff no additional '
            'keyword args are supplied')
    if args:
        if len(args) != len(filenames):
            raise exception.ImproperlyConfigured(
                'When add\'l unnamed args are provided, len(args) == '
                'len(filenames).')
    else:
        args = [kwargs] * len(filenames)

    processes = processes or auto_nprocs()

    if lengths is None:
        with ThreadPoolExecutor(max_workers=processes) as ex:
            lengths = list(ex.map(
                lambda fa: sound_trajectory(
                    fa[0], stride=fa[1].get('stride', 1) or 1,
                    frame=fa[1].get('frame')),
                zip(filenames, args)))

    # peek at the first file to determine n_atoms after any slicing
    first = io_traj.load(filenames[0], **args[0])
    n_atoms = first.n_atoms
    full_shape = (int(sum(lengths)), n_atoms, 3)
    try:
        xyz = np.empty(full_shape, dtype=np.float32)
    except MemoryError:
        raise exception.InsufficientResourceError(
            "Couldn't allocate array of shape %s while loading "
            'trajectories.' % (full_shape,))

    starts = np.concatenate([[0], np.cumsum(lengths)[:-1]]).astype(int)

    def load_one(i):
        if i == 0:
            trj = first
        else:
            trj = io_traj.load(filenames[i], **args[i])
        if trj.n_atoms != n_atoms:
            raise exception.DataInvalid(
                'Trajectory %s has %d atoms, expected %d'
                % (filenames[i], trj.n_atoms, n_atoms))
        n = min(len(trj), lengths[i])
        xyz[starts[i]:starts[i] + n] = trj.xyz[:n]
        return n

    with ThreadPoolExecutor(max_workers=processes) as ex:
        got = list(ex.map(load_one, range(len(filenames))))

    for i, (expect, actual) in enumerate(zip(lengths, got)):
        if actual != expect:
            raise exception.DataInvalid(
                'Expected %d frames in %s, loaded %d'
                % (expect, filenames[i], actual))

    return list(lengths), xyz


def concatenate_trjs(trj_list, atoms=None, n_procs=None):
    """Concatenate a list of Trajectory objects into one, optionally
    slicing atoms with a selection string. (reference:
    util/load.py:164)"""
    example = trj_list[0]
    if atoms is not None:
        sel = example.top.select(atoms)
        trj_list = [t.atom_slice(sel) for t in trj_list]
        example = trj_list[0]
    xyz = np.concatenate([np.asarray(t.xyz, np.float32)
                          for t in trj_list])
    return io_traj.Trajectory(xyz, example.top)
