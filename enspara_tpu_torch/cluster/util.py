"""Clustering utilities (counterpart of ``enspara_tpu/cluster/util.py``):
the results container, nearest-center assignment, metric dispatch, and
the data loaders, writers and reassignment the CLI apps use.

Trajectory I/O is the port's own host code (``io``, ``util.load``,
``ra``); the named feature metrics dispatch to ``geometry.libdist`` on
the host and to ``cluster.engine`` on the device.
"""

import logging
import os
import pickle
import time
from collections import namedtuple

import numpy as np
import torch

from .. import io as io_mod
from .. import native, ra
from ..exception import DataInvalid, ImproperlyConfigured
from ..geometry import libdist
from ..ops.qcp_matrix import pairwise_rmsd
from ..ra.ra import partition_indices, partition_list
from ..util.device import resolve_device
from ..util.load import load_as_concatenated, sound_trajectory
from ..util.log import timed
from ..util.parallel import auto_nprocs
from . import engine

logger = logging.getLogger(__name__)

__all__ = ['ClusterResult', 'gather_frames', 'run_timed',
           'assign_to_nearest_center', 'find_cluster_centers',
           'MolecularClusterMixin']

class ClusterResult(namedtuple('ClusterResult',
                               ['center_indices', 'distances',
                                'assignments', 'centers'])):
    """Clustering output: per-frame assignments and distances, the
    indices of the frames chosen as centers, and the center data."""

    def partition(self, lengths):
        """Split the concatenated per-frame arrays back into
        per-trajectory rows: an ndarray when the lengths are uniform, a
        RaggedArray otherwise."""
        if len(set(int(n) for n in lengths)) <= 1:
            def chop(flat):
                return np.array(partition_list(flat, lengths))
        else:
            def chop(flat):
                return ra.RaggedArray(flat, lengths=lengths)
        return self._replace(
            assignments=chop(self.assignments),
            distances=chop(self.distances),
            center_indices=partition_indices(self.center_indices, lengths))


def run_timed(fn, *args, **kwargs):
    """Call ``fn(*args, **kwargs)``; return ``(result, wall_seconds)``."""
    tick = time.perf_counter()
    out = fn(*args, **kwargs)
    return out, time.perf_counter() - tick


def gather_frames(X, indices):
    """``[X[i] for i in indices]`` as host arrays; a tensor on a device
    crosses to the host in one copy."""
    indices = np.asarray(indices, dtype=np.int64)
    if hasattr(X, 'xyz'):
        X = X.xyz
    if isinstance(X, torch.Tensor):
        picked = X[torch.as_tensor(indices, device=X.device)]
        return list(picked.cpu().numpy())
    return [np.asarray(X[i]) for i in indices]


def assign_to_nearest_center(trajectory, cluster_centers, distance_method):
    """Assign each frame to the nearest of ``cluster_centers`` under
    ``distance_method``, iterating centers in order with first-minimum
    ties: ``argmin`` inside a block of 32 centers, a strict ``<``
    across blocks. For the batched device form see
    :func:`enspara_tpu_torch.cluster.engine.assign_device`."""
    n_frames = len(trajectory)
    best_dist = np.full(n_frames, np.inf, dtype=float)
    best_ctr = np.zeros(n_frames, dtype=int)
    block_len = 32
    for lo in range(0, len(cluster_centers), block_len):
        block = cluster_centers[lo:lo + block_len]
        dmat = np.stack(
            [np.asarray(distance_method(trajectory, ctr)).reshape(-1)
             for ctr in block])
        winner = dmat.argmin(axis=0)
        winning_dist = dmat[winner, np.arange(n_frames)]
        improved = winning_dist < best_dist
        best_dist[improved] = winning_dist[improved]
        best_ctr[improved] = winner[improved] + lo
    return best_ctr, best_dist


def find_cluster_centers(assignments, distances):
    """For each label, the index of its minimum-distance frame (the
    first such frame on ties), labels in ascending order.

    Integer labels in a range no wider than the frames take two
    scatter-min passes (O(n), torch's threads; a 14.68M-frame warm start
    sorted for ~4 s); others, and distances with a NaN, the sort."""
    if len(distances) != len(assignments):
        raise DataInvalid(
            'Length of distances (%s) must match length of assignments '
            '(%s).' % (len(distances), len(assignments)))
    labels = np.ravel(assignments)
    gaps = np.ravel(distances)
    if labels.size and labels.dtype.kind in 'iu' \
            and gaps.dtype.kind == 'f' and not np.isnan(gaps).any():
        lo = int(labels.min())
        width = int(labels.max()) - lo + 1
        if width <= labels.size:
            lab = torch.from_numpy(labels.astype(np.int64) - lo)
            gap = torch.from_numpy(np.ascontiguousarray(gaps))
            best = torch.full((width,), float('inf'), dtype=gap.dtype)
            best = best.scatter_reduce(0, lab, gap, 'amin')
            hit = gap == best[lab]
            first = torch.full((width,), labels.size, dtype=torch.int64)
            first = first.scatter_reduce(
                0, lab[hit], torch.nonzero(hit)[:, 0], 'amin')
            return first[first < labels.size].numpy()
    order = np.lexsort((np.arange(labels.size), gaps, labels))
    ranked = labels[order]
    group_head = np.flatnonzero(
        np.r_[True, ranked[1:] != ranked[:-1]] if ranked.size else [])
    return order[group_head]


def _rmsd_metric(trajectory, center):
    """Callable metric for coordinate data: minimum RMSD of each frame
    to one structure (float64 host array), one all-pairs block where
    the frames lie (the CUDA kernel for a CUDA tensor)."""
    xyz = trajectory.xyz if hasattr(trajectory, 'xyz') else trajectory
    cxyz = center.xyz if hasattr(center, 'xyz') else center
    xyz = torch.as_tensor(xyz, dtype=torch.float32,
                          device=resolve_device(xyz))
    cxyz = torch.as_tensor(cxyz, dtype=torch.float32, device=xyz.device)
    if cxyz.ndim == 3:
        cxyz = cxyz[0]
    d = pairwise_rmsd(xyz - xyz.mean(dim=1, keepdim=True),
                      (cxyz - cxyz.mean(dim=0, keepdim=True))[None])
    return d[:, 0].cpu().numpy().astype(np.float64)


def _get_distance_method(metric):
    """'rmsd' -> the QCP metric; named vector metrics -> libdist;
    callables pass through (JAX ``cluster/util.py:131-146``)."""
    if metric == 'rmsd':
        return _rmsd_metric
    if metric == 'euclidean':
        return libdist.euclidean
    if metric in ('cityblock', 'manhattan'):
        return libdist.manhattan
    if metric == 'hamming':
        return libdist.hamming
    if callable(metric):
        return metric
    raise ImproperlyConfigured(
        "Unknown metric %r: expected 'rmsd', 'euclidean', 'manhattan', "
        "'hamming', or a callable." % (metric,))


def _metric_name(metric):
    """The device-engine name for a metric, or None if only the generic
    host path applies (user callables)."""
    if metric in ('rmsd', 'euclidean', 'manhattan', 'cityblock',
                  'hamming'):
        return 'manhattan' if metric == 'cityblock' else metric
    if metric is libdist.euclidean:
        return 'euclidean'
    if metric is libdist.manhattan:
        return 'manhattan'
    if metric is libdist.hamming:
        return 'hamming'
    if metric is _rmsd_metric:
        return 'rmsd'
    return None


class MolecularClusterMixin:
    """``predict()`` and the ``result_`` properties shared by the
    cluster estimators."""

    def predict(self, X):
        try:
            centers = self.centers_
        except AttributeError:
            raise ImproperlyConfigured(
                'To predict the clustering result for new data, the '
                'clusterer first must have fit some data.') from None
        labels, gaps = assign_to_nearest_center(
            X, centers, _get_distance_method(self.metric))
        return ClusterResult(
            assignments=labels, distances=gaps,
            center_indices=find_cluster_centers(labels, gaps),
            centers=self.centers_)

    @property
    def labels_(self):
        return self.result_.assignments

    @property
    def distances_(self):
        return self.result_.distances

    @property
    def center_indices_(self):
        return self.result_.center_indices

    @property
    def centers_(self):
        return self.result_.centers


# ---------------------------------------------------------------------
# data loading front ends and output writers (used by the CLI apps)
# ---------------------------------------------------------------------

def expand_files(pgroups):
    """Expand glob patterns in nested file-group lists, sorting each
    expansion."""
    from glob import glob

    expanded = []
    for pgroup in pgroups:
        expanded.append([])
        for p in pgroup:
            expanded[-1].extend(sorted(glob(p)))
    return expanded


def load_xtc_codec(paths):
    """Build the native XTC codec on this thread, before the loader
    threads start, when any of ``paths`` is an ``.xtc`` file: the
    threads then load one library instead of each compiling it."""
    if any(str(p).lower().endswith('.xtc') for p in paths):
        native.load_library('xdr')


def load_trajectories(topologies, trajectories, selections, stride,
                      processes=None):
    """Load trajectory sets (one topology + atom selection per set)
    into one concatenated coordinate array. Returns ``(lengths, xyz,
    selected topology)``."""
    flat_trjs = []
    configs = []
    n_inds = None
    top = None
    indices = None

    for topfile, trjset, selection in zip(topologies, trajectories,
                                          selections):
        top = io_mod.load(topfile).top
        try:
            indices = top.select(selection)
        except Exception:
            raise ImproperlyConfigured(
                "The provided selection '{s}' didn't match the topology "
                'file, {t}'.format(s=selection, t=topfile))
        if len(indices) == 0:
            raise ImproperlyConfigured(
                "Selection '%s' selected no atoms in %s"
                % (selection, topfile))
        if n_inds is not None and n_inds != len(indices):
            raise ImproperlyConfigured(
                'Selection on topology %s selected %s atoms, but other '
                'selections selected %s atoms.'
                % (topfile, len(indices), n_inds))
        n_inds = len(indices)
        for trj in trjset:
            flat_trjs.append(trj)
            configs.append({'top': top, 'stride': stride,
                            'atom_indices': indices})

    load_xtc_codec(flat_trjs)
    with timed('Loading took %.1f sec', logger.info):
        lengths, xyz = load_as_concatenated(
            flat_trjs, args=configs,
            processes=processes or auto_nprocs())

    return lengths, xyz, top.subset(indices)


def load_features(features, stride):
    """Load feature arrays: one ``.h5`` RaggedArray file or many
    ``.npy`` files, memory-mapped so that a stride reads only its rows
    (JAX ``cluster/util.py:228-246``). Returns ``(lengths, data)``."""
    if len(features) == 1:
        data = ra.load(features[0], stride=stride)
        if isinstance(data, ra.RaggedArray):
            return list(data.lengths), data._data
        return [len(data)], np.asarray(data)
    rows = [np.asarray(np.load(f, mmap_mode='r')[::stride])
            for f in features]
    inner = set(r.shape[1:] for r in rows)
    if len(inner) > 1:
        raise DataInvalid(
            'Feature files had inconsistent widths: %s' % inner)
    lengths = [len(r) for r in rows]
    return lengths, np.concatenate(rows).astype(np.float32)


def load_trjs_or_features(args):
    """Load the CLI's input: ``(lengths, data)``, data an ndarray of
    features or a Trajectory."""
    if getattr(args, 'features', None):
        return load_features(args.features, stride=args.subsample)
    assert args.trajectories
    assert len(args.trajectories) == len(args.topologies)
    lengths, xyz, select_top = load_trajectories(
        args.topologies, args.trajectories, selections=args.atoms,
        stride=args.subsample, processes=auto_nprocs())
    return lengths, io_mod.Trajectory(xyz, select_top)


def load_frames(filenames, indices, **kwargs):
    """Load specific ``(file_index, frame_index)`` frames, each file
    read once however many of its frames are asked for."""
    stride = kwargs.pop('stride', 1) or 1
    out = [None] * len(indices)
    name = traj = None
    for i in sorted(range(len(indices)), key=lambda i: indices[i][0]):
        file_id, frame_id = indices[i]
        pos = frame_id * stride
        try:
            if filenames[file_id] != name:
                name = filenames[file_id]
                traj = io_mod.load(name, **kwargs)
            out[i] = traj.slice(pos)
        except Exception as err:
            raise ImproperlyConfigured(
                'Failed to load frame %s of %s (%s).'
                % (pos, filenames[file_id], err))
    return out


def load_asymm_frames(center_indices, trajectories, topology, subsample):
    """Load the center frames ``(trajectory, frame)`` of several
    trajectory sets, each with its own topology."""
    import itertools

    frames = []
    begin_index = 0
    for topfile, trjset in zip(topology, trajectories):
        end_index = begin_index + len(trjset)
        target_centers = [c for c in center_indices
                          if begin_index <= c[0] < end_index]
        subframes = load_frames(
            list(itertools.chain(*trajectories)),
            target_centers,
            top=io_mod.load(topfile).top,
            stride=subsample)
        frames.extend(subframes)
        begin_index += len(trjset)
    return frames


def _intermediate(path, intermediate_n):
    """``path`` moved into ``intermediate-<n>/`` beside it (made here),
    or ``path`` itself when ``intermediate_n`` is None."""
    if intermediate_n is None:
        return path
    d = os.path.join(os.path.dirname(path), 'intermediate-%s' % intermediate_n)
    os.makedirs(d, exist_ok=True)
    return os.path.join(d, os.path.basename(path))


def write_centers_indices(path, indices, intermediate_n=None):
    """Save the center indices as ``.npy`` (nothing when ``path`` is
    empty), under ``intermediate-<n>/`` given ``intermediate_n``."""
    if not path:
        logger.info('--center-indices not provided, not writing center '
                    'indices to file.')
        return
    with open(_intermediate(path, intermediate_n), 'wb') as f:
        np.save(f, indices)


def write_centers(result, args, intermediate_n=None):
    """Save the centers (JAX ``cluster/util.py:367-389``): feature
    centers as one array (``.npy``, or ``ra.save`` under
    ``intermediate-<n>/``); trajectory centers pickled, reloaded from the
    trajectories at full atom detail."""
    if getattr(args, 'features', None):
        if intermediate_n is not None:
            ra.save(_intermediate(args.center_features, intermediate_n),
                    np.asarray(result.centers))
        else:
            np.save(args.center_features, np.asarray(result.centers))
        return
    outdir = os.path.dirname(args.center_features) or '.'
    if intermediate_n is not None:
        outdir = os.path.join(outdir, 'intermediate-%s' % intermediate_n)
    os.makedirs(outdir, exist_ok=True)
    centers = load_asymm_frames(result.center_indices, args.trajectories,
                                args.topologies, args.subsample)
    with open(args.center_features, 'wb') as f:
        pickle.dump(centers, f)


def reassign_features(result, args, device=None):
    """Every frame of the full (unsubsampled) ``--features`` assigned
    to the result's centers, on ``device`` for a named metric, by the
    host loop otherwise: ``(assignments, distances)`` RaggedArrays."""
    lengths, data = load_features(args.features, stride=1)
    centers = np.asarray(result.centers)
    name = _metric_name(args.cluster_distance)
    if name is not None:
        assig, dist = engine.assign_device(data, centers, name,
                                           device=device)
    else:
        assig, dist = assign_to_nearest_center(
            data, centers, _get_distance_method(args.cluster_distance))
    return (ra.RaggedArray(assig, lengths=lengths),
            ra.RaggedArray(dist, lengths=lengths))


def write_assignments_and_distances_with_reassign(result, args,
                                                  intermediate_n=None,
                                                  device=None):
    """Write the cluster app's ``--distances`` and ``--assignments``
    (``.h5``, under ``intermediate-<n>/`` given ``intermediate_n``): the
    clustering's own for ``--subsample 1``, else every frame of the full
    trajectories or features reassigned to the centers on ``device``
    (nothing with ``--no-reassign``)."""
    if args.subsample == 1:
        assig, dist = result.assignments, result.distances
    elif args.no_reassign:
        logger.debug('Got --no-reassign, not doing reassigment')
        return
    elif getattr(args, 'features', None):
        assig, dist = reassign_features(result, args, device=device)
    else:
        assig, dist = reassign(args.topologies, args.trajectories,
                               args.atoms, centers=result.centers,
                               device=device)
    ra.save(_intermediate(args.distances, intermediate_n), dist)
    ra.save(_intermediate(args.assignments, intermediate_n), assig)


def compute_batches(lengths, batch_size):
    """Greedily pack trajectory indices into batches whose summed frame
    counts stay within ``batch_size``."""
    batches = [[]]
    room = batch_size
    for i, ln in enumerate(lengths):
        if ln <= room:
            batches[-1].append(i)
            room -= ln
        else:
            batches.append([i])
            room = batch_size - ln
    return [b for b in batches if b]


def determine_batch_size(n_atoms, dtype_bytes, frac_mem):
    """Frames per batch so one batch takes ``frac_mem`` of host RAM:
    ``(batch_size, batch GiB)``. RAM is read with ``os.sysconf``."""
    bytes_per_frame = n_atoms * 3 * dtype_bytes
    bytes_total = os.sysconf('SC_PAGE_SIZE') * os.sysconf('SC_PHYS_PAGES')
    batch_size = int(bytes_total * frac_mem / bytes_per_frame)
    return batch_size, batch_size * bytes_per_frame / 1024 ** 3


def batch_reassign(targets, centers, lengths, frac_mem, n_procs=None,
                   device=None):
    """Reassign every frame of a big dataset to the nearest center,
    loading trajectories in RAM-bounded batches and assigning each
    batch on ``device``."""
    center_xyz = np.stack([
        (c.xyz[0] if hasattr(c, 'xyz') else np.asarray(c))
        for c in centers])
    n_atoms = center_xyz.shape[1]

    batch_size, _ = determine_batch_size(n_atoms, 4, frac_mem)
    if batch_size < max(lengths):
        raise ImproperlyConfigured(
            'Batch size of %s was smaller than largest file (size %s).'
            % (batch_size, max(lengths)))

    assignments = []
    distances = []
    for batch_indices in compute_batches(lengths, batch_size):
        batch_targets = [targets[j] for j in batch_indices]
        batch_lengths, xyz = load_as_concatenated(
            [tfile for tfile, top, aids in batch_targets],
            lengths=[lengths[j] for j in batch_indices],
            args=[{'top': top, 'atom_indices': aids}
                  for t, top, aids in batch_targets],
            processes=n_procs)
        batch_assignments, batch_distances = engine.assign_device(
            xyz, center_xyz, metric='rmsd', device=device)
        del xyz
        assignments.extend(partition_list(batch_assignments, batch_lengths))
        distances.extend(partition_list(batch_distances, batch_lengths))
    return assignments, distances


def reassign(topologies, trajectories, atoms, centers, frac_mem=0.5,
             device=None):
    """Reassign full (unsubsampled) trajectory sets to ``centers`` in
    batches, on ``device``. Returns ``(assignments, distances)``,
    ndarrays for equal lengths, else RaggedArrays."""
    from concurrent.futures import ThreadPoolExecutor

    n_procs = auto_nprocs()
    if len(topologies) != len(trajectories):
        raise ImproperlyConfigured(
            "Number of topologies (%s) didn't match number of sets of "
            'trajectories (%s).' % (len(topologies), len(trajectories)))
    if len(topologies) != len(atoms):
        raise ImproperlyConfigured(
            "Number of topologies (%s) didn't match number of atom "
            'selection strings (%s).' % (len(topologies), len(atoms)))

    if hasattr(centers, 'xyz'):
        centers = [centers[i] for i in range(len(centers))]

    with timed('Reassignment took %.1f seconds.', logger.info):
        targets = []
        for topfile, trjfiles, atoms_i in zip(topologies, trajectories,
                                              atoms):
            t = io_mod.load(topfile).top
            atom_ids = t.select(atoms_i)
            for trjfile in trjfiles:
                assert os.path.exists(trjfile)
                targets.append((trjfile, t, atom_ids))
        load_xtc_codec(tgt[0] for tgt in targets)
        with ThreadPoolExecutor(max_workers=n_procs) as ex:
            lengths = list(ex.map(
                lambda tgt: sound_trajectory(tgt[0]), targets))
        assignments, distances = batch_reassign(
            targets, centers, lengths, frac_mem=frac_mem, n_procs=n_procs,
            device=device)

    if all(len(assignments[0]) == len(a) for a in assignments):
        return np.array(assignments), np.array(distances)
    return ra.RaggedArray(assignments), ra.RaggedArray(distances)
