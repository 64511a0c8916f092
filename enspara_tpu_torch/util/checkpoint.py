"""Checkpoint and resume of clustering state (counterpart of
``enspara_tpu/util/checkpoint.py:21-87``).

The full state (distances, assignments, center indices, iteration and
metadata) round-trips through one directory in the JAX package's format,
unchanged: ``manifest.json`` beside ``distances.npy``,
``assignments.npy`` and ``center_indices.npy``. So the port resumes a
directory the JAX package wrote, and the reverse.
"""

import json
import os

import numpy as np

__all__ = ['save_clustering_checkpoint', 'load_clustering_checkpoint',
           'resume_kcenters']


def save_clustering_checkpoint(path, distances, assignments,
                               center_indices, iteration=None,
                               metadata=None):
    """Write clustering state to a checkpoint directory."""
    os.makedirs(path, exist_ok=True)
    np.save(os.path.join(path, 'distances.npy'), np.asarray(distances))
    np.save(os.path.join(path, 'assignments.npy'), np.asarray(assignments))
    np.save(os.path.join(path, 'center_indices.npy'),
            np.asarray(center_indices))
    manifest = {
        'iteration': int(iteration) if iteration is not None
        else int(len(center_indices)),
        'n_frames': int(len(distances)),
        'metadata': metadata or {},
        'files': {
            'distances': 'distances.npy',
            'assignments': 'assignments.npy',
            'center_indices': 'center_indices.npy',
        },
    }
    with open(os.path.join(path, 'manifest.json'), 'w') as f:
        json.dump(manifest, f, indent=2, sort_keys=True)
    return path


def load_clustering_checkpoint(path):
    """Read clustering state back: a dict of distances, assignments,
    center_indices, iteration and metadata."""
    with open(os.path.join(path, 'manifest.json')) as f:
        manifest = json.load(f)
    files = manifest['files']
    return {
        'distances': np.load(os.path.join(path, files['distances'])),
        'assignments': np.load(os.path.join(path, files['assignments'])),
        'center_indices': np.load(
            os.path.join(path, files['center_indices'])),
        'iteration': manifest['iteration'],
        'metadata': manifest.get('metadata', {}),
    }


def resume_kcenters(path, X, metric='euclidean', n_clusters=None,
                    dist_cutoff=None, mesh=None, device=None):
    """Continue a checkpointed k-centers run on ``X`` to the new
    stopping criteria, on ``device`` or over ``mesh``; returns a
    ClusterResult."""
    from ..cluster import engine
    from ..cluster.util import ClusterResult, gather_frames

    state = load_clustering_checkpoint(path)
    res = engine.kcenters_device(
        X, metric=metric, n_clusters=n_clusters, dist_cutoff=dist_cutoff,
        init_distances=state['distances'],
        init_assignments=state['assignments'],
        n_init_centers=state['iteration'],
        init_center_indices=state['center_indices'], mesh=mesh,
        device=device)
    ctr_inds = list(res.center_indices)
    return ClusterResult(center_indices=ctr_inds,
                         assignments=res.assignments,
                         distances=res.distances,
                         centers=gather_frames(X, ctr_inds))
