"""Clustering results container (counterpart of the ``ClusterResult``
and ``gather_frames`` of ``enspara_tpu/cluster/util.py``)."""

from collections import namedtuple

import numpy as np
import torch

from enspara_tpu import ra
from enspara_tpu.ra.ra import partition_indices, partition_list

__all__ = ['ClusterResult', 'gather_frames']


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
