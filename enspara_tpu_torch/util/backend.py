"""Device selection for the apps and the random-state contract
(counterpart of ``enspara_tpu/util/backend.py :: select_platform`` and
of the ``sklearn.utils.check_random_state`` the JAX package imports).

The apps run on the CUDA device unless ``$ENSPARA_TPU_PLATFORM`` names
the CPU; there is no "cuda else cpu": without a card the default
raises.
"""

import numbers
import os

import numpy as np
import torch

from .device import require_cuda

__all__ = ['select_device', 'check_random_state']


def select_device(platform=None):
    """The device the apps run on: ``platform`` or, when None,
    ``$ENSPARA_TPU_PLATFORM``. Unset, empty, 'cuda' or 'gpu' ->
    :func:`~enspara_tpu_torch.util.device.require_cuda` (raises without
    a card); 'cpu' -> the CPU, where every kernel takes its plain
    version. Anything else raises ``ValueError``."""
    if platform is None:
        platform = os.environ.get('ENSPARA_TPU_PLATFORM', '')
    platform = platform.strip().lower()
    if platform in ('', 'cuda', 'gpu'):
        return require_cuda()
    if platform == 'cpu':
        return torch.device('cpu')
    raise ValueError("ENSPARA_TPU_PLATFORM must be 'cpu', 'cuda' or 'gpu' "
                     'for enspara_tpu_torch, got %r' % (platform,))


def check_random_state(seed):
    """A ``numpy.random.RandomState`` with sklearn's semantics: None ->
    the global RandomState of ``numpy.random``, an int -> a new
    ``RandomState(seed)``, a RandomState passes through. Anything else
    raises ``ValueError``."""
    if seed is None or seed is np.random:
        return np.random.mtrand._rand
    if isinstance(seed, numbers.Integral):
        return np.random.RandomState(seed)
    if isinstance(seed, np.random.RandomState):
        return seed
    raise ValueError('%r cannot be used to seed a numpy.random.RandomState'
                     ' instance' % (seed,))
