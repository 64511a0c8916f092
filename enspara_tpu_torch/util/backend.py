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

__all__ = ['select_device', 'select_platform', 'check_random_state']

_PLATFORM_ENV = 'ENSPARA_TPU_PLATFORM'


def select_device(platform=None):
    """The device the apps run on: ``platform`` or, when None,
    ``$ENSPARA_TPU_PLATFORM``. Unset, empty, 'cuda' or 'gpu' ->
    :func:`~enspara_tpu_torch.util.device.require_cuda` (raises without
    a card); 'cpu' -> the CPU, where every kernel takes its plain
    version. Anything else raises ``ValueError``."""
    if platform is None:
        platform = os.environ.get(_PLATFORM_ENV, '')
    platform = _checked(platform)
    if platform in ('', 'cuda', 'gpu'):
        return require_cuda()
    return torch.device('cpu')


def _checked(platform):
    platform = platform.strip().lower()
    if platform not in ('', 'cpu', 'cuda', 'gpu'):
        raise ValueError("ENSPARA_TPU_PLATFORM must be 'cpu', 'cuda' or "
                         "'gpu' for enspara_tpu_torch, got %r" % (platform,))
    return platform


def select_platform(platform=None):
    """Pin the platform of this process (the JAX package's name): with a
    ``platform`` ('cpu', 'cuda' or 'gpu'), set ``$ENSPARA_TPU_PLATFORM``
    to it, so that :func:`select_device` and every host input with no
    ``device=`` go there; with None, check the variable as it stands.
    Anything else raises ``ValueError``, as :func:`select_device` does.
    Returns the platform, '' when none is pinned."""
    if platform is None:
        return _checked(os.environ.get(_PLATFORM_ENV, ''))
    platform = _checked(platform)
    os.environ[_PLATFORM_ENV] = platform
    return platform


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
