"""Deprecated alias of :mod:`enspara_tpu_torch.ra` (counterpart of
``enspara_tpu/util/array.py``), kept so code written against the
reference's ``enspara.util.array`` import path ports unchanged."""

import warnings

from ..ra.ra import *  # noqa: F401,F403

warnings.warn('enspara_tpu_torch.util.array has been moved to its own '
              'module at enspara_tpu_torch.ra', PendingDeprecationWarning)
