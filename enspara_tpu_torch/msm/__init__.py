"""Markov state models: transition counting, the builders, the ``MSM``
estimator, implied timescales, bootstrap and BACE, synthetic data, and
the eigensolves of reversible transition matrices on a device."""

from . import builders  # noqa: F401
from .msm import MSM  # noqa: F401
from .transition_matrices import (assigns_to_counts, eigenspectrum,  # noqa: F401
                                  trim_disconnected, eq_probs,
                                  TrimMapping, assigns_to_counts_device,
                                  assigns_to_counts_sharded)
from .timescales import implied_timescales  # noqa: F401
from .eigen_device import (eigenspectrum_reversible,  # noqa: F401
                           implied_timescales_device,
                           implied_timescales_batched,
                           transpose_timescales_device)
from . import bace  # noqa: F401
from .bootstrap import bootstrap, MSMs  # noqa: F401
from .synthetic_data import (synthetic_trajectory,  # noqa: F401
                             synthetic_ensemble,
                             synthetic_trajectory_device,
                             sparse_metastable_counts)
