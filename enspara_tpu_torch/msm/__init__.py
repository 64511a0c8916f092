"""Markov state models: transition counting, the builders, and the
eigensolves of reversible transition matrices on a device."""

from . import builders  # noqa: F401
from .transition_matrices import (assigns_to_counts, eigenspectrum,  # noqa: F401
                                  trim_disconnected, eq_probs,
                                  TrimMapping, assigns_to_counts_device,
                                  assigns_to_counts_sharded)
from .eigen_device import (eigenspectrum_reversible,  # noqa: F401
                           implied_timescales_device,
                           implied_timescales_batched,
                           transpose_timescales_device)
from .synthetic_data import (synthetic_trajectory,  # noqa: F401
                             sparse_metastable_counts)
