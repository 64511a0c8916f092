"""Transition counts and the transpose-builder timescales on a device."""

from .eigen_device import transpose_timescales_device  # noqa: F401
from .transition_matrices import assigns_to_counts_device  # noqa: F401
