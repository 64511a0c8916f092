"""Transition path theory (counterpart of ``enspara_tpu/tpt``): committors
and mean first passage times (the dense LU on the card, refined on the
host), reactive fluxes and populations, and the highest-flux pathways."""

from .core import committors, mfpts  # noqa: F401
from .tpt import reactive_fluxes, net_fluxes, reactive_populations  # noqa: F401
from .path import paths, top_path  # noqa: F401
