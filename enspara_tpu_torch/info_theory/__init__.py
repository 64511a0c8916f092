"""Information theory (counterpart of ``enspara_tpu/info_theory``):
entropies and divergences, joint counts and mutual information. The
exposons wait for the port of SASA (ROADMAP.md queue 1 step 9)."""

from . import entropy  # noqa: F401
from . import mutual_info  # noqa: F401
from . import libinfo  # noqa: F401
from .entropy import (shannon_entropy, kl_divergence,  # noqa: F401
                      js_divergence, relative_entropy_msm,
                      relative_entropy_per_state, energy_to_probability)
from .mutual_info import (mi_matrix, weighted_mi, joint_counts,  # noqa: F401
                          mutual_information,
                          channel_capacity_normalization,
                          mi_to_nmi, mi_to_apc, mi_to_nmi_apc,
                          deconvolute_network)
