"""Information theory (counterpart of ``enspara_tpu/info_theory``):
entropies and divergences, joint counts, mutual information and
exposons."""

from . import entropy  # noqa: F401
from . import mutual_info  # noqa: F401
from . import exposons  # noqa: F401
from . import libinfo  # noqa: F401
from .entropy import (shannon_entropy, kl_divergence,  # noqa: F401
                      js_divergence, relative_entropy_msm,
                      relative_entropy_per_state, energy_to_probability)
from .mutual_info import (mi_matrix, weighted_mi, joint_counts,  # noqa: F401
                          mutual_information,
                          channel_capacity_normalization,
                          mi_to_nmi, mi_to_apc, mi_to_nmi_apc,
                          deconvolute_network)
from .exposons import exposons as compute_exposons  # noqa: F401
from .exposons import exposons_from_sasas  # noqa: F401
