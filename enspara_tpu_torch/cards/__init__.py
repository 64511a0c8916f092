"""CARDS (counterpart of ``enspara_tpu/cards``): rotamer featurization,
order/disorder segmentation and the four MI matrices."""

from .cards import cards, cards_matrices  # noqa: F401
from .featurizers import RotamerFeaturizer  # noqa: F401
from . import disorder  # noqa: F401
# the reference star-exports the disorder vocabulary at package level
# (enspara/cards/__init__.py: `from .disorder import *`)
from .disorder import (transitions, traj_ord_disord_times,  # noqa: F401
                       create_disorder_traj, assign_order_disorder,
                       transition_stats, aggregate_mean_times)
