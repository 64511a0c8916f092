"""K-centers clustering by RMSD."""

from .kcenters import KCenters, kcenters  # noqa: F401
from .util import ClusterResult  # noqa: F401
