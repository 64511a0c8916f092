"""Geometry (counterpart of ``enspara_tpu/geometry``): the
point-against-set distances of :mod:`.libdist`, dihedral angles and
rotamer states. SASA, RMSF, helices and pockets are ROADMAP.md queue 1
step 9."""

from . import libdist  # noqa: F401
from . import dihedrals  # noqa: F401
from . import rotamer  # noqa: F401
from .rotamer import all_rotamers, dihedral_angles  # noqa: F401
