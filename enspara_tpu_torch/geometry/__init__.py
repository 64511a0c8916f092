"""Geometry (counterpart of ``enspara_tpu/geometry``): the
point-against-set distances of :mod:`.libdist`, dihedral angles, rotamer
states, Shrake-Rupley SASA, RMSF, helix frames, LIGSITE pockets and, on
first access, the smFRET modules: the point clouds of
:mod:`.dyes_from_expt_dist` and the explicit dyes of
:mod:`.explicit_r0_calc` and :mod:`.dye_lifetimes`."""

from . import libdist  # noqa: F401
from . import dihedrals  # noqa: F401
from . import rotamer  # noqa: F401
from . import sasa  # noqa: F401
from . import rmsf  # noqa: F401
from . import helix  # noqa: F401
from . import pockets  # noqa: F401
from .rotamer import all_rotamers, dihedral_angles  # noqa: F401
from .sasa import shrake_rupley  # noqa: F401
from .rmsf import rmsf_calc  # noqa: F401
from .pockets import get_pockets  # noqa: F401

# the smFRET dye modules pull scipy.stats (>1 s of import time on slow
# hosts) and only the smFRET apps need them: load them lazily (PEP 562);
# `from enspara_tpu_torch.geometry import dyes_from_expt_dist` still works
_LAZY_DYE_MODULES = ('dyes_from_expt_dist', 'explicit_r0_calc',
                     'dye_lifetimes')


def __getattr__(name):
    if name in _LAZY_DYE_MODULES:
        import importlib
        mod = importlib.import_module('.' + name, __name__)
        globals()[name] = mod
        return mod
    raise AttributeError('module %r has no attribute %r'
                         % (__name__, name))


def __dir__():
    return sorted(list(globals()) + list(_LAZY_DYE_MODULES))
