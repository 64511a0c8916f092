"""Bundled-data resolution (counterpart of ``enspara_tpu/data``).

The FRET-dye library directory (point clouds, R0 tables,
``libraries.yml``) resolves at runtime from:

1. ``$ENSPARA_TPU_DYE_DIR``;
2. ``<this package>/data/dyes``, where a user may place the full
   library;
3. ``<this package>/data/dyes_builtin``: the port's copy of the JAX
   package's minimal SYNTHETIC two-dye library (procedurally generated,
   MIT; ``tools/make_builtin_dyes.py``), so an air-gapped install runs
   the smFRET point-cloud route offline. Not real fluorophores.

Nothing here downloads.
"""

import logging
import os

from ..exception import MissingData

__all__ = ['dye_library_path']

_HERE = os.path.dirname(os.path.abspath(__file__))
_BUILTIN = os.path.join(_HERE, 'dyes_builtin')


def _candidates():
    return [os.environ.get('ENSPARA_TPU_DYE_DIR', ''),
            os.path.join(_HERE, 'dyes'), _BUILTIN]


def dye_library_path(required=True):
    """Directory of the FRET dye library, or None/raise if absent.

    Resolving to the builtin SYNTHETIC library warns (once): its numbers
    are physically plausible but are not measurements of real
    fluorophores."""
    for cand in _candidates():
        if cand and os.path.isdir(cand):
            if (os.path.normpath(cand) == _BUILTIN
                    and not getattr(dye_library_path, '_warned_builtin',
                                    False)):
                dye_library_path._warned_builtin = True
                logging.getLogger(__name__).warning(
                    'Using the builtin SYNTHETIC dye library (SimFluor '
                    'test dyes) — NOT real fluorophore data. For science, '
                    'set $ENSPARA_TPU_DYE_DIR to the full library.')
            return cand
    if required:
        raise MissingData(
            'No FRET dye library found: set $ENSPARA_TPU_DYE_DIR to an '
            'existing library directory.')
    return None
