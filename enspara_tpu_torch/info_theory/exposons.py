"""Exposons: clusters of residues whose solvent exposure changes
cooperatively (counterpart of ``enspara_tpu/info_theory/exposons.py``;
reference: enspara/info_theory/exposons.py).

Pipeline: atomic SASAs (:func:`~enspara_tpu_torch.geometry.sasa.shrake_rupley`
on the card) -> per-sidechain condensation (host, float32, the
reference's order) -> exposed/buried dichotomy -> weighted MI (float64
on the card) -> affinity propagation (the port's own,
:mod:`._affinity`, with sklearn's labels: random_state 0, preference 0,
as at publication).
"""

import logging

import numpy as np

from .. import exception
from ..citation import cite
from ._affinity import affinity_propagation
from .mutual_info import weighted_mi

logger = logging.getLogger(__name__)

__all__ = ['exposons', 'exposons_from_sasas', 'condense_sidechain_sasas',
           'get_sidechain_atom_ids']


@cite('exposons')
def exposons(trj, damping, weights=None, probe_radius=0.28,
             threshold=0.02, mesh=None, device=None):
    """Compute exposons for a trajectory (the port's
    :class:`~enspara_tpu_torch.io.Trajectory`). (reference: exposons.py:16)

    Returns ``(sasa_mi, exposon_labels)``.
    """
    from ..geometry.sasa import shrake_rupley

    if weights is None:
        weights = np.full((len(trj),), 1 / len(trj))
    else:
        weights = np.array(weights) / sum(weights)

    sasas = shrake_rupley(trj, probe_radius=probe_radius, mode='atom',
                          mesh=mesh, device=device)
    sasas = condense_sidechain_sasas(sasas, trj.top)
    return exposons_from_sasas(sasas, damping, weights, threshold,
                               device=mesh.lead if mesh is not None
                               else device)


@cite('exposons')
def exposons_from_sasas(sasas, damping, weights, threshold, device=None):
    """Exposons from precomputed sidechain SASAs: dichotomize exposure
    at ``threshold``, take the frame-weighted MI between sidechains on
    ``device`` (default: the card), and cluster the MI matrix.
    (capability match: exposons.py:86)"""
    exposure = np.asarray(sasas) > threshold
    mi_mtx = weighted_mi(exposure, weights, device=device)
    # the publication's hyperparameters: MI as a precomputed affinity,
    # preference 0, random_state 0
    labels = affinity_propagation(mi_mtx, damping=damping, preference=0,
                                  random_state=0, max_iter=10000)
    return mi_mtx, labels


_BACKBONE_NAMES = frozenset(
    ['N', 'C', 'CA', 'O', 'HA', 'H', 'H1', 'H2', 'H3', 'OXT',
     # C-terminal carboxylate synonyms, which the port's loaders keep as
     # written: backbone in every format
     'OC1', 'OC2', 'OT1', 'OT2'])


def get_sidechain_atom_ids(top):
    """Per-residue lists of sidechain atom ids (everything but the
    backbone names). (reference: exposons.py:135)"""
    sc_ids = []
    for res in top.residues:
        ids = np.array([a.index for a in res.atoms
                        if a.name not in _BACKBONE_NAMES], dtype=int)
        sc_ids.append(ids)
    return sc_ids


@cite('exposons')
def condense_sidechain_sasas(sasas, top):
    """Sum atomic SASAs into per-residue sidechain SASAs: a float32 sum
    over each residue's atom ids, in the reference's order (another
    order flips near-threshold exposures). (reference: exposons.py:179)"""
    if top.n_residues <= 1:
        raise exception.DataInvalid(
            'Topology must have more than one residue.')
    if top.n_atoms != sasas.shape[1]:
        raise exception.DataInvalid(
            'need one SASA column per topology atom (%d columns, %d '
            "atoms) -- were the SASAs computed with mode='atom' against "
            'this topology?' % (sasas.shape[1], top.n_atoms))

    sc_ids = get_sidechain_atom_ids(top)
    sasas32 = np.asarray(sasas, dtype='float32')
    out = np.zeros((sasas32.shape[0], len(sc_ids)), dtype='float32')
    for r, ids in enumerate(sc_ids):
        if ids.size == 0:
            logger.warning('Found 0 sidechain atoms for residue %s.', r)
            continue
        out[:, r] = sasas32[:, ids].sum(axis=1)
    return out
