"""Rotamer featurizer: atomic trajectories -> integer rotamer state
trajectories (counterpart of ``enspara_tpu/cards/featurizers.py``;
reference: enspara/cards/featurizers.py)."""

from .. import geometry

__all__ = ['RotamerFeaturizer']


class RotamerFeaturizer(object):
    """Assign every dihedral in every frame to a rotamer state (CARDS
    definition), exposing ``feature_trajectories_`` (int16 numpy),
    ``n_feature_states_`` and ``atom_indices_`` after fit(). The
    featurization runs on the card unless ``$ENSPARA_TPU_PLATFORM=cpu``.

    Accepts lists or generators of trajectories.
    """

    __slots__ = ['buffer_width', 'n_procs', 'feature_trajectories_',
                 'n_feature_states_', 'atom_indices_']

    def __init__(self, buffer_width=15, n_procs=1):
        self.buffer_width = buffer_width
        self.n_procs = n_procs

    def fit(self, trajectories):
        states = []
        for trj in trajectories:       # works for lists and generators
            labels, dihedral_atoms, bins_per_feature = \
                geometry.all_rotamers(trj, buffer_width=self.buffer_width)
            if not states:
                # dihedral topology is shared, so the metadata of the
                # first trajectory covers the whole set
                self.atom_indices_ = dihedral_atoms
                self.n_feature_states_ = bins_per_feature
            states.append(labels)
        self.feature_trajectories_ = states
        return self
