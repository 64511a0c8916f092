"""Population-weighted RMSF, host numpy (counterpart of
``enspara_tpu/geometry/rmsf.py``; reference: enspara/geometry/rmsf.py)."""

import itertools

import numpy as np

__all__ = ['rmsf_calc']


def rmsf_calc(centers, populations=None, ref_frame=0, per_residue=True,
              atom_indices=None):
    """Population-weighted RMSF of MSM cluster centers relative to a
    reference frame. (reference: rmsf.py:6)

    Returns per-residue (default) or per-atom RMSFs.
    """
    aligned = centers.copy().superpose(centers[ref_frame],
                                       atom_indices=atom_indices)
    weights = (np.full(aligned.n_frames, 1.0 / aligned.n_frames)
               if populations is None else np.asarray(populations))

    delta = aligned.xyz - aligned.xyz[ref_frame]
    sq_dev = (delta * delta).sum(axis=-1)     # (n_frames, n_atoms)
    weighted = weights @ sq_dev               # ensemble-average, per atom

    if not per_residue:
        return np.sqrt(weighted)

    # residue average = binned sum of the per-atom ensemble averages
    # divided by the residue's atom count (linearity lets the ensemble
    # and residue reductions commute)
    resid = np.array([a.residue.index for a in aligned.top.atoms])
    _, dense = np.unique(resid, return_inverse=True)
    return np.sqrt(np.bincount(dense, weights=weighted)
                   / np.bincount(dense))


def _bfactors_from_rmsfs(pdb, rmsfs):
    """(reference: rmsf.py:66)"""
    return np.concatenate([
        list(itertools.repeat(rmsf, r.n_atoms))
        for rmsf, r in zip(rmsfs, pdb.top.residues)])
