"""Dihedral-angle discovery and computation (counterpart of
``enspara_tpu/geometry/dihedrals.py``).

Atom quartets come from the topology with the standard residue
templates; the angle is the arctan2 of cross products over (n_frames,
n_dihedrals), in torch ops on the device of the input or of ``device=``
(host input goes to the card), a chunk of frames at a time.
"""

import numpy as np
import torch

from ..util.device import resolve_device

__all__ = ['compute_dihedrals', 'compute_phi', 'compute_psi',
           'compute_chi1', 'compute_chi2', 'compute_chi3',
           'compute_chi4', 'atom_quartets']

# standard chi-angle atom-name templates (one match per residue, first
# template that matches wins)
_CHI_TEMPLATES = {
    1: [['N', 'CA', 'CB', 'CG'], ['N', 'CA', 'CB', 'CG1'],
        ['N', 'CA', 'CB', 'SG'], ['N', 'CA', 'CB', 'OG'],
        ['N', 'CA', 'CB', 'OG1']],
    2: [['CA', 'CB', 'CG', 'CD'], ['CA', 'CB', 'CG', 'CD1'],
        ['CA', 'CB', 'CG1', 'CD1'], ['CA', 'CB', 'CG', 'OD1'],
        ['CA', 'CB', 'CG', 'ND1'], ['CA', 'CB', 'CG', 'SD']],
    3: [['CB', 'CG', 'CD', 'NE'], ['CB', 'CG', 'CD', 'CE'],
        ['CB', 'CG', 'CD', 'OE1'], ['CB', 'CG', 'SD', 'CE']],
    4: [['CG', 'CD', 'NE', 'CZ'], ['CG', 'CD', 'CE', 'NZ']],
}

# frames a chunk of the angle evaluation
_CHUNK_FRAMES = 1 << 16


def _residue_atom_map(res):
    return {a.name: a.index for a in res.atoms}


def atom_quartets(top, kind):
    """(n_dihedrals, 4) atom-index quartets for 'phi', 'psi' or
    'chi1'..'chi4'."""
    quartets = []
    if kind in ('phi', 'psi'):
        for chain in top.chains:
            residues = chain.residues
            for i in range(len(residues)):
                cur = _residue_atom_map(residues[i])
                if kind == 'phi':
                    if i == 0:
                        continue
                    prev = _residue_atom_map(residues[i - 1])
                    names = [prev.get('C'), cur.get('N'), cur.get('CA'),
                             cur.get('C')]
                else:
                    if i == len(residues) - 1:
                        continue
                    nxt = _residue_atom_map(residues[i + 1])
                    names = [cur.get('N'), cur.get('CA'), cur.get('C'),
                             nxt.get('N')]
                if all(n is not None for n in names):
                    quartets.append(names)
    elif kind.startswith('chi'):
        order = int(kind[3])
        for res in top.residues:
            amap = _residue_atom_map(res)
            for template in _CHI_TEMPLATES[order]:
                idx = [amap.get(n) for n in template]
                if all(i is not None for i in idx):
                    quartets.append(idx)
                    break
    else:
        raise ValueError('Unknown dihedral kind %r' % kind)
    return np.array(quartets, dtype=int).reshape(-1, 4)


def _angles(xyz, q):
    """Dihedral angles of the quartets ``q`` (n_q, 4) in the frames
    ``xyz`` (n, a, 3), radians in (-pi, pi]."""
    p0, p1, p2, p3 = (xyz[:, q[:, k]] for k in range(4))
    b1 = p1 - p0
    b2 = p2 - p1
    b3 = p3 - p2
    c1 = torch.linalg.cross(b2, b3)
    c2 = torch.linalg.cross(b1, b2)
    p1v = (b1 * c1).sum(-1) * torch.sqrt((b2 * b2).sum(-1))
    p2v = (c1 * c2).sum(-1)
    return torch.atan2(p1v, p2v)


def dihedrals_tensor(xyz, quartets, device=None):
    """Dihedral angles in radians, an (n_frames, n_quartets) tensor of
    the coordinates' float dtype on ``device`` (default: where ``xyz``
    lies; host input goes to the card). ``xyz`` is (n_frames, n_atoms, 3),
    numpy or a tensor; it crosses to the device a chunk of frames at a
    time."""
    dev = resolve_device(xyz, device)
    if not isinstance(xyz, torch.Tensor):
        xyz = torch.from_numpy(np.ascontiguousarray(xyz))
    q = torch.as_tensor(np.asarray(quartets, dtype=np.int64).reshape(-1, 4),
                        device=dev)
    out = torch.empty((xyz.shape[0], q.shape[0]), dtype=xyz.dtype,
                      device=dev)
    if q.shape[0]:
        for lo in range(0, xyz.shape[0], _CHUNK_FRAMES):
            out[lo:lo + _CHUNK_FRAMES] = _angles(
                xyz[lo:lo + _CHUNK_FRAMES].to(dev), q)
    return out


def compute_dihedrals(traj, quartets, device=None):
    """Dihedral angles in radians, (n_frames, n_quartets) numpy of the
    coordinates' dtype, range (-pi, pi]."""
    xyz = traj.xyz if hasattr(traj, 'xyz') else traj
    return dihedrals_tensor(xyz, quartets, device).cpu().numpy()


def _make_compute(kind):
    def compute(traj, periodic=True, device=None, **kwargs):
        q = atom_quartets(traj.top, kind)
        return q, compute_dihedrals(traj, q, device)
    compute.__name__ = 'compute_%s' % kind
    compute.__doc__ = ('Quartet indices and %s angles (radians) for '
                       'every applicable residue.' % kind)
    return compute


compute_phi = _make_compute('phi')
compute_psi = _make_compute('psi')
compute_chi1 = _make_compute('chi1')
compute_chi2 = _make_compute('chi2')
compute_chi3 = _make_compute('chi3')
compute_chi4 = _make_compute('chi4')
