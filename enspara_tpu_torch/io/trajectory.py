"""Trajectory container + format-dispatching load/save.

Covers the slice of the mdtraj.Trajectory API the reference uses: xyz
(nm, float32), topology, time, slicing, joining, atom_slice,
center_coordinates, superpose, save. The heavy geometry (RMSD etc.)
lives in device kernels; this class is deliberately a thin host
container.
"""

import os

import numpy as np

from ..exception import ImproperlyConfigured, DataInvalid

__all__ = ['Trajectory', 'load', 'load_frame', 'join']


class Trajectory(object):

    def __init__(self, xyz, topology=None, time=None,
                 unitcell_vectors=None):
        xyz = np.asarray(xyz, dtype=np.float32)
        if xyz.ndim == 2:
            xyz = xyz[None]
        if xyz.ndim != 3 or xyz.shape[-1] != 3:
            raise DataInvalid('xyz must be (n_frames, n_atoms, 3); got '
                              '%s' % (xyz.shape,))
        if topology is not None and topology.n_atoms != xyz.shape[1]:
            raise DataInvalid(
                'Topology has %d atoms but coordinates have %d'
                % (topology.n_atoms, xyz.shape[1]))
        self.xyz = xyz
        self.topology = topology
        self.time = (np.asarray(time, dtype=np.float32)
                     if time is not None else
                     np.arange(len(xyz), dtype=np.float32))
        self.unitcell_vectors = unitcell_vectors

    # -- basic container behavior ---------------------------------------

    @property
    def top(self):
        return self.topology

    @property
    def n_frames(self):
        return self.xyz.shape[0]

    @property
    def n_atoms(self):
        return self.xyz.shape[1]

    @property
    def n_residues(self):
        return self.topology.n_residues if self.topology else 0

    def __len__(self):
        return self.n_frames

    def __getitem__(self, key):
        if isinstance(key, (int, np.integer)):
            n = self.n_frames
            if not -n <= key < n:
                # a silent empty slice here hides the bad index until
                # downstream statistics NaN out (review finding)
                raise IndexError(
                    'frame index %d out of range for %d frames'
                    % (key, n))
            key = slice(key, key + 1) if key != -1 else slice(-1, None)
        xyz = self.xyz[key]
        time = self.time[key]
        cell = (self.unitcell_vectors[key]
                if self.unitcell_vectors is not None else None)
        if xyz.ndim == 2:
            xyz = xyz[None]
            time = np.atleast_1d(time)
            cell = cell[None] if cell is not None else None
        return Trajectory(xyz, self.topology, time, cell)

    def slice(self, key, copy=True):
        out = self[key]
        if copy:
            out.xyz = out.xyz.copy()
        return out

    def __repr__(self):
        return ('<Trajectory with %d frames, %d atoms>'
                % (self.n_frames, self.n_atoms))

    def __add__(self, other):
        return self.join(other)

    def join(self, other):
        """Concatenate frames (same topology)."""
        others = other if isinstance(other, (list, tuple)) else [other]
        xyz = np.concatenate([self.xyz] + [o.xyz for o in others])
        time = np.concatenate([self.time] + [o.time for o in others])
        cell = None
        if self.unitcell_vectors is not None and all(
                o.unitcell_vectors is not None for o in others):
            cell = np.concatenate(
                [self.unitcell_vectors]
                + [o.unitcell_vectors for o in others])
        return Trajectory(xyz, self.topology, time, cell)

    def stack(self, other):
        """Concatenate atoms (same frame count)."""
        if self.n_frames != other.n_frames:
            raise DataInvalid('Frame counts differ: %d vs %d'
                              % (self.n_frames, other.n_frames))
        xyz = np.concatenate([self.xyz, other.xyz], axis=1)
        top = (self.topology.join(other.topology)
               if self.topology and other.topology else None)
        return Trajectory(xyz, top, self.time, self.unitcell_vectors)

    def atom_slice(self, atom_indices):
        atom_indices = np.asarray(atom_indices)
        top = (self.topology.subset(atom_indices)
               if self.topology is not None else None)
        cell = self.unitcell_vectors
        return Trajectory(self.xyz[:, atom_indices], top, self.time,
                          cell)

    def copy(self):
        return Trajectory(self.xyz.copy(), self.topology, self.time.copy(),
                          None if self.unitcell_vectors is None
                          else self.unitcell_vectors.copy())

    # -- geometry helpers ------------------------------------------------

    def center_coordinates(self):
        """Remove each frame's centroid in place (reference precenters
        before RMSD work, cluster/util.py:625)."""
        self.xyz = self.xyz - self.xyz.mean(axis=1, keepdims=True)
        return self

    def superpose(self, reference, frame=0, atom_indices=None):
        """Least-squares align every frame onto reference[frame]
        (Kabsch), in place."""
        ref = np.asarray(reference.xyz[frame], dtype=np.float64)
        idx = (np.asarray(atom_indices) if atom_indices is not None
               else np.arange(self.n_atoms))
        ref_sel = ref[idx]
        ref_mean = ref_sel.mean(0)
        out = np.empty_like(self.xyz)
        for i in range(self.n_frames):
            mob = self.xyz[i].astype(np.float64)
            mob_sel = mob[idx]
            mob_mean = mob_sel.mean(0)
            H = (mob_sel - mob_mean).T @ (ref_sel - ref_mean)
            U, s, Vt = np.linalg.svd(H)
            d = np.sign(np.linalg.det(Vt.T @ U.T))
            D = np.diag([1.0, 1.0, d])
            R = Vt.T @ D @ U.T
            out[i] = ((mob - mob_mean) @ R.T + ref_mean).astype(
                np.float32)
        self.xyz = out
        return self

    # -- io ----------------------------------------------------------------

    def save(self, filename, **kwargs):
        ext = os.path.splitext(str(filename))[1].lower()
        if ext == '.pdb':
            from .pdb import write_pdb
            return write_pdb(filename, self)
        if ext == '.xtc':
            from .xtc import write_xtc
            return write_xtc(filename, self, **kwargs)
        if ext in ('.h5', '.hdf5'):
            from .hdf5 import write_hdf5
            return write_hdf5(filename, self)
        if ext == '.dcd':
            from .dcd import write_dcd
            return write_dcd(filename, self)
        if ext == '.trr':
            from .trr import write_trr
            return write_trr(filename, self)
        if ext in ('.nc', '.ncdf', '.netcdf'):
            from .netcdf import write_netcdf
            return write_netcdf(filename, self)
        if ext == '.gro':
            from .gro import write_gro
            return write_gro(filename, self)
        raise ImproperlyConfigured(
            'Unknown trajectory format %r' % ext)

    save_pdb = save
    save_xtc = save
    save_hdf5 = save
    save_dcd = save


def _resolve_top(top):
    if top is None:
        return None
    if isinstance(top, str):
        if top.lower().endswith('.gro'):
            from .gro import load_gro
            return load_gro(top).topology
        from .pdb import load_pdb
        return load_pdb(top).topology
    if isinstance(top, Trajectory):
        return top.topology
    return top


def load(filename, top=None, stride=None, atom_indices=None,
         frame=None, **kwargs):
    """Load a trajectory file, dispatching on extension (.pdb, .xtc,
    .h5, .dcd). ``top`` may be a Topology, Trajectory, or path to a
    PDB."""
    fname = str(filename).lower()
    ext = os.path.splitext(fname)[1]
    if ext == '.gz' and not fname.endswith('.pdb.gz'):
        raise DataInvalid(
            'only gzipped PDBs (.pdb.gz) are supported; got %r'
            % (filename,))
    top = _resolve_top(top)
    if ext in ('.pdb', '.gz'):
        from .pdb import load_pdb
        traj = load_pdb(filename)
        if frame is not None:
            traj = traj[frame]
        elif stride is not None and stride > 1:
            traj = traj[::stride]
        if atom_indices is not None:
            traj = traj.atom_slice(atom_indices)
        return traj
    if ext == '.xtc':
        from .xtc import load_xtc
        return load_xtc(filename, top=top, stride=stride,
                        atom_indices=atom_indices, frame=frame)
    if ext in ('.h5', '.hdf5'):
        from .hdf5 import load_hdf5
        return load_hdf5(filename, top=top, stride=stride,
                         atom_indices=atom_indices, frame=frame)
    if ext == '.dcd':
        from .dcd import load_dcd
        return load_dcd(filename, top=top, stride=stride,
                        atom_indices=atom_indices, frame=frame)
    if ext == '.trr':
        from .trr import load_trr
        return load_trr(filename, top=top, stride=stride,
                        atom_indices=atom_indices, frame=frame)
    if ext in ('.nc', '.ncdf', '.netcdf'):
        from .netcdf import load_netcdf
        return load_netcdf(filename, top=top, stride=stride,
                           atom_indices=atom_indices, frame=frame)
    if ext == '.gro':
        from .gro import load_gro
        return load_gro(filename, top=top, stride=stride,
                        atom_indices=atom_indices, frame=frame)
    raise ImproperlyConfigured('Unknown trajectory format %r' % ext)


def load_frame(filename, index, top=None, **kwargs):
    """Load a single frame by index."""
    return load(filename, top=top, frame=index, **kwargs)


def join(trajs):
    """Concatenate a list of trajectories along frames."""
    trajs = list(trajs)
    return trajs[0].join(trajs[1:]) if len(trajs) > 1 else trajs[0]
