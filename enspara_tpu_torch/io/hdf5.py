"""mdtraj-compatible HDF5 trajectory format ("Pande convention") via
h5py: coordinates (nm), time, cell_lengths/angles, JSON topology."""

import numpy as np

from .topology import Topology

__all__ = ['load_hdf5', 'write_hdf5']


def load_hdf5(filename, top=None, stride=None, atom_indices=None,
              frame=None):
    import h5py
    from .trajectory import Trajectory

    with h5py.File(filename, 'r') as f:
        if frame is not None:
            sl = slice(frame, frame + 1)
        elif stride is not None and stride > 1:
            sl = slice(None, None, stride)
        else:
            sl = slice(None)
        xyz = np.asarray(f['coordinates'][sl], dtype=np.float32)
        time = np.asarray(f['time'][sl]) if 'time' in f else None
        if top is None and 'topology' in f:
            raw = f['topology'][0]
            if isinstance(raw, bytes):
                raw = raw.decode()
            top = Topology.from_json(raw)
        cell = None
        if 'cell_lengths' in f and 'cell_angles' in f:
            lengths = np.asarray(f['cell_lengths'][sl])
            angles = np.asarray(f['cell_angles'][sl])
            cell = _lengths_angles_to_vectors(lengths, angles)

    from .trajectory import _resolve_top
    traj = Trajectory(xyz, _resolve_top(top), time=time,
                      unitcell_vectors=cell)
    if atom_indices is not None:
        traj = traj.atom_slice(atom_indices)
    return traj


def write_hdf5(filename, traj):
    import h5py

    xyz = np.asarray(traj.xyz, dtype=np.float32)
    with h5py.File(filename, 'w') as f:
        f.attrs['conventions'] = np.bytes_(b'Pande')
        f.attrs['conventionVersion'] = np.bytes_(b'1.1')
        f.attrs['program'] = np.bytes_(b'enspara_tpu')
        f.attrs['application'] = np.bytes_(b'enspara_tpu')
        ds = f.create_dataset('coordinates', data=xyz,
                              compression='gzip', compression_opts=1)
        ds.attrs['units'] = np.bytes_(b'nanometers')
        t = traj.time if traj.time is not None else \
            np.arange(len(xyz), dtype=np.float32)
        f.create_dataset('time', data=np.asarray(t, dtype=np.float32))
        if traj.unitcell_vectors is not None:
            lengths, angles = _vectors_to_lengths_angles(
                traj.unitcell_vectors)
            f.create_dataset('cell_lengths', data=lengths)
            f.create_dataset('cell_angles', data=angles)
        if traj.top is not None:
            f.create_dataset(
                'topology',
                data=np.array([traj.top.to_json().encode()],
                              dtype=h5py.special_dtype(vlen=bytes)))
    return filename


def _lengths_angles_to_vectors(lengths, angles):
    a_len, b_len, c_len = lengths[:, 0], lengths[:, 1], lengths[:, 2]
    alpha, beta, gamma = (np.radians(angles[:, i]) for i in range(3))
    a = np.zeros((len(a_len), 3))
    a[:, 0] = a_len
    b = np.zeros_like(a)
    b[:, 0] = b_len * np.cos(gamma)
    b[:, 1] = b_len * np.sin(gamma)
    c = np.zeros_like(a)
    c[:, 0] = c_len * np.cos(beta)
    c[:, 1] = c_len * (np.cos(alpha) - np.cos(beta) * np.cos(gamma)) \
        / np.where(np.sin(gamma) == 0, 1, np.sin(gamma))
    c[:, 2] = np.sqrt(np.maximum(
        c_len ** 2 - c[:, 0] ** 2 - c[:, 1] ** 2, 0))
    return np.stack([a, b, c], axis=1).astype(np.float32)


def _vectors_to_lengths_angles(vectors):
    v = np.asarray(vectors, dtype=np.float64)
    a, b, c = v[:, 0], v[:, 1], v[:, 2]
    la = np.linalg.norm(a, axis=1)
    lb = np.linalg.norm(b, axis=1)
    lc = np.linalg.norm(c, axis=1)
    lengths = np.stack([la, lb, lc], axis=1)

    def ang(x, y, lx, ly):
        with np.errstate(invalid='ignore', divide='ignore'):
            cosv = np.einsum('ij,ij->i', x, y) / \
                np.where(lx * ly == 0, 1, lx * ly)
        return np.degrees(np.arccos(np.clip(cosv, -1, 1)))

    angles = np.stack([ang(b, c, lb, lc), ang(a, c, la, lc),
                       ang(a, b, la, lb)], axis=1)
    angles[np.isnan(angles)] = 90.0
    return (lengths.astype(np.float32), angles.astype(np.float32))
