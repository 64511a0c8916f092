"""AMBER NetCDF trajectory read/write (the ``.nc`` / ``.ncdf`` format
of cpptraj/pmemd, AMBER NetCDF Trajectory Convention 1.0).

Backed by ``scipy.io.netcdf_file`` (NetCDF-3 classic / 64-bit offset —
exactly what AMBER writes), so no extra dependency. Disk units are
angstrom/picosecond per the convention; coordinates convert to this
framework's nm in memory. Replaces the mdtraj ``.nc`` path reference
users reach through ``md.load``.
"""

import numpy as np

from ..exception import DataInvalid

__all__ = ['load_netcdf', 'write_netcdf']


def load_netcdf(filename, top=None, stride=None, atom_indices=None,
                frame=None):
    from scipy.io import netcdf_file

    from .trajectory import Trajectory, _resolve_top

    top = _resolve_top(top)
    with netcdf_file(filename, 'r', mmap=False) as nc:
        if 'coordinates' not in nc.variables:
            raise DataInvalid(
                '%r has no "coordinates" variable — not an AMBER '
                'NetCDF trajectory' % filename)
        coords = nc.variables['coordinates']
        xyz = np.asarray(coords[:], np.float32) / 10.0   # A -> nm
        if xyz.ndim == 2:                                # restart file
            xyz = xyz[None]
        time = None
        if 'time' in nc.variables:
            time = np.asarray(nc.variables['time'][:],
                              np.float32).reshape(-1)
        cells = None
        if ('cell_lengths' in nc.variables
                and 'cell_angles' in nc.variables):
            from .dcd import _vectors_from_cell
            ls = np.asarray(nc.variables['cell_lengths'][:],
                            np.float64).reshape(-1, 3) / 10.0
            an = np.asarray(nc.variables['cell_angles'][:],
                            np.float64).reshape(-1, 3)
            cells = np.stack([
                _vectors_from_cell(*ls[i], *an[i])
                for i in range(len(ls))])

    sel = slice(None)
    if frame is not None:
        sel = slice(frame, frame + 1)
    elif stride is not None and stride > 1:
        sel = slice(None, None, stride)
    xyz = xyz[sel]
    time = None if time is None else time[sel]
    cells = None if cells is None else cells[sel]
    if atom_indices is not None:
        xyz = xyz[:, np.asarray(atom_indices)]
        if top is not None:
            top = top.subset(np.asarray(atom_indices))
    return Trajectory(xyz, topology=top, time=time,
                      unitcell_vectors=cells)


def write_netcdf(filename, traj):
    from scipy.io import netcdf_file

    from .dcd import _cell_from_vectors

    xyz = np.asarray(traj.xyz, np.float32) * 10.0        # nm -> A
    n_frames, n_atoms = xyz.shape[:2]
    with netcdf_file(filename, 'w', version=2) as nc:
        nc.Conventions = b'AMBER'
        nc.ConventionVersion = b'1.0'
        nc.program = b'enspara_tpu'
        nc.programVersion = b'1'
        nc.createDimension('frame', None)
        nc.createDimension('atom', n_atoms)
        nc.createDimension('spatial', 3)

        v = nc.createVariable('coordinates', 'f',
                              ('frame', 'atom', 'spatial'))
        v[:] = xyz
        v.units = b'angstrom'
        t = nc.createVariable('time', 'f', ('frame',))
        t[:] = np.asarray(traj.time, np.float32)
        t.units = b'picosecond'

        if traj.unitcell_vectors is not None:
            nc.createDimension('cell_spatial', 3)
            nc.createDimension('cell_angular', 3)
            cl = nc.createVariable('cell_lengths', 'd',
                                   ('frame', 'cell_spatial'))
            ca = nc.createVariable('cell_angles', 'd',
                                   ('frame', 'cell_angular'))
            cells = np.array([
                _cell_from_vectors(np.asarray(v_, np.float64))
                for v_ in traj.unitcell_vectors])
            cl[:] = cells[:, :3] * 10.0                  # nm -> A
            ca[:] = cells[:, 3:]
            cl.units = b'angstrom'
            ca.units = b'degree'
    return filename
