"""CHARMM/NAMD DCD trajectory read/write (Fortran-record binary,
coordinates in Angstroms on disk, nm in memory)."""

import os
import struct

import numpy as np

from ..exception import MissingData

__all__ = ['load_dcd', 'write_dcd']


def _vectors_from_cell(a, b, c, alpha, beta, gamma):
    """Triclinic box vectors (rows) from lengths + angles in degrees,
    first vector along x, second in the xy plane (GROMACS convention)."""
    al, be, ga = np.radians([alpha, beta, gamma])
    v2x = b * np.cos(ga)
    v2y = b * np.sin(ga)
    v3x = c * np.cos(be)
    v3y = c * (np.cos(al) - np.cos(be) * np.cos(ga)) / np.sin(ga)
    v3z = np.sqrt(max(c * c - v3x * v3x - v3y * v3y, 0.0))
    return np.array([[a, 0.0, 0.0],
                     [v2x, v2y, 0.0],
                     [v3x, v3y, v3z]], np.float32)


def _cell_from_vectors(v):
    """(a, b, c, alpha, beta, gamma[deg]) from (3, 3) row vectors."""
    a, b, c = (np.linalg.norm(v[i]) for i in range(3))

    def ang(x, y, nx, ny):
        return np.degrees(np.arccos(
            np.clip(np.dot(x, y) / (nx * ny), -1.0, 1.0)))

    return (a, b, c, ang(v[1], v[2], b, c), ang(v[0], v[2], a, c),
            ang(v[0], v[1], a, b))


def _angle_deg(x):
    """DCD cell-record angle: cosines in [-1, 1] (X-PLOR/NAMD) or
    degrees (CHARMM) — disambiguate the same way VMD's dcdplugin does."""
    return np.degrees(np.arccos(x)) if -1.0 <= x <= 1.0 else x


def _read_record(f):
    head = f.read(4)
    if len(head) < 4:
        return None
    (n,) = struct.unpack('<i', head)
    data = f.read(n)
    if len(data) < n:
        # tail-truncated file (simulation killed mid-write): treat the
        # partial record as EOF so the complete frames before it load
        return None
    f.read(4)
    return data


def scan_dcd(filename):
    """(n_frames, n_atoms) from the header records + file size —
    no coordinate decode. Size-derived so truncated tails and writers
    with a stale NSET header field both count correctly."""
    with open(filename, 'rb') as f:
        header = _read_record(f)
        if header is None or header[:4] != b'CORD':
            raise MissingData('%s is not a DCD file' % filename)
        has_cell = struct.unpack('<i', header[44:48])[0]
        _read_record(f)                    # title
        (n_atoms,) = struct.unpack('<i', _read_record(f))
        data_start = f.tell()
    frame_bytes = (3 * (4 * n_atoms + 8)
                   + ((6 * 8 + 8) if has_cell else 0))
    total = os.path.getsize(filename) - data_start
    return total // frame_bytes, n_atoms


def load_dcd(filename, top=None, stride=None, atom_indices=None,
             frame=None):
    from .trajectory import Trajectory

    with open(filename, 'rb') as f:
        header = _read_record(f)
        if header is None or header[:4] != b'CORD':
            raise MissingData('%s is not a DCD file' % filename)
        ints = struct.unpack('<9i', header[4:40])
        n_frames_hdr = ints[0]
        has_cell = struct.unpack('<i', header[44:48])[0]
        _read_record(f)  # title
        natoms_rec = _read_record(f)
        (n_atoms,) = struct.unpack('<i', natoms_rec)

        frames = []
        cells = []
        while True:
            if has_cell:
                cell = _read_record(f)
                if cell is None:
                    break
                cells.append(struct.unpack('<6d', cell))
            x = _read_record(f)
            if x is None:
                break
            y = _read_record(f)
            z = _read_record(f)
            if y is None or z is None:
                break
            frames.append((np.frombuffer(x, '<f4'),
                           np.frombuffer(y, '<f4'),
                           np.frombuffer(z, '<f4')))

    n_frames = len(frames)
    xyz = np.empty((n_frames, n_atoms, 3), np.float32)
    for i, (x, y, z) in enumerate(frames):
        xyz[i, :, 0] = x
        xyz[i, :, 1] = y
        xyz[i, :, 2] = z
    xyz *= 0.1  # Angstrom -> nm

    cell_vectors = None
    if cells:
        cv = np.zeros((n_frames, 3, 3), np.float32)
        for i, c in enumerate(cells[:n_frames]):
            # record order (a, gamma, b, beta, alpha, c) per CHARMM
            cv[i] = _vectors_from_cell(
                c[0] * 0.1, c[2] * 0.1, c[5] * 0.1,
                _angle_deg(c[4]), _angle_deg(c[3]), _angle_deg(c[1]))
        cell_vectors = cv

    if frame is not None:
        sl = slice(frame, frame + 1)
    elif stride is not None and stride > 1:
        sl = slice(None, None, stride)
    else:
        sl = slice(None)
    xyz = xyz[sl]
    cell_vectors = cell_vectors[sl] if cell_vectors is not None else None

    from .trajectory import _resolve_top
    traj = Trajectory(xyz, _resolve_top(top),
                      unitcell_vectors=cell_vectors)
    if atom_indices is not None:
        traj = traj.atom_slice(atom_indices)
    return traj


def _write_record(f, data):
    f.write(struct.pack('<i', len(data)))
    f.write(data)
    f.write(struct.pack('<i', len(data)))


def write_dcd(filename, traj):
    xyz = np.asarray(traj.xyz, np.float32) * 10.0  # nm -> Angstrom
    n_frames, n_atoms = xyz.shape[:2]
    cell_vectors = getattr(traj, 'unitcell_vectors', None)
    has_cell = 1 if cell_vectors is not None else 0
    with open(filename, 'wb') as f:
        header = b'CORD' + struct.pack(
            '<9i', n_frames, 0, 1, n_frames, 0, 0, 0, 3 * n_atoms, 0)
        header += struct.pack('<f', 1.0)       # timestep
        header += struct.pack('<i', has_cell)
        header += struct.pack('<8i', *([0] * 8))
        header += struct.pack('<2i', 0, 24)     # CHARMM version
        _write_record(f, header)
        title = b'Written by enspara_tpu'.ljust(80)
        _write_record(f, struct.pack('<i', 1) + title)
        _write_record(f, struct.pack('<i', n_atoms))
        for fr in range(n_frames):
            if has_cell:
                a, b, c, al, be, ga = _cell_from_vectors(
                    np.asarray(cell_vectors[fr], np.float64) * 10.0)
                _write_record(f, struct.pack(
                    '<6d', a, ga, b, be, al, c))
            for d in range(3):
                _write_record(f,
                              np.ascontiguousarray(
                                  xyz[fr, :, d]).tobytes())
    return filename
