"""GROMACS TRR trajectory read/write.

TRR is the full-precision GROMACS format: a sequence of XDR-encoded
(big-endian) frames, each a fixed header followed by optional box /
virial / pressure / coordinate / velocity / force blocks whose byte
sizes the header declares. Frame layout (GROMACS ``xdrfile_trr.c``):

    int32  magic = 1993
    int32  slen  = 13                  # strlen("GMX_trn_file") + 1
    int32  len   = 12                  # XDR string byte count
    char   "GMX_trn_file"              # padded to a multiple of 4
    int32  ir_size, e_size, box_size, vir_size, pres_size,
           top_size, sym_size, x_size, v_size, f_size,
           natoms, step, nre
    real   t, lambda                   # float32 or float64
    real   box[3][3]?  vir[3][3]?  pres[3][3]?
    real   x[natoms][3]?  v[...]?  f[...]?

The float width is inferred per frame from ``box_size`` (72 -> double)
or, boxless, from ``x_size / (3 * natoms)`` — exactly how the GROMACS
reader does it. Coordinates and box are nm natively, matching this
framework's in-memory units. Velocities/forces are skipped on read.

Replaces the mdtraj TRR path reference users reach through ``md.load``
(enspara/cluster/util.py:350 and friends load arbitrary md formats).
"""

import os
import struct

import numpy as np

from ..exception import DataInvalid

__all__ = ['load_trr', 'write_trr']

_MAGIC = 1993
_TAG = b'GMX_trn_file'


def _read_frame_header(f):
    head = f.read(4)
    if len(head) < 4:
        return None
    (magic,) = struct.unpack('>i', head)
    if magic != _MAGIC:
        raise DataInvalid('bad TRR magic %r (expected 1993)' % magic)
    (slen,) = struct.unpack('>i', f.read(4))
    (blen,) = struct.unpack('>i', f.read(4))
    if blen != slen - 1:
        raise DataInvalid(
            'unexpected TRR version-string lengths (%d, %d)'
            % (slen, blen))
    f.read(((blen + 3) // 4) * 4)          # tag, XDR-padded
    names = ('ir_size', 'e_size', 'box_size', 'vir_size', 'pres_size',
             'top_size', 'sym_size', 'x_size', 'v_size', 'f_size',
             'natoms', 'step', 'nre')
    vals = struct.unpack('>13i', f.read(52))
    h = dict(zip(names, vals))

    if h['box_size']:
        fsize = h['box_size'] // 9
    elif h['natoms'] and (h['x_size'] or h['v_size'] or h['f_size']):
        # GROMACS infers the width from whichever per-atom block is
        # present — a double-precision v/f-only frame (nstvout !=
        # nstxout) must not fall back to 4 bytes and desync the stream
        per_atom = h['x_size'] or h['v_size'] or h['f_size']
        fsize = per_atom // (3 * h['natoms'])
    else:
        fsize = 4
    if fsize not in (4, 8):
        raise DataInvalid('cannot infer TRR float size (%d)' % fsize)
    h['float_size'] = fsize
    fmt = '>2f' if fsize == 4 else '>2d'
    h['t'], h['lambda'] = struct.unpack(fmt, f.read(2 * fsize))
    return h


def _read_reals(f, n, fsize):
    dt = np.dtype('>f4' if fsize == 4 else '>f8')
    buf = f.read(n * fsize)
    if len(buf) < n * fsize:
        raise DataInvalid('truncated TRR frame')
    return np.frombuffer(buf, dt, n).astype(np.float32)


def scan_trr(filename):
    """(n_frames, n_atoms) by walking frame headers and seeking past
    the payload blocks — no coordinate decode."""
    n_frames, n_atoms = 0, 0
    with open(filename, 'rb') as f:
        while True:
            try:
                h = _read_frame_header(f)
            except DataInvalid:
                break                      # truncated tail
            if h is None:
                break
            payload = (h['box_size'] + h['vir_size'] + h['pres_size']
                       + h['x_size'] + h['v_size'] + h['f_size'])
            f.seek(payload, 1)
            n_frames += 1
            n_atoms = h['natoms']
    return n_frames, n_atoms


def load_trr(filename, top=None, stride=None, atom_indices=None,
             frame=None):
    from .trajectory import Trajectory, _resolve_top

    top = _resolve_top(top)
    xyzs, times, boxes = [], [], []
    any_box = False
    i = 0
    with open(filename, 'rb') as f:
        while True:
            h = _read_frame_header(f)
            if h is None:
                break
            want = ((frame is None or i == frame)
                    and (frame is not None or stride is None
                         or stride <= 1 or i % stride == 0))
            fs = h['float_size']
            for skip in ('ir_size', 'e_size'):
                f.seek(h[skip], os.SEEK_CUR)
            if h['box_size']:
                box = _read_reals(f, 9, fs).reshape(3, 3)
            else:
                box = None
            for skip in ('vir_size', 'pres_size', 'top_size',
                         'sym_size'):
                f.seek(h[skip], os.SEEK_CUR)
            if h['x_size']:
                if want:
                    xyz = _read_reals(
                        f, 3 * h['natoms'], fs).reshape(-1, 3)
                else:
                    f.seek(h['x_size'], os.SEEK_CUR)
            else:
                xyz = None
            f.seek(h['v_size'] + h['f_size'], os.SEEK_CUR)

            if want and xyz is not None:
                xyzs.append(xyz)
                times.append(h['t'])
                boxes.append(box)
                any_box = any_box or box is not None
            i += 1
            if frame is not None and i > frame:
                break

    if not xyzs:
        raise DataInvalid('no coordinate frames in %r' % filename)
    xyz = np.stack(xyzs)
    if atom_indices is not None:
        xyz = xyz[:, np.asarray(atom_indices)]
        if top is not None:
            top = top.subset(np.asarray(atom_indices))
    cells = None
    if any_box:
        cells = np.stack([b if b is not None else np.zeros((3, 3))
                          for b in boxes]).astype(np.float32)
    return Trajectory(xyz, topology=top,
                      time=np.asarray(times, np.float32),
                      unitcell_vectors=cells)


def write_trr(filename, traj):
    """Write float32 TRR with box + coordinates (no v/f blocks)."""
    xyz = np.asarray(traj.xyz, np.float32)
    n_frames, natoms = xyz.shape[:2]
    cells = traj.unitcell_vectors
    time = np.asarray(traj.time, np.float32)
    with open(filename, 'wb') as f:
        for i in range(n_frames):
            box = None if cells is None else np.asarray(
                cells[i], np.float32)
            box_size = 0 if box is None else 36
            x_size = 12 * natoms
            f.write(struct.pack('>3i', _MAGIC, len(_TAG) + 1,
                                len(_TAG)))
            f.write(_TAG)                      # 12 bytes, already x4
            f.write(struct.pack(
                '>13i', 0, 0, box_size, 0, 0, 0, 0,
                x_size, 0, 0, natoms, i, 0))
            f.write(struct.pack('>2f', float(time[i]), 0.0))
            if box is not None:
                f.write(box.astype('>f4').tobytes())
            f.write(xyz[i].astype('>f4').tobytes())
    return filename
