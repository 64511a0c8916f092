"""GROMACS GRO coordinate file read/write.

Fixed-column text: a title line (with optional ``t=`` time), the atom
count, ``natoms`` lines of ``%5d%-5s%5s%5d%8.3f%8.3f%8.3f`` (residue
number/name, atom name/number, x y z in nm, optional velocities), and
a box line (3 or 9 floats, nm). Multiple concatenated frames form a
trajectory; the first frame also yields a Topology, so a ``.gro`` file
works as the ``top=`` argument anywhere a PDB does (common GROMACS
workflow the reference inherits from mdtraj).
"""

import numpy as np

from ..exception import DataInvalid

__all__ = ['load_gro', 'write_gro']


def _parse_box(tokens):
    vals = [float(t) for t in tokens]
    box = np.zeros((3, 3), np.float32)
    if len(vals) >= 3:
        box[0, 0], box[1, 1], box[2, 2] = vals[:3]
    if len(vals) == 9:
        (box[0, 1], box[0, 2], box[1, 0],
         box[1, 2], box[2, 0], box[2, 1]) = vals[3:]
    return box


def load_gro(filename, top=None, stride=None, atom_indices=None,
             frame=None):
    from .topology import Topology, guess_element
    from .trajectory import Trajectory, _resolve_top

    top = _resolve_top(top)
    xyzs, times, boxes = [], [], []
    built_top = None
    with open(filename) as f:
        while True:
            title = f.readline()
            if not title.strip():
                break
            try:
                natoms = int(f.readline())
            except ValueError:
                raise DataInvalid('bad GRO atom-count line in %r'
                                  % filename)
            t = 0.0
            if 't=' in title:
                try:
                    t = float(title.rsplit('t=', 1)[1].split()[0])
                except (ValueError, IndexError):
                    pass
            xyz = np.empty((natoms, 3), np.float32)
            build = built_top is None and top is None
            if build:
                built_top = Topology()
                chain = built_top.add_chain()
                residue = None
                last_key = None
            for i in range(natoms):
                line = f.readline()
                if len(line) < 44:
                    raise DataInvalid('truncated GRO frame in %r'
                                      % filename)
                xyz[i] = (float(line[20:28]), float(line[28:36]),
                          float(line[36:44]))
                if build:
                    resseq = int(line[0:5])
                    resname = line[5:10].strip()
                    name = line[10:15].strip()
                    if (resseq, resname) != last_key:
                        residue = built_top.add_residue(
                            resname, chain, resseq)
                        last_key = (resseq, resname)
                    built_top.add_atom(
                        name, guess_element(name, resname), residue)
            boxes.append(_parse_box(f.readline().split()))
            xyzs.append(xyz)
            times.append(t)

    if not xyzs:
        raise DataInvalid('no frames in %r' % filename)
    xyz = np.stack(xyzs)
    times = np.asarray(times, np.float32)
    cells = np.stack(boxes)
    if not np.any(cells):
        cells = None

    sel = slice(None)
    if frame is not None:
        sel = slice(frame, frame + 1)
    elif stride is not None and stride > 1:
        sel = slice(None, None, stride)
    xyz, times = xyz[sel], times[sel]
    cells = None if cells is None else cells[sel]

    topology = top if top is not None else built_top
    if atom_indices is not None:
        idx = np.asarray(atom_indices)
        xyz = xyz[:, idx]
        if topology is not None:
            topology = topology.subset(idx)
    return Trajectory(xyz, topology=topology, time=times,
                      unitcell_vectors=cells)


def write_gro(filename, traj):
    xyz = np.asarray(traj.xyz, np.float32)
    top = traj.topology
    cells = traj.unitcell_vectors
    with open(filename, 'w') as f:
        for fi in range(len(xyz)):
            f.write('Written by enspara_tpu, t= %.5f\n'
                    % float(traj.time[fi]))
            f.write('%5d\n' % xyz.shape[1])
            for ai in range(xyz.shape[1]):
                if top is not None:
                    atom = top.atom(ai)
                    resseq = atom.residue.resSeq % 100000
                    resname = atom.residue.name[:5]
                    name = atom.name[:5]
                else:
                    resseq, resname, name = 1, 'UNK', 'X'
                f.write('%5d%-5s%5s%5d%8.3f%8.3f%8.3f\n'
                        % (resseq, resname, name, (ai + 1) % 100000,
                           xyz[fi, ai, 0], xyz[fi, ai, 1],
                           xyz[fi, ai, 2]))
            if cells is not None:
                b = np.asarray(cells[fi], np.float64)
                off = [b[0, 1], b[0, 2], b[1, 0],
                       b[1, 2], b[2, 0], b[2, 1]]
                if np.any(off):
                    f.write(('%10.5f' * 9 + '\n')
                            % (b[0, 0], b[1, 1], b[2, 2], *off))
                else:
                    f.write('%10.5f%10.5f%10.5f\n'
                            % (b[0, 0], b[1, 1], b[2, 2]))
            else:
                f.write('%10.5f%10.5f%10.5f\n' % (0.0, 0.0, 0.0))
    return filename
