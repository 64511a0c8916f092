"""PDB file read/write. Coordinates stored in nm internally (PDB files
are in Angstroms), matching the mdtraj convention the reference's data
flows use."""

import gzip

import numpy as np

from .topology import Topology, guess_element

__all__ = ['load_pdb', 'write_pdb']


def _open(filename, mode='rt'):
    if str(filename).endswith('.gz'):
        return gzip.open(filename, mode)
    return open(filename, mode)


def load_pdb(filename):
    """Parse a PDB file -> Trajectory (possibly multi-MODEL)."""
    from .trajectory import Trajectory

    top = Topology()
    models = []
    coords = []
    chain = None
    residue = None
    last_chain_id = None
    last_res_key = None
    in_later_model = False
    cell = None

    with _open(filename) as f:
        for line in f:
            rec = line[:6]
            if rec == 'CRYST1':
                try:
                    cell = (float(line[6:15]), float(line[15:24]),
                            float(line[24:33]), float(line[33:40]),
                            float(line[40:47]), float(line[47:54]))
                except ValueError:
                    cell = None
            elif rec == 'MODEL ':
                if coords:
                    models.append(coords)
                    coords = []
                    in_later_model = True
            elif rec == 'ENDMDL':
                pass
            elif rec in ('ATOM  ', 'HETATM'):
                x = float(line[30:38])
                y = float(line[38:46])
                z = float(line[46:54])
                coords.append((x * 0.1, y * 0.1, z * 0.1))
                if in_later_model:
                    continue
                name = line[12:16].strip()
                resname = line[17:21].strip()
                chain_id = line[21]
                try:
                    resseq = int(line[22:26])
                except ValueError:
                    resseq = 0
                element = line[76:78].strip() if len(line) > 77 else ''
                if not element:
                    element = guess_element(name, resname)
                else:
                    element = element.capitalize()
                try:
                    serial = int(line[6:11])
                except ValueError:
                    serial = None
                if chain is None or chain_id != last_chain_id:
                    chain = top.add_chain(chain_id)
                    last_chain_id = chain_id
                    last_res_key = None
                res_key = (chain_id, resseq, resname)
                if res_key != last_res_key:
                    residue = top.add_residue(resname, chain, resseq)
                    last_res_key = res_key
                top.add_atom(name, element, residue, serial)
            elif rec == 'TER   ':
                last_res_key = None

    if coords:
        models.append(coords)

    n_atoms = top.n_atoms
    xyz = np.array([m[:n_atoms] for m in models if len(m) >= n_atoms],
                   dtype=np.float32)
    ucv = None
    if cell is not None and cell[0] > 0:
        from .dcd import _vectors_from_cell
        v = _vectors_from_cell(cell[0] * 0.1, cell[1] * 0.1,
                               cell[2] * 0.1, cell[3], cell[4],
                               cell[5])
        ucv = np.tile(v[None], (xyz.shape[0], 1, 1))
    return Trajectory(xyz, top, unitcell_vectors=ucv)


def write_pdb(filename, traj):
    """Write a Trajectory as a (multi-MODEL when n_frames>1) PDB."""
    xyz = np.asarray(traj.xyz)
    top = traj.top
    multi = xyz.shape[0] > 1
    ucv = getattr(traj, 'unitcell_vectors', None)
    with _open(filename, 'wt') as f:
        if ucv is not None:
            from .dcd import _cell_from_vectors
            a, b, c, al, be, ga = _cell_from_vectors(
                np.asarray(ucv[0], np.float64) * 10.0)
            f.write('CRYST1%9.3f%9.3f%9.3f%7.2f%7.2f%7.2f P 1      '
                    '   1\n' % (a, b, c, al, be, ga))
        for m in range(xyz.shape[0]):
            if multi:
                f.write('MODEL     %4d\n' % (m + 1))
            serial = 1
            for chain in top.chains:
                a = None
                for res in chain.residues:
                    for a in res.atoms:
                        x, y, z = xyz[m, a.index] * 10.0
                        name = a.name
                        if len(name) < 4 and len(a.element) < 2:
                            name = ' ' + name
                        f.write(
                            'ATOM  %5d %-4s %-4s%s%4d    '
                            '%8.3f%8.3f%8.3f%6.2f%6.2f          %2s\n'
                            % (serial % 100000, name[:4], res.name[:4],
                               chain.chain_id[:1] or ' ',
                               res.resSeq % 10000, x, y, z, 1.0, 0.0,
                               a.element[:2]))
                        serial += 1
                if a is not None:
                    f.write('TER\n')
            if multi:
                f.write('ENDMDL\n')
        f.write('END\n')
    return filename
