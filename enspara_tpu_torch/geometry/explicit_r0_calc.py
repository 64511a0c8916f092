"""Explicit-dye FRET: full-atom dye trajectories mapped onto protein
residues, orientation-dependent (kappa^2) Forster radii, and burst
simulation (counterpart of ``enspara_tpu/geometry/explicit_r0_calc.py``;
reference: enspara/geometry/explicit_r0_calc.py).

The library's ``libraries.yml`` and ``R0/`` tables are read without pyyaml
or pandas (:mod:`._dye_files`). The Kabsch placement of the dye onto a
residue is host numpy in float64, all of a dye's frames at once, with the
bits of the per-frame fit. The clash test is the point-cloud route's
(``dyes_from_expt_dist._untouched_frames``), run on the device of
``device=`` (default: the card) for every dye frame of every protein
frame at once, with scipy's ``cdist`` rounding, so that the kept frames
equal the host's. Bursts keep the JAX package's numpy streams.
"""

import logging
import os
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
from numpy.linalg import norm

from .. import ra as ra_mod
from ..data import dye_library_path
from ..msm import builders
from ..msm.synthetic_data import synthetic_trajectory
from ..util.device import resolve_device
from . import dyes_from_expt_dist as dyefs
from ._dye_files import load_library_yaml, read_csv

logger = logging.getLogger(__name__)

__all__ = ['load_library', 'load_dye', 'calc_R0', 'get_dye_overlap',
           'remove_touches_protein_dye_traj', 'get_dipole_components',
           'get_dye_center', 'assemble_dye_r_mu', 'sample_dye_coords',
           'calc_k2_r', 'align_full_dye_to_res', 'map_dye_on_protein',
           'find_dyeless_states', 'remove_bad_states',
           'remove_dyeless_msm_states', 'simulate_burst_k2']

def load_library():
    """The dye library metadata (libraries.yml).
    (reference: explicit_r0_calc.py:26)"""
    return load_library_yaml(os.path.join(dye_library_path(),
                                          'libraries.yml'))


def load_dye(dyename, dyelibrary=None, dyes_dir=None):
    """Load a full-atom dye conformation trajectory by library name.
    (reference: explicit_r0_calc.py:15)"""
    from .. import io as io_mod

    if dyelibrary is None:
        dyelibrary = load_library()
    if dyes_dir is None:
        dyes_dir = dye_library_path()
    dye_file = dyelibrary[dyename]['filename'].split('_cutoff')[0]
    return io_mod.load(
        os.path.join(dyes_dir, 'trajs', '%s_cutoff10.dcd' % dye_file),
        top=os.path.join(dyes_dir, 'structures', '%s.pdb' % dye_file))


def calc_R0(k2, QD, J, n=1.333):
    """Forster radius (nm) from kappa^2, donor quantum yield and
    spectral overlap. (reference: explicit_r0_calc.py:34)"""
    scale = 0.02108           # prefactor giving R0 in nm
    return scale * (k2 * QD * J / n ** 4) ** (1 / 6)


def _aligned_product(*cols):
    """The product of columns paired by row position, as pandas pairs two
    Series of default indexes: over the longest, NaN past a shorter one."""
    n = max(len(c) for c in cols)
    out = None
    for c in cols:
        c = np.asarray(c)
        if len(c) < n:
            c = np.concatenate([c.astype(np.float64),
                                np.full(n - len(c), np.nan)])
        out = c if out is None else out * c
    return out


def get_dye_overlap(donorname, acceptorname):
    """Spectral overlap J, donor quantum yield QD and donor lifetime Td
    from the dye library's spectra tables.
    (reference: explicit_r0_calc.py:59)"""
    dyes_dir = dye_library_path()
    donor_fluor, donor_number = donorname.split(' ')[:2]
    acceptor_fluor, acceptor_number = acceptorname.split(' ')[:2]

    donor = read_csv(os.path.join(
        dyes_dir, 'R0', '%s%s.csv' % (donor_fluor, donor_number)))
    acceptor = read_csv(os.path.join(
        dyes_dir, 'R0', '%s%s.csv' % (acceptor_fluor, acceptor_number)))
    for table in (donor, acceptor):
        for col in ('Emission', 'Excitation'):
            table[col] = table[col] / 100

    chromophore_data = read_csv(
        os.path.join(dyes_dir, 'R0', 'Dyes_extinction_QD.csv'),
        names=['Type', 'Chromophore', 'Ext_coeff', 'QD', 'Td'])

    sel_d = ((chromophore_data['Chromophore'] == donor_number)
             & (chromophore_data['Type'] == donor_fluor))
    QD = chromophore_data['QD'][sel_d].astype(float)
    Td = chromophore_data['Td'][sel_d].astype(float)
    sel_a = ((chromophore_data['Chromophore'] == acceptor_number)
             & (chromophore_data['Type'] == acceptor_fluor))
    ext_coeff_max = chromophore_data['Ext_coeff'][sel_a].astype(float)

    ext_coeff_acceptor = ext_coeff_max * acceptor['Excitation']
    ext_coeff_acceptor = np.where(np.isnan(ext_coeff_acceptor), 0.0,
                                  ext_coeff_acceptor)

    trapezoid = getattr(np, 'trapezoid', None) or np.trapz
    wavelength = donor['Wavelength']
    donor_integral = trapezoid(donor['Emission'], x=wavelength)
    J = trapezoid(
        _aligned_product(donor['Emission'], ext_coeff_acceptor,
                         wavelength ** 4),
        x=wavelength) / donor_integral
    return J, QD, Td


def _clearance(pdb, resseq, probe_radius):
    """Indices of the protein atoms outside residue ``resseq`` and their
    clearances (vdW radius + probe, float64)."""
    atoms = pdb.top.select('not resSeq %d' % resseq)
    radii = np.array([pdb.top.atom(int(i)).radius for i in atoms])
    return atoms, radii + probe_radius


def _clear_atoms(dyes, prot, clearance, device):
    """Counts (C, F) of the atoms of each dye frame ``dyes`` (C, F, n, 3)
    clear of their protein frame ``prot`` (C, A, 3): the points of
    ``dyefs._untouched_frames`` with a center's dye frames as one cloud."""
    C, F, n = dyes.shape[:3]
    clear = dyefs._untouched_frames(np.asarray(dyes).reshape(C, F * n, 3),
                                    prot, clearance, device)
    return clear.reshape(C, F, n).sum(-1)


def remove_touches_protein_dye_traj(pdb, dye, resseq, probe_radius=0.04,
                                    atom_tol=6, device=None):
    """Indices of dye conformations that fit at the labeling site
    without clashing (allowing atom_tol overlapping atoms); the distances
    on ``device`` (default: the card). (reference: explicit_r0_calc.py:122)"""
    dev = resolve_device(dye.xyz, device)
    atoms, clearance = _clearance(pdb, resseq, probe_radius)
    clear = _clear_atoms(dye.xyz[None], pdb.xyz[:1, atoms], clearance,
                         dev)[0]
    return np.where(clear >= dye.xyz.shape[1] - atom_tol)[0]


def get_dipole_components(dye, dyename, dyelibrary=None):
    """(dipole origin, dipole vector) per dye frame.
    (reference: explicit_r0_calc.py:169)"""
    lib = dyelibrary if dyelibrary is not None else load_library()
    # library entries are atom names, optionally with a residue filter
    # ("C10 and resname T39"), interpolated directly after 'name'
    head, tail = lib[dyename]['mu'][:2]
    ends = dye.atom_slice(dye.topology.select(
        '(name %s) or (name %s)' % (head, tail))).xyz
    return ends[:, 0, :], ends[:, 0, :] - ends[:, 1, :]


def _norm_sel(sel):
    """Library entries are atom names, optionally followed by extra
    clauses ('C7 and resname T39'); prefix with 'name' as the reference
    does when interpolating into selections."""
    return 'name %s' % sel.strip()


def get_dye_center(dye, dyename, dyelibrary=None):
    """(reference: explicit_r0_calc.py:190)"""
    lib = dyelibrary if dyelibrary is not None else load_library()
    emission_atom = _norm_sel(lib[dyename]['r'][0])
    ids = dye.topology.select(emission_atom)
    return dye.xyz[:, ids, :].reshape(-1, 3)


def assemble_dye_r_mu(dye, dyename, dyelibrary=None):
    """Per-frame (dye center xyz, dipole origin xyz, dipole vector):
    shape (n_frames, 9). (reference: explicit_r0_calc.py:203)"""
    origin, vector = get_dipole_components(dye, dyename, dyelibrary)
    return np.hstack(
        (get_dye_center(dye, dyename, dyelibrary), origin, vector))


def calc_k2_r(Donor_coords, Acceptor_coords):
    """kappa^2 and distance between dye emission centers.
    (reference: explicit_r0_calc.py:254)"""
    d_center, d_origin, d_mu = np.reshape(Donor_coords, (3, 3))
    a_center, a_origin, a_mu = np.reshape(Acceptor_coords, (3, 3))

    r = float(norm(d_center - a_center))

    # kappa = mu_A . mu_D - 3 (r . mu_D)(mu_A . r), all unit vectors
    d_hat = d_mu / norm(d_mu)
    a_hat = a_mu / norm(a_mu)
    s_hat = (d_origin - a_origin) / norm(d_origin - a_origin)

    kappa = a_hat @ d_hat - 3 * (s_hat @ d_hat) * (a_hat @ s_hat)
    return kappa ** 2, r


def sample_dye_coords(donor_coords, acceptor_coords, states, rng=None):
    """Random dye conformations for each visited state -> (k2s, rs).
    (reference: explicit_r0_calc.py:225)"""
    if rng is None:
        rng = np.random.default_rng()
    rs, k2s = [], []
    for state in states:
        D = donor_coords[state][rng.choice(len(donor_coords[state]))]
        A = acceptor_coords[state][
            rng.choice(len(acceptor_coords[state]))]
        k2, r = calc_k2_r(D, A)
        k2s.append(k2)
        rs.append(r)
    return np.array(k2s), np.array(rs)


def _site_selections(pdb, dye, resseq, dyename, dyelibrary):
    """(dye atoms, protein atoms) that the placement superposes: N, CA,
    (CB,) C and O of the dye and of residue ``resseq``."""
    resname = pdb.top.atom(
        int(pdb.top.select('resSeq %d' % resseq)[0])).residue.name

    dye_ca = dye.top.select('name CA')
    dye_n = dye.top.select('name N')
    dye_c = dye.top.select('name C')
    dye_o = dye.top.select('name O')

    prot_ca = pdb.top.select('resSeq %d and name CA' % resseq)
    prot_n = pdb.top.select('resSeq %d and name N' % resseq)
    prot_c = pdb.top.select('resSeq %d and name C' % resseq)
    prot_o = pdb.top.select('resSeq %d and name O' % resseq)

    if resname not in ('GLY', 'PRO'):
        # CB library entries are complete selection strings (unlike
        # mu/r entries, which are bare atom names)
        dye_cb = dye.top.select(dyelibrary[dyename]['CB'][0])
        prot_cb = pdb.top.select('resSeq %d and name CB' % resseq)
        return (np.concatenate((dye_n, dye_ca, dye_cb, dye_c, dye_o)),
                np.concatenate((prot_n, prot_ca, prot_cb, prot_c, prot_o)))
    return (np.concatenate((dye_n, dye_ca, dye_c, dye_o)),
            np.concatenate((prot_n, prot_ca, prot_c, prot_o)))


def align_full_dye_to_res(pdb, dye, resseq, dyename, dyelibrary=None):
    """Superpose the dye trajectory's backbone (+CB for non-GLY/PRO)
    onto the labeled residue. (reference: explicit_r0_calc.py:294)"""
    if dyelibrary is None:
        dyelibrary = load_library()
    dye_sele, prot_sele = _site_selections(pdb, dye, resseq, dyename,
                                           dyelibrary)
    return _kabsch(dye.xyz, pdb.xyz[0][prot_sele], dye_sele)


def _kabsch(xyz, ref_sel, mobile_idx):
    """Every frame of ``xyz`` (F, N, 3) moved so that its atoms
    ``mobile_idx`` fit ``ref_sel`` (k, 3) best, in float64, stored in
    float32. The frames go through numpy's stacked products, SVD and
    determinant at once; these call the same LAPACK and BLAS routines on
    each frame as a loop of 2-D calls, so the bits are the per-frame
    fit's."""
    ref = np.asarray(ref_sel).astype(np.float64)
    ref_mean = ref.mean(0)
    mob_full = np.asarray(xyz).astype(np.float64)
    mob = mob_full[:, mobile_idx]
    mob_mean = mob.mean(1)[:, None]
    H = np.matmul((mob - mob_mean).transpose(0, 2, 1), ref - ref_mean)
    U, s, Vt = np.linalg.svd(H)
    V, Ut = Vt.transpose(0, 2, 1), U.transpose(0, 2, 1)
    D = np.zeros((len(mob_full), 3, 3))
    D[:, 0, 0] = D[:, 1, 1] = 1.0
    D[:, 2, 2] = np.sign(np.linalg.det(np.matmul(V, Ut)))
    R = np.matmul(np.matmul(V, D), Ut)
    return (np.matmul(mob_full - mob_mean, R.transpose(0, 2, 1))
            + ref_mean).astype(np.float32)


def _place_and_prune(trj, dye, resseq, dyename, dyelibrary, n_procs=1,
                     device=None, probe_radius=0.04, atom_tol=6):
    """The dye ``dye`` placed on every frame of ``trj`` at ``resseq``
    (host threads, ``n_procs`` frames at a time) and the frames it keeps
    there (the clash test of every frame at once on ``device``): returns
    (placed float32 (len(trj), F, n, 3), [kept indices per frame],
    {stage: seconds})."""
    dev = resolve_device(trj.xyz, device)
    ref = trj[0]
    dye_sele, prot_sele = _site_selections(ref, dye, resseq, dyename,
                                           dyelibrary)
    atoms, clearance = _clearance(ref, resseq, probe_radius)

    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=max(n_procs, 1)) as pool:
        placed = np.stack(list(pool.map(
            lambda i: _kabsch(dye.xyz, trj.xyz[i][prot_sele], dye_sele),
            range(len(trj))))) if len(trj) else np.zeros(
                (0,) + dye.xyz.shape, np.float32)
    t1 = time.perf_counter()
    clear = _clear_atoms(placed, trj.xyz[:, atoms], clearance, dev)
    kept = [np.where(c >= dye.xyz.shape[1] - atom_tol)[0] for c in clear]
    t2 = time.perf_counter()
    return placed, kept, {'placement': t1 - t0, 'clash': t2 - t1,
                          'tests': float(clear.size) * dye.xyz.shape[1]
                          * len(atoms)}


def map_dye_on_protein(trj, dyename, resseq, outpath='.',
                       save_aligned_dyes=False, weight_dyes=False,
                       n_procs=1, device=None):
    """Aligned, clash-pruned dye (center, dipole) parameters for every
    protein conformation: the placement on ``n_procs`` host threads, the
    clash test of every conformation at once on ``device`` (default: the
    card). (reference: explicit_r0_calc.py:399)"""
    if weight_dyes:
        raise NotImplementedError('Dye-weighting not yet implemented')

    library = load_library()
    dye = load_dye(dyename, library)
    placed, kept, _ = _place_and_prune(trj, dye, resseq, dyename, library,
                                       n_procs=n_procs, device=device)
    out = []
    for i, (xyz, keep) in enumerate(zip(placed, kept)):
        moved = dye.copy()
        moved.xyz = xyz
        if save_aligned_dyes and len(keep) > 0:
            os.makedirs(os.path.join(outpath, 'dye-alignments'),
                        exist_ok=True)
            moved[list(keep)].save(os.path.join(
                outpath, 'dye-alignments', '%s-center-%d-residue%d.dcd'
                % (''.join(dyename.split(' ')), i, resseq)))
        out.append(assemble_dye_r_mu(moved[list(keep)], dyename, library))
    return ra_mod.RaggedArray(out)


def find_dyeless_states(dye_coords):
    """(reference: explicit_r0_calc.py:457)"""
    empties = [len(row) == 0 for row in dye_coords]
    return np.flatnonzero(empties)


def remove_bad_states(bad_states, t_counts):
    """Zero all transitions in/out of the bad states.
    (reference: explicit_r0_calc.py:481)"""
    pruned = np.array(t_counts)
    if np.size(bad_states):
        gone = np.zeros(pruned.shape[0], dtype=bool)
        gone[np.asarray(bad_states, dtype=int)] = True
        pruned[gone, :] = 0
        pruned[:, gone] = 0
    return pruned


def remove_dyeless_msm_states(dye_coords1, dye_coords2, dyename1,
                              dyename2, eq_probs, t_counts):
    """Drop states where either dye can't be placed; rebuild the MSM by
    row normalization. (reference: explicit_r0_calc.py:515)"""
    bad_states1 = find_dyeless_states(dye_coords1)
    logger.info('%d states had no available dye configuration for dye '
                '%s.', len(bad_states1), dyename1)
    bad_states2 = find_dyeless_states(dye_coords2)
    logger.info('%d states had no available dye configuration for dye '
                '%s.', len(bad_states2), dyename2)

    bad_states = np.unique(np.concatenate((bad_states1, bad_states2)))
    trimmed = remove_bad_states(bad_states, t_counts)

    counts, tprobs, eqs = builders.normalize(trimmed,
                                             calculate_eq_probs=True)

    logger.info('Total states removed: %d/%d.', len(bad_states),
                len(t_counts))
    if len(t_counts) and len(bad_states) / len(t_counts) > 0.2:
        logger.warning('Labeling resulted in lots of states lost from '
                       'your MSM.')
    if np.asarray(eq_probs)[bad_states].sum() > 0.2:
        logger.warning('Labeling at this position resulted in major '
                       'probability loss.')

    for i in bad_states:
        dye_coords1[i] = [np.zeros(9)]
        dye_coords2[i] = [np.zeros(9)]

    return eqs, tprobs, dye_coords1, dye_coords2


def _simulate_burst_k2(MSM_frames, T, populations, dye_coords1,
                       dye_coords2, J, QD, n=1.333, rng=None):
    """(reference: explicit_r0_calc.py:579)"""
    rng = np.random.default_rng() if rng is None else rng

    start = rng.choice(T.shape[0], p=populations)
    chain = synthetic_trajectory(T, start, int(np.amax(MSM_frames)) + 1,
                                 random_state=rng)

    k2s, rs = sample_dye_coords(dye_coords1, dye_coords2,
                                chain[MSM_frames], rng=rng)
    FE = dyefs.FRET_efficiency(rs, calc_R0(k2s, QD, J, n=n))
    to_acceptor = rng.random(len(FE)) <= FE
    return to_acceptor.mean(), chain, k2s, rs


def simulate_burst_k2(MSM_frames, T, populations, dye_coords1,
                      dye_coords2, dyename1, dyename2, n=1.333,
                      n_procs=1, random_state=None):
    """Photon bursts with instantaneous kappa^2-dependent R0 per photon.
    (reference: explicit_r0_calc.py:615)"""
    J, QD, Td = get_dye_overlap(dyename1, dyename2)

    seeds = np.random.SeedSequence(random_state).spawn(len(MSM_frames))

    def one(i):
        return _simulate_burst_k2(
            MSM_frames[i], T=T, populations=populations,
            dye_coords1=dye_coords1, dye_coords2=dye_coords2, J=J,
            QD=QD, n=n, rng=np.random.default_rng(seeds[i]))

    with ThreadPoolExecutor(max_workers=max(n_procs, 1)) as ex:
        burst_info = list(ex.map(one, range(len(MSM_frames))))

    burst_info = np.array(burst_info, dtype=object)
    return (burst_info[:, 0], burst_info[:, 1], burst_info[:, 2],
            burst_info[:, 3])
