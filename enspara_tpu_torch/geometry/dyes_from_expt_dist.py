"""smFRET forward prediction from dye point clouds (counterpart of
``enspara_tpu/geometry/dyes_from_expt_dist.py``; reference:
enspara/geometry/dyes_from_expt_dist.py).

Empirical dye-position point clouds are aligned onto labeled residues
(CA/CB/N local frame), sterically pruned against the protein, and the
resulting dye-dye distance distributions drive Monte Carlo sampling of
FRET efficiencies over MSM trajectories.

The cloud distances (the steric pruning and the dye-dye histograms) run
in float64 torch ops on the device of ``device=`` (default: the card),
with scipy's ``cdist`` rounding (``sqrt((dx^2 + dy^2) + dz^2)``) and
numpy's histogram rule (the bin from ``d / (hi - lo) * n``, then
corrected against ``np.linspace`` edges), so the counts equal the host's.
Everything else, the photon-burst sampling with its numpy random streams
included, is host numpy/scipy as in the JAX package.
"""

import glob
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import scipy.cluster.hierarchy
import scipy.sparse
import torch
from scipy.stats import kurtosis, skew

from .. import ra
from ..exception import DataInvalid
from ..msm.synthetic_data import synthetic_trajectory
from ..util.device import resolve_device

__all__ = [
    'FRET_efficiency', 'make_distribution', 'load_dye', 'norm_vec',
    'determine_rot_mat', 'find_atom_index', 'calc_cb_coords',
    'rodrigues_rotation', 'remove_touches_protein', 'cluster_grids',
    'align_dye_to_res', 'pairwise_distance_distribution',
    'dye_distance_distribution', 'sample_FE_probs',
    'sample_FRET_histograms', 'convert_photon_times',
    'histogram_to_match_expt', 'Sum_sq_resid', 'normalize_array',
    'remake_data_from_hist', 'calc_4_moments', 'calc_2_3_4_moments',
]


def FRET_efficiency(dists, r0, offset=0):
    """E = r0^6 / (r0^6 + (r + offset)^6). (reference: :13)"""
    r06 = r0 ** 6
    return r06 / (r06 + ((dists + offset) ** 6))


def make_distribution(probs, bin_edges):
    """(distance, probability) rows per state: bin centers paired with
    unit-mass probabilities, one ragged row per state."""
    rows = []
    for p, edges in zip(probs, bin_edges):
        p = np.asarray(p, dtype=np.float64)
        e = np.asarray(edges)
        centers = (e[1:] + e[:-1]) / 2.
        rows.append(np.stack([centers, p / p.sum()], axis=1))
    return ra.RaggedArray(rows)


def load_dye(dye):
    """Load a FRET dye point cloud by name or path.
    (reference: :26)"""
    from .. import io as io_mod
    from ..data import dye_library_path

    if os.path.exists(dye):
        return io_mod.load(dye)
    folder = dye_library_path()
    for sub in ('', 'point-clouds', 'structures'):
        path = os.path.join(folder, sub, '%s.pdb' % dye)
        if os.path.exists(path):
            return io_mod.load(path)
    known = sorted(glob.glob(os.path.join(folder, '**', '*.pdb'),
                             recursive=True))
    names = ', '.join(os.path.basename(p)[:-4] for p in known)
    raise DataInvalid(
        '%s is not a path to a pdb or a known dye. Known dyes: %s'
        % (dye, names))


def norm_vec(vec):
    """Unit-length row(s); accepts one vector or a stack of them."""
    vec = np.asarray(vec)
    if vec.ndim == 1:
        return vec / np.sqrt(vec @ vec)
    mags = np.sqrt((vec * vec).sum(axis=-1))
    return vec / mags[:, None]


def divide_chunks(seq, n):
    for i in range(0, len(seq), n):
        yield seq[i:i + n]


def int_norm(xs, ys):
    dx = xs[1] - xs[0]
    return ys / np.sum(ys * dx)


def find_atom_index(pdb, resSeq, atom_name):
    """Index of the first atom called ``atom_name`` in the first
    residue with the given resSeq (None when absent)."""
    matches = pdb.top.select(
        f'resSeq {int(resSeq)} and name {atom_name}')
    return int(matches[0]) if len(matches) else None


def calc_cb_coords(pdb, resSeqs=None):
    """Ideal CB positions from backbone geometry (handles GLY/PRO).
    (reference: :146)"""
    if resSeqs is None:
        sel = pdb.topology.select
        picks = {nm: sel('name ' + nm) for nm in ('N', 'CA', 'C')}
    else:
        wanted = np.asarray(resSeqs).reshape(-1)
        picks = {nm: np.array([find_atom_index(pdb, r, nm)
                               for r in wanted])
                 for nm in ('N', 'CA', 'C')}
    return _cb_coords(*(pdb.xyz[0][picks[nm]] for nm in ('N', 'CA', 'C')))


def _cb_coords(n, ca, c):
    """Ideal CB positions (k, 3) from N, CA and C positions (k, 3)."""
    CA_CB = 0.153   # canonical CA->CB bond length, nm
    away_from_n = norm_vec(ca - n)
    away_from_c = norm_vec(ca - c)
    plane_normal = norm_vec(np.cross(away_from_n, away_from_c))
    bisector = norm_vec(ca - ((n + c) / 2.))
    tilt = np.pi / 6.   # CB sits 30 degrees out of the backbone plane
    return (ca + np.sin(tilt) * CA_CB * bisector
            + np.cos(tilt) * CA_CB * plane_normal)


def determine_rot_mat(pdb, resSeq):
    """Local frame at a residue: z along CA->CB, N in the z-y plane.
    (reference: :90)"""
    return _rot_mat(pdb.xyz[0], _site_atoms(pdb, resSeq))


def _site_atoms(pdb, resSeq):
    """Indices of the N, CA and C atoms of the residue ``resSeq``."""
    return [find_atom_index(pdb, resSeq, nm) for nm in ('N', 'CA', 'C')]


def _rot_mat(xyz, atoms):
    """:func:`determine_rot_mat` of one frame's coordinates ``xyz`` (A, 3)
    at the residue whose N, CA and C are ``atoms``."""
    n_xyz, origin = xyz[atoms[0]], xyz[atoms[1]]
    z_axis = norm_vec(_cb_coords(*(xyz[[i]] for i in atoms))[0] - origin)
    x_axis = norm_vec(np.cross(norm_vec(n_xyz - origin), z_axis))
    y_axis = norm_vec(np.cross(z_axis, x_axis))
    return np.array([x_axis, y_axis, z_axis]), origin


def rodrigues_rotation(v, k, theta, centers=None):
    """Rotate coordinate frames around per-frame axes k by theta.
    (reference: :196)"""
    pivot = np.zeros(3) if centers is None else centers[:, None, :]
    rel = v - pivot
    axis = k[:, None, :]

    in_plane = rel * np.cos(theta)
    swung = np.cross(axis, rel) * np.sin(theta)
    axial = np.einsum('ijk,ijk->ij', axis, rel)
    along_axis = axis * axial[..., None] * (1 - np.cos(theta))
    return in_plane + swung + along_axis + pivot


# elements of the largest distance tensor of a chunk of frames
_CHUNK_ELEMS = 1 << 27
# points a batch of the exact re-test of the clash test's undecided points
_RETEST_ROWS = 4096


def _cdist(a, b):
    """Euclidean distances (..., n, m) between the rows of float64 tensors
    ``a`` (..., n, 3) and ``b`` (..., m, 3), rounded as scipy's ``cdist``:
    the squares summed x, y, z in order, then the correctly rounded square
    root (CUDA's; on the CPU numpy's, since torch's vectorized CPU sqrt
    can miss the nearest double by one ulp)."""
    d2 = None
    for c in range(3):
        t = a[..., :, None, c] - b[..., None, :, c]
        t = t * t
        d2 = t if d2 is None else d2 + t
    if d2.device.type == 'cpu':
        return torch.from_numpy(np.sqrt(d2.numpy()))
    return torch.sqrt(d2)


def remove_touches_protein(coords, pdb, probe_radius=0.17, device=None):
    """Drop cloud points within (vdW + probe) of any protein atom, on
    ``device`` in float64; chunked to bound the pairwise-distance memory.
    (reference: :251)"""
    dev = resolve_device(coords, device)
    coords = np.asarray(coords)
    clearance = np.array([a.radius for a in pdb.top.atoms]) + probe_radius
    step = (2048 if coords.shape[0] * pdb.xyz[0].shape[0] > 5e7
            else max(coords.shape[0], 1))
    keep = [_untouched_frames(c[None], pdb.xyz[:1], clearance, dev)[0]
            for c in divide_chunks(coords, step)]
    return coords[np.concatenate([np.zeros(0, dtype=bool)] + keep)]


def cluster_grids(point_cloud, spacing, n_clouds=all):
    """Keep the largest contiguous cloud(s). (reference: :295)"""
    labels = scipy.cluster.hierarchy.fclusterdata(
        point_cloud, t=spacing, criterion='distance')
    labels -= labels.min()

    by_size = np.argsort(-np.bincount(labels))
    keep = by_size if n_clouds is all else by_size[:n_clouds]
    member_rows = [np.flatnonzero(labels == lab) for lab in keep]
    return point_cloud[np.concatenate(member_rows)]


def align_dye_to_res(pdb, dye_coords, resSeq, placement=None):
    """Place a dye cloud in the local frame of the given residue.

    ``placement`` lets a caller reuse one residue frame for several
    dye clouds (it is ``determine_rot_mat``'s return value).
    """
    if placement is None:
        placement = determine_rot_mat(pdb, resSeq=resSeq)
    frame, origin = placement
    return np.einsum('...j,jk->...k', dye_coords, frame) + origin


def bincount_dists(dists, bin_width=0.1):
    """Fixed-width histogram from zero, one spare bin past the max:
    ``np.histogram(dists, range=(0, w * n), bins=n)``. A tensor of
    distances is counted on its device, by numpy's rule."""
    if not isinstance(dists, torch.Tensor):
        top = float(np.max(dists))
        n_bins = int(top / bin_width) + 2
        return np.histogram(dists, range=(0, bin_width * n_bins),
                            bins=n_bins)
    d = dists.reshape(1, -1)
    return _histograms(d, torch.ones_like(d, dtype=torch.bool), bin_width)[0]


def _histograms(d, valid, bin_width):
    """:func:`bincount_dists` of the ``valid`` entries of every row of the
    float64 distances ``d`` (B, M) on their device: numpy's rule (the bin
    from the scaled value, then moved by at most one against the row's
    ``np.linspace`` edges; the last bin holds its right edge), counted by
    one bincount. Returns ``[(counts, edges)]`` a row."""
    B = d.shape[0]
    tops = torch.where(valid, d, -torch.inf).amax(dim=1).cpu()
    if not torch.isfinite(tops).all():
        raise ValueError('no distance to count: a dye cloud has no point '
                         'left after removing those that touch the protein')
    n_bins = [int(float(t) / bin_width) + 2 for t in tops]
    edges = [np.linspace(0, bin_width * n, n + 1) for n in n_bins]
    width = max(n_bins)
    E = np.zeros((B, width + 1))
    for j, e in enumerate(edges):
        E[j, :len(e)] = e
    E = torch.as_tensor(E, device=d.device)
    n = torch.as_tensor(n_bins, device=d.device)[:, None]
    hi = torch.as_tensor([bin_width * k for k in n_bins],
                         device=d.device)[:, None]
    rows = torch.arange(B, device=d.device)[:, None]
    # entries counted nowhere take 0, which keeps their bin in range
    d = torch.where(valid, d, 0.0)
    b = (d / hi * n).to(torch.int64)
    b = torch.where(b == n, b - 1, b)
    b -= (d < E[rows, b]).to(torch.int64)
    b += ((d >= E[rows, b + 1]) & (b != n - 1)).to(torch.int64)
    counts = torch.bincount((rows * width + b)[valid],
                            minlength=B * width).reshape(B, width).cpu()
    return [(counts[j, :k].numpy(), e)
            for j, (k, e) in enumerate(zip(n_bins, edges))]


def int_norm_hist(xs, ys):
    """Scale ys to unit integral over xs; handles both bin-count
    (len(ys) == len(xs) - 1) and sampled-curve (trapezoid) inputs."""
    counts_per_bin = (ys if ys.shape[0] == xs.shape[0] - 1
                      else (ys[1:] + ys[:-1]) / 2.)
    return ys / np.sum(counts_per_bin * np.diff(xs))


def _merge_histograms(counts, bin_edges, weights=None):
    """(reference: :415)"""
    if weights is None:
        weights = np.ones(len(counts))
    else:
        weights = np.array(weights).reshape(-1)
    lens = [c.shape[0] for c in counts]
    n_pads = np.max(lens) - np.asarray(lens)
    padded = np.array([
        np.hstack([counts[n], np.zeros(n_pads[n])])
        for n in range(len(counts))])
    tot_counts = np.sum(padded * weights[:, None], axis=0)
    return tot_counts, bin_edges[int(np.argmax(lens))]


def pairwise_distance_distribution(coords1, coords2, bin_width=0.1,
                                   device=None):
    """Histogram of all cross distances, on ``device`` in float64
    (chunked as the reference chunks it). (reference: :354)"""
    dev = resolve_device(coords1, device)

    def cdist(a, b):
        return _cdist(*(torch.as_tensor(np.asarray(x, np.float64),
                                        device=dev) for x in (a, b)))
    max_dist_points = 5e7
    if coords1.shape[0] * coords2.shape[0] > max_dist_points:
        if coords1.shape[0] > coords2.shape[0]:
            max_coords, min_coords = coords1, coords2
        else:
            max_coords, min_coords = coords2, coords1
        counts, bin_edges = [], []
        for chunk in divide_chunks(max_coords, 2048):
            c, b = bincount_dists(cdist(min_coords, chunk), bin_width)
            counts.append(c)
            bin_edges.append(b)
        tot_counts, bin_edges = _merge_histograms(counts, bin_edges)
    else:
        tot_counts, bin_edges = bincount_dists(cdist(coords1, coords2),
                                               bin_width)
    return int_norm_hist(bin_edges, tot_counts), bin_edges


def _untouched_frames(clouds, xyz, clearance, device):
    """Masks (F, n) of the points of ``clouds`` (F, n, 3) farther than
    ``clearance`` (A,) from every protein atom of their frame of ``xyz``
    (F, A, 3) (strict ``>``), with scipy's ``cdist`` rounding, a batch of
    frames at a time on ``device``.

    Each (point, atom) pair is screened by one float64 product,
    ``|x - p|^2 - clearance^2`` from the coordinates less the frame's
    protein centroid; a point whose smallest screened value lies within
    the product's rounding bound of 0 (rare) is tested again with
    :func:`_cdist`."""
    F, n = clouds.shape[:2]
    A = xyz.shape[1]
    out = np.ones((F, n), dtype=bool)
    if F == 0 or n == 0 or A == 0:
        return out
    clear = torch.as_tensor(np.asarray(clearance, np.float64), device=device)
    thr2 = clear * clear
    batch = max(1, _CHUNK_ELEMS // (n * A))
    row_step = max(1, min(n, _CHUNK_ELEMS // A))
    eps = float(np.finfo(np.float64).eps)
    for lo in range(0, F, batch):
        X, P = (torch.as_tensor(np.asarray(x[lo:lo + batch], np.float64),
                                device=device) for x in (clouds, xyz))
        B = P.shape[0]
        o = P.mean(dim=1, keepdim=True)
        Ps, Xs = P - o, X - o
        Pa = torch.cat([-2 * Ps, torch.ones_like(Ps[..., :1]),
                        (Ps * Ps).sum(-1, keepdim=True) - thr2[:, None]], -1)
        Xa = torch.cat([Xs, (Xs * Xs).sum(-1, keepdim=True),
                        torch.ones_like(Xs[..., :1])], -1)
        reach = (torch.linalg.vector_norm(Xs, dim=-1).amax()
                 + torch.linalg.vector_norm(Ps, dim=-1).amax())
        # 256 eps of the largest term bounds the product's rounding and the
        # shift's, hundreds of times over
        margin = 256 * eps * (reach * reach + thr2.max())
        clash = torch.empty((B, n), dtype=torch.bool, device=device)
        for r0 in range(0, n, row_step):
            m = torch.bmm(Xa[:, r0:r0 + row_step],
                          Pa.transpose(1, 2)).amin(dim=-1)
            clash[:, r0:r0 + row_step] = m < -margin
            b, r = torch.nonzero(m.abs() <= margin, as_tuple=True)
            for k in range(0, len(b), _RETEST_ROWS):
                bb, rr = b[k:k + _RETEST_ROWS], r[k:k + _RETEST_ROWS] + r0
                d = _cdist(X[bb, rr][:, None], P[bb])[:, 0]
                clash[bb, rr] = ~(d > clear).all(dim=-1)
        out[lo:lo + B] = (~clash).cpu().numpy()
    return out


def _padded(clouds, width):
    """Ragged clouds as (len, width, 3) float64 zeros-padded, and masks."""
    pts = np.zeros((len(clouds), width, 3))
    mask = np.zeros((len(clouds), width), dtype=bool)
    for i, c in enumerate(clouds):
        pts[i, :len(c)] = c
        mask[i, :len(c)] = True
    return pts, mask


def _pair_histograms(pairs, bin_width, device):
    """``pairwise_distance_distribution`` of every (cloud, cloud) pair of
    ``pairs``: the pairs that it would cut into chunks go through it; the
    others a chunk of pairs a batch, zero-padded."""
    out = [None] * len(pairs)
    small = [i for i, (a, b) in enumerate(pairs) if len(a) * len(b) <= 5e7]
    for i in sorted(set(range(len(pairs))) - set(small)):
        out[i] = pairwise_distance_distribution(*pairs[i], bin_width,
                                                device=device)
    if not small:
        return out
    w1 = max(len(pairs[i][0]) for i in small)
    w2 = max(len(pairs[i][1]) for i in small)
    step = max(1, _CHUNK_ELEMS // max(w1 * w2, 1))
    for lo in range(0, len(small), step):
        idx = small[lo:lo + step]
        (p1, m1), (p2, m2) = (_padded([pairs[i][k] for i in idx], w)
                              for k, w in ((0, w1), (1, w2)))
        d = _cdist(*(torch.as_tensor(p, device=device) for p in (p1, p2)))
        valid = torch.as_tensor(m1[:, :, None] & m2[:, None, :],
                                device=device)
        hists = _histograms(d.reshape(len(idx), -1),
                            valid.reshape(len(idx), -1), bin_width)
        for i, (c, e) in zip(idx, hists):
            out[i] = (int_norm_hist(e, c), e)
    return out


def dye_distance_distribution(trj, dye1, dye2, resSeq_list,
                              cluster_grid_points=False, n_procs=1,
                              device=None):
    """Per-frame dye-pair distance distributions over a trajectory.
    (reference: :506)

    The clouds are placed on each frame on the host (``n_procs`` frames
    at a time); the pruning against the protein and the dye-dye
    histograms run a chunk of frames a batch on ``device`` (default: the
    card), in float64."""
    dev = resolve_device(trj.xyz, device)
    sites = (resSeq_list[0], resSeq_list[1])
    # the frames share one topology: find the site atoms once
    atoms = [_site_atoms(trj[0], site) for site in sites]

    def place(i):
        # every (dye, labeling site) combination gets its own cloud:
        # donor at both sites, then acceptor at both sites
        placements = [_rot_mat(trj.xyz[i], a) for a in atoms]
        return np.concatenate([
            align_dye_to_res(None, dye.xyz[0], site, placement=pl)
            for dye in (dye1, dye2) for site, pl in zip(sites, placements)])

    with ThreadPoolExecutor(max_workers=max(n_procs, 1)) as ex:
        clouds = np.stack(list(ex.map(place, range(len(trj)))))
    clearance = np.array([a.radius for a in trj.top.atoms]) + 0.2
    masks = _untouched_frames(clouds, trj.xyz, clearance, dev)
    cuts = np.cumsum([0] + [len(dye.xyz[0]) for dye in
                            (dye1, dye1, dye2, dye2)])
    kept = []
    for c, m in zip(clouds, masks):
        pts = [c[lo:hi][m[lo:hi]] for lo, hi in zip(cuts[:-1], cuts[1:])]
        if cluster_grid_points:
            pts = [cluster_grids(p, spacing=0.25, n_clouds=1) for p in pts]
        kept.append(pts)
    # the labeling is orientation-agnostic: average the two ways of
    # assigning the dye pair to the site pair (donor at the first site
    # with acceptor at the second, and the reverse)
    hists = _pair_histograms([(k[0], k[3]) for k in kept]
                             + [(k[1], k[2]) for k in kept], 0.1, dev)
    F = len(kept)
    outputs = [_merge_histograms([hists[i][0], hists[F + i][0]],
                                 [hists[i][1], hists[F + i][1]],
                                 weights=[0.5, 0.5]) for i in range(F)]
    probs = ra.RaggedArray([o[0] for o in outputs])
    bin_edges = ra.RaggedArray([o[1] for o in outputs])
    return probs, bin_edges


def sample_FE_probs(dist_distribution, states, R0, rng=None):
    """Draw a dye-dye distance per visited state and convert to FRET
    efficiency. (reference: :546)"""
    if rng is None:
        rng = np.random.default_rng()
    bin_width = (dist_distribution[0][1, 0]
                 - dist_distribution[0][0, 0])
    dists = np.empty(len(states))
    for i, state in enumerate(states):
        row = dist_distribution[state]
        dist = rng.choice(row[:, 0], p=row[:, 1])
        dists[i] = dist + rng.random() * bin_width - bin_width / 2.
    return FRET_efficiency(dists, R0)


def _sample_FRET_histograms(MSM_frames, T, populations,
                            dist_distribution, R0, n_photon_std,
                            rng=None):
    """One photon burst: MSM chain + per-photon acceptor/donor coin
    flips. (reference: :562)"""
    if rng is None:
        rng = np.random.default_rng()
    n_frames = int(np.amax(MSM_frames)) + 1

    initial_state = rng.choice(np.arange(T.shape[0]), p=populations)
    trj = synthetic_trajectory(T, initial_state, n_frames,
                               random_state=rng)

    FRET_probs = sample_FE_probs(dist_distribution, trj[MSM_frames],
                                 R0, rng=rng)
    acceptor_emissions = rng.random(FRET_probs.shape[0]) <= FRET_probs

    if n_photon_std is None:
        FRET_val = np.mean(acceptor_emissions)
        FRET_std = None
    else:
        chunks = [np.mean(s) for s in
                  divide_chunks(acceptor_emissions, n_photon_std)]
        FRET_std = np.std(chunks)
        FRET_val = np.mean(acceptor_emissions)

    return FRET_val, FRET_std, trj


def sample_FRET_histograms(T, populations, dist_distribution,
                           MSM_frames, R0, n_procs=1,
                           n_photon_std=None, random_state=None):
    """Sample an MSM to regenerate experimental FRET distributions.
    (reference: :607)

    Returns ``(FEs (n_bursts, 2), trajs)``.
    """
    if scipy.sparse.issparse(T):
        T = np.asarray(T.todense())
    seeds = np.random.SeedSequence(random_state).spawn(len(MSM_frames))

    def one(i):
        return _sample_FRET_histograms(
            MSM_frames[i], T=T, populations=populations,
            dist_distribution=dist_distribution, R0=R0,
            n_photon_std=n_photon_std,
            rng=np.random.default_rng(seeds[i]))

    with ThreadPoolExecutor(max_workers=max(n_procs, 1)) as ex:
        FE = list(ex.map(one, range(len(MSM_frames))))

    FE = np.array(FE, dtype=object)
    return FE[:, 0:2], FE[:, 2]


def convert_photon_times(inter_photon_times, lagtime, slowing_factor):
    """Inter-photon times (us) -> cumulative MSM steps.
    (reference: :669)"""
    steps_per_us = 1000 / (lagtime * slowing_factor)

    def to_steps(times):
        return np.cumsum(np.asarray(times) * steps_per_us, dtype=int)

    return np.array([to_steps(t) for t in inter_photon_times],
                    dtype=object)


def histogram_to_match_expt(pred_data, expt_data):
    """(reference: :703)"""
    bin_centers = expt_data[:, 0]
    bin_width = bin_centers[1] - bin_centers[0]
    lo = bin_centers[0] - bin_width / 2
    hi = bin_centers[-1] + bin_width / 2
    nbins = len(bin_centers)
    if np.ndim(pred_data) == 1:
        counts, _ = np.histogram(pred_data, range=[lo, hi], bins=nbins)
        return counts / counts.sum()
    probs = []
    for row in pred_data:
        counts, _ = np.histogram(row, range=[lo, hi], bins=nbins)
        probs.append(counts / counts.sum())
    return np.array(probs)


def Sum_sq_resid(expt_data, pred_data):
    """(reference: :722)"""
    return np.sum((pred_data - expt_data) ** 2, axis=1)


def normalize_array(array):
    """(reference: :726)"""
    if np.ndim(array) == 1:
        return (array - np.amin(array)) / (np.amax(array)
                                           - np.amin(array))
    return [(a - np.amin(a)) / (np.amax(a) - np.amin(a))
            for a in array]


def remake_data_from_hist(histo_data, rng=None):
    """(reference: :735)"""
    if rng is None:
        rng = np.random.default_rng()
    bin_centers = histo_data[:, 0]
    bin_width = bin_centers[1] - bin_centers[0]
    bin_counts = histo_data[:, 1].astype(int)
    rebuilt = [
        rng.uniform(low=bin_centers[i] - bin_width / 2,
                    high=bin_centers[i] + bin_width / 2,
                    size=int(c))
        for i, c in enumerate(bin_counts)]
    return np.concatenate(rebuilt)


def calc_4_moments(histo_data):
    """(reference: :758)"""
    axis = None if np.ndim(histo_data) == 1 else 1
    return np.vstack((np.mean(histo_data, axis=axis),
                      np.std(histo_data, axis=axis),
                      skew(histo_data, axis=axis),
                      kurtosis(histo_data, axis=axis, fisher=True)))


def calc_2_3_4_moments(histo_data):
    axis = None if np.ndim(histo_data) == 1 else 1
    return np.vstack((np.std(histo_data, axis=axis),
                      skew(histo_data, axis=axis),
                      kurtosis(histo_data, axis=axis, fisher=True)))
