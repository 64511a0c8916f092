"""LIGSITE-style pocket detection, host numpy (counterpart of
``enspara_tpu/geometry/pockets.py``; reference:
enspara/geometry/pockets.py).

A grid is laid over the structure; cells overlapping protein are
discarded; each remaining cell is ranked by how many of 7 scan
directions (3 cartesian + 4 cube diagonals) pass through protein on
both sides of it; high-rank cells are clustered into contiguous
pockets.

The reference ranks cells with per-line Python loops
(pockets.py:156-216); here each scan is a vectorized
forward/backward cumulative-or over the (possibly sheared) grid, and
frames fan out over a thread pool.
"""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import scipy.cluster.hierarchy

from ..citation import cite
from ..util.parallel import auto_nprocs

__all__ = ['get_pockets', 'get_pocket_cells', 'cluster_pocket_cells',
           'create_grid', 'xyz_to_traj', 'determine_touches_protein']


def _grid_to_xyz(grid):
    return grid.reshape((-1, 3))


def xyz_to_traj(xyz, cluster_ids=None):
    """Pocket cells as a 1-frame Trajectory of carbons; cells of one
    pocket share a POK residue. (reference: pockets.py:29)"""
    from ..io import Topology, Trajectory

    if xyz.size == 0:
        return None

    if cluster_ids is None:
        order = np.arange(xyz.shape[0])
        labels = np.zeros(xyz.shape[0], dtype=int)
    else:
        order = np.argsort(cluster_ids)
        labels = np.asarray(cluster_ids)[order]

    top = Topology()
    chain = top.add_chain()
    res, last = None, None
    for lab in labels:
        if res is None or lab != last:
            res = top.add_residue('POK', chain, int(lab))
            last = lab
        top.add_atom('C', 'C', res)

    coords = np.asarray(xyz)[order][None].astype(np.float32)
    return Trajectory(coords, top)


# backwards-compatible alias with the reference's name
xyz_to_mdtraj = xyz_to_traj


def create_grid(struct, grid_spacing, padding=0):
    """Cubic grid of cell coordinates spanning the first frame.
    (reference: pockets.py:83)"""
    xyz = struct.xyz[0]
    mins = xyz.min(axis=0)
    maxs = xyz.max(axis=0)
    n_cells = (np.ceil((maxs - mins) / grid_spacing).astype(int)
               + padding * 2)
    axes = [mins[d] - grid_spacing * padding
            + np.arange(n_cells[d]) * grid_spacing for d in range(3)]
    x, y, z = np.meshgrid(*axes, indexing='ij')
    return np.stack([x, y, z], axis=-1).astype(np.float32)


def determine_touches_protein(struct, grid, probe_radius):
    """Boolean grid: cell center within (probe + vdw radius) of any
    atom. (reference: pockets.py:219)"""
    n_x, n_y, n_z = grid.shape[:3]
    mins = grid[0, 0, 0]
    spacing = (grid[-1, -1, -1][0] - mins[0]) / max(n_x - 1, 1)

    touches = np.zeros((n_x, n_y, n_z), dtype=bool)
    radii = np.array([a.radius for a in struct.top.atoms])
    xyz = struct.xyz[0]
    for i in range(struct.top.n_atoms):
        coord = xyz[i]
        cutoff = probe_radius + radii[i]
        cell = ((coord - mins) / spacing).astype(int)
        ncut = int(np.ceil(cutoff / spacing))
        lo = np.maximum(cell - ncut, 0)
        hi = np.minimum(cell + ncut, [n_x - 1, n_y - 1, n_z - 1])
        sub = grid[lo[0]:hi[0] + 1, lo[1]:hi[1] + 1, lo[2]:hi[2] + 1]
        off = sub - coord
        d2 = np.einsum('ijkl,ijkl->ijk', off, off)
        hit = d2 < cutoff ** 2
        touches[lo[0]:hi[0] + 1, lo[1]:hi[1] + 1,
                lo[2]:hi[2] + 1] |= hit
    return touches


def _enclosed_along_axis0(touches):
    """Cells with protein strictly before AND after along axis 0, not
    themselves touching protein (the vectorized form of the
    reference's per-line scan, pockets.py:156)."""
    fwd = np.zeros_like(touches)
    fwd[1:] = np.logical_or.accumulate(touches, axis=0)[:-1]
    bwd = np.zeros_like(touches)
    bwd[:-1] = np.logical_or.accumulate(
        touches[::-1], axis=0)[::-1][1:]
    return fwd & bwd & ~touches


def _check_cartesian_axis(touches, rank):
    rank += _enclosed_along_axis0(touches)


def _check_diagonal_axis_helper(touches, rank):
    """Scan along the (+1,+1,+1) diagonal for lines starting on the
    z=0 face from (i<nx-1, j<ny-1) — the reference's enumeration
    (pockets.py:176-201) — via a sheared view."""
    n_x, n_y, n_z = touches.shape
    I, J, T = np.meshgrid(np.arange(n_x), np.arange(n_y),
                          np.arange(n_z), indexing='ij')
    Xi = I + T
    Yj = J + T
    valid = (Xi < n_x) & (Yj < n_y)
    # lines starting at i = n_x-1 or j = n_y-1 are not scanned
    valid &= (I < n_x - 1) & (J < n_y - 1)
    sheared = np.zeros_like(touches)
    sheared[valid] = touches[Xi[valid], Yj[valid], T[valid]]
    # protein flags outside the line are False; enclosed test along T
    mask = _enclosed_along_axis0(np.moveaxis(sheared, 2, 0))
    mask = np.moveaxis(mask, 0, 2) & valid
    np.add.at(rank, (Xi[mask], Yj[mask], T[mask]), 1)


def _check_diagonal_axis(touches, rank):
    """(reference: pockets.py:203)"""
    views = (lambda a: a,
             lambda a: a.swapaxes(1, 2)[1:, 1:, :],
             lambda a: a.swapaxes(0, 2)[1:, 1:, :])
    for view in views:
        _check_diagonal_axis_helper(view(touches), view(rank))


@cite('pockets')
def get_pocket_cells(struct, grid_spacing=0.1, probe_radius=0.07,
                     min_rank=3):
    """Coordinates of grid cells ranked >= min_rank by the 7-direction
    scan. (reference: pockets.py:257)"""
    grid = create_grid(struct, grid_spacing)
    touches = determine_touches_protein(struct, grid, probe_radius)

    rank = np.zeros(touches.shape, dtype=np.int64)
    _check_cartesian_axis(touches, rank)
    _check_cartesian_axis(touches.swapaxes(0, 1), rank.swapaxes(0, 1))
    _check_cartesian_axis(touches.swapaxes(0, 2), rank.swapaxes(0, 2))

    _check_diagonal_axis(touches, rank)
    _check_diagonal_axis(touches[::-1, :, :], rank[::-1, :, :])
    _check_diagonal_axis(touches[::-1, ::-1, :], rank[::-1, ::-1, :])
    _check_diagonal_axis(touches[:, ::-1, :], rank[:, ::-1, :])

    return grid[rank >= min_rank]


def cluster_pocket_cells(pocket_cells, grid_spacing=0.1,
                         min_cluster_size=0):
    """Merge contiguous pocket cells (hierarchical, 1.5*spacing
    cutoff); pockets ordered largest first. (reference:
    pockets.py:328)"""
    if pocket_cells.size == 0:
        return np.array([]), np.array([])

    if len(pocket_cells) == 1:
        mapping = np.array([0])
    else:
        mapping = scipy.cluster.hierarchy.fclusterdata(
            pocket_cells, t=grid_spacing * 1.5, criterion='distance')
    if mapping.min() > 0:
        mapping = mapping - mapping.min()

    n_clusters = mapping.max() + 1
    sizes = np.bincount(mapping, minlength=n_clusters)
    order = np.argsort(-sizes)

    sorted_cells = []
    sorted_mapping = []
    for new_id, cid in enumerate(order):
        if sizes[cid] <= min_cluster_size:
            break
        for j in np.where(mapping == cid)[0]:
            sorted_mapping.append(new_id)
            sorted_cells.append(pocket_cells[j])

    return (np.array(sorted_cells),
            np.array(sorted_mapping, dtype=int))


def _frame_pockets(struct, grid_spacing, probe_radius, min_rank,
                   min_cluster_size):
    """Full pocket pipeline for one frame: rank cells, group them into
    pockets, emit the carbon pseudo-trajectory."""
    ranked = get_pocket_cells(struct, grid_spacing=grid_spacing,
                              probe_radius=probe_radius,
                              min_rank=min_rank)
    return xyz_to_traj(*cluster_pocket_cells(
        ranked, grid_spacing=grid_spacing,
        min_cluster_size=min_cluster_size))


# legacy name used by external callers of the reference
_get_pockets_helper = _frame_pockets


@cite('pockets')
def get_pockets(traj, grid_spacing=0.1, probe_radius=0.14, min_rank=5,
                min_cluster_size=0, n_procs=None):
    """Pockets per frame, each a 1-frame carbon Trajectory (largest
    pocket = residue 0). (reference: pockets.py:410)"""
    import functools
    per_frame = functools.partial(
        _frame_pockets, grid_spacing=grid_spacing,
        probe_radius=probe_radius, min_rank=min_rank,
        min_cluster_size=min_cluster_size)
    workers = auto_nprocs() if n_procs is None else n_procs
    with ThreadPoolExecutor(max_workers=workers) as pool:
        return list(pool.map(per_frame,
                             (traj[i] for i in range(len(traj)))))
