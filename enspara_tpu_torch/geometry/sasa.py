"""Shrake-Rupley solvent-accessible surface area (counterpart of
``enspara_tpu/geometry/sasa.py``; reference: mdtraj's ``shrake_rupley``,
reached from enspara/info_theory/exposons.py:76).

Each atom carries a golden-spiral shell of points at radius
``r_vdw + probe``; a point is accessible when no other atom's inflated
sphere covers it. Every (frame, atom, point, other atom) test runs in
torch ops on the device of the input or of ``device=``. Only atoms with
``|x_i - x_j| < (r_i + p) + (r_j + p)`` can cover a point of atom i's
shell, so by default each atom is tested against its K nearest such
candidates (the neighbor-list path), with K sized from the exact maximum
count: the answer is that of the dense all-pairs path, not an
approximation.

The squared distances are the difference form ``sum (shell - x_j)^2``,
summed over x, y and z in that order, as the JAX package computes them:
the expanded form ``R^2 + |x_i - x_j|^2 + 2 R u.(x_i - x_j)`` is one
matrix product but rounds differently, and would flip shell points that
lie near a cover boundary. The tests of a chunk of frames x one atom
block are at most ``_CHUNK_ELEMS`` elements (the JAX package maps over
frames and blocks one at a time).
"""

import numpy as np
import torch

from ..citation import cite
from ..parallel.mesh import host_fetch, shard_frames
from ..util.device import resolve_device

__all__ = ['shrake_rupley', 'sphere_points', 'shrake_rupley_np']

# elements of the largest (frames, atoms, points, neighbors) test tensor
_CHUNK_ELEMS = 1 << 28


def sphere_points(n):
    """n points ~uniform on the unit sphere (golden spiral, the classic
    Shrake-Rupley construction), float32."""
    inc = np.pi * (3 - np.sqrt(5))
    offset = 2.0 / n
    k = np.arange(n)
    y = k * offset - 1 + offset / 2
    r = np.sqrt(np.maximum(1 - y * y, 0))
    phi = k * inc
    return np.stack([np.cos(phi) * r, y, np.sin(phi) * r],
                    axis=1).astype(np.float32)


def _radii_from_top(top):
    return np.array([a.radius for a in top.atoms], dtype=np.float32)


@cite('shrake-rupley')
def shrake_rupley(traj, probe_radius=0.14, n_sphere_points=960,
                  mode='atom', atom_block=64, mesh=None,
                  n_neighbors='auto', device=None):
    """Per-atom (or per-residue) SASA in nm^2 for every frame.

    Parameters
    ----------
    traj : Trajectory (with topology for radii) or tuple
        ``(xyz (F, A, 3), radii (A,))``; ``xyz`` may be a tensor.
    probe_radius : float, nm (0.14 = water; exposons use 0.28).
    n_sphere_points : test points per atom (quality/cost knob).
    mode : 'atom' or 'residue'.
    atom_block : atoms a chunk of the test tensor.
    mesh : optional :class:`~enspara_tpu_torch.parallel.FrameMesh`; its
        shards take contiguous blocks of frames (no collectives but the
        neighbor count's max).
    n_neighbors : 'auto', int, or None. 'auto' counts the exact maximum
        number of candidate occluders of any atom in any frame and sizes
        K to cover it, so the result equals the dense path's; an int sets
        K (each atom keeps its K nearest candidates); None forces the
        dense all-pairs path. K is rounded up to a multiple of 8, and a K
        above 3/4 of the atoms takes the dense path.
    device : where to run (default: the device of a tensor ``xyz``, else
        the card); not with ``mesh``.

    Returns
    -------
    (n_frames, n_atoms) or (n_frames, n_residues) float32 numpy array.
    """
    if isinstance(traj, tuple):
        xyz, radii = traj
        top = None
    else:
        xyz = traj.xyz
        top = traj.top
        radii = _radii_from_top(top)
    if mesh is not None and device is not None:
        raise ValueError('pass device= or mesh=, not both')

    if isinstance(xyz, torch.Tensor):
        xyz = xyz.to(torch.float32)
    else:
        xyz = np.asarray(xyz, dtype=np.float32)
    # the inflated radii in float32 numpy, as the JAX package forms them
    rad = np.asarray(radii, dtype=np.float32) + probe_radius
    out = _sasa(xyz, rad, int(n_sphere_points), int(atom_block), mesh,
                n_neighbors, device)

    if mode == 'residue':
        if top is None:
            raise ValueError("mode='residue' requires a topology")
        res_out = np.zeros((out.shape[0], top.n_residues),
                           dtype=np.float32)
        for r in top.residues:
            idx = [a.index for a in r.atoms]
            res_out[:, r.index] = out[:, idx].sum(axis=1)
        return res_out
    return out


def _sum_sq_diff(a, b):
    """``((a0 - b0)^2 + (a1 - b1)^2) + (a2 - b2)^2`` over the broadcast of
    ``a`` and ``b`` (..., 3): one coordinate at a time, in place, so the
    largest temporaries are two of the broadcast's size."""
    out = torch.sub(a[..., 0], b[..., 0])
    out.mul_(out)
    for c in (1, 2):
        t = torch.sub(a[..., c], b[..., c])
        out.add_(t.mul_(t))
    return out


def _block_candidates(coords, rad, lo, hi):
    """For the atoms ``lo:hi`` of every frame of ``coords`` (nf, A, 3):
    their squared distances to every atom (nf, b, A), and which atoms can
    occlude their shells (``d2 < (r_i + r_j)^2``, not the atom itself)."""
    n_atoms = coords.shape[1]
    d2 = _sum_sq_diff(coords[:, lo:hi, None, :], coords[:, None, :, :])
    thresh = (rad[lo:hi, None] + rad[None, :]) ** 2
    own = (torch.arange(n_atoms, device=coords.device)[None, :]
           == torch.arange(lo, hi, device=coords.device)[:, None])
    return d2, (d2 < thresh) & ~own


def _frames_a_chunk(per_frame):
    return max(1, _CHUNK_ELEMS // max(per_frame, 1))


def _max_neighbor_count(coords, rad, atom_block):
    """The exact max over frames and atoms of the candidate occluders of
    one atom, as a 0-d int64 tensor on the device of ``coords``."""
    n_frames, n_atoms = coords.shape[:2]
    best = torch.zeros((), dtype=torch.int64, device=coords.device)
    for lo in range(0, n_atoms, atom_block):
        hi = min(lo + atom_block, n_atoms)
        step = _frames_a_chunk((hi - lo) * n_atoms)
        for f in range(0, n_frames, step):
            _, rel = _block_candidates(coords[f:f + step], rad, lo, hi)
            best = torch.maximum(best, rel.sum(-1).max())
    return best


def _sasa_shard(coords, rad, pts, atom_block, k):
    """SASA (nf, A) float32 of the frames ``coords`` (nf, A, 3) on their
    device: against each atom's ``k`` nearest candidates, or every atom
    when ``k`` is None."""
    n_frames, n_atoms = coords.shape[:2]
    n_points = pts.shape[0]
    out = torch.empty((n_frames, n_atoms), dtype=torch.float32,
                      device=coords.device)
    width = n_atoms if k is None else k
    rad2 = rad * rad
    for lo in range(0, n_atoms, atom_block):
        hi = min(lo + atom_block, n_atoms)
        rads = rad[lo:hi]
        step = _frames_a_chunk((hi - lo) * n_points * width)
        for f in range(0, n_frames, step):
            xyz = coords[f:f + step]
            nf = xyz.shape[0]
            if k is None:
                # every other atom; the atom itself gets radius 0, and
                # d2 >= 0 is never < 0
                ncoords = xyz[:, None, None, :, :]
                own = (torch.arange(n_atoms, device=xyz.device)[None, :]
                       == torch.arange(lo, hi, device=xyz.device)[:, None])
                nrad2 = torch.where(own, 0.0, rad2[None, :])[None, :, None]
            else:
                d2, rel = _block_candidates(xyz, rad, lo, hi)
                score = torch.where(rel, -d2, -torch.inf)
                vals, idx = torch.topk(score, k, dim=-1, sorted=False)
                ncoords = torch.gather(
                    xyz, 1, idx.reshape(nf, -1, 1).expand(-1, -1, 3)
                ).reshape(nf, hi - lo, 1, k, 3)
                # slots beyond the atom's candidates get radius 0
                nrad = torch.where(torch.isfinite(vals), rad[idx], 0.0)
                nrad2 = (nrad * nrad)[:, :, None, :]
            shell = (xyz[:, lo:hi, None, :]
                     + rads[None, :, None, None] * pts[None, None])
            occluded = (_sum_sq_diff(shell[:, :, :, None, :], ncoords)
                        < nrad2).any(-1)
            frac = 1.0 - occluded.sum(-1, dtype=torch.float32) / n_points
            out[f:f + step, lo:hi] = frac * 4.0 * np.pi * rads * rads
    return out


def _pick_n_neighbors(need, n_atoms):
    """K for the neighbor-list path, or None for the dense one."""
    k = max(8, -(-need // 8) * 8)   # round up to a multiple of 8
    if k >= n_atoms or k > 0.75 * n_atoms:
        return None
    return k


def _sasa(xyz, rad, n_points, atom_block, mesh, n_neighbors, device):
    if mesh is None:
        dev = resolve_device(xyz, device)
        shards = [torch.as_tensor(xyz, dtype=torch.float32, device=dev)]
        real = [shards[0].shape[0]]
    else:
        shards, n = shard_frames(xyz, mesh)
        shards = [s.to(torch.float32) for s in shards]
        # frames of each shard before the padding (the count skips it)
        n_local = shards[0].shape[0]
        real = [min(max(n - (mesh.first_shard + s) * n_local, 0), n_local)
                for s in range(len(shards))]
    n_atoms = shards[0].shape[1]
    atom_block = min(atom_block, n_atoms)
    rads = [torch.as_tensor(rad, device=s.device) for s in shards]
    pts = torch.as_tensor(sphere_points(n_points))

    k = None
    if n_neighbors == 'auto':
        need = torch.stack([
            _max_neighbor_count(s[:m], r, atom_block).to(shards[0].device)
            for s, r, m in zip(shards, rads, real)]).max()
        if mesh is not None:
            need = mesh.all_reduce(need, 'max')
        k = _pick_n_neighbors(int(need), n_atoms)
    elif n_neighbors is not None:
        k = _pick_n_neighbors(int(n_neighbors), n_atoms)

    outs = [_sasa_shard(s, r, pts.to(s.device), atom_block, k)
            for s, r in zip(shards, rads)]
    if mesh is None:
        return outs[0].cpu().numpy()
    return host_fetch(outs, mesh)[:n]


def shrake_rupley_np(xyz, radii, probe_radius=0.14, n_sphere_points=960):
    """Host float64 oracle for tests."""
    xyz = np.asarray(xyz, np.float64)
    radii = np.asarray(radii, np.float64) + probe_radius
    pts = sphere_points(n_sphere_points).astype(np.float64)
    F, A = xyz.shape[:2]
    out = np.zeros((F, A), dtype=np.float64)
    for f in range(F):
        for a in range(A):
            shell = xyz[f, a] + radii[a] * pts
            d2 = ((shell[:, None, :] - xyz[f][None, :, :]) ** 2).sum(-1)
            cover = d2 < radii[None, :] ** 2
            cover[:, a] = False
            acc = ~cover.any(axis=1)
            out[f, a] = acc.mean() * 4 * np.pi * radii[a] ** 2
    return out
