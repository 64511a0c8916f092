"""Metastable-basin frames made on the device from the seed.

A stand-in for a protein's landscape at its published frame and atom
counts: ``n_basins`` random template structures (unit normal
coordinates), a basin sequence that switches with probability
``1 / dwell`` a frame to a uniformly drawn basin, and each frame its
basin's template plus ``noise`` times unit normal noise. The frames are
one long sequence, cut into trajectories of ``traj_frames`` (the last
shorter). The same seed and device give the same frames.
"""

import torch

CHUNK = 1 << 20


def generator(seed, device):
    return torch.Generator(device=device).manual_seed(int(seed))


def frames(seed, n, n_atoms, n_basins, dwell, noise, device, out=None):
    """``(n, n_atoms, 3)`` float32 frames on ``device`` (or written into
    ``out``, a tensor of that shape anywhere, a chunk at a time)."""
    gen = generator(seed, device)
    templates = torch.randn((n_basins, n_atoms, 3), generator=gen,
                            device=device)
    switch = torch.rand(n, generator=gen, device=device) < 1.0 / dwell
    seg = torch.cumsum(switch.to(torch.int64), 0)
    basin = torch.randint(0, n_basins, (n + 1,), generator=gen,
                          device=device)[seg]
    if out is None:
        out = torch.empty((n, n_atoms, 3), device=device)
    for lo in range(0, n, CHUNK):
        hi = min(n, lo + CHUNK)
        part = torch.randn((hi - lo, n_atoms, 3), generator=gen,
                           device=device).mul_(noise)
        part += templates[basin[lo:hi]]
        out[lo:hi].copy_(part)
    return out


def lengths(n, traj_frames):
    """Trajectory lengths: ``traj_frames`` each, the last shorter."""
    full, rest = divmod(n, traj_frames)
    return [traj_frames] * full + ([rest] if rest else [])


def subsample(lens, step):
    """Global indices of every ``step``-th frame of each trajectory."""
    out, lo = [], 0
    for n in lens:
        out.append(torch.arange(lo, lo + n, step))
        lo += n
    return torch.cat(out)
