#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (enspara_tpu_torch) on one GPU.

Run from the root of a checkout, with one CUDA card visible:

    python3 chip_smoke.py

It builds the k-centers kernel (csrc/kcenters_step.cu) from the
checkout, holds it against its plain PyTorch version on the card, then
drives the north-star pipeline once at full size through the port's
public functions: 1M frames x 64 atoms (random, seed 42) ->
prepare_rmsd_frames -> kcenters_device_fused to 1000 centers -> lag-10
counts -> transpose-builder top-21 eigenpairs, each checked (exact
counts against numpy, eigenvalues within 1e-4 of a float64 host solve).
Every time printed was taken on the card, warm, and stands beside the
card's name and power limit. Any failed check raises and the exit code
is not 0. Without a CUDA device it fails before printing a result.

Standard output ends with a JSON line per kernel, the nvidia-smi line,
and the result line {"ok": true, "device": {...}}.
"""

import json
import subprocess
import time

import numpy as np
import torch

from enspara_tpu_torch.cluster import engine
from enspara_tpu_torch.convert import result_to_numpy
from enspara_tpu_torch.msm import (assigns_to_counts_device,
                                   transpose_timescales_device)
from enspara_tpu_torch.ops import _build
from enspara_tpu_torch.ops.kcenters_step import (KCentersState,
                                                 kcenters_chunk,
                                                 kcenters_chunk_plain,
                                                 start_state)
from enspara_tpu_torch.ops.qcp import rmsd_from_S_components_unrolled
from enspara_tpu_torch.util.device import require_cuda

N_FRAMES, N_ATOMS, N_CLUSTERS, LAG, N_EIGS = 1_000_000, 64, 1000, 10, 21
CHECK_FRAMES, CHECK_CENTERS = 65_536, 128
TIMED_ITERS = 64
SOURCE = 'enspara_tpu_torch/csrc/kcenters_step.cu'
REPLACES = 'enspara_tpu/ops/kcenters_skip_pallas.py:274'


def check(ok, what):
    if not ok:
        raise RuntimeError('check failed: ' + what)


def card_line():
    out = subprocess.run(
        ['nvidia-smi', '-i', '0', '--query-gpu=name,power.limit',
         '--format=csv,noheader'],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()


def basin_data(rng, n, a, n_basins, noise=0.02, dwell=64):
    """Temporally ordered metastable-basin frames, the generator of
    tests/test_kcenters_skip.py."""
    templates = rng.normal(size=(n_basins, a, 3)).astype(np.float32)
    seg = np.cumsum(rng.random(n) < 1.0 / dwell)
    basin = rng.integers(0, n_basins, size=seg.max() + 1)[seg]
    return (templates[basin]
            + noise * rng.normal(size=(n, a, 3)).astype(np.float32))


def random_walk(device, seed=42):
    """1M frames around one structure with a per-frame scalar drift and
    noise, centered (the bench.py dataset), made on the card."""
    gen = torch.Generator(device=device).manual_seed(seed)
    base = torch.randn((N_ATOMS, 3), generator=gen, device=device)
    drift = torch.randn((N_FRAMES, 1, 1), generator=gen, device=device)
    frames = torch.randn((N_FRAMES, N_ATOMS, 3), generator=gen,
                         device=device).mul_(0.1)
    frames += base + 0.3 * drift * base
    return frames - frames.mean(dim=1, keepdim=True)


def fresh_state(prep):
    n_pad = prep.frames_r.shape[1]
    dev = prep.frames_r.device
    dist = torch.full((1, n_pad), float('inf'), device=dev)
    dist[0, prep.n:] = -float('inf')
    assig = torch.full((1, n_pad), -1, dtype=torch.int32, device=dev)
    return start_state(dist, assig, prep.frames_r.shape[0], prep.tile, 0,
                       1 << 30, 0.0)


def clone(state):
    return KCentersState(*(t.clone() for t in state))


def msd_bar(prep):
    """Elementwise bar on |a^2 - b^2| of two RMSDs of these frames:
    rtol 1e-5 on the msd plus 16 ulp of gsum / n_atoms (fp32 QCP takes
    the msd as gsum - 2*lambda_max, so its error scales with gsum)."""
    floor = 16 * np.finfo(np.float32).eps * 2 * float(prep.g.max()) \
        / prep.n_atoms
    return lambda d: 1e-5 * d * d + floor


def rmsd_close(a, b, bar):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    fin = np.isfinite(b)
    if not np.array_equal(a[~fin], b[~fin]):
        return False
    return bool((np.abs(a[fin] ** 2 - b[fin] ** 2) <= bar(b[fin])).all())


def pair_rmsd(prep, fa, fb):
    """RMSD of frame fa[k] to frame fb[k] by the plain QCP functions,
    read from the prepared layout (float64 host result)."""
    a_pad = prep.frames_r.shape[0] // 3

    def structs(idx):
        cols = prep.frames_r[:, torch.as_tensor(idx, device=prep.g.device)]
        return cols.view(3, a_pad, -1).permute(2, 1, 0)
    A, B = structs(fa), structs(fb)
    S = torch.einsum('fni,fnj->ijf', A, B)
    gsum = (A * A).sum((1, 2)) + (B * B).sum((1, 2))
    d = rmsd_from_S_components_unrolled(
        tuple(S[i, j] for i in range(3) for j in range(3)), gsum,
        float(prep.n_atoms))
    return d.cpu().numpy().astype(np.float64)


def compare_chunks(prep, start, kern, plain, n_iters, what):
    """Kernel against plain version over one chunk from ``start``:
    centers, skip counts and the next center exactly equal, distances
    within the msd bar, and assignments equal except for frames whose
    RMSDs to the two centers lie within the msd bar of each other (a
    near tie decided by rounding). Where a pick differs: a near tie of
    the two candidates in the plain run and an equal covering radius to
    1e-5. Returns a one-line verdict."""
    bar = msd_bar(prep)
    if np.array_equal(kern[2], plain[2]):
        for k, name in ((3, 'next center'), (6, 'skip counts')):
            check(np.array_equal(kern[k], plain[k]),
                  '%s: %s differ' % (what, name))
        for k, name in ((0, 'distances'), (4, 'next max'), (5, 'tmax')):
            check(rmsd_close(kern[k], plain[k], bar),
                  '%s: %s outside the msd bar' % (what, name))
        flips = np.flatnonzero(kern[1][0] != plain[1][0])
        if len(flips):
            ctr = kern[2][:, 0]
            ci = start.scalars()[2]
            dk = pair_rmsd(prep, flips, ctr[kern[1][0, flips] - ci])
            dp = pair_rmsd(prep, flips, ctr[plain[1][0, flips] - ci])
            check(bool((np.abs(dk ** 2 - dp ** 2)
                        <= bar(np.maximum(dk, dp))).all()),
                  '%s: assignments differ beyond near ties' % what)
        return ('%s: centers and skip counts equal; distances within the '
                'msd bar; assignments equal but for %d near-tie frames'
                % (what, len(flips)))
    i = int(np.flatnonzero(kern[2][:, 0] != plain[2][:, 0])[0])
    a, b = int(kern[2][i, 0]), int(plain[2][i, 0])
    st = clone(start)
    if i:
        kcenters_chunk_plain(prep, st, i)
    d = st.dist[0].cpu().numpy().astype(np.float64)
    check(abs(d[a] ** 2 - d[b] ** 2) <= bar(max(d[a], d[b])),
          '%s: pick %d differs (%d vs %d) without a near tie: %r vs %r'
          % (what, i, a, b, d[a], d[b]))
    rk, rp = float(kern[4][0, 0]), float(plain[4][0, 0])
    check(abs(rk - rp) <= 1e-5 * abs(rp),
          '%s: covering radius %r vs %r' % (what, rk, rp))
    return ('%s: near tie at pick %d (%d vs %d, %.9g vs %.9g) swapped the '
            'pick; covering radius equal to 1e-5 (%.9g vs %.9g)'
            % (what, i, a, b, d[a], d[b], rk, rp))


def run_chunk(fn, prep, state, n_iters, **kw):
    ctr, skc = fn(prep, state, n_iters, **kw)
    return result_to_numpy(state, ctr, skc)


def timed_chunk(fn, prep, start, n_iters):
    """Device time of one chunk of ``n_iters`` iterations from a copy of
    ``start``, in ms per iteration, and the chunk's outcome."""
    state = clone(start)
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    ctr, skc = fn(prep, state, n_iters)
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / n_iters, result_to_numpy(state, ctr, skc)


def host_eigs(counts):
    """float64 transpose builder + numpy eigh: the top eigenvalues and
    the equilibrium populations."""
    C = counts.astype(np.float64)
    sym = C + C.T
    mass = sym.sum(axis=1)
    pi = mass / mass.sum()
    sq = np.sqrt(pi)
    S = sq[:, None] * (sym / mass[:, None]) / sq[None, :]
    w = np.linalg.eigvalsh((S + S.T) * 0.5)[::-1][:N_EIGS]
    return w, pi


def pipeline(frames, device):
    """The north-star main path through the port's public functions,
    each stage timed to a synchronize."""
    torch.cuda.synchronize()
    tp = time.perf_counter()
    prep = engine.prepare_rmsd_frames(frames)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = engine.kcenters_device_fused(prep, n_clusters=N_CLUSTERS)
    t1 = time.perf_counter()
    assigns = res.assignments.reshape(100, -1)
    counts = assigns_to_counts_device(assigns, np.ones_like(assigns, bool),
                                      LAG, N_CLUSTERS, device=device)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    _, vals, vecs = transpose_timescales_device(counts, N_EIGS,
                                                lag_time=LAG)
    t3 = time.perf_counter()
    return prep, res, counts, vals, vecs, (t0 - tp, t1 - t0, t2 - t1,
                                           t3 - t2)


def main():
    card = card_line()
    print('card:', card, flush=True)
    device = require_cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    t = time.perf_counter()
    _build.load_library('kcenters_step')
    print('built %s in %.3f s (nvcc %s)'
          % (SOURCE, time.perf_counter() - t, ' '.join(_build.NVCC_FLAGS)),
          flush=True)

    # -- 1. kernel against plain version on basin data ---------------------
    X = basin_data(np.random.default_rng(0), CHECK_FRAMES, N_ATOMS,
                   n_basins=256)
    prep = engine.prepare_rmsd_frames(X, device=device)
    start = fresh_state(prep)
    n0 = kcenters_chunk.n_launches
    on = run_chunk(kcenters_chunk, prep, clone(start), CHECK_CENTERS)
    off = run_chunk(kcenters_chunk, prep, clone(start), CHECK_CENTERS,
                    skip=False)
    plain = run_chunk(kcenters_chunk_plain, prep, clone(start),
                      CHECK_CENTERS)
    torch.cuda.synchronize()
    check(kcenters_chunk.n_launches == n0 + 2 * (1 + CHECK_CENTERS),
          'launch count did not grow by the launches made')
    check(all(np.array_equal(x, y) for x, y in zip(on, off)),
          'skip on and skip off differ')
    skipped = int(on[6][on[6] > 0].sum())
    check(skipped > 0, 'no tile was skipped on basin data')
    check(int((on[2] >= 0).sum()) == CHECK_CENTERS, 'centers not placed')
    print(compare_chunks(prep, start, on, plain, CHECK_CENTERS,
                         '%d x %d x %d kernel vs plain'
                         % (CHECK_FRAMES, N_ATOMS, CHECK_CENTERS)))
    print('skip on/off bit-identical over %d iterations; %d of %d tile '
          'visits skipped' % (CHECK_CENTERS, skipped,
                              CHECK_CENTERS * (prep.frames_r.shape[1]
                                               // prep.tile)), flush=True)
    del X, prep, start, on, off, plain

    # -- 2. main path at full size ----------------------------------------
    frames = random_walk(device)
    pipeline(frames, device)                      # warm-up
    kcenters_chunk.n_launches = 0
    prep, res, counts, vals, vecs, (t_prep, t_cl, t_co, t_eig) = \
        pipeline(frames, device)
    launches = kcenters_chunk.n_launches
    check(res.n_found == N_CLUSTERS, 'n_found %d' % res.n_found)
    check(int(res.assignments.max()) == N_CLUSTERS - 1,
          'assignments.max() %d' % res.assignments.max())
    check(launches >= N_CLUSTERS, 'only %d kernel launches' % launches)
    check(np.isfinite(res.distances).all(), 'non-finite distances')
    a = res.assignments.reshape(100, -1)
    ref_counts = np.bincount(
        (a[:, :-LAG] * N_CLUSTERS + a[:, LAG:]).ravel(),
        minlength=N_CLUSTERS ** 2).reshape(N_CLUSTERS, N_CLUSTERS)
    counts_h = counts.cpu().numpy()
    check(np.array_equal(counts_h, ref_counts), 'counts differ from numpy')
    w_ref, pi_ref = host_eigs(counts_h)
    eig_err = float(np.abs(vals - w_ref).max())
    pi_err = float(np.abs(vecs[:, 0] - pi_ref).max())
    check(vals.shape == (N_EIGS,) and eig_err < 1e-4,
          'eigenvalues differ by %g' % eig_err)
    check(pi_err < 1e-5, 'equilibrium populations differ by %g' % pi_err)
    print('main path: %d frames x %d atoms -> %d centers (%d kernel '
          'launches), max distance %.6f; lag-%d counts equal numpy; top-%d '
          'eigenvalues within %.2e of float64 numpy, pi within %.2e'
          % (N_FRAMES, N_ATOMS, res.n_found, launches,
             res.distances.max(), LAG, N_EIGS, eig_err, pi_err))
    print('[%s] prepare %.4f s; cluster %.4f s (%.4g pairs/s), counts '
          '%.4f s, eigsolve %.4f s, north-star %.4f s (cluster + counts + '
          'eigsolve)' % (card, t_prep, t_cl, N_FRAMES * N_CLUSTERS / t_cl,
                         t_co, t_eig, t_cl + t_co + t_eig), flush=True)

    # -- 3. the kernel and its plain version at the main path's shapes -----
    start = fresh_state(prep)
    one_k = run_chunk(kcenters_chunk, prep, clone(start), 1)
    one_p = run_chunk(kcenters_chunk_plain, prep, clone(start), 1)
    fin = np.isfinite(one_p[0])
    max_abs_err = float(np.abs(one_k[0][fin] - one_p[0][fin]).max())
    check(rmsd_close(one_k[0], one_p[0], msd_bar(prep)),
          'one iteration at full size: distances outside the msd bar')
    times = {'kernel': [], 'plain': []}
    outs = {}
    for name in ('plain', 'kernel', 'kernel', 'plain'):
        fn = kcenters_chunk if name == 'kernel' else kcenters_chunk_plain
        ms, outs[name] = timed_chunk(fn, prep, start, TIMED_ITERS)
        times[name].append(ms)
    print(compare_chunks(prep, start, outs['kernel'], outs['plain'],
                         TIMED_ITERS, '%d x %d x %d kernel vs plain'
                         % (N_FRAMES, N_ATOMS, TIMED_ITERS)))
    ms, plain_ms = min(times['kernel']), min(times['plain'])
    print('[%s] per iteration at %d x %d: kernel %.4f ms, plain %.4f ms '
          '(turns plain, kernel, kernel, plain: %s); one-iteration '
          'max |kernel - plain| %.3g'
          % (card, N_FRAMES, N_ATOMS, ms, plain_ms,
             ', '.join('%.4f' % t for t in times['plain'][:1]
                       + times['kernel'] + times['plain'][1:]),
             max_abs_err), flush=True)

    print(json.dumps({'kernels': [{
        'name': 'kcenters_step', 'route': 'cuda', 'source': SOURCE,
        'replaces': REPLACES, 'launches': launches,
        'max_abs_err': max_abs_err, 'ms': ms, 'plain_ms': plain_ms}]}))
    print(card)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    main()
