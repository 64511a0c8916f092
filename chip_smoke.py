#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (enspara_tpu_torch) on one GPU.

Run from the root of a checkout, with one CUDA card visible:

    python3 chip_smoke.py

It builds both kernels (csrc/kcenters_step.cu and csrc/qcp_matrix.cu,
one nvcc each, in parallel) from the checkout and drives two paths:

1-3. the k-centers kernel against its plain PyTorch version on the
     card, and the north-star pipeline at full size through the port's
     public functions: 1M frames x 64 atoms (random, seed 42) ->
     prepare_rmsd_frames -> kcenters_device_fused to 1000 centers ->
     lag-10 counts -> transpose-builder top-21 eigenpairs, each checked
     (exact counts against numpy, eigenvalues within 1e-4 of a float64
     host solve);
4.   the all-pairs QCP kernel against its plain version at the shapes
     its path gives it (a 1M x 256-center assignment block, a 131,072 x
     64 PAM proposal block, a 1,000 x 37 x 61-atom padding shape);
5.   the cluster -> reassign workflow through the port's apps: 100 XTC
     trajectories x 10,000 frames of 64 CA atoms (metastable-basin
     data, seed 1) clustered with --algorithm khybrid --cluster-number
     1000 --subsample 10 --random-state 0 (k-centers, then 5 PAM sweeps
     on the QCP kernel), then every one of the 1M frames reassigned to the centers
     (the reassign app, on the QCP kernel). The two .h5 writes of the
     apps (enspara_tpu.ra.save) are left out: they need h5py.

Every time printed was taken on the card, warm where it says so, and
stands beside the card's name and power limit. Any failed check raises
and the exit code is not 0. Without a CUDA device it fails before
printing a result.

Standard output ends with a JSON line per kernel, the nvidia-smi line,
and the result line {"ok": true, "device": {...}}.
"""

import importlib
import json
import os
import subprocess
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from enspara_tpu.io import Topology, Trajectory, write_pdb, write_xtc

from enspara_tpu_torch.apps import cluster as cluster_app
from enspara_tpu_torch.apps import reassign as reassign_app
from enspara_tpu_torch.cluster import engine, engine_kmedoids
from enspara_tpu_torch.cluster import util as cluster_util
from enspara_tpu_torch.convert import result_to_numpy
from enspara_tpu_torch.msm import (assigns_to_counts_device,
                                   transpose_timescales_device)
from enspara_tpu_torch.ops import _build
from enspara_tpu_torch.ops.kcenters_step import (KCentersState,
                                                 kcenters_chunk,
                                                 kcenters_chunk_plain,
                                                 start_state)
from enspara_tpu_torch.ops import qcp_matrix
from enspara_tpu_torch.ops.qcp import rmsd_from_S_components_unrolled
from enspara_tpu_torch.util.device import require_cuda

N_FRAMES, N_ATOMS, N_CLUSTERS, LAG, N_EIGS = 1_000_000, 64, 1000, 10, 21
CHECK_FRAMES, CHECK_CENTERS = 65_536, 128
TIMED_ITERS = 64
SOURCE = 'enspara_tpu_torch/csrc/kcenters_step.cu'
REPLACES = 'enspara_tpu/ops/kcenters_skip_pallas.py:274'
# the module, which the package's hybrid() function shadows as an attribute
hybrid_mod = importlib.import_module('enspara_tpu_torch.cluster.hybrid')
QCP_SOURCE = 'enspara_tpu_torch/csrc/qcp_matrix.cu'
QCP_REPLACES = 'enspara_tpu/ops/qcp_pallas.py:111'
# phase 4 shapes (frames, centers, atoms): an assignment block, a PAM
# proposal block, a padding shape
QCP_SHAPES = ((1_048_576, 256, 64), (131_072, 64, 64), (1000, 37, 61))
# phase 5: trajectories x frames each, atoms, centers, subsample
N_TRJ, TRJ_FRAMES, CLUSTER_K, SUBSAMPLE = 100, 10_000, 1000, 10


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


def bar_from(gsum_max, n_atoms):
    """The msd bar of msd_bar, from a bound on gsum and the atom
    count."""
    floor = 16 * np.finfo(np.float32).eps * gsum_max / n_atoms
    return lambda d: 1e-5 * d * d + floor


def events_ms(fn):
    """Device time of one call of ``fn`` in ms (CUDA events)."""
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0.record()
    out = fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1), out


def qcp_shape(device, F, C, A, seed):
    """Kernel 5 against its plain version at one (F, C, A) shape, on
    random centered frames and centers near some of them: every entry
    within the msd bar, argmins equal but for near ties, the launch
    counter grown by the launches made; then timed in turns plain,
    kernel, kernel, plain. Returns ``(max |kernel - plain|, kernel ms,
    plain ms, line)``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    X = torch.randn((F, A, 3), generator=gen, device=device)
    Y = X[torch.randint(0, F, (C,), generator=gen, device=device)] \
        + 0.01 * torch.randn((C, A, 3), generator=gen, device=device)
    X = X - X.mean(dim=1, keepdim=True)
    Y = Y - Y.mean(dim=1, keepdim=True)
    a_pad = -(-A // 8) * 8
    fr, gf = qcp_matrix.to_layout(X, qcp_matrix.pad_frames(F), a_pad)
    cr, gc = qcp_matrix.to_layout(Y, qcp_matrix.pad_centers(C), a_pad)
    del X, Y
    args = (fr, gf, cr, gc, A)
    n0 = qcp_matrix.qcp_rmsd_matrix_kernel.n_launches
    k = qcp_matrix.qcp_rmsd_matrix_kernel(*args)
    torch.cuda.synchronize()
    check(qcp_matrix.qcp_rmsd_matrix_kernel.n_launches == n0 + 1,
          'qcp launch count did not grow by 1')
    p = qcp_matrix.qcp_rmsd_matrix_plain(*args)
    k, p = k[:F, :C].double(), p[:F, :C].double()
    check(bool(torch.isfinite(k).all()), 'qcp kernel: non-finite values')
    bar = bar_from(2 * float(max(gf.max(), gc.max())), A)
    check(bool(((k * k - p * p).abs() <= bar(p)).all()),
          '%d x %d x %d: qcp kernel outside the msd bar' % (F, C, A))
    max_abs_err = float((k - p).abs().max())
    ak, ap = k.argmin(dim=1), p.argmin(dim=1)
    flips = torch.nonzero(ak != ap).flatten()
    if len(flips):
        dk = p[flips, ak[flips]]
        dp = p[flips, ap[flips]]
        check(bool(((dk * dk - dp * dp).abs()
                    <= bar(torch.maximum(dk, dp))).all()),
              '%d x %d x %d: argmins differ beyond near ties' % (F, C, A))
    del k, p
    fns = {'kernel': qcp_matrix.qcp_rmsd_matrix_kernel,
           'plain': qcp_matrix.qcp_rmsd_matrix_plain}
    for fn in fns.values():
        fn(*args)                                  # warm-up
    times = []
    for name in ('plain', 'kernel', 'kernel', 'plain'):
        times.append(events_ms(lambda: fns[name](*args))[0])
    check(qcp_matrix.qcp_rmsd_matrix_kernel.n_launches == n0 + 4,
          'qcp launch count did not grow by the launches made')
    ms, plain_ms = min(times[1:3]), min(times[0], times[3])
    line = ('%d x %d x %d kernel vs plain: within the msd bar, argmins '
            'equal but for %d near ties, max |kernel - plain| %.3g; ms '
            'per block kernel %.4f, plain %.4f (turns plain, kernel, '
            'kernel, plain: %s)' % (F, C, A, len(flips), max_abs_err, ms,
                                    plain_ms,
                                    ', '.join('%.4f' % t for t in times)))
    return max_abs_err, ms, plain_ms, line


def write_trajectories(d):
    """The phase-5 data set under ``d``: a PDB of 64 CA atoms and
    N_TRJ XTC trajectories of TRJ_FRAMES basin frames each (seed 1,
    2,000 basins, noise 0.02 nm). Returns ``(pdb, xtc paths, an upper
    bound on the frame pairs' G sum)``."""
    X = basin_data(np.random.default_rng(1), N_TRJ * TRJ_FRAMES, N_ATOMS,
                   n_basins=2000)
    top = Topology()
    chain = top.add_chain()
    for i in range(N_ATOMS):
        top.add_atom('CA', 'C', top.add_residue('ALA', chain, i + 1))
    pdb = os.path.join(d, 'ca.pdb')
    write_pdb(pdb, Trajectory(X[:1], top))
    paths = [os.path.join(d, 'trj%03d.xtc' % t) for t in range(N_TRJ)]
    cluster_util.load_xtc_codec(paths)   # before the writer threads

    def one(t):
        write_xtc(paths[t], Trajectory(
            X[t * TRJ_FRAMES:(t + 1) * TRJ_FRAMES], top))
    with ThreadPoolExecutor(8) as ex:
        list(ex.map(one, range(N_TRJ)))
    Xc = X - X.mean(axis=1, keepdims=True)
    # xtc stores 1e-3 nm: 1% covers its change of G
    return pdb, paths, 2.02 * float(np.einsum('nai,nai->n', Xc, Xc).max())


class Stage:
    """Wrap ``module.name`` for one run: device-synchronised wall time,
    the kernel launches made inside it and its result."""

    def __init__(self, module, name):
        self.module, self.name = module, name
        self.fn = getattr(module, name)

    def __enter__(self):
        def wrapped(*a, **kw):
            torch.cuda.synchronize()
            q0 = qcp_matrix.qcp_rmsd_matrix_kernel.n_launches
            k0 = kcenters_chunk.n_launches
            t = time.perf_counter()
            self.result = self.fn(*a, **kw)
            torch.cuda.synchronize()
            self.seconds = time.perf_counter() - t
            self.qcp = qcp_matrix.qcp_rmsd_matrix_kernel.n_launches - q0
            self.kc = kcenters_chunk.n_launches - k0
            return self.result
        setattr(self.module, self.name, wrapped)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.fn)


def reassign_path(device, card):
    """Phase 5: the cluster -> reassign workflow through the port's
    apps at 1M frames x 64 atoms -> 1000 centers, with its checks.
    Returns the launches of both kernels in the run."""
    with tempfile.TemporaryDirectory() as d:
        t = time.perf_counter()
        pdb, trjs, gsum = write_trajectories(d)
        print('wrote %d XTC trajectories x %d frames x %d atoms in %.1f s'
              % (N_TRJ, TRJ_FRAMES, N_ATOMS, time.perf_counter() - t),
              flush=True)
        bar = bar_from(gsum, N_ATOMS)
        out = {k: os.path.join(d, v) for k, v in (
            ('--distances', 'dist.h5'), ('--assignments', 'assig.h5'),
            ('--center-features', 'centers.pkl'),
            ('--center-indices', 'inds.npy'))}
        argv = ['cluster', '--trajectories', *trjs, '--topology', pdb,
                '--atoms', 'name CA', '--algorithm', 'khybrid',
                '--cluster-number', str(CLUSTER_K), '--subsample',
                str(SUBSAMPLE), '--random-state', '0']
        for k, v in out.items():
            argv += [k, v]

        qcp_matrix.qcp_rmsd_matrix_kernel.n_launches = 0
        kcenters_chunk.n_launches = 0
        engine_kmedoids._pam_sweeps.n_host_syncs = 0
        # the sequence of apps/cluster.py :: main, but for its .h5 write
        args = cluster_app.process_command_line(argv)
        t = time.perf_counter()
        lengths, data = cluster_util.load_trjs_or_features(args)
        t_load = time.perf_counter() - t
        with Stage(hybrid_mod, '_kcenters') as kc, \
                Stage(hybrid_mod, '_kmedoids_iterations') as pam:
            clustering = cluster_app.fit(args, data, device)
        syncs = engine_kmedoids._pam_sweeps.n_host_syncs
        res = clustering.result_
        result = res.partition(lengths)
        t = time.perf_counter()
        cluster_util.write_centers_indices(
            args.center_indices, cluster_app.center_indices(result, args))
        cluster_util.write_centers(result, args)
        t_write = time.perf_counter() - t

        # the sequence of apps/reassign.py :: main, but for its .h5 writes
        rargv = ['reassign', '--centers', out['--center-features'],
                 '--trajectories', *trjs, '--topology', pdb, '--atoms',
                 'name CA', '--distances', os.path.join(d, 'rd.h5'),
                 '--assignments', os.path.join(d, 'ra.h5')]
        rargs = reassign_app.process_command_line(rargv)
        t = time.perf_counter()
        with Stage(engine, 'assign_device') as asg:
            r_assig, r_dist = reassign_app.run(
                rargs, reassign_app.load_centers(rargs), device)
        t_reassign = time.perf_counter() - t
        launches = {'qcp_matrix': qcp_matrix.qcp_rmsd_matrix_kernel.n_launches,
                    'kcenters_step': kcenters_chunk.n_launches}

        # -- checks --
        n_sub = sum(lengths)
        check(n_sub == N_TRJ * TRJ_FRAMES // SUBSAMPLE,
              'loaded %d frames' % n_sub)
        ctr = np.asarray(res.center_indices)
        check(len(ctr) == CLUSTER_K and len(set(ctr.tolist())) == CLUSTER_K,
              '%d distinct centers' % len(set(ctr.tolist())))
        check(bool((bar(0.0) >= res.distances[ctr] ** 2).all()),
              'a center frame lies %g from its own center'
              % res.distances[ctr].max())
        cost_kc = float(np.mean(kc.result.distances ** 2))
        cost = float(np.mean(res.distances ** 2))
        check(cost <= cost_kc, 'PAM cost %r above k-centers cost %r'
              % (cost, cost_kc))
        check(kc.kc > 0, 'k-centers launched no kernel')
        check(pam.qcp > 0 and pam.kc == 0,
              'PAM: %d qcp launches, %d k-centers launches'
              % (pam.qcp, pam.kc))
        check(asg.qcp > 0, 'reassign launched no qcp kernel')
        r_assig, r_dist = np.asarray(r_assig), np.asarray(r_dist)
        check(r_assig.shape == (N_TRJ, TRJ_FRAMES) and
              np.isfinite(r_dist).all(), 'reassign output %s'
              % (r_assig.shape,))
        sub_a = r_assig[:, ::SUBSAMPLE]
        sub_d = r_dist[:, ::SUBSAMPLE]
        clu_a = np.asarray(result.assignments)
        clu_d = np.asarray(result.distances, np.float64)
        check(bool((np.abs(sub_d ** 2 - clu_d ** 2) <= bar(clu_d)).all()),
              'reassigned distances outside the msd bar')
        flips = sub_a != clu_a
        # a flip took another center at the same distance: a near tie
        check(bool((np.abs(sub_d[flips] ** 2 - clu_d[flips] ** 2)
                    <= bar(np.maximum(sub_d[flips], clu_d[flips]))).all()),
              'reassignment differs beyond near ties')
        ctr_full = [(t, f * SUBSAMPLE) for t, f in result.center_indices]
        own = np.array([r_dist[t, f] for t, f in ctr_full])
        check(bool((own ** 2 <= bar(0.0)).all()),
              'a center frame is %g from every center' % own.max())

    pairs = N_TRJ * TRJ_FRAMES * CLUSTER_K
    print('cluster -> reassign: %d of %d frames clustered (--subsample %d)'
          ' to %d centers, PAM cost %.6g <= k-centers cost %.6g; %d of '
          '%d subsampled frames reassigned to another center, each a near'
          ' tie; every center frame within the msd bar of 0'
          % (n_sub, N_TRJ * TRJ_FRAMES, SUBSAMPLE, CLUSTER_K, cost,
             cost_kc, int(flips.sum()), flips.size))
    print('[%s] load %.4f s; k-centers %.4f s (%d launches); PAM %.4f s '
          '(5 sweeps, %d host syncs, %d qcp launches); write centers '
          '%.4f s; reassign %.4f s (load + assign), of which assign '
          '%.4f s = %.4g pairs/s (%d qcp launches)'
          % (card, t_load, kc.seconds, kc.kc, pam.seconds, syncs, pam.qcp,
             t_write, t_reassign, asg.seconds, pairs / asg.seconds,
             asg.qcp), flush=True)
    return launches


def main():
    card = card_line()
    print('card:', card, flush=True)
    device = require_cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    t = time.perf_counter()
    _build.build('kcenters_step', 'qcp_matrix')
    _build.load_library('kcenters_step')
    _build.load_library('qcp_matrix')
    print('built %s and %s in %.3f s (nvcc %s)'
          % (SOURCE, QCP_SOURCE, time.perf_counter() - t,
             ' '.join(_build.NVCC_FLAGS)), flush=True)

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
    qcp_matrix.qcp_rmsd_matrix_kernel.n_launches = 0
    prep, res, counts, vals, vecs, (t_prep, t_cl, t_co, t_eig) = \
        pipeline(frames, device)
    launches = kcenters_chunk.n_launches
    check(qcp_matrix.qcp_rmsd_matrix_kernel.n_launches == 0,
          'the north star launched the qcp kernel')
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

    del frames, prep, res, counts, start, outs
    torch.cuda.empty_cache()

    # -- 4. the all-pairs QCP kernel and its plain version -----------------
    qcp_err = qcp_ms = qcp_plain_ms = None
    for i, (F, C, A) in enumerate(QCP_SHAPES):
        err, k_ms, p_ms, line = qcp_shape(device, F, C, A, seed=i)
        print('[%s] %s' % (card, line), flush=True)
        if i == 0:
            qcp_err, qcp_ms, qcp_plain_ms = err, k_ms, p_ms
        torch.cuda.empty_cache()

    # -- 5. cluster -> reassign through the apps at full size --------------
    path = reassign_path(device, card)
    print('launches: north star kcenters_step %d; cluster -> reassign '
          'kcenters_step %d, qcp_matrix %d'
          % (launches, path['kcenters_step'], path['qcp_matrix']))

    print(json.dumps({'kernels': [{
        'name': 'kcenters_step', 'route': 'cuda', 'source': SOURCE,
        'replaces': REPLACES, 'launches': launches,
        'max_abs_err': max_abs_err, 'ms': ms, 'plain_ms': plain_ms}, {
        'name': 'qcp_matrix', 'route': 'cuda', 'source': QCP_SOURCE,
        'replaces': QCP_REPLACES, 'launches': path['qcp_matrix'],
        'max_abs_err': qcp_err, 'ms': qcp_ms, 'plain_ms': qcp_plain_ms}]}))
    print(card)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    main()
