#!/usr/bin/env python3
"""Where ``mesh=None`` of enspara_tpu_torch should stop keeping a job on
one card: k-centers, the assignment and the PAM sweeps, each called as a
user calls it on host frames, on one card (``device='cuda:0'``) and over
every visible card (``mesh=frame_mesh()``), at growing frame counts; and
the batched implied timescales over the cards, with one host thread a
shard and with the shards' solves queued from one thread.

Run from the root of a checkout, with two or more CUDA cards visible:

    python3 chip_mesh_crossover.py [N_FRAMES[:K] ...]

Each N_FRAMES (default: 1M, 4M, 8M and 16M) is a random walk of 64-atom
frames around one structure (``chip_smoke.random_walk``'s data, made on
the card a million frames at a time and copied to the host). At each
size, to ``K`` centers (default 1000):

- ``kcenters``: ``kcenters(X, 'rmsd', n_clusters=K)`` from the host array,
  ingest, loop and the host copy of the results included;
- ``assign``: ``engine.assign_device(X, X[centers], 'rmsd')``;
- ``sweeps``: ``kmedoids_sweeps_device`` of ``X``, 2 PAM sweeps from the
  k-centers result.

Each is run in the order one card, cards, cards, one card, timed to a
synchronize of every card, and the results of the two placements are
compared bit for bit. ``features`` is the small-job rule's measure,
``n * 3 * 64`` (``parallel/mesh.py :: job_features``), and ``work`` the
JAX package's, ``n * K * 3 * 64``. First, ``its``: the batched
implied timescales of 100 chains x 10,000 steps over 1,000 states at the
implied CLI's 48 lags (``5:100:2``), on one card and over the cards with
the thread pool of ``eigen_device.implied_timescales_batched`` and with a
serial stand-in for it, five times each, interleaved.

The cards' names and power limits come first, then one JSON line for
``its`` and one a size. Exits 1 with fewer than two cards.
"""

import json
import subprocess
import sys
import time

import numpy as np
import torch

from enspara_tpu_torch.cluster import engine, engine_kmedoids
from enspara_tpu_torch.cluster.kcenters import kcenters
from enspara_tpu_torch.msm import eigen_device
from enspara_tpu_torch.ops import _build
from enspara_tpu_torch.parallel import frame_mesh
from enspara_tpu_torch.parallel.mesh import job_features

SIZES = (1_000_000, 4_000_000, 8_000_000, 16_000_000)
N_ATOMS, K, SWEEPS, CHUNK = 64, 1000, 2, 1_000_000
ITS_CHAINS, ITS_STEPS, ITS_STATES, ITS_REPS = 100, 10_000, 1000, 5
ITS_LAGS = list(range(5, 100, 2))
ITS_EIGS = 5


def card_lines():
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'],
        capture_output=True, text=True, check=True, timeout=60)
    return '; '.join(out.stdout.strip().splitlines())


def sync_all():
    for k in range(torch.cuda.device_count()):
        torch.cuda.synchronize(k)


def random_walk(n, device, seed=42):
    """``n`` centered 64-atom frames around one structure with a
    per-frame scalar drift and noise, as a host array."""
    gen = torch.Generator(device=device).manual_seed(seed)
    base = torch.randn((N_ATOMS, 3), generator=gen, device=device)
    out = np.empty((n, N_ATOMS, 3), np.float32)
    for lo in range(0, n, CHUNK):
        m = min(CHUNK, n - lo)
        drift = torch.randn((m, 1, 1), generator=gen, device=device)
        f = torch.randn((m, N_ATOMS, 3), generator=gen,
                        device=device).mul_(0.1)
        f += base + 0.3 * drift * base
        out[lo:lo + m] = (f - f.mean(dim=1, keepdim=True)).cpu().numpy()
    return out


def timed(fn):
    sync_all()
    t = time.perf_counter()
    res = fn()
    sync_all()
    return res, time.perf_counter() - t


def same(a, b):
    return all(np.array_equal(np.asarray(x), np.asarray(y))
               for x, y in zip(a, b))


def one_vs_cards(fn, one, mesh):
    """``fn`` on one card and over the cards, in the order one, cards,
    cards, one: ``(seconds one, seconds cards, equal, result one)``."""
    times = {'one': [], 'cards': []}
    res = {}
    for where in ('one', 'cards', 'cards', 'one'):
        kw = {'device': one} if where == 'one' else {'mesh': mesh}
        r, t = timed(lambda: fn(**kw))
        times[where].append(round(t, 4))
        res[where] = r
        torch.cuda.empty_cache()
    return times['one'], times['cards'], same(res['one'], res['cards']), \
        res['one']


class _Serial:
    """The thread pool's interface, each call run where it is queued."""

    def __init__(self, *a):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def map(self, fn, it):
        return [fn(x) for x in it]


def its_labels():
    rng = np.random.default_rng(3)
    steps = rng.integers(-3, 4, size=(ITS_CHAINS, ITS_STEPS))
    steps[rng.random(steps.shape) < 0.5] = 0
    start = rng.integers(0, ITS_STATES, size=(ITS_CHAINS, 1))
    return ((start + np.cumsum(steps, axis=1)) % ITS_STATES).astype(np.int64)


def its_check(one, mesh):
    labels = its_labels()
    pool = eigen_device.ThreadPoolExecutor

    def run(**kw):
        return eigen_device.implied_timescales_batched(
            labels, ITS_LAGS, n_times=ITS_EIGS, **kw)
    ref = run(device=one)                    # warm-up
    times = {'one': [], 'pool': [], 'serial': []}
    equal = True
    for _ in range(ITS_REPS):
        for name in ('one', 'pool', 'serial'):
            eigen_device.ThreadPoolExecutor = \
                _Serial if name == 'serial' else pool
            kw = {'device': one} if name == 'one' else {'mesh': mesh}
            r, t = timed(lambda: run(**kw))
            times[name].append(round(t, 4))
            equal = equal and np.array_equal(r, ref)
    eigen_device.ThreadPoolExecutor = pool
    return {'its': {'lags': len(ITS_LAGS), 'states': ITS_STATES,
                    'equal': bool(equal),
                    **{k: v for k, v in times.items()},
                    'median_s': {k: float(np.median(v))
                                 for k, v in times.items()}}}


def main():
    n_cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n_cards < 2:
        print('needs two or more CUDA cards, %d visible' % n_cards)
        return 1
    print('cards:', card_lines(), flush=True)
    sizes = [tuple(int(float(x)) for x in (a + ':%d' % K).split(':')[:2])
             for a in sys.argv[1:]] or [(n, K) for n in SIZES]
    t = time.perf_counter()
    sources = ('kcenters_step', 'qcp_update', 'qcp_matrix', 'ell_spmm')
    _build.build(*sources)
    for name in sources:
        _build.load_library(name)
    print('built in %.1f s' % (time.perf_counter() - t), flush=True)
    mesh = frame_mesh()
    one = torch.device('cuda', 0)

    # warm every kernel and path on both placements at a small size
    X = random_walk(100_000, one, seed=1)
    for kw in ({'device': one}, {'mesh': mesh}):
        r = kcenters(X, 'rmsd', n_clusters=K, **kw)
        engine.assign_device(X, X[r.center_indices], 'rmsd', **kw)
        engine_kmedoids.kmedoids_sweeps_device(
            X, 'rmsd', r.assignments, r.distances, r.center_indices,
            n_sweeps=1, seed=0, **kw)
    del X

    print(json.dumps(its_check(one, mesh)), flush=True)
    for n, k in sizes:
        X = random_walk(n, one)
        row = {'n_frames': n, 'k': k, 'features': job_features(X),
               'work': job_features(X) * k, 'cards': mesh.size}
        o, c, eq, res = one_vs_cards(
            lambda **kw: kcenters(X, 'rmsd', n_clusters=k, **kw), one, mesh)
        row['kcenters'] = {'one_s': o, 'cards_s': c, 'equal': eq}
        ctr = np.asarray(res.center_indices)
        o, c, eq, _ = one_vs_cards(
            lambda **kw: engine.assign_device(X, X[ctr], 'rmsd', **kw),
            one, mesh)
        row['assign'] = {'one_s': o, 'cards_s': c, 'equal': eq}
        o, c, eq, _ = one_vs_cards(
            lambda **kw: engine_kmedoids.kmedoids_sweeps_device(
                X, 'rmsd', res.assignments, res.distances, ctr,
                n_sweeps=SWEEPS, seed=0, **kw), one, mesh)
        row['sweeps'] = {'one_s': o, 'cards_s': c, 'equal': eq}
        print(json.dumps(row), flush=True)
        del X, res

    print('cards:', card_lines())
    return 0


if __name__ == '__main__':
    sys.exit(main())
