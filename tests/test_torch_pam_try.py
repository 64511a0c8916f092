"""The PAM sweeps' try kernels (``ops/pam_try.py``) and the one-read
try of ``engine_kmedoids._pam_sweeps``. Imports no jax: on the card
machine, run the ``cuda`` tests with ``python -m pytest --noconftest -m
cuda tests/test_torch_pam_try.py``.

On the CPU:

- ``pam_try_eval_plain`` and ``pam_try_commit_plain`` equal, bit for
  bit, a frozen copy of the sweep's per-try expressions as they stood
  before the kernels (two reads a try): random states with stale points,
  a padded tail, a ``cid`` with no members, ties of ``dnew`` with ``d1``
  and ``d2``, a state that forces the on-demand repair;
- the sweep, on one device and over two CPU shards, makes
  ``2 x batches + tries + n_reevals`` host reads and returns what a
  frozen copy of the two-read sweep returns, bit for bit.

On the card (``cuda``, skipped without one): the kernels against the
plain versions at 321,500 frames (counts equal, the sum of squares
within 1e-12 relative, the commit bit for bit); and
``kmedoids_sweeps_device`` on 100,000 x 80 basin frames, k = 300, three
seeds, with the kernels (one evaluation launch per evaluation) and with
the plain versions: the same medoids, and two kernel runs identical;
and a profiled sweep in which no try copies a host value to the card.
"""

import math

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from enspara_tpu_torch.cluster import engine, engine_kmedoids, kcenters
from enspara_tpu_torch.ops import pam_try
from enspara_tpu_torch.parallel import FrameMesh
from enspara_tpu_torch.parallel.ops import argmax_over_shards, owned_rows

from test_torch_port import basin_data


@pytest.fixture(autouse=True)
def _cpu_platform(monkeypatch):
    """Host inputs run on the CPU in these tests, on one thread: the
    tier-1 run puts several test workers on one host's cores."""
    monkeypatch.setenv('ENSPARA_TPU_PLATFORM', 'cpu')
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device (torch.cuda.is_available() is '
                    'False)')
    return torch.device('cuda')


# ---- the frozen per-try expressions of the two-read sweep -------------

def frozen_eval(d1, a1, d2, a2, dnew, stale, valid, cid):
    """``(n_ms, n_su, sumsq)`` as the two-read sweep computed them with
    no repair between its reads."""
    members = (a1 == cid) & valid
    unc = (members | (a2 == cid)) & (dnew > d2) & valid
    n_ms, n_su = torch.stack(((members & stale).sum(),
                              (stale | unc).sum()))
    cand_d1 = torch.where(members, torch.minimum(d2, dnew),
                          torch.minimum(d1, dnew))
    sq = torch.where(valid, cand_d1 * cand_d1, 0.0).sum(dtype=torch.float64)
    return n_ms, n_su, sq


def frozen_commit(d1, a1, d2, a2, dnew, stale, valid, cid):
    """The new ``(d1, a1, d2, a2, stale)`` of the two-read sweep's
    commit."""
    members = (a1 == cid) & valid
    unc = (members | (a2 == cid)) & (dnew > d2) & valid
    cand_d1 = torch.where(members, torch.minimum(d2, dnew),
                          torch.minimum(d1, dnew))
    w = torch.where
    in1, in2 = dnew < d1, dnew < d2
    caseB, caseC = a1 == cid, a2 == cid
    na1 = w(caseB, w(in2, cid, a2), w(in1, cid, a1))
    nd2 = w(caseB, torch.maximum(dnew, d2),
            w(caseC, torch.maximum(dnew, d1),
              w(in1, d1, w(in2, dnew, d2))))
    na2 = w(caseB, w(in2, a2, cid),
            w(caseC, w(in1, a1, cid),
              w(in1, a1, w(in2, cid, a2))))
    return (w(valid, cand_d1, math.inf), w(valid, na1, -1).to(torch.int32),
            w(valid, nd2, math.inf), w(valid, na2, -1).to(torch.int32),
            stale | unc)


def state(case, n=3000, k=40, seed=0, device='cpu'):
    """A shard's ``(d1, a1, d2, a2, dnew, stale, n_valid, cid)``: exact
    nearest / second-nearest pairs over ``k`` medoids, padding at inf /
    -1 past ``n_valid``."""
    rng = np.random.default_rng(seed)
    D = rng.random((n, k)).astype(np.float32)
    order = np.argsort(D, axis=1, kind='stable')
    a1, a2 = order[:, 0].astype(np.int32), order[:, 1].astype(np.int32)
    d1 = np.take_along_axis(D, order[:, :1], 1)[:, 0]
    d2 = np.take_along_axis(D, order[:, 1:2], 1)[:, 0]
    dnew = rng.random(n).astype(np.float32) * 0.3
    stale = rng.random(n) < 0.1
    n_valid, cid = n, int(a1[0])
    if case == 'tail':
        n_valid = n - 517
    elif case == 'empty':
        cid = k                          # in no a1 and no a2
    elif case == 'ties':
        t = rng.random(n)
        dnew = np.where(t < 0.3, d1, np.where(t < 0.6, d2, dnew))
    elif case == 'repair':
        stale = stale | (a1 == cid)       # stale members of cid
    if case == 'random':
        stale = rng.random(n) < 0.3
    d1[n_valid:], d2[n_valid:] = np.inf, np.inf
    a1[n_valid:], a2[n_valid:] = -1, -1
    stale[n_valid:] = False
    t = [torch.from_numpy(np.ascontiguousarray(x)).to(device)
         for x in (d1, a1, d2, a2, dnew, stale)]
    return (*t, n_valid, cid)


CASES = ['random', 'tail', 'empty', 'ties', 'repair']


@pytest.mark.parametrize('case', CASES)
def test_plain_versions_equal_the_frozen_expressions(case):
    d1, a1, d2, a2, dnew, stale, n_valid, cid = state(case)
    valid = torch.arange(d1.shape[0]) < n_valid
    got = pam_try.pam_try_eval(d1, a1, d2, a2, dnew, stale, cid, n_valid)
    n_ms, n_su, sq = frozen_eval(d1, a1, d2, a2, dnew, stale, valid, cid)
    assert got.dtype == torch.float64 and got.shape == (3,)
    assert got[0].item() == n_ms.item() and got[1].item() == n_su.item()
    assert torch.equal(got[2], sq)
    if case == 'repair':
        assert n_ms > 0
    if case == 'empty':
        assert n_ms == 0

    want = frozen_commit(d1, a1, d2, a2, dnew, stale, valid, cid)
    mine = [t.clone() for t in (d1, a1, d2, a2, stale)]
    pam_try.pam_try_commit(*mine[:4], dnew, mine[4], cid, n_valid)
    for a, b in zip(mine, want):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert not mine[4][n_valid:].any()
    with pytest.raises(ValueError, match='n_valid'):
        pam_try.pam_try_commit(*mine[:4], dnew, mine[4], cid,
                               d1.shape[0] + 1)


# ---- the frozen two-read sweep -----------------------------------------

def frozen_sweeps(prep, d1, a1, medoid_inds, sweep_bits, bucket, batch,
                  mesh=None):
    """``_pam_sweeps`` as it stood with two host reads a try, its try
    body as eager torch ops and a host value written to ``medoid_inds``
    on each commit."""
    sharded = mesh is not None
    if sharded:
        shards, n_local, first = prep.shards, prep.n_local, prep.first_shard
    else:
        shards, n_local, first = (prep,), prep.n_pad, 0
        mesh = FrameMesh((prep.device,))
    d1, a1 = list(d1), list(a1)
    lead, S = mesh.lead, range(len(shards))
    devs = [sh.device for sh in shards]
    starts = [(first + s) * n_local for s in S]
    n_valid = int(prep.n)
    n_pad = n_local * mesh.size
    valid = [torch.arange(starts[s], starts[s] + n_local, device=devs[s])
             < n_valid for s in S]
    medoid_inds = torch.as_tensor(medoid_inds, dtype=torch.long,
                                  device=lead).clone()
    k = int(medoid_inds.shape[0])
    B = int(min(batch, k))

    def read(*ts):
        return torch.cat([t.reshape(-1).to(torch.float64)
                          for t in ts]).cpu().tolist()

    def block(cols, rows=None):
        if sharded:
            return engine._pairwise_block(prep, cols, rows, mesh)
        return [engine._pairwise_block(prep, cols,
                                       None if rows is None else rows[0])]

    def total(parts):
        return mesh.reduce([p.to(torch.float64) for p in parts])

    def cost(parts):
        return total(parts).float() / n_valid

    def sq_sums(ds):
        return [torch.where(valid[s], ds[s] * ds[s], 0.0).sum(
            dtype=torch.float64) for s in S]

    C = int(min(64, k))
    n_chunks = (k + C - 1) // C
    minds_pad = torch.nn.functional.pad(medoid_inds, (0, n_chunks * C - k))
    d2 = [torch.full((n_local,), math.inf, device=dv) for dv in devs]
    a2 = [torch.full((n_local,), -1, dtype=torch.int32, device=dv)
          for dv in devs]
    for ci in range(n_chunks):
        cids = ci * C + torch.arange(C, dtype=torch.int32, device=lead)
        Ds = block(minds_pad[cids.long()])
        for s in S:
            c = cids.to(devs[s])
            invalid = (c[None, :] == a1[s][:, None]) | (c[None, :] >= k)
            cmin, carg = torch.where(invalid, math.inf, Ds[s]).min(dim=1)
            better = (cmin < d2[s]) & valid[s]
            d2[s] = torch.where(better, cmin, d2[s])
            a2[s] = torch.where(better, c[carg], a2[s])

    def repair(a1, d2, a2, stale, medoid_inds):
        amb = [torch.argsort((~st).to(torch.int8), stable=True)[:bucket]
               for st in stale]
        Ds = block(medoid_inds, rows=amb)
        d2, a2 = list(d2), list(a2)
        for s in S:
            idx = amb[s]
            amb_real = stale[s][idx]
            m = medoid_inds.to(devs[s])
            d_amb = torch.where((idx + starts[s])[:, None] == m[None, :],
                                0.0, Ds[s])
            hide = (torch.arange(k, device=devs[s])[None, :]
                    == a1[s][idx][:, None])
            b_d2, b_a2 = torch.where(hide, math.inf, d_amb).min(dim=1)
            d2[s] = d2[s].clone()
            a2[s] = a2[s].clone()
            d2[s][idx] = torch.where(amb_real, b_d2, d2[s][idx])
            a2[s][idx] = torch.where(amb_real, b_a2.to(torch.int32),
                                     a2[s][idx])
        return d2, a2

    def rows_of(s, D, p_idxs):
        D = D.t().contiguous()
        li, own = owned_rows(p_idxs.to(devs[s]), n_local, first + s)
        r = torch.arange(B, device=devs[s])
        D[r, li] = torch.where(own, 0.0, D[r, li])
        return D

    cost_cur = cost(sq_sums(d1))
    for rbits in sweep_bits:
        rbits = torch.as_tensor(rbits).reshape(-1)[:n_valid].to(
            device=lead, dtype=torch.long)
        rbits = torch.nn.functional.pad(rbits, (0, n_pad - n_valid))
        rb = [rbits[starts[s]:starts[s] + n_local].to(devs[s]) for s in S]
        for bi in range((k + B - 1) // B):
            cids = bi * B + torch.arange(B, dtype=torch.long, device=lead)
            member0, pvals, pargs = [], [], []
            for s in S:
                c = cids.to(devs[s])
                m0 = (a1[s][None, :] == c[:, None]) & valid[s][None, :]
                member0.append(m0)
                v, a = engine_kmedoids._sample(rb[s], c, m0)
                pvals.append(v)
                pargs.append(a + starts[s])
            pmax, p_idxs = argmax_over_shards(pvals, pargs, mesh)
            sampled_ok = pmax > 0
            Dt = [rows_of(s, D, p_idxs) for s, D in zip(S, block(p_idxs))]
            est0 = cost([engine_kmedoids._screen(member0[s], d1[s], d2[s],
                                                 Dt[s], valid[s])
                         for s in S])
            vals = read(cost_cur, est0, sampled_ok, p_idxs)
            cost_h = vals[0]
            est0_h, ok_h = vals[1:B + 1], vals[B + 1:2 * B + 1]
            p_idx_h = [int(v) for v in vals[2 * B + 1:]]
            stale = [torch.zeros(n_local, dtype=torch.bool, device=dv)
                     for dv in devs]
            for b in range(B):
                cid = bi * B + b
                if not (est0_h[b] < cost_h and ok_h[b] and cid < k):
                    continue
                dnew = [Dt[s][b] for s in S]
                members = [(a1[s] == cid) & valid[s] for s in S]
                unc = [(members[s] | (a2[s] == cid))
                       & (dnew[s] > d2[s]) & valid[s] for s in S]
                n_ms, n_su = read(total([torch.stack((
                    (members[s] & stale[s]).sum(),
                    (stale[s] | unc[s]).sum())) for s in S]))
                if n_ms > 0 or n_su > bucket:
                    d2, a2 = repair(a1, d2, a2, stale, medoid_inds)
                    stale = [torch.zeros_like(st) for st in stale]
                    unc = [(members[s] | (a2[s] == cid))
                           & (dnew[s] > d2[s]) & valid[s] for s in S]
                cand_d1 = [torch.where(members[s],
                                       torch.minimum(d2[s], dnew[s]),
                                       torch.minimum(d1[s], dnew[s]))
                           for s in S]
                new_stale = [stale[s] | unc[s] for s in S]
                tot = total([torch.stack((p, st.sum().double()))
                             for p, st in zip(sq_sums(cand_d1), new_stale)])
                new_cost = tot[0].float() / n_valid
                new_cost_h, n_stale = read(new_cost, tot[1])
                if not (new_cost_h < cost_h and n_stale <= bucket):
                    continue
                for s in S:
                    out = frozen_commit(d1[s], a1[s], d2[s], a2[s], dnew[s],
                                        stale[s], valid[s], cid)
                    d1[s], a1[s], d2[s], a2[s], _ = out
                medoid_inds[cid] = p_idx_h[b]
                cost_cur, cost_h = new_cost, new_cost_h
                stale = new_stale
            if read(total([st.sum() for st in stale]))[0] > 0:
                d2, a2 = repair(a1, d2, a2, stale, medoid_inds)
    return d1, a1, medoid_inds


@pytest.mark.parametrize('shards', [None, 2])
def test_sweep_reads_once_a_try_and_equals_the_two_read_sweep(shards):
    """Small buckets force on-demand repairs, so both read paths run."""
    n, k, batch, n_sweeps, bucket = 900, 24, 8, 3, 40
    X = basin_data(np.random.default_rng(3), n, 8, n_basins=30)
    mesh = None if shards is None else FrameMesh(['cpu'] * shards)
    warm = kcenters(X, 'rmsd', n_clusters=k, device='cpu')
    prep = engine.prepare_rmsd_frames(X, tile=32, mesh=mesh)
    n_local = prep.n_local if mesh else prep.n_pad
    n_pad = n_local * (shards or 1)
    d1 = np.full(n_pad, np.inf, np.float32)
    d1[:n] = warm.distances
    a1 = np.full(n_pad, -1, np.int32)
    a1[:n] = warm.assignments

    def local(a):
        return [torch.from_numpy(a[s * n_local:(s + 1) * n_local].copy())
                for s in range(shards or 1)]

    def bits():
        return engine_kmedoids.sweep_bits(9, n_sweeps, n, 'cpu')

    args = (np.asarray(warm.center_indices, np.int64),)
    want = frozen_sweeps(prep, local(d1), local(a1), *args, bits(), bucket,
                         batch, mesh)
    sweeps = engine_kmedoids._pam_sweeps
    reads, reevals = sweeps.n_host_syncs, sweeps.n_reevals
    d1_in, a1_in = local(d1), local(a1)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        got = sweeps(prep, d1_in, a1_in, *args, bits(), bucket, batch=batch,
                     mesh=mesh)
    reads, reevals = sweeps.n_host_syncs - reads, sweeps.n_reevals - reevals
    names = [e.name for e in prof.events()]
    tries = names.count('enspara/pam.try')
    batches = names.count('enspara/pam.batch')
    assert batches == n_sweeps * ((k + batch - 1) // batch)
    assert tries > 0 and reevals > 0
    assert reads == 2 * batches + tries + reevals
    def cat(t):
        return torch.cat(t) if isinstance(t, list) else t
    for a, b in zip(got, want):
        a, b = cat(a), cat(b)
        assert a.dtype == b.dtype and torch.equal(a, b)
    # the caller's state is left as it was
    assert torch.equal(cat(d1_in), cat(local(d1)))
    assert torch.equal(cat(a1_in), cat(local(a1)))


# ---- the card ----------------------------------------------------------

@pytest.mark.cuda
def test_cuda_kernels_equal_plain(cuda):
    """At the benchmark's 321,500 frames a shard, with a padded tail."""
    for case in CASES:
        d1, a1, d2, a2, dnew, stale, n_valid, cid = state(
            case, n=321_600, k=1000, seed=CASES.index(case), device=cuda)
        if case != 'tail':
            n_valid = 321_500
            for t, fill in ((d1, math.inf), (d2, math.inf), (a1, -1),
                            (a2, -1), (stale, False)):
                t[n_valid:] = fill
        e0 = pam_try.pam_try_eval.n_launches
        got = pam_try.pam_try_eval(d1, a1, d2, a2, dnew, stale, cid,
                                   n_valid)
        want = pam_try.pam_try_eval_plain(d1, a1, d2, a2, dnew, stale, cid,
                                          n_valid)
        torch.cuda.synchronize()
        assert pam_try.pam_try_eval.n_launches == e0 + 1
        assert torch.equal(got[:2], want[:2]), case
        assert abs(got[2].item() - want[2].item()) <= 1e-12 * want[2].item()
        again = pam_try.pam_try_eval(d1, a1, d2, a2, dnew, stale, cid,
                                     n_valid)
        assert torch.equal(again, got), case

        mine = [t.clone() for t in (d1, a1, d2, a2, stale)]
        ref = [t.clone() for t in (d1, a1, d2, a2, stale)]
        c0 = pam_try.pam_try_commit.n_launches
        pam_try.pam_try_commit(*mine[:4], dnew, mine[4], cid, n_valid)
        pam_try.pam_try_commit_plain(*ref[:4], dnew, ref[4], cid, n_valid)
        torch.cuda.synchronize()
        assert pam_try.pam_try_commit.n_launches == c0 + 1
        for a, b in zip(mine, ref):
            assert torch.equal(a, b), case


@pytest.mark.cuda
def test_cuda_sweeps_kernels_equal_plain(cuda, monkeypatch):
    """kmedoids_sweeps_device on 100,000 x 80 basin frames, k = 300:
    one evaluation launch per evaluation, at least one commit launch,
    the plain versions' medoids, and a second kernel run identical."""
    n, k, batch = 100_000, 300, 64
    sweeps = engine_kmedoids._pam_sweeps
    for seed in (0, 1, 2):
        X = basin_data(np.random.default_rng(seed), n, 80, n_basins=1000)
        warm = kcenters(X, 'rmsd', n_clusters=k, device=cuda)

        def run():
            return engine_kmedoids.kmedoids_sweeps_device(
                X, 'rmsd', warm.assignments, warm.distances,
                warm.center_indices, n_sweeps=5, seed=seed, device=cuda,
                proposal_batch=batch)

        e0 = pam_try.pam_try_eval.n_launches
        c0 = pam_try.pam_try_commit.n_launches
        r0 = sweeps.n_host_syncs
        first = run()
        reads = sweeps.n_host_syncs - r0
        assert pam_try.pam_try_eval.n_launches - e0 == \
            reads - 2 * 5 * ((k + batch - 1) // batch) > 0
        assert pam_try.pam_try_commit.n_launches > c0
        second = run()
        for a, b in zip(first, second):
            np.testing.assert_array_equal(a, b)
        with monkeypatch.context() as m:
            m.setattr(engine_kmedoids, 'pam_try_eval',
                      pam_try.pam_try_eval_plain)
            m.setattr(engine_kmedoids, 'pam_try_commit',
                      pam_try.pam_try_commit_plain)
            e1 = pam_try.pam_try_eval.n_launches
            plain = run()
            assert pam_try.pam_try_eval.n_launches == e1
        np.testing.assert_array_equal(first[0], plain[0])
        np.testing.assert_array_equal(first[2], plain[2])
        np.testing.assert_array_equal(first[1], plain[1])


def _below(e, skip):
    """``e`` and every CPU op under it, but for the subtrees of the
    spans named ``skip``."""
    yield e
    for c in e.cpu_children:
        if c.name != skip:
            yield from _below(c, skip)


@pytest.mark.cuda
def test_cuda_tries_copy_no_host_value_to_the_card(cuda):
    """A profiled kmedoids_sweeps_device on the card: no host-to-device
    copy inside a try, outside its repairs (the new medoid is copied
    from the card); the try's own evaluation kernel is seen there, so
    the profile links device work to the try's ops."""
    n, k = 20_000, 100
    X = basin_data(np.random.default_rng(4), n, 32, n_basins=200)
    warm = kcenters(X, 'rmsd', n_clusters=k, device=cuda)
    c0 = pam_try.pam_try_commit.n_launches
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        engine_kmedoids.kmedoids_sweeps_device(
            X, 'rmsd', warm.assignments, warm.distances,
            warm.center_indices, n_sweeps=2, seed=4, device=cuda)
        torch.cuda.synchronize()
    assert pam_try.pam_try_commit.n_launches > c0
    tries = [e for e in prof.events() if e.name == 'enspara/pam.try']
    device = [kn.name for t in tries for e in _below(t, 'enspara/pam.repair')
              for kn in e.kernels]
    assert tries and any('pam_eval_kernel' in d for d in device)
    assert not [d for d in device if 'HtoD' in d]
