"""K-medoids (PAM) sweeps on the device (counterpart of
``enspara_tpu/cluster/engine_kmedoids.py``).

The FastPAM second-nearest cache of the JAX module, step for step.
Beside the nearest-medoid state ``(d1, a1)`` the sweep carries the
exact second-nearest ``(d2, a2)``, so a proposal that replaces medoid
``cid`` by candidate ``c`` costs one distance column plus elementwise
selects: members of ``cid`` get ``min(d2, dnew)``, everyone else
``min(d1, dnew)``. Proposals for ``batch`` consecutive medoids are
sampled together (a uniform member of each cluster, as of the batch
start), their columns computed as one ``(n, batch)`` block
(``engine._pairwise_block``: for RMSD the all-pairs CUDA kernel on the
card, for features ``ops.distances``), and screened for the whole batch; the
survivors are verified exactly against the live cache before they
commit. An accept only marks the points whose ``(d2, a2)`` became upper
bounds as stale; a bucketed k-way re-rank repairs them on demand and at
batch end.

Every ``lax.cond``/``fori_loop`` of the JAX sweep is Python control
flow here, deciding on a device scalar read back to the host:
``n_host_syncs`` counts those reads, two a batch and one a tried
proposal, a second only after an on-demand repair (``n_reevals``
counts those tries). A try is two launches a shard on the card
(``ops/pam_try.py``): one evaluation that reduces the counts deciding a
repair and the post-swap sum of squares to three numbers, and one
commit that updates the state in place; the new medoid is copied into
``medoid_inds`` from the card, so that no host value is written there.
Under ``torch.profiler`` each read is an ``enspara/pam.read`` span (``util.log.trace_region``), inside
the ``enspara/pam.batch`` span of its batch, as are the
``enspara/pam.try`` and ``enspara/pam.repair`` spans.

Over a :class:`~enspara_tpu_torch.parallel.mesh.FrameMesh` of several
shards (a sharded container from ``engine``) every per-frame array
lives per shard, and the collectives GSPMD puts into the JAX sweep are
explicit: the medoid and proposal columns reach every shard through one
owner-masked sum per block (``engine._columns``); the proposal of each
cluster is the global first argmax of the shards' priorities
(``parallel.ops.argmax_over_shards`` of each shard's maxima); the
candidate's zero self-distance is set on the shard that owns it; costs,
the screen and the counts that
decide a repair are per-shard partial sums, reduced over the mesh
before any host read, so that every process reads the same values and
takes the same branch. The costs add the float32 squares in float64,
within each shard and over the mesh, and are rounded to float32 once,
as the JAX sweep's float32 cost is: their rounding then does not
depend on how the frames are split into shards or the shards over
processes, and a mesh accepts the swaps of one device but where two
float64 sums round to float32 apart. Each shard
repairs its own stale points:
commits keep the global stale count within the bucket, so a shard's
bucket holds all of them. A one-device container runs the same code as
a mesh of one shard.
"""

import math

import numpy as np
import torch

from . import engine
from ..ops.pam_try import pam_try_commit, pam_try_eval
from ..parallel.mesh import FrameMesh, host_fetch, resolve_placement
from ..parallel.ops import argmax_over_shards, owned_rows
from ..util.log import trace_region

__all__ = ['kmedoids_sweeps_device', 'sweep_bits']

_M32 = 0xFFFFFFFF


def _mul32(x, c):
    """``(x * c) mod 2**32`` for int64 tensors ``x`` in [0, 2**32) and a
    constant ``c`` < 2**32, without overflowing int64 (the uint32 wrap
    of the JAX sampler)."""
    lo = x * (c & 0xFFFF)
    hi = (x * (c >> 16)) & 0xFFFF
    return (lo + (hi << 16)) & _M32


# elements of one 8-byte temporary of the proposal sampling and screen (1
# GiB): a batch's clusters are sampled and screened as many at a time as
# fit, so that their memory does not grow with the batch
_SAMPLE_ELEMS = 1 << 27


def _sample(rb, c, m0):
    """Each cluster ``c`` (B,)'s largest priority over one shard's
    frames and the first local frame holding it, ``(B,)`` int64 each:
    the priority of a member (``m0`` (B, n)) is its random value ``rb``
    (n,) mixed with the cluster id, a non-member's 0. As many clusters
    at a time as keep a ``(rows, n)`` temporary within
    ``_SAMPLE_ELEMS``."""
    rows = max(1, _SAMPLE_ELEMS // max(1, rb.shape[0]))
    vals, args = [], []
    for lo in range(0, c.shape[0], rows):
        mixed = rb[None, :] ^ ((0x9E3779B9 * c[lo:lo + rows, None]) & _M32)
        prio = torch.where(m0[lo:lo + rows], _mul32(mixed, 0x85EBCA6B) | 1,
                           0)
        del mixed
        arg = torch.argmax(prio, dim=1)
        vals.append(prio.gather(1, arg[:, None])[:, 0])
        args.append(arg)
    return torch.cat(vals), torch.cat(args)


def _screen(m0, d1, d2, Dt, valid):
    """One shard's float64 sums of squares of each proposal's post-swap
    distances at batch start, ``(B,)``: members of the displaced medoid
    (``m0`` (B, n)) take ``min(d2, dnew)``, the others ``min(d1, dnew)``,
    ``dnew`` the proposal's row of ``Dt`` (B, n). As many rows at a time
    as keep a ``(rows, n)`` float64 copy within ``_SAMPLE_ELEMS``."""
    rows = max(1, _SAMPLE_ELEMS // max(1, Dt.shape[1]))
    sums = []
    for lo in range(0, Dt.shape[0], rows):
        D = Dt[lo:lo + rows]
        cand0 = torch.where(m0[lo:lo + rows], torch.minimum(d2[None, :], D),
                            torch.minimum(d1[None, :], D))
        sums.append(torch.where(valid[None, :], cand0 * cand0, 0.0).sum(
            dim=1, dtype=torch.float64))
    return torch.cat(sums)


def _read(*ts):
    """Device tensors to one flat list of host floats (exact for fp32
    values, bools and indices): one synchronising copy."""
    _pam_sweeps.n_host_syncs += 1
    flat = torch.cat([t.reshape(-1).to(torch.float64) for t in ts])
    with trace_region('enspara/pam.read'):
        return flat.cpu().tolist()


def _pam_sweeps(prep, d1, a1, medoid_inds, sweep_bits, bucket, batch=64,
                mesh=None):
    """PAM sweeps over ``prep``'s frames from the warm start ``(d1,
    a1)``, one per entry of ``sweep_bits``.

    On one device ``d1``/``a1`` are (n_pad,) float32/int32 on ``prep``'s
    device (inf and -1 past ``prep.n``); for a sharded ``prep`` they are
    lists of this process's (n_local,) per-shard tensors, and ``mesh``
    is the mesh ``prep`` was laid out for. ``medoid_inds`` (k,) int64
    global frame indices; ``sweep_bits`` yields one int64 tensor of
    random uint32 values per sweep, of which the first ``prep.n`` are
    used (the JAX module draws ``jax.random.bits(fold_in(key, s),
    (n_pad,), uint32)``). Returns ``(d1, a1, medoid_inds)`` in the form
    ``d1``/``a1`` came in.
    """
    sharded = isinstance(prep, (engine.ShardedRMSDFrames,
                                engine.ShardedFeatures))
    if sharded:
        if mesh is None or mesh.size != prep.n_shards:
            raise ValueError('sharded frames need the mesh they were laid '
                             'out for (%d shards)' % prep.n_shards)
        shards, n_local = prep.shards, prep.n_local
        first = prep.first_shard
    else:
        shards, n_local, first = (prep,), prep.n_pad, 0
        mesh = FrameMesh((prep.device,))
        d1, a1 = [d1], [a1]
    lead = mesh.lead
    S = range(len(shards))
    devs = [sh.device for sh in shards]
    starts = [(first + s) * n_local for s in S]
    n_valid = int(prep.n)
    n_pad = n_local * mesh.size
    valid = [torch.arange(starts[s], starts[s] + n_local, device=devs[s])
             < n_valid for s in S]
    # each shard's real frames, a prefix of it
    n_real = [min(n_local, max(0, n_valid - starts[s])) for s in S]
    # the commits update the state in place, never the caller's tensors
    d1, a1 = [t.clone() for t in d1], [t.clone() for t in a1]
    medoid_inds = torch.as_tensor(medoid_inds, dtype=torch.long,
                                  device=lead).clone()
    k = int(medoid_inds.shape[0])
    B = int(min(batch, k))
    n_batches = (k + B - 1) // B

    def block(cols, rows=None):
        if sharded:
            return engine._pairwise_block(prep, cols, rows, mesh)
        return [engine._pairwise_block(prep, cols,
                                       None if rows is None else rows[0])]

    def total(parts):
        """The sum over the mesh of per-shard float64 partials, on the
        lead device."""
        return mesh.reduce([p.to(torch.float64) for p in parts])

    def cost(parts):
        """Mean square distance from per-shard sums of squares, rounded
        to float32 as the JAX sweep's cost is."""
        return total(parts).float() / n_valid

    def sq_sums(ds):
        return [torch.where(valid[s], ds[s] * ds[s], 0.0).sum(
            dtype=torch.float64) for s in S]

    def evaluate(d2, a2, stale, dnew, cid):
        """The try's one host read: the counts that decide a repair
        (stale members of ``cid``, ``stale | unc``) over the mesh, and
        the post-swap cost as a device scalar and its host value."""
        tot = total([pam_try_eval(d1[s], a1[s], d2[s], a2[s], dnew[s],
                                  stale[s], cid, n_real[s]) for s in S])
        new_cost = tot[2].float() / n_valid
        n_ms, n_su, _, new_cost_h = _read(tot, new_cost)
        return n_ms, n_su, new_cost, new_cost_h

    # ---- the exact second-nearest cache from the warm start: chunked
    # (n, 64) blocks, running min over every medoid but a point's own
    C_CHUNK = int(min(64, k))
    n_chunks = (k + C_CHUNK - 1) // C_CHUNK
    minds_pad = torch.nn.functional.pad(medoid_inds,
                                        (0, n_chunks * C_CHUNK - k))
    d2 = [torch.full((n_local,), math.inf, device=dv) for dv in devs]
    a2 = [torch.full((n_local,), -1, dtype=torch.int32, device=dv)
          for dv in devs]
    for ci in range(n_chunks):
        cids = ci * C_CHUNK + torch.arange(C_CHUNK, dtype=torch.int32,
                                           device=lead)
        Ds = block(minds_pad[cids.long()])
        for s in S:
            c = cids.to(devs[s])
            invalid = (c[None, :] == a1[s][:, None]) | (c[None, :] >= k)
            cmin, carg = torch.where(invalid, math.inf, Ds[s]).min(dim=1)
            better = (cmin < d2[s]) & valid[s]
            d2[s] = torch.where(better, cmin, d2[s])
            a2[s] = torch.where(better, c[carg], a2[s])
        del Ds                 # before the next block is made

    def repair(a1, d2, a2, stale, medoid_inds):
        """One k-way re-rank restores (d2, a2) for every stale point of
        every shard; (d1, a1) are exact throughout and stay as they are.
        A shard's bucket holds its stale points, lowest index first,
        then filler."""
        with trace_region('enspara/pam.repair'):
            amb = [torch.argsort((~st).to(torch.int8), stable=True)[:bucket]
                   for st in stale]
            Ds = block(medoid_inds, rows=amb)
            d2, a2 = list(d2), list(a2)
            for s in S:
                idx = amb[s]
                amb_real = stale[s][idx]
                m = medoid_inds.to(devs[s])
                # self-distance clamp for bucketed medoid points
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
        """Shard ``s``'s ``(n, B)`` block ``D`` of the proposals
        ``p_idxs`` as ``(B, n)`` rows, each candidate's distance to
        itself 0 on the shard that owns it."""
        D = D.t().contiguous()
        li, own = owned_rows(p_idxs.to(devs[s]), n_local, first + s)
        r = torch.arange(B, device=devs[s])
        D[r, li] = torch.where(own, 0.0, D[r, li])
        return D

    cost_cur = cost(sq_sums(d1))
    for rbits in sweep_bits:
        # the sweep's n values, padded and cut into this process's shards
        rbits = torch.as_tensor(rbits).reshape(-1)[:n_valid].to(
            device=lead, dtype=torch.long)
        rbits = torch.nn.functional.pad(rbits, (0, n_pad - n_valid))
        rb = [rbits[starts[s]:starts[s] + n_local].to(devs[s]) for s in S]
        for bi in range(n_batches):
            with trace_region('enspara/pam.batch'):
                cids = bi * B + torch.arange(B, dtype=torch.long, device=lead)
                # a uniform member per cluster, all B clusters in (rows, n)
                # passes: the argmax of iid random priorities over a member
                # set is uniform on it; |1 keeps members above the 0 of
                # non-members. sampled_ok: the cluster had members.
                member0, pvals, pargs = [], [], []
                for s in S:
                    c = cids.to(devs[s])
                    m0 = (a1[s][None, :] == c[:, None]) & valid[s][None, :]
                    member0.append(m0)
                    v, a = _sample(rb[s], c, m0)
                    pvals.append(v)
                    pargs.append(a + starts[s])
                pmax, p_idxs = argmax_over_shards(pvals, pargs, mesh)
                sampled_ok = pmax > 0

                # one (n, B) block for the whole batch, then (B, n) rows; a
                # candidate's distance to itself is 0 by definition, set on
                # the shard that owns it
                Dt = [rows_of(s, D, p_idxs)
                      for s, D in zip(S, block(p_idxs))]

                # batch-start screen: exact post-swap cost of every proposal
                # at batch start, a pre-filter once accepts move the cache
                est0 = cost([_screen(member0[s], d1[s], d2[s], Dt[s], valid[s])
                             for s in S])
                vals = _read(cost_cur, est0, sampled_ok)
                cost_h = vals[0]
                est0_h, ok_h = vals[1:B + 1], vals[B + 1:]

                stale = [torch.zeros(n_local, dtype=torch.bool, device=dv)
                         for dv in devs]
                for b in range(B):
                    cid = bi * B + b
                    if not (est0_h[b] < cost_h and ok_h[b] and cid < k):
                        continue
                    with trace_region('enspara/pam.try'):
                        dnew = [Dt[s][b] for s in S]
                        n_ms, n_su, new_cost, new_cost_h = evaluate(
                            d2, a2, stale, dnew, cid)
                        # repair on demand: a stale member's d2 would make the
                        # post-swap d1 inexact, and an over-budget stale set
                        # could not be repaired later; the repair empties the
                        # stale set, so the second n_su counts unc alone
                        if n_ms > 0 or n_su > bucket:
                            d2, a2 = repair(a1, d2, a2, stale, medoid_inds)
                            stale = [torch.zeros_like(st) for st in stale]
                            _pam_sweeps.n_reevals += 1
                            n_ms, n_su, new_cost, new_cost_h = evaluate(
                                d2, a2, stale, dnew, cid)
                        if not (new_cost_h < cost_h and n_su <= bucket):
                            continue
                        # commit, in place; the new medoid is copied from
                        # the card (a host int written there would sync)
                        for s in S:
                            pam_try_commit(d1[s], a1[s], d2[s], a2[s],
                                           dnew[s], stale[s], cid, n_real[s])
                        medoid_inds[cid] = p_idxs[b]
                        cost_cur, cost_h = new_cost, new_cost_h

                # batch-end repair: the next batch starts from an exact cache
                if _read(total([st.sum() for st in stale]))[0] > 0:
                    d2, a2 = repair(a1, d2, a2, stale, medoid_inds)
                # nothing of this batch's block outlives it
                Dt = dnew = None
    if sharded:
        return d1, a1, medoid_inds
    return d1[0], a1[0], medoid_inds


# host reads of device scalars made by _pam_sweeps: two a batch, one a
# tried proposal, and one more for each try whose first evaluation an
# on-demand repair made stale (n_reevals)
_pam_sweeps.n_host_syncs = 0
_pam_sweeps.n_reevals = 0


def sweep_bits(seed, n_sweeps, n, device):
    """The random bits of each sweep: ``n`` uint32 values (as int64) per
    sweep from one ``torch.Generator`` seeded with ``seed`` on
    ``device``. Exactly ``n`` values whatever the layout's padding, so
    that a seed gives the same proposals on one device, on any mesh and
    in every process (a device's stream is not a prefix-stable function
    of the size it draws)."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    for _ in range(int(n_sweeps)):
        yield torch.randint(0, 2 ** 32, (int(n),), generator=gen,
                            dtype=torch.long, device=device)


def kmedoids_sweeps_device(X, metric, assignments, distances, medoid_inds,
                           n_sweeps=5, bucket_factor=8, seed=0, device=None,
                           proposal_batch=64, mesh=None):
    """Run ``n_sweeps`` device PAM sweeps from a warm start.

    Parameters
    ----------
    X : (n, d) features or (n, n_atoms, 3) coordinates (numpy or a
        tensor), or a container prepared for ``metric``
        (:class:`~enspara_tpu_torch.cluster.engine.PreparedFeatures`,
        :class:`~enspara_tpu_torch.cluster.engine.PreparedRMSDFrames`,
        or their sharded forms laid out for ``mesh``).
    metric : 'rmsd' | 'euclidean' | 'manhattan' | 'hamming'.
    assignments, distances : warm-start state (e.g. from k-centers).
    medoid_inds : (k,) current medoid frame indices.
    bucket_factor : ambiguous-bucket size in units of n/k.
    seed : seeds the ``torch.Generator`` that draws each sweep's random
        bits on the mesh's lead device (:func:`sweep_bits`; deterministic
        for a seed and device type, not jax's bits).
    device : where to run host (numpy) input; tensors and prepared
        containers run where they lie.
    proposal_batch : proposals per all-pairs block.
    mesh : a :class:`~enspara_tpu_torch.parallel.mesh.FrameMesh` to run
        the sweeps over its shards (not with ``device``); prepared
        frames laid out for another shard count raise ``ValueError``.
        With neither, host input runs over every visible card
        (:func:`~enspara_tpu_torch.parallel.mesh.frame_mesh`, the JAX
        function's default; one card is the one-device path), but frames
        of fewer than ``SMALL_JOB_FEATURES`` features (n_frames x
        features a frame) on the current card.

    Returns ``(medoid_inds, distances, assignments)`` as numpy arrays
    (on every process of a mesh that spans processes).
    """
    device, mesh = resolve_placement(X, device, mesh, small_job_rule=True)
    prep = engine._prepared(X, metric, device, mesh)
    sharded = isinstance(prep, (engine.ShardedRMSDFrames,
                                engine.ShardedFeatures))
    n, k = prep.n, len(medoid_inds)
    bucket = int(min(n, max(64, bucket_factor * ((n + k - 1) // k))))
    if sharded:
        shards, n_local, first = prep.shards, prep.n_local, prep.first_shard
        lead = mesh.lead
    else:
        shards, n_local, first = (prep,), prep.n_pad, 0
        lead = prep.device
    n_pad = n_local * (prep.n_shards if sharded else 1)

    d1 = np.full(n_pad, np.inf, np.float32)
    d1[:n] = distances
    a1 = np.full(n_pad, -1, np.int32)
    a1[:n] = assignments

    def local(a):
        return [torch.from_numpy(a[(first + s) * n_local:][:n_local].copy())
                .to(sh.device) for s, sh in enumerate(shards)]
    d1_l, a1_l = local(d1), local(a1)
    d1_out, a1_out, m_out = _pam_sweeps(
        prep, d1_l if sharded else d1_l[0], a1_l if sharded else a1_l[0],
        np.asarray(medoid_inds, dtype=np.int64),
        sweep_bits(seed, n_sweeps, n, lead), bucket,
        batch=int(proposal_batch), mesh=mesh if sharded else None)
    if sharded:
        d_out, a_out = host_fetch(d1_out, mesh), host_fetch(a1_out, mesh)
    else:
        d_out, a_out = d1_out.cpu().numpy(), a1_out.cpu().numpy()
    return (m_out.cpu().numpy().astype(np.int64),
            d_out[:n].astype(np.float64), a_out[:n].astype(np.int64))
