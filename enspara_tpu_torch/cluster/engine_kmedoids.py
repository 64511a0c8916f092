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
``n_host_syncs`` counts those reads.
"""

import math

import numpy as np
import torch

from . import engine

__all__ = ['kmedoids_sweeps_device']

_M32 = 0xFFFFFFFF


def _mul32(x, c):
    """``(x * c) mod 2**32`` for int64 tensors ``x`` in [0, 2**32) and a
    constant ``c`` < 2**32, without overflowing int64 (the uint32 wrap
    of the JAX sampler)."""
    lo = x * (c & 0xFFFF)
    hi = (x * (c >> 16)) & 0xFFFF
    return (lo + (hi << 16)) & _M32


def _read(*ts):
    """Device tensors to one flat list of host floats (exact for fp32
    values, bools and indices): one synchronising copy."""
    _pam_sweeps.n_host_syncs += 1
    return torch.cat([t.reshape(-1).to(torch.float64) for t in ts]) \
        .cpu().tolist()


def _pam_sweeps(prep, d1, a1, medoid_inds, sweep_bits, bucket, batch=64):
    """PAM sweeps over ``prep``'s frames from the warm start ``(d1,
    a1)``, one per entry of ``sweep_bits``.

    ``d1``/``a1`` are (n_pad,) float32/int32 on ``prep``'s device (inf
    and -1 past ``prep.n``); ``medoid_inds`` (k,) int64 frame indices;
    ``sweep_bits`` yields one (n_pad,) int64 tensor of random uint32
    values per sweep (the JAX module draws ``jax.random.bits(fold_in(
    key, s), (n_pad,), uint32)``). Returns ``(d1, a1, medoid_inds)``.
    """
    dev = prep.device
    n_pad = prep.n_pad
    valid = torch.arange(n_pad, device=dev) < prep.n
    n_valid = int(prep.n)
    medoid_inds = torch.as_tensor(medoid_inds, dtype=torch.long,
                                  device=dev).clone()
    k = int(medoid_inds.shape[0])
    B = int(min(batch, k))
    n_batches = (k + B - 1) // B
    inf = torch.tensor(math.inf, device=dev)

    def cost(d):
        return torch.where(valid, d * d, 0.0).sum() / n_valid

    # ---- the exact second-nearest cache from the warm start: chunked
    # (n, 64) blocks, running min over every medoid but a point's own
    C_CHUNK = int(min(64, k))
    n_chunks = (k + C_CHUNK - 1) // C_CHUNK
    minds_pad = torch.nn.functional.pad(medoid_inds,
                                        (0, n_chunks * C_CHUNK - k))
    d2 = torch.full((n_pad,), math.inf, device=dev)
    a2 = torch.full((n_pad,), -1, dtype=torch.int32, device=dev)
    for ci in range(n_chunks):
        cids = ci * C_CHUNK + torch.arange(C_CHUNK, dtype=torch.int32,
                                           device=dev)
        D = engine._pairwise_block(prep, minds_pad[cids.long()])
        invalid = (cids[None, :] == a1[:, None]) | (cids[None, :] >= k)
        cmin, carg = torch.where(invalid, inf, D).min(dim=1)
        better = (cmin < d2) & valid
        d2 = torch.where(better, cmin, d2)
        a2 = torch.where(better, cids[carg], a2)

    def repair(d2, a2, stale, medoid_inds):
        """One k-way re-rank restores (d2, a2) for every stale point;
        (d1, a1) are exact throughout and stay as they are. The bucket
        holds the stale points, lowest index first, then filler."""
        amb_idx = torch.argsort((~stale).to(torch.int8), stable=True)[:bucket]
        amb_real = stale[amb_idx]
        d_amb = engine._pairwise_block(prep, medoid_inds, rows=amb_idx)
        # self-distance clamp for bucketed medoid points
        d_amb = torch.where(amb_idx[:, None] == medoid_inds[None, :], 0.0,
                            d_amb)
        hide = (torch.arange(k, device=dev)[None, :]
                == a1[amb_idx][:, None])
        b_d2, b_a2 = torch.where(hide, inf, d_amb).min(dim=1)
        d2 = d2.clone()
        a2 = a2.clone()
        d2[amb_idx] = torch.where(amb_real, b_d2, d2[amb_idx])
        a2[amb_idx] = torch.where(amb_real, b_a2.to(torch.int32),
                                  a2[amb_idx])
        return d2, a2

    cost_cur = cost(d1)
    for rbits in sweep_bits:
        rbits = rbits.to(device=dev, dtype=torch.long)
        for bi in range(n_batches):
            cids = bi * B + torch.arange(B, dtype=torch.long, device=dev)
            # a uniform member per cluster, all B clusters in one (B, n)
            # pass: the argmax of iid random priorities over a member
            # set is uniform on it; |1 keeps members above the 0 of
            # non-members. sampled_ok: the cluster had members.
            member0 = (a1[None, :] == cids[:, None]) & valid[None, :]
            mixed = rbits[None, :] ^ ((0x9E3779B9 * cids[:, None]) & _M32)
            mixed = _mul32(mixed, 0x85EBCA6B)
            prio = torch.where(member0, mixed | 1, 0)
            p_idxs = torch.argmax(prio, dim=1)
            sampled_ok = prio.amax(dim=1) > 0

            # one (n, B) block for the whole batch, then (B, n) rows; a
            # candidate's distance to itself is 0 by definition
            Dt = engine._pairwise_block(prep, p_idxs).t().contiguous()
            Dt[torch.arange(B, device=dev), p_idxs] = 0.0

            # batch-start screen: exact post-swap cost of every proposal
            # at batch start, a pre-filter once accepts move the cache
            cand0 = torch.where(member0, torch.minimum(d2[None, :], Dt),
                                torch.minimum(d1[None, :], Dt))
            est0 = torch.where(valid[None, :], cand0 * cand0, 0.0) \
                .sum(dim=1) / n_valid
            vals = _read(cost_cur, est0, sampled_ok, p_idxs)
            cost_h = vals[0]
            est0_h, ok_h = vals[1:B + 1], vals[B + 1:2 * B + 1]
            p_idx_h = [int(v) for v in vals[2 * B + 1:]]

            stale = torch.zeros(n_pad, dtype=torch.bool, device=dev)
            for b in range(B):
                cid = bi * B + b
                if not (est0_h[b] < cost_h and ok_h[b] and cid < k):
                    continue
                dnew = Dt[b]
                members = (a1 == cid) & valid
                # repair on demand: a stale member's d2 would make the
                # post-swap d1 inexact, and an over-budget stale set
                # could not be repaired later
                unc_bound = (members | (a2 == cid)) & (dnew > d2) & valid
                need = _read((members & stale).any()
                             | ((stale | unc_bound).sum() > bucket))[0]
                if need:
                    d2, a2 = repair(d2, a2, stale, medoid_inds)
                    stale = torch.zeros_like(stale)

                cand_d1 = torch.where(members, torch.minimum(d2, dnew),
                                      torch.minimum(d1, dnew))
                new_cost = cost(cand_d1)
                uncertain = (members | (a2 == cid)) & (dnew > d2) & valid
                new_stale = stale | uncertain
                new_cost_h, n_stale = _read(new_cost, new_stale.sum())
                if not (new_cost_h < cost_h and n_stale <= bucket):
                    continue

                # commit: d1/a1 exact in every case; d2/a2 exact unless
                # flagged stale, upper bounds until the next repair
                in1, in2 = dnew < d1, dnew < d2
                caseB = a1 == cid        # nearest displaced
                caseC = a2 == cid        # second-nearest displaced
                w = torch.where
                na1 = w(caseB, w(in2, cid, a2), w(in1, cid, a1))
                nd2 = w(caseB, torch.maximum(dnew, d2),
                        w(caseC, torch.maximum(dnew, d1),
                          w(in1, d1, w(in2, dnew, d2))))
                na2 = w(caseB, w(in2, a2, cid),
                        w(caseC, w(in1, a1, cid),
                          w(in1, a1, w(in2, cid, a2))))
                d1 = w(valid, cand_d1, inf)
                a1 = w(valid, na1, -1).to(torch.int32)
                d2 = w(valid, nd2, inf)
                a2 = w(valid, na2, -1).to(torch.int32)
                medoid_inds[cid] = p_idx_h[b]
                cost_cur, cost_h = new_cost, new_cost_h
                stale = new_stale

            # batch-end repair: the next batch starts from an exact cache
            if _read(stale.any())[0]:
                d2, a2 = repair(d2, a2, stale, medoid_inds)
    return d1, a1, medoid_inds


# host reads of device scalars made by _pam_sweeps (one per lax.cond
# of the JAX sweep that had to be decided on the host, plus one per batch)
_pam_sweeps.n_host_syncs = 0


def kmedoids_sweeps_device(X, metric, assignments, distances, medoid_inds,
                           n_sweeps=5, bucket_factor=8, seed=0, device=None,
                           proposal_batch=64):
    """Run ``n_sweeps`` device PAM sweeps from a warm start.

    Parameters
    ----------
    X : (n, d) features or (n, n_atoms, 3) coordinates (numpy or a
        tensor), or a one-device container prepared for ``metric``
        (:class:`~enspara_tpu_torch.cluster.engine.PreparedFeatures`,
        :class:`~enspara_tpu_torch.cluster.engine.PreparedRMSDFrames`).
    metric : 'rmsd' | 'euclidean' | 'manhattan' | 'hamming'.
    assignments, distances : warm-start state (e.g. from k-centers).
    medoid_inds : (k,) current medoid frame indices.
    bucket_factor : ambiguous-bucket size in units of n/k.
    seed : seeds the ``torch.Generator`` that draws each sweep's random
        bits (deterministic for a seed and device; not jax's bits).
    device : where to run host (numpy) input; tensors run where they lie.
    proposal_batch : proposals per all-pairs block.

    Returns ``(medoid_inds, distances, assignments)`` as numpy arrays.
    """
    prep = engine._prepared(X, metric, device)
    dev = prep.device
    n, n_pad = prep.n, prep.n_pad
    k = len(medoid_inds)
    bucket = int(min(n, max(64, bucket_factor * ((n + k - 1) // k))))

    d1 = np.full(n_pad, np.inf, np.float32)
    d1[:n] = distances
    a1 = np.full(n_pad, -1, np.int32)
    a1[:n] = assignments
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    sweep_bits = (torch.randint(0, 2 ** 32, (n_pad,), generator=gen,
                                dtype=torch.long, device=dev)
                  for _ in range(int(n_sweeps)))
    d1_out, a1_out, m_out = _pam_sweeps(
        prep, torch.from_numpy(d1).to(dev), torch.from_numpy(a1).to(dev),
        np.asarray(medoid_inds, dtype=np.int64), sweep_bits, bucket,
        batch=int(proposal_batch))
    return (m_out.cpu().numpy().astype(np.int64),
            d1_out[:n].cpu().numpy().astype(np.float64),
            a1_out[:n].cpu().numpy().astype(np.int64))
