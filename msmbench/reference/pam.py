"""Plain PAM sweeps with the program's documented proposal rule, for the
k-hybrid cell's reference.

The k-hybrid estimator refines k-centers with ``kmedoids_updates``
sweeps. A sweep visits the medoids in batches of 64; at the start of a
batch each cluster's proposal is the member (as of the batch start) of
largest priority ``(mix(bits[f] ^ (0x9E3779B9 * cid)) * 0x85EBCA6B) | 1``
(uint32 arithmetic), ``bits`` the sweep's ``n`` random uint32 values
drawn from one ``torch.Generator`` seeded with the sweep seed on the
frames' device, so a uniform member. A proposal is screened against its
post-swap cost at the batch start and accepted, in turn, where the
post-swap mean square distance is below the current one. Costs are sums
of float32 squares in float64, rounded to float32 and divided by ``n``.

This module keeps every frame's distance to every medoid (the ``(n, k)``
columns in float64), so each post-swap cost is exact; decisions read
the distances rounded to float32, as the program's are.
"""

import torch

M32 = 0xFFFFFFFF


def _mul32(x, c):
    lo = x * (c & 0xFFFF)
    hi = (x * (c >> 16)) & 0xFFFF
    return (lo + (hi << 16)) & M32


def _cost(d32, n):
    return ((d32 * d32).sum(dtype=torch.float64).float() / n)


def _top2(D32):
    vals, args = torch.topk(D32, 2, dim=1, largest=False, sorted=True)
    return vals[:, 0], args[:, 0], vals[:, 1], args[:, 1]


def sweeps(frames, columns, medoids, seed, n_sweeps, batch=64,
           bucket_factor=8):
    """PAM sweeps over ``frames`` (a :class:`~.qcp.Frames`) from the
    medoids ``medoids`` (k,) whose float64 distance columns are
    ``columns`` (n, k), updated in place. Returns the final medoid
    indices (a list)."""
    n, k = columns.shape
    dev = columns.device
    medoids = [int(m) for m in medoids]
    bucket = int(min(n, max(64, bucket_factor * ((n + k - 1) // k))))
    D32 = columns.float()
    d1, a1, d2, a2 = _top2(D32)
    cost = float(_cost(d1, n))
    B = int(min(batch, k))
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    for _ in range(int(n_sweeps)):
        rb = torch.randint(0, 2 ** 32, (n,), generator=gen,
                           dtype=torch.long, device=dev)
        for bi in range((k + B - 1) // B):
            cids = bi * B + torch.arange(B, dtype=torch.long, device=dev)
            m0 = a1[None, :] == cids[:, None]
            mixed = rb[None, :] ^ ((0x9E3779B9 * cids[:, None]) & M32)
            prio = torch.where(m0, _mul32(mixed, 0x85EBCA6B) | 1, 0)
            pidx = torch.argmax(prio, dim=1)
            ok = prio.gather(1, pidx[:, None])[:, 0] > 0
            Dt = frames.rmsd(slice(None), pidx)
            Dt[pidx, torch.arange(B, device=dev)] = 0.0
            Dt32 = Dt.float()
            cand0 = torch.where(m0.T, torch.minimum(d2[:, None], Dt32),
                                torch.minimum(d1[:, None], Dt32))
            est0 = ((cand0 * cand0).sum(dim=0, dtype=torch.float64).float()
                    / n).tolist()
            ok, pidx_h = ok.tolist(), pidx.tolist()
            for b in range(B):
                cid = bi * B + b
                if not (est0[b] < cost and ok[b] and cid < k):
                    continue
                dnew = Dt32[:, b]
                members = a1 == cid
                touched = members | (a2 == cid)
                cand = torch.where(members, torch.minimum(d2, dnew),
                                   torch.minimum(d1, dnew))
                new_cost, n_unc = torch.stack((
                    _cost(cand, n).double(),
                    (touched & (dnew > d2)).sum().double())).tolist()
                if not (new_cost < cost and n_unc <= bucket):
                    continue
                columns[:, cid] = Dt[:, b]
                D32[:, cid] = dnew
                medoids[cid] = pidx_h[b]
                cost = new_cost
                # rows whose nearest or second nearest was cid: ranked
                # again; the others take the new column as a candidate
                in1, in2 = dnew < d1, dnew < d2
                nd1 = torch.where(in1, dnew, d1)
                na1 = torch.where(in1, cid, a1)
                nd2 = torch.where(in1, d1, torch.where(in2, dnew, d2))
                na2 = torch.where(in1, a1, torch.where(in2, cid, a2))
                rows = torch.nonzero(touched)[:, 0]
                if rows.numel():
                    r1, q1, r2, q2 = _top2(D32[rows])
                    nd1[rows], na1[rows] = r1, q1
                    nd2[rows], na2[rows] = r2, q2
                d1, a1, d2, a2 = nd1, na1, nd2, na2
    return medoids
