"""The look behind a k-centers job whose farthest-first picks the judge
refuses (``kcenters_pick_gap``), on one card.

    python3 msmbench/witness.py --workload <name> --cases <seed>:<job> ...

For each case: the cell's frames from ``seed`` (in host memory, as the
cell holds them), ``KCenters(random_first_center=True)`` of the program
on one card with job ``job``'s random state (the picks do not depend on
how the frames are sharded: each distance is one pair's), the judge's
pick check, and at the worst pick ``c_i`` and the frame ``f`` that is
truly farthest from the earlier centers, each one's distance to its
nearest earlier center by four methods:

- the reference (float64 QCP, Newton to convergence);
- Kabsch's SVD in float64 (numpy), a witness independent of QCP;
- the program's plain QCP (``enspara_tpu_torch.ops.qcp.rmsd``, float32,
  the kernels' arithmetic);
- float64 QCP with the kernels' Newton scheme (12 steps from ``u = 1``),
  which tells the scheme's error from float32's.

The benchmark's runs never run this script.
"""

import argparse
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from msmbench.harness import cli, spec  # noqa: E402
from msmbench.data import basins  # noqa: E402
from msmbench.reference import kcenters as ref_kc  # noqa: E402
from msmbench.reference.qcp import Frames, center, rmsd_block  # noqa: E402

KERNEL_STEPS = 12


def kabsch(a, b):
    a = a - a.mean(0)
    b = b - b.mean(0)
    U, s, Vt = np.linalg.svd(a.T @ b)
    s[-1] *= np.sign(np.linalg.det(U @ Vt))
    return float(np.sqrt(max(0.0, ((a * a).sum() + (b * b).sum()
                                   - 2 * s.sum()) / len(a))))


def nearest_earlier(fr, frame, centers):
    d = rmsd_block(fr.x[[frame]], fr.g[[frame]], fr.x[centers],
                   fr.g[centers])[0]
    j = int(torch.argmin(d))
    return int(centers[j]), float(d[j])


def main(argv=None):
    p = argparse.ArgumentParser(prog='msmbench/witness.py')
    p.add_argument('--workload', required=True)
    p.add_argument('--cases', nargs='+', required=True)
    args = p.parse_args(argv)
    cli.require_program()
    from enspara_tpu_torch.cluster import KCenters
    from enspara_tpu_torch.ops.qcp import rmsd as program_rmsd
    bench = spec.load_benchmark()
    cell = spec.workload(bench, args.workload)
    cfg = spec.config(cell['config'])
    device = cli.require_cards(1)
    k = cfg['cluster']['n_clusters']
    for case in args.cases:
        seed, job = (int(x) for x in case.split(':'))
        n, A = cfg['n_frames'], cfg['n_atoms']
        X = np.empty((n, A, 3), np.float32)
        basins.frames(seed, n, A, **cfg['assumed']['generator'],
                      device=device, out=torch.from_numpy(X))
        rs = cli.job_random_state(seed, job)
        res = KCenters(metric='rmsd', n_clusters=k, random_first_center=True,
                       random_state=rs, device=device).fit(X).result_
        centers = np.asarray(res.center_indices, np.int64)
        fr = Frames(torch.from_numpy(X).to(device))
        cx, cg = fr.x[centers], fr.g[centers]
        part = ref_kc.judge_stripe(fr, 0, (centers, cx, cg),
                                   res.assignments, res.distances)
        M = np.asarray(part['pick_max'])
        v = np.asarray(part['pick_val'])
        gaps = M[1:] - v[1:]
        i = int(np.argmax(gaps)) + 1
        print('case %s: pick_gap %.6g at step %d; steps over 1e-4: %s'
              % (case, gaps.max(), i,
                 (np.flatnonzero(gaps > 1e-4) + 1).tolist()[:20]),
              flush=True)
        earlier = torch.as_tensor(centers[:i], device=device)
        best, far = -1.0, -1
        for lo in range(0, n, 1 << 14):
            D = rmsd_block(fr.x[lo:lo + (1 << 14)], fr.g[lo:lo + (1 << 14)],
                           fr.x[earlier], fr.g[earlier]).min(dim=1).values
            j = int(torch.argmax(D))
            if float(D[j]) > best:
                best, far = float(D[j]), lo + j
        for name, f in (('program pick c_%d' % i, int(centers[i])),
                        ('farthest frame', far)):
            c, d_ref = nearest_earlier(fr, f, earlier)
            d_kabsch = kabsch(X[f].astype(np.float64),
                              X[c].astype(np.float64))
            d_prog = float(program_rmsd(torch.from_numpy(X[[f]]),
                                        torch.from_numpy(X[c]))[0])
            xf, gf = center(torch.from_numpy(X[[f]]))
            xc, gc = center(torch.from_numpy(X[[c]]))
            d_steps = float(rmsd_block(xf, gf, xc, gc,
                                       fixed_steps=KERNEL_STEPS)[0, 0])
            print('  %s: frame %d, nearest earlier center %d: msd by the '
                  'reference %.9f, Kabsch %.9f, the program\'s plain QCP '
                  '%.9f, float64 QCP in 12 steps from u=1 %.9f'
                  % (name, f, c, d_ref ** 2, d_kabsch ** 2, d_prog ** 2,
                     d_steps ** 2), flush=True)
        del fr
        torch.cuda.empty_cache()
    return 0


if __name__ == '__main__':
    sys.exit(main())
