#!/usr/bin/env python3
"""The clash test and the dye chains' equilibrium solve of
enspara_tpu_torch's explicit-dye route, timed on one GPU at
``chip_smoke.py``'s phase-15 size, for one checkout or several.

Run from the root of a checkout, with one CUDA card visible:

    python3 chip_bench_dyes.py [ROOT ...]

Each ROOT (default: this checkout) is the root of a checkout of the
repository. Each is timed in a process of its own, in the order given, so
that two versions compare within one call (parent, change, change,
parent). Each process builds phase 15's inputs with that checkout's
``chip_smoke.py`` (the 2,000 globule centers, the synthetic dyes of 500
conformations, the residue pair of ``dye_sites``) and times:

- ``clash``: ``dyes_from_expt_dist._untouched_frames`` on every placed
  dye frame of every center, a center's frames as one cloud, both dyes
  (2.84e11 (dye atom, protein atom) tests): once on 8 centers to warm up,
  then twice in full, with a hash of the masks;
- ``cloud_prune``: the same function's time inside phase 13d's
  ``dye_distance_distribution`` (SF488/SF594 over the 2,000 centers, its
  first residue pair), twice;
- ``normalize``, ``eq_probs_dense`` and ``eq_probs_csr``: per call, over
  the dye chains of the first ``N_CHAINS`` centers of both dyes as
  ``make_dye_msm`` prunes them: ``builders.normalize`` of the counts, and
  ``transition_matrices.eq_probs`` of its T given as a numpy array and as
  a CSR matrix (median and mean seconds), with a hash of the pi.

The card's name and power limit come first; one JSON line a ROOT follows.
"""

import hashlib
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

N_CHAINS = 50


def _sha(*arrays):
    h = hashlib.sha256()
    for a in arrays:
        h.update(a.tobytes())
    return h.hexdigest()[:16]


def _per_call(fn, args):
    out, times = [], []
    for a in args:
        t = time.perf_counter()
        out.append(fn(a))
        times.append(time.perf_counter() - t)
    return out, {'median_s': statistics.median(times),
                 'mean_s': statistics.fmean(times), 'calls': len(times)}


def one(root):
    sys.path.insert(0, root)
    import numpy as np
    import scipy.sparse
    import torch

    import chip_smoke as cs
    from enspara_tpu_torch import io as port_io
    from enspara_tpu_torch.geometry import dyes_from_expt_dist as dyefs
    from enspara_tpu_torch.geometry import explicit_r0_calc as r0c
    from enspara_tpu_torch.msm import builders
    from enspara_tpu_torch.msm import transition_matrices as tm

    for m in (cs, tm):
        assert os.path.abspath(m.__file__).startswith(root + os.sep), m
    device = cs.require_cuda()
    untouched = dyefs._untouched_frames
    spent = []

    def timed_untouched(*args):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = untouched(*args)
        torch.cuda.synchronize()
        spent.append(time.perf_counter() - t)
        return out

    res = {'root': root}
    top = cs.lys_topology(cs.Topology, cs.GLOB_RES)
    xyz, _, groups = cs.globule_frames(cs.globule(cs.GLOB_RES),
                                       cs.SASA_FRAMES, seed=14)
    traj = cs.Trajectory(xyz, top)
    n = len(traj)
    exclude = np.concatenate(groups)

    # phase 13d's pruning inside dye_distance_distribution
    d1, d2 = dyefs.load_dye('SF488'), dyefs.load_dye('SF594')
    pair13 = cs.label_sites(traj, cs.FRET_PAIRS, exclude)[0]
    dyefs._untouched_frames = timed_untouched
    try:
        res['cloud_prune_s'] = []
        for _ in range(2):
            spent.clear()
            dyefs.dye_distance_distribution(traj, d1, d2, pair13, n_procs=8)
            res['cloud_prune_s'].append(sum(spent))
    finally:
        dyefs._untouched_frames = untouched

    with tempfile.TemporaryDirectory() as d:
        lib = cs.explicit_dye_library(d, 20)
        os.environ['ENSPARA_TPU_DYE_DIR'] = d
        pair = cs.dye_sites(traj, exclude, lib, device)
        meta = r0c.load_library()
        res['pair'] = pair.tolist()
        res['clash_s'], res['clash_tests'], masks = [], 0, []
        res['kept_share'] = []
        chains = []
        for k, (name, dcd, pdb, cnt) in enumerate(lib.values()):
            dye = port_io.load(dcd, top=pdb)
            sel_d, sel_p = r0c._site_selections(traj[0], dye, int(pair[k]),
                                                name, meta)
            atoms, clearance = r0c._clearance(traj[0], int(pair[k]), 0.04)
            with ThreadPoolExecutor(max_workers=8) as pool:
                placed = np.stack(list(pool.map(
                    lambda i: r0c._kabsch(dye.xyz, traj.xyz[i][sel_p],
                                          sel_d), range(n))))
            C, F, na = placed.shape[:3]
            clouds = placed.reshape(C, F * na, 3)
            prot = traj.xyz[:, atoms]
            untouched(clouds[:8], prot[:8], clearance, device)
            times = []
            for _ in range(2):
                torch.cuda.synchronize()
                t = time.perf_counter()
                mask = untouched(clouds, prot, clearance, device)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t)
            res['clash_s'].append(times)
            res['clash_tests'] += C * F * na * len(atoms)
            masks.append(mask)
            counts = np.load(cnt)
            clear = mask.reshape(C, F, na).sum(-1)
            res['kept_share'].append(float((clear >= na - 6).mean()))
            for c in range(N_CHAINS):
                keep = np.where(clear[c] >= na - 6)[0]
                if len(keep):
                    chains.append(r0c.remove_bad_states(
                        np.setdiff1d(np.arange(F), keep), counts))
        res['masks_sha'] = _sha(*masks)

    out, res['normalize'] = _per_call(
        lambda c: builders.normalize(c, calculate_eq_probs=True), chains)
    Ts = [np.asarray(o[1].toarray() if scipy.sparse.issparse(o[1])
                     else o[1]) for o in out]
    pis, res['eq_probs_dense'] = _per_call(tm.eq_probs, Ts)
    res['pi_dense_sha'] = _sha(*[np.asarray(p) for p in pis])
    csrs = [scipy.sparse.csr_matrix(T) for T in Ts]
    pis, res['eq_probs_csr'] = _per_call(tm.eq_probs, csrs)
    res['pi_csr_sha'] = _sha(*[np.asarray(p) for p in pis])
    res['chain_states'] = [int((T.sum(1) > 0).sum()) for T in Ts[:4]]
    print('BENCH ' + json.dumps(res), flush=True)


def main():
    if len(sys.argv) > 2 and sys.argv[1] == '--one':
        one(os.path.abspath(sys.argv[2]))
        return
    card = subprocess.run(
        ['nvidia-smi', '-i', '0', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    print('card:', card, flush=True)
    roots = [os.path.abspath(r) for r in sys.argv[1:]] or [
        os.path.dirname(os.path.abspath(__file__))]
    rc = 0
    for root in roots:
        r = subprocess.run([sys.executable, os.path.abspath(__file__),
                            '--one', root], cwd=root)
        rc = rc or r.returncode
    sys.exit(rc)


if __name__ == '__main__':
    main()
