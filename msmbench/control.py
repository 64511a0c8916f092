"""Readings that set the limits of a cell's output check, on one card.

    python3 msmbench/control.py --workload <name> --mode <mode> --seeds <n> [<n> ...]

For each seed: the cell's set-up from that seed, then one job with the
random state of a window's first job, judged as a run judges it; prints
the judge's numbers a line a seed (``seed <n>: name=value ...``) and one
JSON line a seed on standard output. ``--mode``:

- ``program``: the program's own job (the lower readings);
- ``control``: the reference in the program's place, one precision
  down (the job kind's ``control``: TF32 products, a bfloat16 MSM) —
  the upper readings;
- ``pam-unchanged``: the program with its PAM sweeps returning their
  warm start unchanged (a planted fault).

A cell on several cards runs here on one card (``world`` 1): the
control and the judge hold all of its frames there. The benchmark's
runs never run this script.
"""

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from msmbench.harness import cli, spec  # noqa: E402
from msmbench.harness.trace import Spans  # noqa: E402


def _pam_unchanged():
    import importlib
    km = importlib.import_module('enspara_tpu_torch.cluster.engine_kmedoids')

    def unchanged(X, metric, assignments, distances, medoid_inds, **kw):
        return (np.asarray(medoid_inds, np.int64),
                np.asarray(distances, np.float64),
                np.asarray(assignments, np.int64))
    km.kmedoids_sweeps_device = unchanged


def main(argv=None):
    p = argparse.ArgumentParser(prog='msmbench/control.py')
    p.add_argument('--workload', required=True)
    p.add_argument('--mode', required=True,
                   choices=('program', 'control', 'pam-unchanged'))
    p.add_argument('--seeds', type=int, nargs='+', required=True)
    args = p.parse_args(argv)
    cli.require_program()
    bench = spec.load_benchmark()
    cell = spec.workload(bench, args.workload)
    cfg = spec.config(cell['config'])
    trf = spec.traffic(cell['traffic'])
    kind = spec.job_kind(trf['job'])
    device = cli.require_cards(1)
    card = cli.Card(device)
    if args.mode == 'pam-unchanged':
        _pam_unchanged()
    quiet = Spans(on=False)
    for seed in args.seeds:
        tick = time.time()
        ctx = cli.Context(cfg, trf, seed, device, quiet)
        state = kind.setup(ctx)
        rs = cli.job_random_state(seed, 1)
        if args.mode == 'control':
            out = kind.control(state, rs)
        else:
            kind.run(state, cli.job_random_state(seed, 0), quiet)
            out = kind.run(state, rs, quiet)
        card.sync()
        made = time.time() - tick
        card.free()
        nums = kind.numbers([kind.judge(state, out, ctx)])
        ok, _ = cli.verdict(nums, trf['limits'])
        print('seed %d (%s, job %.1f s, judge %.1f s): %s%s' % (
            seed, args.mode, made, time.time() - tick - made,
            ' '.join('%s=%.6g' % kv for kv in nums.items()),
            '' if ok else '  NOT CORRECT'), file=sys.stderr, flush=True)
        print(json.dumps({'workload': args.workload, 'mode': args.mode,
                          'seed': seed, 'correct': bool(ok),
                          'numbers': nums}), flush=True)
        del state, out
        card.free()
    return 0


if __name__ == '__main__':
    sys.exit(main())
