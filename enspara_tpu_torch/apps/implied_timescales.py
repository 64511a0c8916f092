"""`implied_timescales` app: implied-timescale scan + plot (counterpart of
``enspara_tpu/apps/implied_timescales.py``, same flags; reference:
enspara/apps/implied_timescales.py).

    python -m enspara_tpu_torch.apps.implied_timescales \\
        --assignments assig.h5 --out its.npy --plot its.png

It runs on the CUDA devices; ``ENSPARA_TPU_PLATFORM=cpu`` runs it on the
CPU. On the cards, the transpose builder without ``--trim`` on gap-free
assignments takes one batched solve over every lag, the lag axis split
over every visible card as the JAX app splits it over the chips;
otherwise the lags fan out over the host.
"""

import argparse
import logging
import sys

import numpy as np

from .. import exception
from .. import ra
from ..msm import builders
from ..msm.eigen_device import implied_timescales_batched
from ..msm.timescales import implied_timescales
from ..parallel.mesh import resolve_placement
from ..util.backend import select_device

logger = logging.getLogger(__name__)


def prior_counts(C):
    """(reference: apps/implied_timescales.py:81)"""
    return builders.normalize(C, prior_counts=1 / C.shape[0])


def process_command_line(argv):
    parser = argparse.ArgumentParser(
        prog='implied',
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)

    parser.add_argument(
        '--assignments', required=True,
        help='File containing assignments to states.')
    parser.add_argument(
        '--n-eigenvalues', default=5, type=int,
        help='Number of eigenvalues to compute for each lag time.')
    parser.add_argument(
        '--lag-times', default='5:100:2',
        help='Lag times (frames), as min:max:step.')
    parser.add_argument(
        '--symmetrization', default='transpose',
        choices=['transpose', 'row_normalize', 'prior_counts'],
        help='Estimator used to fit transition probabilities.')
    parser.add_argument(
        '--trj-ids', default=None,
        help='Only use given trajectory ids (as a slice min:max).')
    parser.add_argument(
        '--trim', default=False, action='store_true',
        help='Turn ergodic trimming on.')
    parser.add_argument(
        '--processes', default=None, type=int,
        help='Lag times to compute in parallel.')
    parser.add_argument(
        '--timestep', default=None, type=float,
        help='Frames per nanosecond, to scale axes to physical units.')
    parser.add_argument(
        '--infer-timestep', default=None,
        help='Trajectory from which to infer frames->ns conversion.')
    parser.add_argument(
        '--plot', default=None,
        help='Path for the implied timescales plot.')
    parser.add_argument(
        '--out', default=None,
        help='Path for the implied timescales values (npy).')
    parser.add_argument(
        '--logscale', action='store_true',
        help='Log-scale y axis.')

    args = parser.parse_args(argv[1:])

    args.lag_times = range(*map(int, args.lag_times.split(':')))
    if args.trj_ids is not None:
        args.trj_ids = slice(*map(int, args.trj_ids.split(':')))

    if args.symmetrization == 'prior_counts':
        args.symmetrization = prior_counts
    elif args.symmetrization == 'row_normalize':
        args.symmetrization = builders.normalize
    else:
        args.symmetrization = getattr(builders, args.symmetrization)
    return args


def process_units(timestep=None, infer_timestep=None):
    """(reference: apps/implied_timescales.py:85)"""
    if timestep and infer_timestep:
        raise exception.ImproperlyConfigured(
            'Only one of --timestep and --infer-timestep can be '
            'supplied.')
    if timestep:
        return timestep, 'ns'
    if infer_timestep:
        from ..io import load as io_load
        try:
            trj = io_load(infer_timestep)
            # like the reference (apps/implied_timescales.py:116-120),
            # inspect only the leading frames: XTC stores time as
            # float32, so late-trajectory timestamps carry rounding
            # wobble that would spuriously fail a global equality check
            timesteps = np.diff(trj.time[:10])
        except Exception:
            raise exception.ImproperlyConfigured(
                "Couldn't infer timestep from %s" % infer_timestep)
        if timesteps.size == 0:
            raise exception.ImproperlyConfigured(
                '%s has fewer than 2 frames; cannot infer a timestep'
                % infer_timestep)
        if not np.allclose(timesteps, timesteps[0], atol=1e-3):
            raise exception.ImproperlyConfigured(
                'timestep wobbles across %s (%s); pass --timestep '
                'explicitly' % (infer_timestep, timesteps))
        return 1000 / float(timesteps[0]), 'ns'
    return 1, 'frames'


def _batched_device(device):
    """Whether ``device`` takes the batched solve: a CUDA device (in place
    of the JAX package's TPU-backend check)."""
    return device.type == 'cuda'


def _timescales_dispatch(assignments, args, device, mesh=None):
    """Pick the batched device path when it is exactly applicable
    (transpose builder, no trim, gap-free assignments, a CUDA device);
    otherwise the host per-lag fan-out. The batched path runs every
    lag's counting + builder + ``eigvalsh`` in one (n_lags, n, n) fp32
    stack on ``device``, or with the lags split over the shards of
    ``mesh``."""
    eligible = (args.symmetrization is builders.transpose
                and not args.trim
                and _batched_device(device if mesh is None else mesh.lead))
    if eligible:
        data = assignments._data if hasattr(assignments, '_data') \
            else np.asarray(assignments)
        eligible = not (np.asarray(data) == -1).any()
    if eligible:
        logger.info('using batched device timescales (%d lags in one '
                    'solve on %s)', len(args.lag_times),
                    device if mesh is None else mesh)
        return implied_timescales_batched(
            assignments, args.lag_times, n_times=args.n_eigenvalues,
            sliding_window=True, device=device, mesh=mesh)
    return implied_timescales(
        assignments, args.lag_times, n_times=args.n_eigenvalues,
        sliding_window=True, trim=args.trim,
        method=args.symmetrization, n_procs=args.processes)


def load_assignments(args):
    """``--assignments``, cut to ``--trj-ids``."""
    assignments = ra.load(args.assignments)
    if args.trj_ids is not None:
        assignments = assignments[args.trj_ids]
    return assignments


def run(assignments, args, device=None, mesh=None):
    """The timescales of ``assignments`` at every lag of ``args`` on
    ``device`` or over ``mesh`` (default: every visible card, one card
    the one-device path; see
    :func:`~enspara_tpu_torch.parallel.mesh.resolve_placement`), written
    to ``--out`` and plotted to ``--plot`` when given; returns them."""
    device, mesh = resolve_placement(assignments, device, mesh)
    tscales = _timescales_dispatch(assignments, args, device, mesh)

    unit_factor, unit_str = process_units(args.timestep,
                                          args.infer_timestep)

    if args.out:
        np.save(args.out, tscales)

    if args.plot:
        import matplotlib
        matplotlib.use('Agg')
        from matplotlib import pyplot as plt

        lag_times = np.array(args.lag_times) / unit_factor
        scaled = tscales / unit_factor
        for i in range(min(args.n_eigenvalues, scaled.shape[1])):
            plt.plot(lag_times, scaled[:, i],
                     label=r'$\lambda_{i}$'.format(i=i + 1))
        if args.logscale:
            plt.yscale('log')
        plt.ylabel('Implied Timescale [{u}]'.format(u=unit_str))
        plt.xlabel('Lag Time [{u}]'.format(u=unit_str))
        plt.legend(frameon=False)
        plt.savefig(args.plot, dpi=300)
    return tscales


def main(argv=None):
    select_device()   # honors $ENSPARA_TPU_PLATFORM; raises without a card
    args = process_command_line(sys.argv if argv is None else argv)
    run(load_assignments(args), args)
    return 0


def entry_point():
    return main(sys.argv)


if __name__ == '__main__':
    sys.exit(main(sys.argv))
