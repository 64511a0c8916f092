"""`smFRET_dye_MC` app: explicit-dye lifetime Monte Carlo + burst MC
(counterpart of ``enspara_tpu/apps/smFRET_dye_MC.py``, same subcommands,
flags and output files; reference: enspara/apps/smFRET_dye_MC.py).

Subcommands: ``calc_lifetimes`` (model dyes onto protein centers and
simulate per-photon decay) and ``run_burst`` (sample experimental
photon-arrival bursts over the protein MSM).

``calc_lifetimes`` places both dyes on every center on ``--n_procs`` host
threads, tests every placement for clashes at once on the card (or on the
CPU under ``$ENSPARA_TPU_PLATFORM=cpu``), rebuilds the dye MSMs a center
at a time on the host, then runs the treatment: 'Monte-carlo-device' steps
the photons of every center together in one lockstep loop on the card;
the host treatments keep the JAX package's numpy streams. It logs each
stage's seconds. ``run_burst`` is host numpy.
"""

import argparse
import logging
import os
import pickle
import sys

import numpy as np

from .. import ra
from ..data import dye_library_path
from ..geometry import dye_lifetimes
from ..geometry import dyes_from_expt_dist as dyefs
from .util import readable_dir

logger = logging.getLogger(__name__)


def process_command_line(argv):
    parser = argparse.ArgumentParser(
        prog='smFRET',
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
        description='Convert an MSM and FRET dye residue pairs into '
                    'predicted FRET efficiencies with explicit dye '
                    'lifetimes.')
    subparsers = parser.add_subparsers(title='commands',
                                   dest='command', required=True)

    clp = subparsers.add_parser(
        'calc_lifetimes',
        help='model FRET dyes onto MSM centers and calculate their '
             'lifetimes')
    g = clp.add_argument_group('Input Settings (Required)')
    g.add_argument('--donor_name', required=True)
    g.add_argument('--donor_centers', required=True)
    g.add_argument('--donor_top', required=True)
    g.add_argument('--donor_tcounts', required=True)
    g.add_argument('--acceptor_name', required=True)
    g.add_argument('--acceptor_centers', required=True)
    g.add_argument('--acceptor_top', required=True)
    g.add_argument('--acceptor_tcounts', required=True)
    g.add_argument('--dye_lagtime', type=float, required=True)
    g.add_argument('--prot_top', required=True)
    g.add_argument('--resid_pairs', required=True)
    g.add_argument('--save_dye_centers', default=False,
                   action='store_true')
    g.add_argument('--save_k2_r2', default=False, action='store_true')
    p = clp.add_argument_group('Parameters (Optional)')
    p.add_argument('--prot_centers', required=False)
    p.add_argument('--n_procs', type=int, default=1)
    p.add_argument('--n_samples', type=int, default=1000)
    p.add_argument('--save_dtrj', default=False, action='store_true')
    p.add_argument('--save_dmsm', default=False, action='store_true')
    p.add_argument('--output_dir', action=readable_dir, default='./')
    p.add_argument('--dye_treatment', default='Monte-carlo',
                   choices=['Monte-carlo', 'Monte-carlo-device',
                            'static', 'isotropic'],
                   help="'Monte-carlo-device' runs the photons of every "
                        'center in one lockstep loop on the card '
                        '(statistically identical, far faster for many '
                        'samples)')
    p.add_argument('--rng_seed', type=int, default=None)

    rbp = subparsers.add_parser(
        'run_burst',
        help='calculate FRET E from MSM centers using modeled dye '
             'lifetimes')
    g = rbp.add_argument_group('Input Settings (Required)')
    g.add_argument('--eq_probs', required=True)
    g.add_argument('--t_counts', required=True)
    g.add_argument('--lifetimes_dir', action=readable_dir)
    g.add_argument('--donor_name', required=True)
    g.add_argument('--acceptor_name', required=True)
    g.add_argument('--lagtime', type=float, required=True)
    g.add_argument('--resid_pairs', required=True)
    p = rbp.add_argument_group('Parameters (Optional)')
    p.add_argument('--n_procs', type=int, default=1)
    p.add_argument('--save_photon_trjs', default=False,
                   action='store_true')
    p.add_argument('--output_dir', action=readable_dir, default='./')
    p.add_argument('--photon_times', required=False, default=None)
    p.add_argument('--correction_factor', type=int, default=[10000],
                   nargs='+')
    p.add_argument('--save_burst_frames', default=False,
                   action='store_true')

    return parser.parse_args(argv[1:])


def main(argv=None):
    if argv is None:
        argv = sys.argv
    args = process_command_line(argv)

    from .. import io as io_mod
    from ..util.backend import select_device

    os.makedirs(args.output_dir, exist_ok=True)
    resSeqs = np.loadtxt(args.resid_pairs, dtype=int).reshape(-1, 2)

    if args.command == 'calc_lifetimes':
        device = select_device()   # honors $ENSPARA_TPU_PLATFORM
        logger.info('Loading dye MSMs.')
        d_centers = io_mod.load(args.donor_centers, top=args.donor_top)
        a_centers = io_mod.load(args.acceptor_centers,
                                top=args.acceptor_top)
        d_tcounts = np.load(args.donor_tcounts, allow_pickle=True)
        a_tcounts = np.load(args.acceptor_tcounts, allow_pickle=True)

        if args.prot_centers is None:
            prot_traj = io_mod.load(args.prot_top)
        else:
            prot_traj = io_mod.load(args.prot_centers,
                                    top=args.prot_top)

        for resSeq in resSeqs:
            lifetime_events, info = dye_lifetimes._calc_lifetimes_all(
                prot_traj, d_centers, d_tcounts, a_centers, a_tcounts,
                resSeq, [args.donor_name, args.acceptor_name],
                args.dye_lagtime, n_samples=args.n_samples,
                dye_treatment=args.dye_treatment, outdir=args.output_dir,
                save_dye_trj=args.save_dtrj, save_dye_msm=args.save_dmsm,
                save_dye_centers=args.save_dye_centers,
                save_k2_r2=args.save_k2_r2, rng_seed=args.rng_seed,
                n_procs=args.n_procs, device=device)
            kept = [sum(map(len, k)) / max(len(k) * len(c), 1)
                    for k, c in zip(info['kept'], (d_centers, a_centers))]
            logger.info(
                'Residues %s-%s over %d centers on %s: placement %.3f s, '
                'clash test %.3f s (%.4g tests, %.1f%% and %.1f%% of the '
                'dye states kept), dye MSMs %.3f s, %s %.3f s', resSeq[0],
                resSeq[1], len(prot_traj), device, info['placement'],
                info['clash'], info['tests'], 100 * kept[0], 100 * kept[1],
                info['msm'], args.dye_treatment, info['treatment'])

            lifetime_events = np.array(lifetime_events, dtype='O')
            np.save(os.path.join(
                args.output_dir,
                'events-%s-%s.npy' % (resSeq[0], resSeq[1])),
                lifetime_events)
            logger.info('Saved lifetimes and outcomes to %s',
                        args.output_dir)

    elif args.command == 'run_burst':
        prot_tcounts = np.load(args.t_counts, allow_pickle=True)
        prot_eqs = np.load(args.eq_probs)

        photon_times = args.photon_times or os.path.join(
            dye_library_path(), 'interphoton_times.npy')
        try:
            interphoton_times = np.load(photon_times,
                                        allow_pickle=True)
        except (OSError, ValueError, pickle.UnpicklingError):
            interphoton_times = ra.load(photon_times)

        os.makedirs(os.path.join(args.output_dir, 'MSMs'),
                    exist_ok=True)

        for resSeq in resSeqs:
            dye_lifetimes.remake_msms(
                resSeq, prot_tcounts, args.lifetimes_dir,
                [args.donor_name, args.acceptor_name], prot_eqs,
                args.output_dir)

        for time_correction in args.correction_factor:
            MSM_frames = dyefs.convert_photon_times(
                interphoton_times, args.lagtime, time_correction)
            for resSeq in resSeqs:
                dye_lifetimes.run_mc(
                    resSeq, prot_tcounts,
                    [args.donor_name, args.acceptor_name], MSM_frames,
                    args.lifetimes_dir, args.output_dir,
                    time_correction,
                    save_photon_trjs=args.save_photon_trjs,
                    save_burst_frames=args.save_burst_frames)

    return 0


def entry_point():
    return main(sys.argv)


if __name__ == '__main__':
    sys.exit(main(sys.argv))
