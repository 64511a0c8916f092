"""`smFRET_point_clouds` app: point-cloud dye modeling, FRET-efficiency
burst sampling, and fitting to experimental histograms (counterpart of
``enspara_tpu/apps/smFRET_point_clouds.py``, same subcommands, flags and
output files; reference: enspara/apps/smFRET_point_clouds.py).

``model_dyes`` computes the cloud distances on the card, or on the CPU
under ``$ENSPARA_TPU_PLATFORM=cpu``; ``calc_FRET`` and ``fit_FRET`` are
host numpy. The ``.h5`` files go through ``ra.save``/``ra.load`` (h5py).
"""

import argparse
import glob
import logging
import os
import re
import sys

import numpy as np
from scipy.stats import entropy

from .. import ra
from ..data import dye_library_path
from ..geometry import dyes_from_expt_dist
from .util import readable_dir

logger = logging.getLogger(__name__)


def _default_dye(name):
    d = dye_library_path(required=False)
    return os.path.join(d, 'point-clouds', name) if d else name


def process_command_line(argv):
    parser = argparse.ArgumentParser(
        prog='smFRET',
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
        description='Convert an MSM and FRET dye residue pairs into '
                    'predicted FRET efficiencies via dye point clouds.')
    subparsers = parser.add_subparsers(title='commands',
                                   dest='command', required=True)

    mdp = subparsers.add_parser('model_dyes',
                                help='model FRET dyes onto MSM centers')
    mdp.add_argument('centers')
    mdp.add_argument('topology')
    mdp.add_argument('resid_pairs')
    mdp.add_argument('--n_procs', type=int, default=1)
    mdp.add_argument('--FRETdye1', default=_default_dye('AF488.pdb'))
    mdp.add_argument('--FRETdye2', default=_default_dye('AF594.pdb'))
    mdp.add_argument('--output_dir', action=readable_dir, default='./')

    cfp = subparsers.add_parser(
        'calc_FRET', help='calculate FRET E from MSM centers using '
                          'modeled dye distance distributions')
    cfp.add_argument('eq_probs')
    cfp.add_argument('t_probs')
    cfp.add_argument('lagtime', type=float)
    cfp.add_argument('FRET_dye_dists', action=readable_dir)
    cfp.add_argument('resid_pairs')
    cfp.add_argument('--n_procs', type=int, default=1)
    cfp.add_argument('--photon_times', default=None)
    cfp.add_argument('--n_chunks', type=int, default=2)
    cfp.add_argument('--R0', type=float, default=5.4)
    cfp.add_argument('--time_factor', type=int, default=1)
    cfp.add_argument('--output_dir', action=readable_dir, default='./')
    cfp.add_argument('--save_burst_frames', default=False,
                     type=lambda s: s.lower() in ('true', '1', 'yes'),
                     choices=[True, False])

    ffp = subparsers.add_parser(
        'fit_FRET', help='fit predicted FRET to experimental '
                         'histograms over time factors')
    ffp.add_argument('fit_conf_file')
    ffp.add_argument('resid_pairs')
    ffp.add_argument('--method', default='2_3_4_moments',
                     choices=['4_moments', '2_3_4_moments',
                              'sum_sq_residuals', 'entropy'])
    ffp.add_argument('--Global_fit', default=False,
                     choices=['True', 'False'])
    ffp.add_argument('--output_dir', action=readable_dir, default='./')

    return parser.parse_args(argv[1:])


def main(argv=None):
    if argv is None:
        argv = sys.argv
    args = process_command_line(argv)
    from ..util.backend import select_device

    from .. import io as io_mod

    if args.output_dir != './':
        os.makedirs(args.output_dir, exist_ok=True)

    if args.command == 'model_dyes':
        device = select_device()   # honors $ENSPARA_TPU_PLATFORM
        trj = io_mod.load(args.centers, top=args.topology)
        dye1 = dyes_from_expt_dist.load_dye(args.FRETdye1)
        dye2 = dyes_from_expt_dist.load_dye(args.FRETdye2)
        resSeq_pairs = np.loadtxt(args.resid_pairs,
                                  dtype=int).reshape(-1, 2)

        for pair in resSeq_pairs:
            logger.info('Calculating distance distribution for '
                        'residue pair: %s', pair)
            probs, bin_edges = \
                dyes_from_expt_dist.dye_distance_distribution(
                    trj, dye1, dye2, pair, n_procs=args.n_procs,
                    device=device)
            ra.save('%s/probs_%s_%s.h5'
                    % (args.output_dir, pair[0], pair[1]), probs)
            ra.save('%s/bin_edges_%s_%s.h5'
                    % (args.output_dir, pair[0], pair[1]), bin_edges)

    elif args.command == 'calc_FRET':
        t_probabilities = np.load(args.t_probs)
        populations = np.load(args.eq_probs)
        resSeq_pairs = np.loadtxt(args.resid_pairs,
                                  dtype=int).reshape(-1, 2)

        photon_times = args.photon_times or os.path.join(
            dye_library_path(), 'interphoton_times.npy')
        cumulative_times = np.load(photon_times, allow_pickle=True)
        MSM_frames = dyes_from_expt_dist.convert_photon_times(
            cumulative_times, args.lagtime, args.time_factor)

        for pair in resSeq_pairs:
            title = '%s_%s' % (pair[0], pair[1])
            probs = ra.load('%s/probs_%s.h5'
                            % (args.FRET_dye_dists, title))
            bin_edges = ra.load('%s/bin_edges_%s.h5'
                                % (args.FRET_dye_dists, title))
            dist_distribution = \
                dyes_from_expt_dist.make_distribution(probs, bin_edges)
            FEs_sampling, trajs = \
                dyes_from_expt_dist.sample_FRET_histograms(
                    T=t_probabilities, populations=populations,
                    dist_distribution=dist_distribution,
                    MSM_frames=MSM_frames, R0=args.R0,
                    n_procs=args.n_procs, n_photon_std=args.n_chunks)
            np.save('%s/FRET_E_%s_time_factor_%s.npy'
                    % (args.output_dir, title, args.time_factor),
                    FEs_sampling)
            if args.save_burst_frames:
                np.save('%s/syn-trjs-%s.npy'
                        % (args.output_dir, title), trajs)

    elif args.command == 'fit_FRET':
        conf_file = np.loadtxt(args.fit_conf_file, dtype=str)
        conf_file = conf_file.reshape(-1, 2)
        expt_histogram_paths = conf_file[:, 0]
        predicted_histogram_paths = conf_file[:, 1]
        labelpairs = np.loadtxt(args.resid_pairs,
                                dtype=int).reshape(-1, 2)

        difference_array = []
        time_scales = []
        for i, label_pair in enumerate(labelpairs):
            FRET_histos = sorted(glob.glob(
                '%s/*%s*%s*.npy' % (predicted_histogram_paths[i],
                                    label_pair[0], label_pair[1])))
            if len(FRET_histos) == 0:
                FRET_histos = sorted(glob.glob(
                    '%s/*%s*%s*.npy' % (predicted_histogram_paths[i],
                                        label_pair[1], label_pair[0])))

            parts = [re.split('[. _]', f) for f in FRET_histos]
            time_scales = [int(p[-2]) for p in parts]

            # allow_pickle: calc_FRET's per-burst (FE, std) rows are
            # object-dtype
            predicted = np.array(
                [np.load(f, allow_pickle=True) for f in FRET_histos],
                dtype='O')
            expt_counts = np.loadtxt(expt_histogram_paths[i])

            if args.method == 'sum_sq_residuals':
                expt_probs = expt_counts[:, 1] / np.sum(
                    expt_counts[:, 1])
                pred = dyes_from_expt_dist.histogram_to_match_expt(
                    predicted[:, :, 0], expt_counts)
                difference_array.append(
                    dyes_from_expt_dist.Sum_sq_resid(expt_probs, pred))
            elif args.method == 'entropy':
                expt_probs = expt_counts[:, 1] / np.sum(
                    expt_counts[:, 1])
                pred = dyes_from_expt_dist.histogram_to_match_expt(
                    predicted[:, :, 0], expt_counts)
                difference_array.append(
                    [entropy(p, expt_probs) for p in pred])
            else:
                expt_data = dyes_from_expt_dist.remake_data_from_hist(
                    expt_counts)
                if args.method == '4_moments':
                    moments_fn = dyes_from_expt_dist.calc_4_moments
                else:
                    moments_fn = dyes_from_expt_dist.calc_2_3_4_moments
                expt_moments = moments_fn(expt_data)
                pred_moments = moments_fn(predicted[:, 0])
                diff = dyes_from_expt_dist.normalize_array(
                    (expt_moments - pred_moments) ** 2)
                difference_array.append(np.sum(diff, axis=0))

            logger.info(
                'Minimum difference between experiment and prediction '
                'for %s is at time factor: %s.', label_pair,
                time_scales[int(np.argmin(difference_array[i]))])
            output_array = np.vstack(
                (np.array(time_scales, dtype='O'),
                 difference_array[i])).T
            np.save('%s/%s_%s.npy' % (args.output_dir, label_pair,
                                      args.method), output_array)

        if args.Global_fit == 'True':
            difference_array = np.array(difference_array)
            abs_diff = np.sum(difference_array, axis=0)
            normd = np.sum(dyes_from_expt_dist.normalize_array(
                difference_array), axis=0)
            logger.info('Global min (normalized): time factor %s',
                        time_scales[int(np.argmin(normd))])
            logger.info('Global min (absolute): time factor %s',
                        time_scales[int(np.argmin(abs_diff))])

    return 0


def entry_point():
    return main(sys.argv)


if __name__ == '__main__':
    sys.exit(main(sys.argv))
