"""`collect_cards` app: compute and save the four CARDS matrices
(counterpart of ``enspara_tpu/apps/collect_cards.py``, same flags and
checks; reference: enspara/apps/collect_cards.py).

    python -m enspara_tpu_torch.apps.collect_cards \\
        --trajectories t*.xtc --topology top.pdb \\
        --matrices cards.pkl --indices inds.csv

It runs on the CUDA devices, the joint counting sharded over every
visible card (:func:`~enspara_tpu_torch.parallel.mesh.frame_mesh`, as
in the JAX app; one card runs on its own); ``ENSPARA_TPU_PLATFORM=cpu``
runs it on the CPU. The pickle holds numpy arrays under the
reference's four keys.
"""

import argparse
import logging
import pickle
import sys

import numpy as np

from .. import exception
from ..cards import cards
from ..parallel.mesh import frame_mesh
from ..util.backend import select_device
from ..util.log import timed
from ..util.parallel import auto_nprocs
from .util import readable_dir, expand_files

logger = logging.getLogger(__name__)


# grouped flag table: (group title, ((switches, argparse spec), ...))
_FLAG_GROUPS = (
    ('Input Settings', (
        (('--trajectories',),
         dict(required=True, nargs='+', action='append',
              help='List of paths to aligned trajectory files.')),
        (('--topology',),
         dict(required=True, action='append',
              help='The topology file for the trajectories.')),
    )),
    ('CARDS Settings', (
        (('--buffer-size',),
         dict(default=15, type=int,
              help='Size of buffer zone between rotameric states, '
                   'degrees.')),
        (('--processes',),
         dict(default=max(1, auto_nprocs() // 4), type=int,
              help='Number of processes to use.')),
    )),
    ('Output Settings', (
        (('--matrices',),
         dict(required=True, action=readable_dir,
              help='Where to write the four CARDS matrices (pickle).')),
        (('--indices',),
         dict(required=True, action=readable_dir,
              help='Where to write the dihedral indices (CSV).')),
    )),
)


def process_command_line(argv):
    parser = argparse.ArgumentParser(
        formatter_class=argparse.RawDescriptionHelpFormatter,
        description='Compute CARDS matrices for a set of trajectories '
                    'and save all matrices and dihedral mappings.')
    for title, flags in _FLAG_GROUPS:
        group = parser.add_argument_group(title)
        for switches, spec in flags:
            group.add_argument(*switches, **spec)

    args = parser.parse_args(argv[1:])
    if not 0 < args.buffer_size < 360:
        raise exception.ImproperlyConfigured(
            'The given buffer size (%s) is not possible.'
            % args.buffer_size)
    args.trajectories = expand_files(args.trajectories)
    return args


def load_trajectory_generator(trajectories, topology):
    """(reference: apps/collect_cards.py:114)"""
    from .. import io as io_mod
    top = io_mod.load(topology).top
    for t in trajectories:
        logger.info('loading %s', t)
        yield io_mod.load(t, top=top)


def load_trajs(args):
    """Generator of loaded trajectories from parsed CLI args.
    (reference: apps/collect_cards.py:135)"""
    return load_trajectory_generator(args.trajectories[0],
                                     args.topology[0])


def save_cards(ss_mi, dd_mi, sd_mi, ds_mi, output_name):
    """(reference: apps/collect_cards.py:163)

    The pickle's key names are the reference's on-disk contract; its
    values are numpy arrays, so a reader needs no torch."""
    keys = ('Struc_struc_MI', 'Disorder_disorder_MI',
            'Struc_disorder_MI', 'Disorder_struc_MI')
    mats = [np.asarray(m) for m in (ss_mi, dd_mi, sd_mi, ds_mi)]
    with open(output_name, 'wb') as f:
        pickle.dump(dict(zip(keys, mats)), f)
    return 0


def main(argv=None):
    if argv is None:
        argv = sys.argv
    select_device()   # honors $ENSPARA_TPU_PLATFORM; raises without a card
    args = process_command_line(argv)

    if len(args.trajectories) != 1 or len(args.topology) != 1:
        raise exception.ImproperlyConfigured(
            'collect_cards takes exactly one --trajectories/--topology '
            'group (%d/%d given); concatenate file lists into one '
            'group instead' % (len(args.trajectories),
                               len(args.topology)))
    gen = load_trajectory_generator(args.trajectories[0],
                                    args.topology[0])

    mesh = frame_mesh()
    with timed('Calculating CARDS correlations took %.1f s.',
               logger.info):
        ss_mi, dd_mi, sd_mi, ds_mi, inds = cards(
            gen, args.buffer_size, args.processes,
            mesh=mesh if mesh.size > 1 else None)

    save_cards(ss_mi, dd_mi, sd_mi, ds_mi, args.matrices)
    np.savetxt(args.indices, inds, delimiter=',')
    logger.info('Saved dihedral indices as %s', args.indices)
    return 0


def entry_point():
    return main(sys.argv)


if __name__ == '__main__':
    sys.exit(main(sys.argv))
