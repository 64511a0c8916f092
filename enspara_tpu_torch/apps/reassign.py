"""`reassign` app: assign full datasets to existing cluster centers
(counterpart of ``enspara_tpu/apps/reassign.py``, same flags).

    python -m enspara_tpu_torch.apps.reassign --centers c.pkl \\
        --trajectories ... --topology ... --atoms 'name CA' \\
        --distances d.h5 --assignments a.h5

It runs on every visible card (a small batch on the current one), the
library's default; ``ENSPARA_TPU_PLATFORM=cpu`` runs it on the CPU.
"""

import argparse
import logging
import os
import pickle
import sys

from .. import exception, ra
from ..util.load import concatenate_trjs
from ..util.log import timed
from ..util.parallel import auto_nprocs

from ..cluster.util import reassign
from ..util.backend import select_device

logger = logging.getLogger(__name__)

# flag table: (switches, argparse spec), the JAX app's
_FLAGS = (
    (('--centers',),
     dict(required=True,
          help='Pickled center structures to reassign against.')),
    (('--trajectories',),
     dict(required=True, nargs='+', action='append',
          help='Trajectory files, one group per topology.')),
    (('--topology',),
     dict(required=True, action='append', dest='topologies',
          help='Topology file for each trajectory group.')),
    (('--atoms',),
     dict(default='(name CA or name C or name N or name CB)',
          help='Atom selection used for the reassignment metric.')),
    (('--output-path',),
     dict(default=None,
          help='Directory for outputs; defaults next to --centers.')),
    (('-m', '--mem-fraction'),
     dict(default=0.5, type=float,
          help='Fraction of host RAM used to size streaming batches.')),
    (('--distances',),
     dict(required=True,
          help='h5 output for nearest-center distances.')),
    (('--assignments',),
     dict(required=True,
          help='h5 output for nearest-center assignments.')),
)


def process_command_line(argv):
    parser = argparse.ArgumentParser(
        prog='reassign',
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    for switches, spec in _FLAGS:
        parser.add_argument(*switches, **spec)
    return _validated(parser.parse_args(argv[1:]))


def _validated(args):
    if not 0 < args.mem_fraction < 1:
        raise exception.ImproperlyConfigured(
            'Flag --mem-fraction must be in range (0, 1). Got %s'
            % args.mem_fraction)
    if len(args.topologies) != len(args.trajectories):
        raise exception.ImproperlyConfigured(
            'The number of --topology and --trajectory flags must '
            'agree.')
    if args.output_path is None:
        args.output_path = os.path.dirname(args.centers)
    for group in args.trajectories:
        for path in group:          # fail fast on unreadable inputs
            open(path, 'r').close()
    return args


def load_centers(args):
    """The pickled center structures, sliced to ``--atoms`` and
    concatenated into one Trajectory."""
    with timed('Prepared center structures in %.1f seconds.',
               logger.info):
        with open(args.centers, 'rb') as f:
            centers = concatenate_trjs(pickle.load(f), args.atoms,
                                       auto_nprocs())
    logger.info('Reassigning onto %s centers of %s atoms each.',
                len(centers), centers.n_atoms)
    return centers


def run(args, centers, device=None):
    """Every frame of the trajectories to its nearest center on
    ``device`` (None: the library's default placement, every visible
    card or, for a small batch, the current card): ``(assignments,
    distances)``."""
    return reassign(args.topologies, args.trajectories,
                    [args.atoms] * len(args.topologies), centers=centers,
                    frac_mem=args.mem_fraction, device=device)


def main(argv=None):
    select_device()   # honors $ENSPARA_TPU_PLATFORM; raises without a card
    args = process_command_line(sys.argv if argv is None else argv)
    assig, dist = run(args, load_centers(args))
    for path, payload in ((args.distances, dist),
                          (args.assignments, assig)):
        ra.save(path, payload)
        logger.info('Wrote %s.', path)
    return 0


def entry_point():
    return main(sys.argv)


if __name__ == '__main__':
    sys.exit(main(sys.argv))
