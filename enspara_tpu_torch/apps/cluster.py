"""`cluster` app: cluster trajectories by RMSD, or feature vectors by
euclidean or manhattan distance, into a state space (counterpart of
``enspara_tpu/apps/cluster.py``, same flags, checks and messages).

    python -m enspara_tpu_torch.apps.cluster --trajectories ... \\
        --topology ... --atoms 'name CA' --algorithm khybrid \\
        --cluster-number 1000 --subsample 10 --distances d.h5 \\
        --assignments a.h5 --center-features c.pkl
    python -m enspara_tpu_torch.apps.cluster --features f*.npy \\
        --cluster-distance euclidean --algorithm khybrid \\
        --cluster-number 1000 --subsample 10 --checkpoint ckpt/ \\
        --distances d.h5 --assignments a.h5 --center-features c.npy

``--checkpoint DIR`` saves the final clustering state there (the JAX
package's format, :mod:`enspara_tpu_torch.util.checkpoint`); a DIR that
already holds a manifest warm-starts ``--algorithm kmedoids`` from it.
``--precision bf16`` streams the frames in bfloat16 through the
k-centers kernels and ``--locality-sort`` clusters a locality-sorted
layout (both ``--algorithm kcenters`` by rmsd only, as in the JAX app).

It runs on every visible card (a small job on the current one), the
library's default; ``ENSPARA_TPU_PLATFORM=cpu`` runs it on the CPU,
where every kernel takes its plain version.

Multi-process mode (the reference's ``mpirun -n N cluster ...``): with
``ENSPARA_TPU_COORDINATOR=host:port``, ``ENSPARA_TPU_NUM_PROCESSES=N``
and ``ENSPARA_TPU_PROCESS_ID=r`` set, each process joins the job over
``torch.distributed`` (:func:`join_job`) before it touches the card,
loads the input, and fits over the job's frame mesh: this process's
visible cards (or ``$ENSPARA_TPU_LOCAL_SHARDS`` of them; that many CPU
shards under ``ENSPARA_TPU_PLATFORM=cpu``), joined by NCCL when every
process leads from a card of its own and by gloo otherwise
(:func:`~enspara_tpu_torch.parallel.mesh.job_mesh`). Rank 0 alone writes
the outputs; the job ends at a barrier. ``--subsample`` above 1 is
refused there, as in the JAX app.

To give each process a card of its own, and the job NCCL, start process
``r`` with ``CUDA_VISIBLE_DEVICES=r``; where the NCCL group cannot be
made the job raises at join. A process that sees every card takes all
of them as its shards, and the processes, sharing cards, stay on gloo.

    CUDA_VISIBLE_DEVICES=0 ENSPARA_TPU_COORDINATOR=localhost:29500 \
        ENSPARA_TPU_NUM_PROCESSES=2 ENSPARA_TPU_PROCESS_ID=0 \
        python -m enspara_tpu_torch.apps.cluster \
        --trajectories ... --algorithm khybrid --subsample 1 ...

``python3 chip_smoke.py`` with two or more cards visible runs the
sequence in one process a card (its phase 16d).
"""

import argparse
import logging
import os
import sys

import numpy as np

from .. import exception, ra
from ..util.log import timed

from ..cluster import KCenters, KHybrid, KMedoids, util
from ..parallel.mesh import initialize_distributed, job_mesh
from ..util.backend import select_device
from ..util.checkpoint import (load_clustering_checkpoint,
                               save_clustering_checkpoint)
from . import util as apputil

logger = logging.getLogger(__name__)

FEATURE_DISTANCES = ['euclidean', 'manhattan']
TRAJECTORY_DISTANCES = ['rmsd']
ALGORITHMS = {'kcenters': KCenters, 'khybrid': KHybrid,
              'kmedoids': KMedoids}


JOB_VARIABLES = ('ENSPARA_TPU_COORDINATOR', 'ENSPARA_TPU_NUM_PROCESSES',
                 'ENSPARA_TPU_PROCESS_ID')


def process_command_line(argv):
    parser = argparse.ArgumentParser(
        prog='cluster',
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
        description='Cluster a set (or several sets) of trajectories '
                    'into a single state space based upon RMSD.')

    input_args = parser.add_argument_group('Input Settings')
    input_data_group = parser.add_mutually_exclusive_group(required=True)
    input_data_group.add_argument(
        '--features', nargs='+',
        help='The h5 file containing observations and features.')
    input_data_group.add_argument(
        '--trajectories', nargs='+', action='append',
        help='List of paths to aligned trajectory files to cluster.')
    input_args.add_argument(
        '--topology', action='append', dest='topologies',
        help='The topology file for the trajectories, once per '
             '--trajectories flag.')

    cluster_args = parser.add_argument_group('Clustering Settings')
    cluster_args.add_argument(
        '--algorithm', required=True,
        choices=['khybrid', 'kcenters', 'kmedoids'],
        help='The clustering algorithm to use.')
    cluster_args.add_argument(
        '--atoms', action='append',
        help='Atom selection used for RMSD clustering; once globally or '
             'once per --trajectories flag.')
    cluster_args.add_argument(
        '--cluster-radius', default=None, type=float,
        help='Produce clusters with a maximum distance to cluster '
             'center of this value.')
    cluster_args.add_argument(
        '--cluster-number', default=None, type=int,
        help='Produce at least this number of clusters.')
    cluster_args.add_argument(
        '--cluster-distance', default=None,
        choices=FEATURE_DISTANCES + TRAJECTORY_DISTANCES,
        help='The metric for measuring distances.')
    cluster_args.add_argument(
        '--cluster-iterations', default=None, type=int,
        help='The number of refinement iterations to perform (khybrid/'
             'kmedoids).')
    cluster_args.add_argument(
        '--init-center-inds', default=None, type=str,
        help='Path to a .npy of initial center positions (restarts).')
    cluster_args.add_argument(
        '--init-assignments', default=None, type=str,
        help='Path to an .h5 of initial assignments (restarts).')
    cluster_args.add_argument(
        '--init-distances', default=None, type=str,
        help='Path to an .h5 of initial distances (restarts).')
    cluster_args.add_argument(
        '--checkpoint', default=None, type=str,
        help='Checkpoint directory (util.checkpoint layout). If it '
             'already holds a manifest, clustering warm-starts from '
             'it (kmedoids only, like the --init-* flags); the final '
             'clustering state is always saved back to it.')
    cluster_args.add_argument(
        '--subsample', default=1, type=int,
        help='Take only every nth frame when loading trajectories.')
    cluster_args.add_argument(
        '--random-state', default=None, type=int,
        help='Random seed for medoid proposals.')
    cluster_args.add_argument(
        '--locality-sort', default=False, action='store_true',
        help='Reorder frames by a 1-pivot RMSD key before clustering '
             'so the tri-skip kernels can skip provably inert tiles even '
             'on temporally shuffled data (kcenters + rmsd only). Finds '
             'a different, equally valid, Gonzalez covering than the '
             'unsorted order.')
    cluster_args.add_argument(
        '--precision', default='fp32', choices=['fp32', 'bf16'],
        help='bf16 streams frames as bfloat16 through the k-centers '
             'kernels: half the frame bytes at ~4e-3 relative distance '
             'rounding (kcenters + rmsd only).')

    output_args = parser.add_argument_group('Output Settings')
    output_args.add_argument(
        '--no-reassign', default=False, action='store_true',
        help='Do not do a reassigment step after subsampled clustering.')
    output_args.add_argument(
        '--distances', required=True, action=apputil.readable_dir,
        help='The location to write the distances file.')
    output_args.add_argument(
        '--center-features', required=True, action=apputil.readable_dir,
        help='The location to write the cluster center structures.')
    output_args.add_argument(
        '--assignments', required=True, action=apputil.readable_dir,
        help='The location to write assignments of frames to clusters.')
    output_args.add_argument(
        '--center-indices', required=False, action=apputil.readable_dir,
        help='Location for cluster center indices output (npy).')

    args = parser.parse_args(argv[1:])

    if args.features:
        args.features = apputil.expand_files([args.features])[0]
        if args.cluster_distance not in FEATURE_DISTANCES:
            raise exception.ImproperlyConfigured(
                'The given distance (%s) is not compatible with '
                'features.' % args.cluster_distance)
        if args.subsample != 1 and len(args.features) == 1:
            raise exception.ImproperlyConfigured(
                'Subsampling is not supported for h5 inputs.')
        if args.topologies:
            raise exception.ImproperlyConfigured(
                'When --features is specified, --topology is '
                'unneccessary.')
        if args.atoms:
            raise exception.ImproperlyConfigured(
                'Option --atoms is only meaningful when clustering '
                'trajectories.')
    elif args.trajectories and args.topologies:
        args.trajectories = apputil.expand_files(args.trajectories)
        if not args.cluster_distance or args.cluster_distance == 'rmsd':
            args.cluster_distance = 'rmsd'
        else:
            raise exception.ImproperlyConfigured(
                'Option --cluster-distance must be rmsd when clustering '
                'trajectories.')
        if not args.atoms:
            raise exception.ImproperlyConfigured(
                'Option --atoms is required when clustering '
                'trajectories.')
        if len(args.atoms) == 1:
            args.atoms = args.atoms * len(args.trajectories)
        elif len(args.atoms) != len(args.trajectories):
            raise exception.ImproperlyConfigured(
                'Flag --atoms must be provided either once or the same '
                'number of times --trajectories is supplied.')
        if len(args.topologies) != len(args.trajectories):
            raise exception.ImproperlyConfigured(
                'The number of --topology and --trajectory flags must '
                'agree.')
    else:
        raise exception.ImproperlyConfigured(
            'Either --features or both of --trajectories and '
            '--topologies are required.')

    if args.cluster_radius is None and args.cluster_number is None:
        raise exception.ImproperlyConfigured(
            'At least one of --cluster-radius and --cluster-number is '
            'required to cluster.')

    args.Clusterer = ALGORITHMS[args.algorithm]
    if args.Clusterer is KCenters and args.cluster_iterations is not None:
        raise exception.ImproperlyConfigured(
            '--cluster-iterations only has an effect when using an '
            'iterative clustering scheme (e.g. khybrid).')
    if args.Clusterer is KMedoids and args.cluster_radius is not None:
        raise exception.ImproperlyConfigured(
            '--cluster-radius only has an effect when using kcenters or '
            'khybrid.')
    if args.precision != 'fp32' and (
            args.Clusterer is not KCenters
            or args.cluster_distance != 'rmsd'):
        raise exception.ImproperlyConfigured(
            '--precision bf16 is only implemented for kcenters with '
            'the rmsd metric (the fused TPU streaming path).')
    if args.locality_sort and (
            args.Clusterer is not KCenters
            or args.cluster_distance != 'rmsd'):
        raise exception.ImproperlyConfigured(
            '--locality-sort is only implemented for kcenters with '
            'the rmsd metric (the fused TPU tri-skip path).')
    if args.Clusterer is not KMedoids:
        for name in (args.init_center_inds, args.init_distances,
                     args.init_assignments):
            if name:
                raise exception.ImproperlyConfigured(
                    '--init-center-inds, --init-distances, and '
                    '--init-assignments are only implemented for '
                    'kmedoids')
    if args.checkpoint and _manifest(args):
        if args.Clusterer is not KMedoids:
            raise exception.ImproperlyConfigured(
                'Warm-starting from --checkpoint is only implemented '
                'for kmedoids (matching the --init-* flags).')
        if (args.init_center_inds or args.init_distances
                or args.init_assignments):
            raise exception.ImproperlyConfigured(
                'Give either --checkpoint or the --init-* flags for a '
                'restart, not both.')
    return args


def _manifest(args):
    return os.path.exists(os.path.join(args.checkpoint, 'manifest.json'))


def _flat(path):
    arr = ra.load(path)
    return arr._data if isinstance(arr, ra.RaggedArray) \
        else np.asarray(arr).reshape(-1)


def join_job():
    """Join the multi-process job that ``$ENSPARA_TPU_COORDINATOR``
    names (``torch.distributed`` over ``tcp://`` + the coordinator, the
    world size and rank from ``$ENSPARA_TPU_NUM_PROCESSES`` and
    ``$ENSPARA_TPU_PROCESS_ID``) and return the job's frame mesh; None
    when the coordinator is not set. ``$ENSPARA_TPU_LOCAL_SHARDS``, when
    set, is the number of shards this process holds (default: its
    visible cards, or one CPU shard)."""
    coord = os.environ.get(JOB_VARIABLES[0])
    if not coord:
        return None
    missing = [v for v in JOB_VARIABLES[1:] if not os.environ.get(v)]
    if missing:
        raise exception.ImproperlyConfigured(
            'Multi-process mode (%s=%s) also needs %s.'
            % (JOB_VARIABLES[0], coord, ' and '.join(missing)))
    initialize_distributed(
        backend='gloo', init_method='tcp://' + coord,
        world_size=int(os.environ[JOB_VARIABLES[1]]),
        rank=int(os.environ[JOB_VARIABLES[2]]))
    n = os.environ.get('ENSPARA_TPU_LOCAL_SHARDS')
    return job_mesh(int(n) if n else None)


def check_job(args, mesh):
    """Refuse what a multi-process run does not support: the
    reassignment of ``--subsample`` above 1."""
    if mesh is not None and mesh.spans_processes and args.subsample > 1:
        raise exception.ImproperlyConfigured(
            'multi-host runs do not support --subsample reassignment '
            'yet; reassign separately with the reassign app')


def fit(args, data, device=None, mesh=None):
    """Build the parsed ``--algorithm``'s estimator over ``mesh`` when
    given, else on ``device`` (None: the library's default placement,
    every visible card, the current card for a small job) and fit it to
    ``data`` (k-medoids restarts from a ``--checkpoint`` that holds a
    manifest, or from the ``--init-*`` files)."""
    kwargs = {}
    if args.cluster_iterations is not None:
        if args.Clusterer is KHybrid:
            kwargs['kmedoids_updates'] = int(args.cluster_iterations)
        elif args.Clusterer is KMedoids:
            kwargs['n_iters'] = int(args.cluster_iterations)
    if args.cluster_radius is not None:
        kwargs['cluster_radius'] = args.cluster_radius
    if args.random_state is not None:
        kwargs['random_state'] = args.random_state
    if args.precision != 'fp32':
        kwargs['precision'] = args.precision
    if args.locality_sort:
        kwargs['sort'] = 'locality'
    if mesh is not None:
        kwargs['mesh'] = mesh
    elif device is not None:
        kwargs['device'] = device
    clustering = args.Clusterer(metric=args.cluster_distance,
                                n_clusters=args.cluster_number, **kwargs)
    if args.Clusterer is KMedoids:
        restart = {}
        if args.checkpoint and _manifest(args):
            state = load_clustering_checkpoint(args.checkpoint)
            restart['distances'] = state['distances'].reshape(-1)
            restart['assignments'] = state['assignments'].reshape(-1)
            restart['cluster_center_inds'] = state['center_indices']
            logger.info('Warm-starting from checkpoint %s (%d centers).',
                        args.checkpoint, len(state['center_indices']))
        if args.init_distances:
            restart['distances'] = _flat(args.init_distances)
        if args.init_assignments:
            restart['assignments'] = _flat(args.init_assignments)
        if args.init_center_inds:
            restart['cluster_center_inds'] = np.load(args.init_center_inds)
        return clustering.fit(data, **restart)
    return clustering.fit(data)


def save_checkpoint(args, clustering):
    """Save the fitted clustering's state to ``--checkpoint``."""
    r = clustering.result_
    save_clustering_checkpoint(
        args.checkpoint, np.asarray(r.distances), np.asarray(r.assignments),
        np.asarray(r.center_indices),
        metadata={'algorithm': args.algorithm, 'subsample': args.subsample})
    logger.info('Saved clustering checkpoint to %s.', args.checkpoint)


def center_indices(result, args):
    """``(trajectory, frame)`` of each center in full-trajectory frames."""
    return [(t, f * args.subsample) for t, f in result.center_indices]


def write_outputs(args, clustering, lengths, device=None, mesh=None,
                  h5=True):
    """Write the fitted clustering's outputs (the checkpoint, the center
    indices and structures and, with ``h5``, the ``.h5`` assignments and
    distances, reassigned on ``device`` for ``--subsample`` above 1) on
    rank 0 of the job alone (``device`` None: the library's default
    placement, or the mesh's lead device). Returns whether this process
    wrote."""
    if mesh is not None and mesh.process_index != 0:
        return False
    if args.checkpoint:
        save_checkpoint(args, clustering)
    result = clustering.result_.partition(lengths)
    with timed('Wrote center indices in %.2f sec.', logger.info):
        util.write_centers_indices(args.center_indices,
                                   center_indices(result, args))
    with timed('Wrote center structures in %.2f sec.', logger.info):
        util.write_centers(result, args)
    if h5:
        util.write_assignments_and_distances_with_reassign(
            result, args, device=device if mesh is None else mesh.lead)
    return True


def end_job(mesh):
    """Wait for every process of a multi-process job (a barrier)."""
    if mesh is not None and mesh.spans_processes:
        import torch.distributed as dist
        dist.barrier()


def main(argv=None):
    if argv is None:
        argv = sys.argv
    mesh = join_job()          # before anything touches the card
    select_device()            # honors $ENSPARA_TPU_PLATFORM

    args = process_command_line(argv)
    check_job(args, mesh)
    lengths, data = util.load_trjs_or_features(args)
    clustering = fit(args, data, None, mesh)
    del data
    logger.info('Clustered %s frames into %s clusters in %s seconds.',
                sum(lengths), len(clustering.centers_), clustering.runtime_)
    write_outputs(args, clustering, lengths, mesh=mesh)
    end_job(mesh)
    logger.info('Success! Data can be found in %s.',
                os.path.dirname(args.distances))
    return 0


def entry_point():
    return main(sys.argv)


if __name__ == '__main__':
    sys.exit(main(sys.argv))
