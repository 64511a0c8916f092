"""Representative structures of each cluster as PDBs (counterpart of
``enspara_tpu/cluster/save_states.py:17-100``), on the port's own
``io.load_frame`` and ``Trajectory.save``."""

import logging
import os
from concurrent.futures import ThreadPoolExecutor
from glob import glob

import numpy as np

from .. import io as io_mod

logger = logging.getLogger(__name__)

__all__ = ['save_states', 'unique_states']


def unique_states(assignments):
    """All state ids present in ``assignments``, -1 left out."""
    state_nums = np.unique(assignments)
    return state_nums[state_nums != -1]


def save_states(assignments, distances, state_nums=None,
                traj_filenames='./Trajectories/*.xtc',
                output_directory='./PDBs/', topology='prot_masses.pdb',
                largest_center=np.inf, n_confs=1, n_processes=1,
                random_state=None, verbose=True):
    """Write per-state PDBs ``State<s>-<conf>.pdb``: the conformation
    nearest the center (conf 0) plus ``n_confs - 1`` random members.
    ``assignments``/``distances`` are 2-D (or ragged) per-trajectory
    arrays; ``traj_filenames`` a glob or a list, one per row. Returns
    the written paths."""
    if state_nums is None:
        state_nums = unique_states(np.concatenate(
            [np.asarray(a) for a in assignments]))

    if isinstance(traj_filenames, str):
        traj_filenames = np.array(
            [os.path.abspath(t) for t in sorted(glob(traj_filenames))])
    else:
        traj_filenames = np.asarray(traj_filenames)

    output_directory = os.path.abspath(output_directory)
    os.makedirs(output_directory, exist_ok=True)

    rng = np.random.default_rng(random_state)

    assignments = [np.asarray(a) for a in assignments]
    distances = [np.asarray(d) for d in distances]

    # flat (traj, frame) indices of usable conformations
    traj_ids = np.concatenate([
        np.full(len(a), i) for i, a in enumerate(assignments)])
    frame_ids = np.concatenate([np.arange(len(a)) for a in assignments])
    flat_assign = np.concatenate(assignments)
    flat_dist = np.concatenate(distances)

    ok = (flat_dist > -0.1) & (flat_dist < largest_center)
    traj_ids, frame_ids = traj_ids[ok], frame_ids[ok]
    flat_assign, flat_dist = flat_assign[ok], flat_dist[ok]

    top = io_mod.load(topology).top if isinstance(topology, str) \
        else topology

    jobs = []
    for state in state_nums:
        sel = np.where(flat_assign == state)[0]
        if len(sel) == 0:
            continue
        order = np.argsort(flat_dist[sel])
        picks = [0]
        if n_confs > 1:
            extra = rng.choice(np.arange(1, max(len(sel), 2)),
                               n_confs - 1, replace=len(sel) < n_confs)
            picks.extend(int(e) % len(sel) for e in extra)
        for conf_num, p in enumerate(picks[:n_confs]):
            idx = sel[order[p]]
            jobs.append((int(state), conf_num, int(traj_ids[idx]),
                         int(frame_ids[idx])))

    def write_one(job):
        state, conf, traj_num, frame = job
        trj = io_mod.load_frame(traj_filenames[traj_num], frame, top=top)
        out = os.path.join(output_directory,
                           'State%d-%d.pdb' % (state, conf))
        trj.save(out)
        return out

    with ThreadPoolExecutor(max_workers=max(n_processes, 1)) as ex:
        written = list(ex.map(write_one, jobs))
    logger.info('Wrote %d state PDBs to %s', len(written), output_directory)
    return written
