"""`compute-shannon-entropy` app: per-residue rotamer Shannon
entropies, normalized by each residue's channel capacity (counterpart of
``enspara_tpu/apps/shannon_entropy.py``, same CLI and CSV; reference:
enspara/apps/compute-shannon-entropy.py:56-441).

    python -m enspara_tpu_torch.apps.shannon_entropy \\
        --trajectories t*.xtc --topology top.pdb --entropies ent.csv

The rotamer featurization runs on one CUDA device
(``ENSPARA_TPU_PLATFORM=cpu``: the CPU); after it the pipeline is three
host reductions:

1. per-dihedral occupancy histograms via ONE fused-key ``bincount``
   over all frames of all trajectories (key = dihedral*width + state),
2. per-dihedral entropies via a single ``xlogy`` over the histogram
   matrix,
3. per-residue aggregation (entropy sums AND capacities) via
   ``bincount(resi_map, weights=...)`` segment sums, keyed by the
   topology's ``residue.index``.
"""

import argparse
import logging
import sys

import numpy as np
from scipy.special import xlogy

from .. import exception
from ..cards import featurizers as feat
from ..util.backend import select_device
from ..util.parallel import auto_nprocs
from .util import readable_dir, expand_files

logger = logging.getLogger(__name__)

# CLI flag table: (group, name, options). Parity surface with the
# reference parser (compute-shannon-entropy.py:75-112).
_FLAGS = (
    ('Input Settings', '--trajectories',
     dict(required=True, nargs='+',
          help='Aligned trajectory files (any supported format).')),
    ('Input Settings', '--topology',
     dict(required=True, action='append',
          help='Topology file for the trajectories.')),
    ('CARDS Settings', '--buffer-size',
     dict(default=15, type=int,
          help='Width of the hysteresis buffer between rotameric '
               'states, in degrees.')),
    ('CARDS Settings', '--processes',
     dict(default=max(1, auto_nprocs() // 4), type=int,
          help='Worker process count for featurization.')),
    ('Output Settings', '--entropies',
     dict(required=True, action=readable_dir,
          help='Destination CSV for per-residue entropies.')),
)


def process_command_line(argv):
    parser = argparse.ArgumentParser(
        formatter_class=argparse.RawDescriptionHelpFormatter,
        description='Per-residue rotamer Shannon entropies, '
                    'normalized to [0, 1] by channel capacity.')
    groups = {}
    for group_name, flag, options in _FLAGS:
        if group_name not in groups:
            groups[group_name] = parser.add_argument_group(group_name)
        groups[group_name].add_argument(flag, **options)

    args = parser.parse_args(argv[1:])
    if args.buffer_size <= 0 or args.buffer_size >= 360:
        raise exception.ImproperlyConfigured(
            'Buffer size must lie strictly inside (0, 360) degrees; '
            'got %d.' % args.buffer_size)
    args.trajectories = expand_files([args.trajectories])[0]
    return args


def _occupancy_histograms(feature_trajs, width):
    """(n_dihedrals, width) state-occupancy counts, accumulated with
    one fused-key bincount per trajectory: the pair (dihedral d,
    state s) maps to flat key d*width + s."""
    hist = None
    for labels in feature_trajs:
        labels = np.asarray(labels)
        n_dihedrals = labels.shape[1]
        offsets = np.arange(n_dihedrals, dtype=np.int64) * width
        keys = (labels.astype(np.int64) + offsets).ravel()
        counts = np.bincount(keys, minlength=n_dihedrals * width)
        counts = counts.reshape(n_dihedrals, width)
        hist = counts if hist is None else hist + counts
    return hist


def _entropy_rows(hist):
    """Shannon entropy (nats) of each row of a count matrix, fully
    vectorized: H = log(N) - (1/N) * sum c*log(c)."""
    totals = hist.sum(axis=1, dtype=np.float64)
    c = hist.astype(np.float64)
    plogp_sum = xlogy(c, c).sum(axis=1)
    with np.errstate(divide='ignore', invalid='ignore'):
        h = np.log(totals) - plogp_sum / totals
    return np.where(totals > 0, h, 0.0)


def _dihedral_residue_map(topology_file, atom_inds):
    """0-based TOPOLOGY residue index owning each dihedral (taken from
    the dihedral's second atom), plus the per-index author resSeq for
    output labeling.

    Keying by ``residue.index`` instead of the reference's
    ``resSeq - 1`` makes numbering that starts above 1, has gaps, or
    repeats across chains aggregate correctly instead of silently
    dropping or merging residues."""
    from .. import io as io_mod

    structure = io_mod.load(topology_file)
    anchor_atoms = np.asarray(atom_inds)[:, 1].astype(int)
    residues = [structure.top.atom(a).residue for a in anchor_atoms]
    resi_map = np.fromiter((r.index for r in residues),
                           dtype=np.int64, count=len(residues))
    resseq_of = np.fromiter(
        (r.resSeq for r in structure.top.residues),
        dtype=np.int64, count=structure.top.n_residues)
    return resi_map, structure.top.n_residues, resseq_of


def _segment_sum(values, segment_ids, n_segments):
    """``bincount`` segment sum that tolerates ids outside
    [0, n_segments): such entries are dropped (a resSeq of 0 or a
    numbering gap must not crash or stretch the output)."""
    ids = np.asarray(segment_ids, dtype=np.int64)
    ok = (ids >= 0) & (ids < n_segments)
    return np.bincount(ids[ok],
                       weights=np.asarray(values, np.float64)[ok],
                       minlength=n_segments)[:n_segments]


def _normalized_residue_entropies(dihedral_entropies, states_per_dihedral,
                                  resi_map, n_resis):
    """Segment-sum both the entropy numerator and the log-capacity
    denominator over the dihedral→residue map, then divide."""
    total = _segment_sum(dihedral_entropies, resi_map, n_resis)
    capacity = _segment_sum(
        np.log(np.asarray(states_per_dihedral, dtype=np.float64)),
        resi_map, n_resis)
    with np.errstate(invalid='ignore', divide='ignore'):
        ratio = total / capacity
    return np.where(capacity > 0, ratio, 0.0)


# ---------------------------------------------------------------------
# Reference-parity API: same function names/signatures as the
# reference app module, implemented over the vectorized core above.
# ---------------------------------------------------------------------

def compute_rotamer_counts(rotamers):
    """Per-dihedral rotamer occupancy counts as an
    (n_dihedrals, n_states) matrix — the same contract as the
    reference, whose ``jc.sum(-1)[i, i]`` rows are state histograms.
    (parity: apps/compute-shannon-entropy.py:155)"""
    width = int(np.max(rotamers.n_feature_states_))
    return _occupancy_histograms(rotamers.feature_trajectories_, width)


def compute_dihedral_shannon_entropy(probs):
    """Rowwise Shannon entropy of a (n_dihedrals, n_states)
    probability/count matrix. (parity: :197)"""
    return _entropy_rows(np.asarray(probs, dtype=np.float64))


def sum_dihedral_entropies(dihedral_entropies, resi_mapping, n_resis):
    """Per-residue entropy totals as a bincount segment sum.
    (parity: :220)"""
    return _segment_sum(dihedral_entropies, resi_mapping, n_resis)


def compute_channel_capacities(n_states_array, resi_list, n_resis):
    """Per-residue max entropy = segment sum of log(states).
    (parity: :243)"""
    logs = np.log(np.asarray(n_states_array, dtype=np.float64))
    return _segment_sum(logs, resi_list, n_resis)


def _present_residues(resi_map, n_resis):
    """Sorted 0-based ids of residues that own at least one dihedral
    (clipped to the topology's residue range)."""
    ids = np.unique(np.asarray(resi_map, dtype=np.int64))
    return ids[(ids >= 0) & (ids < n_resis)]


def compute_residue_shannon_entropies(dihedral_entropies, topology_file,
                                      atom_inds, n_states):
    """Aggregate dihedral entropies into normalized per-residue values
    and the matching author residue-id (resSeq) list — only residues
    that own dihedrals are reported, so the two arrays always align.
    (parity: :270)"""
    resi_map, n_resis, resseq_of = _dihedral_residue_map(
        topology_file, atom_inds)
    normalized = _normalized_residue_entropies(
        np.asarray(dihedral_entropies, dtype=np.float64),
        n_states, resi_map, n_resis)
    present = _present_residues(resi_map, n_resis)
    return normalized[present], resseq_of[present].astype(np.float64)


def _entropy_pipeline(buffer_size, n_procs, trajectories, topology_file):
    """Full pipeline over explicit parameters: featurize, fused-key
    histogram, vectorized entropies, then the shared residue
    aggregation (one implementation — see
    :func:`compute_residue_shannon_entropies`)."""
    featurizer = feat.RotamerFeaturizer(buffer_size, n_procs)
    featurizer.fit(trajectories)
    width = int(np.max(featurizer.n_feature_states_))
    hist = _occupancy_histograms(featurizer.feature_trajectories_, width)
    return compute_residue_shannon_entropies(
        _entropy_rows(hist), topology_file,
        featurizer.atom_indices_, featurizer.n_feature_states_)


def compute_shannon_entropies(args, trj_list):
    """(parity: :332)"""
    return _entropy_pipeline(args.buffer_size, args.processes,
                             trj_list, args.topology[0])


def save_all_entropies(entropies, residues, filename):
    """Two-column CSV: residue id, normalized entropy. (parity: :382)"""
    table = np.column_stack([np.asarray(residues, dtype=np.float64),
                             np.asarray(entropies, dtype=np.float64)])
    np.savetxt(filename, table, delimiter=',')
    return 0


def load_trajs(args):
    """Lazy trajectory iterator over the CLI file list. (parity: :124)"""
    from .. import io as io_mod
    top = io_mod.load(args.topology[0]).top

    def iterate():
        for path in args.trajectories:
            yield io_mod.load(path, top=top)
    return iterate()


def main(argv=None):
    if argv is None:
        argv = sys.argv
    select_device()   # honors $ENSPARA_TPU_PLATFORM; raises without a card
    args = process_command_line(argv)

    residue_entropy, resi_list = compute_shannon_entropies(
        args, load_trajs(args))
    save_all_entropies(residue_entropy, resi_list, args.entropies)
    logger.info('Saved per-residue entropies to %s', args.entropies)
    return 0


def entry_point():
    return main(sys.argv)


if __name__ == '__main__':
    sys.exit(main(sys.argv))
