"""Transition counting, eigenspectra and ergodic trimming (counterpart
of ``enspara_tpu/msm/transition_matrices.py``; reference:
enspara/msm/transition_matrices.py).

The host functions are the JAX package's, unchanged: unassigned (-1)
frames are stripped per trajectory *before* pairing, so transitions
skip over gaps; sliding-window or strided pairing at the lag time;
accumulation into a scipy COO counts matrix. :func:`assigns_to_counts_device`
counts masked lag pairs of padded rows on a device with a scatter-add
(no host read); :func:`assigns_to_counts_sharded` splits the rows
over the shards of a frame mesh and sums their counts.
"""

import csv
import numbers

import numpy as np
import scipy.linalg
import scipy.sparse
import scipy.sparse.linalg
import torch
from scipy.sparse.csgraph import (breadth_first_order,
                                  connected_components)

from .. import exception
from ..ra import RaggedArray
from ..util.device import resolve_device

__all__ = ['TrimMapping', 'assigns_to_counts', 'eigenspectrum',
           'trim_disconnected', 'eq_probs', 'assigns_to_counts_device',
           'assigns_to_counts_sharded']


class TrimMapping:
    """Bijection between pre- and post-ergodic-trimming state ids, with
    CSV round-trip. (reference: transition_matrices.py:26)"""

    __slots__ = ['to_original']

    def __init__(self, transformations=None):
        self.to_original = {}
        if transformations:
            self.to_original = {t: o for o, t in transformations}

    @classmethod
    def load(cls, filename):
        with open(filename, 'r') as f:
            return cls.read(f)

    @classmethod
    def read(cls, file):
        rows = list(csv.reader(file))
        assert rows and rows[0] == ['original', 'mapped']
        pairs = []
        for lineno, row in enumerate(rows[1:], start=2):
            if not row or all(not cell.strip() for cell in row):
                continue    # blank line
            if len(row) != 2:
                raise exception.DataInvalid(
                    'TrimMapping CSV line %d has %d columns (expected '
                    '2): %r' % (lineno, len(row), row))
            try:
                pairs.append((int(row[0]), int(row[1])))
            except ValueError:
                raise exception.DataInvalid(
                    'TrimMapping CSV line %d has non-integer state '
                    'ids: %r' % (lineno, row))
        return TrimMapping(pairs)

    @property
    def to_mapped(self):
        return {v: k for k, v in self.to_original.items()}

    @to_mapped.setter
    def to_mapped(self, value):
        self.to_original = {v: k for k, v in value.items()}

    def save(self, filename):
        with open(filename, 'w') as f:
            self.write(f)

    def write(self, file):
        writer = csv.writer(file)
        writer.writerow(['original', 'mapped'])
        writer.writerows(sorted(self.to_mapped.items(),
                                key=lambda x: x[0]))

    def __eq__(self, other):
        if self is other:
            return True
        if hasattr(other, 'to_original'):
            return self.to_original == other.to_original
        try:
            return TrimMapping(other) == self
        except Exception:
            return False

    def __repr__(self):
        return 'to_original:' + str(self.to_original)

    __str__ = __repr__


def _transitions_helper(assigns_1d, lag_time=1, sliding_window=True):
    """(start, end) state pairs of one gap-compacted trajectory.
    (reference: transition_matrices.py:310)"""
    seq = np.asarray(assigns_1d)
    stride = 1 if sliding_window else lag_time
    origins = seq[:max(len(seq) - lag_time, 0):stride]
    landings = seq[lag_time::stride]
    return np.stack((origins, landings))


def assigns_to_counts(assigns, lag_time, max_n_states=None,
                      sliding_window=True):
    """Count transitions between states. (reference:
    transition_matrices.py:113)

    Parameters
    ----------
    assigns : 2-D array or RaggedArray, rows = trajectories; -1 marks
        unassigned frames (dropped before pairing).
    lag_time : int, observation interval.
    max_n_states : int, optional matrix dimension override.
    sliding_window : bool, every frame (True) or every lag_time'th.

    Returns
    -------
    C : scipy.sparse.coo_matrix, shape=(n_states, n_states)
    """
    if not isinstance(lag_time, numbers.Integral):
        raise exception.DataInvalid(
            'The lag time must be an integer. Got %s type %s.'
            % (lag_time, type(lag_time)))
    if lag_time < 1:
        raise exception.DataInvalid(
            "Lag times must be be strictly greater than 0. Got '%s'."
            % lag_time)

    if isinstance(assigns, RaggedArray):
        rows = [assigns[i] for i in range(len(assigns))]
    else:
        assigns = np.asarray(assigns)
        if assigns.ndim == 1:
            raise exception.DataInvalid(
                'The given assignments array has 1-dimensional shape %s. '
                'Two dimensional shapes = (n_trj, n_frames) are expected. '
                'If this is really what you want, try using '
                'assignments.reshape(1, -1) to create a single-row 2d '
                'array.' % (assigns.shape,))
        rows = list(assigns)

    rows = [np.asarray(a)[np.asarray(a) != -1] for a in rows]

    if max_n_states is None:
        max_n_states = int(max(
            (a.max() for a in rows if len(a)), default=-1)) + 1

    transitions = [
        _transitions_helper(a, lag_time=lag_time,
                            sliding_window=sliding_window)
        for a in rows if len(a) > lag_time]
    if transitions:
        mat_coords = np.hstack(transitions)
    else:
        mat_coords = np.zeros((2, 0), dtype=int)
    mat_data = np.ones(mat_coords.shape[1], dtype=int)
    return scipy.sparse.coo_matrix(
        (mat_data, mat_coords), shape=(max_n_states, max_n_states))


def assigns_to_counts_device(assigns_padded, mask, lag_time, n_states,
                             sliding_window=True, device=None):
    """Count the pairs ``(a[t], a[t + lag])`` of padded (n_traj, max_len)
    assignment rows whose two ends are masked in and assigned (>= 0),
    never across rows.

    On gapped (-1-containing) rows this differs from the host
    ``assigns_to_counts``, which compacts the gaps before pairing; on
    gap-free rows the two agree. Runs on ``device`` (default: where
    a tensor ``assigns_padded`` lies, the card for host data) and returns a dense (n_states, n_states)
    int32 tensor there.
    """
    if not isinstance(lag_time, numbers.Integral) or lag_time < 1:
        raise exception.DataInvalid(
            'lag_time must be a positive integer; got %r' % (lag_time,))
    if isinstance(assigns_padded, np.ndarray) \
            and isinstance(mask, np.ndarray) and assigns_padded.size:
        # the counting drops an out-of-range state silently: check host
        # inputs, masked-in cells only (masked-out cells may hold any
        # padding value); device inputs are the caller's contract
        masked_max = int(np.max(assigns_padded, initial=-1,
                                where=mask.astype(bool)))
        if masked_max >= n_states:
            raise exception.DataInvalid(
                'assignment id %d >= n_states=%d' % (masked_max, n_states))
    device = resolve_device(assigns_padded, device)
    a = torch.as_tensor(assigns_padded, device=device).to(torch.int64)
    m = torch.as_tensor(mask, device=device).to(torch.bool)
    start = a[:, :-lag_time]
    end = a[:, lag_time:]
    # a state out of [0, n_states) is dropped with the invalid pairs,
    # never indexed (the scatter-add would assert on the card)
    valid = (m[:, :-lag_time] & m[:, lag_time:] & (start >= 0)
             & (end >= 0) & (start < n_states) & (end < n_states))
    if not sliding_window:
        stride = torch.zeros_like(valid)
        stride[:, ::lag_time] = True
        valid &= stride
    # invalid pairs go to the sentinel bin n_states**2, sliced off
    sentinel = n_states * n_states
    flat = torch.where(valid, start * n_states + end, sentinel)
    # a scatter-add, not torch.bincount: bincount reads the input's min
    # and max back to the host, which would stall a loop over shards
    flat = flat.reshape(-1)
    counts = torch.zeros(sentinel + 1, dtype=torch.int64,
                         device=flat.device)
    counts.index_add_(0, flat, torch.ones_like(flat))
    return counts[:sentinel].to(torch.int32).reshape(n_states, n_states)


def assigns_to_counts_sharded(assigns_padded, mask, lag_time, n_states,
                              sliding_window=True, mesh=None):
    """:func:`assigns_to_counts_device` with the trajectories split over
    the shards of ``mesh`` (default: :func:`~enspara_tpu_torch.parallel.
    mesh.frame_mesh`, every visible card): the rows are padded to a
    multiple of the shard count with masked-out rows and cut into
    contiguous blocks, each shard counts its block on its device, and
    the counts are summed on the lead device, then over the processes
    of the mesh. Lag pairs never cross rows, so the blocks need no halo.

    The numpy inputs are validated up front (the lag and the masked-in
    state ids). Returns the (n_states, n_states) int32 tensor on the
    mesh's lead device.
    """
    from ..parallel.mesh import frame_mesh, shard_frames

    if mesh is None:
        mesh = frame_mesh()
    a = np.asarray(assigns_padded)
    m = np.asarray(mask, dtype=bool)
    if a.size:
        if not isinstance(lag_time, numbers.Integral) or lag_time < 1:
            raise exception.DataInvalid(
                'lag_time must be a positive integer; got %r' % (lag_time,))
        masked_max = int(np.max(a, initial=-1, where=m))
        if masked_max >= n_states:
            raise exception.DataInvalid(
                'assignment id %d >= n_states=%d' % (masked_max, n_states))
    a_sh, _ = shard_frames(np.ascontiguousarray(a, np.int32), mesh)
    m_sh, _ = shard_frames(np.ascontiguousarray(m), mesh, pad_value=False)
    return mesh.reduce([
        assigns_to_counts_device(a_s, m_s, lag_time, n_states,
                                 sliding_window=sliding_window)
        for a_s, m_s in zip(a_sh, m_sh)])


def eigenspectrum(T, n_eigs=None, left=True, maxiter=100000, tol=1E-30):
    """Top eigenvalues/vectors of a transition matrix, sorted by
    descending real part; the first eigenvector is normalized to sum 1
    (equilibrium populations when left=True).
    (reference: transition_matrices.py:173)
    """
    dim = T.shape[0]
    if n_eigs is None:
        k = dim
    else:
        if n_eigs < 2:
            raise ValueError('n_eig must be greater than or equal to 2')
        k = n_eigs

    # left spectra of T are right spectra of T^T
    A = T.transpose() if left else T

    if scipy.sparse.issparse(A):
        if dim < 1000 or k >= dim - 1:
            # ARPACK can't return near-full spectra (it requires
            # k < dim-1, so the n_eigs=None default would always
            # crash the sparse branch); densify instead
            w, phi = scipy.linalg.eig(A.toarray().astype(float))
        else:
            w, phi = scipy.sparse.linalg.eigs(
                A.tocsr().asfptype(), k, which='LR',
                maxiter=maxiter, tol=tol)
    else:
        w, phi = scipy.linalg.eig(np.asarray(A, dtype=float))

    rank = np.argsort(-w.real)
    w, phi = w[rank], phi[:, rank]

    # leading eigenvector scaled to unit mass (= equilibrium populations
    # when left=True)
    phi[:, 0] = phi[:, 0] / phi[:, 0].sum()

    return w.real[:k], phi.real[:, :k]


def trim_disconnected(counts, threshold=1, renumber_states=True):
    """Keep only the maximum-population strongly-connected component of
    the thresholded counts graph. (reference:
    transition_matrices.py:236)

    Returns (TrimMapping, trimmed_counts) with trimmed_counts recast to
    the input container type.
    """
    out_type = type(counts)
    if scipy.sparse.issparse(counts):
        counts = counts.toarray()
    counts = np.asarray(counts)

    thresholded = np.array(counts, copy=True)
    thresholded[counts < threshold] = 0

    n_subgraphs, labels = connected_components(
        thresholded, connection='strong', directed=True)

    pops = counts.sum(axis=1)
    subgraph_pops = [np.sum(pops[labels == i]) for i in range(n_subgraphs)]
    maxpop_subgraph = np.argmax(subgraph_pops)
    keep_states = np.where(labels == maxpop_subgraph)[0]

    if renumber_states:
        trimmed_counts = counts[np.ix_(keep_states, keep_states)].copy()
        mapping = TrimMapping(zip(keep_states, range(len(trimmed_counts))))
    else:
        trim_states = np.where(labels != maxpop_subgraph)
        trimmed_counts = np.array(counts, copy=True)
        trimmed_counts[trim_states, :] = 0
        trimmed_counts[:, trim_states] = 0
        mapping = TrimMapping(zip(keep_states, keep_states))

    if out_type is not np.ndarray and out_type is not type(trimmed_counts):
        try:
            trimmed_counts = out_type(trimmed_counts)
        except TypeError:
            pass

    return mapping, trimmed_counts


def _eq_probs_detailed_balance(T, rel_tol=1e-10):
    """O(nnz) stationary distribution for a reversible chain, or None.

    If T is row-stochastic and satisfies detailed balance w.r.t. some
    pi, then along any edge with T_ij > 0 and T_ji > 0,
    ``log pi_j - log pi_i = log T_ij - log T_ji``. Propagating those
    increments over a BFS spanning tree of the symmetric-support graph
    determines log-pi up to the normalization constant — no eigensolve.
    The candidate is then *certified* on every stored entry
    (max |pi_i T_ij - pi_j T_ji| <= rel_tol * max |pi_i T_ij|) and on
    row-stochasticity; any violation returns None so the caller falls
    back to the eigensolver. Builders that symmetrize counts
    (transpose, Prinz MLE) produce exact detailed balance, so their
    chains always take this path. A dense T takes the same steps in numpy
    (the same tree, the same values: the same pi): on a 500-state dye
    chain its conversion to CSR alone costs about as much as the solve.
    """
    dense = not scipy.sparse.issparse(T)
    S = (np.asarray(T, dtype=np.float64) if dense
         else scipy.sparse.csr_matrix(T, dtype=np.float64))
    n = S.shape[0]
    if S.ndim != 2 or n == 0 or S.shape[0] != S.shape[1]:
        return None
    rows = np.asarray(S.sum(axis=1)).ravel()
    if not np.all(np.isfinite(rows)) or np.abs(rows - 1.0).max() > 1e-8:
        return None
    values = S if dense else S.data
    if not values.any() or (values < 0).any():
        return None

    # spanning tree over edges present in BOTH directions
    support = (S != 0)
    sym = scipy.sparse.csr_matrix(support & support.T) if dense else \
        support.multiply(support.T).tocsr()
    n_comp, _ = connected_components(sym, directed=False)
    if n_comp != 1:
        return None
    order, pred = breadth_first_order(
        sym, 0, directed=False, return_predecessors=True)
    if order.shape[0] != n:
        return None

    # log-space walk: children appear after their predecessor in BFS
    # order, so one pass assigns every node
    children = order[1:]
    parents = pred[children]
    with np.errstate(divide='ignore'):
        fwd = np.log(np.asarray(
            S[parents, children]).ravel())          # T[parent, child]
        bwd = np.log(np.asarray(
            S[children, parents]).ravel())          # T[child, parent]
    delta = fwd - bwd
    log_pi = np.zeros(n)
    for c, p, d in zip(children, parents, delta):
        log_pi[c] = log_pi[p] + d
    log_pi -= log_pi.max()
    pi = np.exp(log_pi)
    pi /= pi.sum()

    # certify detailed balance on EVERY stored entry, not just the tree
    if dense:
        F = S * pi[:, None]                         # flux pi_i T_ij
        asym = np.abs(F - F.T)
        bound = rel_tol * F.max()
    else:
        F = S.multiply(pi[:, None]).tocoo()
        asym = np.abs((F - F.T).tocoo().data)
        bound = rel_tol * F.data.max()
    if asym.size and asym.max() > bound:
        return None
    return pi


def _eq_probs_with_empty_states(T):
    """:func:`_eq_probs_detailed_balance` of a chain that may hold empty
    states (a zero row and a zero column, as ``remove_bad_states`` leaves
    them): pi of the other states, 0 at the empty ones, which is the top
    left eigenvector of T. None where a zero row has a nonzero column, or
    the other states fail the fast path."""
    if scipy.sparse.issparse(T):
        T = scipy.sparse.csr_matrix(T, dtype=np.float64)
        mass = abs(T)
    else:
        T = np.asarray(T, dtype=np.float64)
        mass = np.abs(T)
    if T.ndim != 2 or T.shape[0] != T.shape[1]:
        return None
    empty = np.ravel(np.asarray(mass.sum(axis=1))) == 0
    if not empty.any():
        return _eq_probs_detailed_balance(T)
    if empty.all() or np.ravel(np.asarray(mass.sum(axis=0)))[empty].any():
        return None
    live = np.flatnonzero(~empty)
    # one live state: its row is its self-transition
    sub = (np.ones(1) if len(live) == 1
           else _eq_probs_detailed_balance(T[live][:, live]))
    if sub is None:
        return None
    pi = np.zeros(T.shape[0])
    pi[live] = sub
    return pi


def eq_probs(T, maxiter=100000, tol=1E-30):
    """Equilibrium populations: the top left eigenvector, normalized.
    (reference: transition_matrices.py:304)

    Reversible chains (builders.transpose / builders.mle output) skip
    the eigensolver entirely: detailed balance determines pi along a
    spanning tree in O(nnz), certified on every entry — the ARPACK
    left-eigenvector solve only runs for non-reversible input. States
    with no counts in or out (a row and a column of zeros) take pi = 0
    on that path, as the eigenvector has it.
    """
    pi = _eq_probs_with_empty_states(T)
    if pi is not None:
        return pi
    val, vec = eigenspectrum(T, n_eigs=3, left=True, maxiter=maxiter,
                             tol=tol)
    return vec[:, 0]
