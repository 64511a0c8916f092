"""Highest-flux pathway extraction from a net-flux network (counterpart
of ``enspara_tpu/tpt/path.py``, host code; reference: enspara/tpt/path.py,
itself derived from msmbuilder).

``top_path`` finds the maximum-bottleneck ("widest") path from any
source to any sink with a heap-based Dijkstra variant — a host graph
algorithm by design (SURVEY.md §3.4). ``paths`` iteratively removes each
found path ('subtract' or 'bottleneck') until ``num_paths`` or the flux
cutoff is reached.

Unlike the reference (which densifies the flux matrix and scans full
rows per visited node, tpt/path.py:114-150), the search here runs on
CSR adjacency — O((V+E) log V) per path — so 10 paths on a 10k-state
sparse MSM take milliseconds instead of a minute, and the flux matrix
is never materialized dense.
"""

import copy
import heapq

import numpy as np
import scipy.sparse

__all__ = ['paths', 'top_path']


def _as_sorted_csr(net_flux):
    """Any matrix -> canonical CSR with sorted column indices (so the
    neighbor visit order matches the reference's ascending np.where)."""
    if scipy.sparse.issparse(net_flux):
        csr = net_flux.tocsr(copy=True)
    else:
        csr = scipy.sparse.csr_matrix(np.asarray(net_flux))
    csr.sum_duplicates()
    csr.sort_indices()
    return csr


def _top_path_csr(sources, sinks, csr):
    """Maximum-bottleneck path over CSR adjacency (Dijkstra variant
    keyed on min edge flux along the path, reference tpt/path.py:46).

    The reference pops its work list with a first-max ``argmax`` over a
    python list, so ties on path flux break by INSERTION order — and
    ties are common, because every node downstream of a bottleneck edge
    carries the same path flux. A lazy max-heap keyed on
    ``(-flux, first_insertion_seq)`` reproduces that order exactly: a
    node improved while queued keeps the sequence number of its
    earliest surviving queue entry (the entry the reference's argmax
    would find first), and stale heap entries are skipped when their
    flux no longer matches the node's current best."""
    n_states = csr.shape[0]
    indptr, indices, data = csr.indptr, csr.indices, csr.data

    visited = np.zeros(n_states, dtype=bool)
    previous_node = np.full(n_states, -1, dtype=int)
    min_fluxes = np.full(n_states, -np.inf)
    min_fluxes[sources] = np.inf

    first_seq = np.full(n_states, -1, dtype=np.int64)
    next_seq = 0
    heap = []
    for s in sources:
        s = int(s)
        if first_seq[s] < 0:        # duplicate sources queue once
            first_seq[s] = next_seq
            heap.append((-np.inf, next_seq, s))
            next_seq += 1
    heapq.heapify(heap)

    while heap:
        neg_flux, _, node = heapq.heappop(heap)
        if visited[node] or -neg_flux != min_fluxes[node]:
            continue                # stale entry (improved or done)
        visited[node] = True

        if np.all(visited[sinks]):
            break

        lo, hi = indptr[node], indptr[node + 1]
        nbrs = indices[lo:hi]
        edges = data[lo:hi]
        pos = edges > 0
        if not pos.all():
            nbrs, edges = nbrs[pos], edges[pos]
        if nbrs.size == 0:
            continue

        # bottleneck to each neighbor = min(path flux so far, edge flux)
        new_fluxes = np.minimum(edges, min_fluxes[node])
        better = (~visited[nbrs]) & (new_fluxes > min_fluxes[nbrs])
        upd = nbrs[better]
        min_fluxes[upd] = new_fluxes[better]
        previous_node[upd] = node
        for u, f in zip(upd.tolist(), new_fluxes[better].tolist()):
            if first_seq[u] < 0:
                first_seq[u] = next_seq
                next_seq += 1
            heapq.heappush(heap, (-f, first_seq[u], u))

    path = [int(sinks[min_fluxes[sinks].argmax()])]
    while previous_node[path[-1]] != -1:
        path.append(int(previous_node[path[-1]]))

    return np.array(path[::-1]), min_fluxes[path[0]]


def top_path(sources, sinks, net_flux):
    """Maximum-bottleneck path from sources to sinks.

    Returns ``(path_states, path_flux)`` where path_flux is the minimum
    edge flux along the path. (reference: tpt/path.py:46)
    """
    sources = np.array(sources, dtype=int).reshape(-1)
    sinks = np.array(sinks, dtype=int).reshape(-1)
    return _top_path_csr(sources, sinks, _as_sorted_csr(net_flux))


def _path_edge_positions(csr, path):
    """Positions in ``csr.data`` of the traversed edges
    (path[i] -> path[i+1]); every edge exists because the search just
    walked it."""
    pos = np.empty(len(path) - 1, dtype=np.int64)
    for i in range(len(path) - 1):
        u, v = path[i], path[i + 1]
        lo, hi = csr.indptr[u], csr.indptr[u + 1]
        pos[i] = lo + np.searchsorted(csr.indices[lo:hi], v)
    return pos


def _remove_bottleneck_csr(csr, path):
    """Zero only the path's bottleneck edge, in CSR data."""
    pos = _path_edge_positions(csr, path)
    csr.data[pos[csr.data[pos].argmin()]] = 0.0


def _subtract_path_flux_csr(csr, path):
    """Subtract the path flux from every edge along it, in CSR data."""
    pos = _path_edge_positions(csr, path)
    vals = csr.data[pos] - csr.data[pos].min()
    csr.data[pos] = vals
    csr.data[pos[vals.argmin()]] = 0.0


def _path_edges(path):
    """(row_idx, col_idx) arrays for the consecutive edges of ``path``."""
    hops = np.asarray(path)
    return hops[:-1], hops[1:]


def _remove_bottleneck(net_flux, path):
    """Zero only the path's bottleneck edge. (reference: tpt/path.py:163)"""
    out = copy.copy(net_flux)
    rows, cols = _path_edges(path)
    weakest = np.ravel(out[rows, cols]).argmin()
    out[rows[weakest], cols[weakest]] = 0.0
    return out


def _subtract_path_flux(net_flux, path):
    """Subtract the path flux from every edge along it.
    (reference: tpt/path.py:178)"""
    out = copy.copy(net_flux)
    rows, cols = _path_edges(path)
    edge_vals = np.ravel(out[rows, cols])
    floor = edge_vals.min()
    out[rows, cols] = edge_vals - floor
    # pin the weakest edge to exactly 0.0 against fp subtraction error
    weakest = edge_vals.argmin()
    out[rows[weakest], cols[weakest]] = 0.0
    return out


_CSR_REMOVERS = {'subtract': _subtract_path_flux_csr,
                 'bottleneck': _remove_bottleneck_csr}


def paths(sources, sinks, net_flux, remove_path='subtract',
          num_paths=np.inf, flux_cutoff=(1 - 1E-10)):
    """Top-N highest-flux paths by iterative removal.
    (reference: tpt/path.py:197)

    Returns ``(paths_list, fluxes_array)``. The named removal schemes
    ('subtract', 'bottleneck') run entirely on CSR adjacency; a custom
    callable ``remove_path`` receives the dense flux matrix, as in the
    reference.
    """
    csr_remover = None
    if not callable(remove_path):
        csr_remover = _CSR_REMOVERS.get(remove_path)
        if csr_remover is None:
            raise ValueError(
                "remove_path_func (%s) must be a callable or one of "
                "['subtract', 'bottleneck']" % str(remove_path))

    sources = np.array(sources, dtype=int).reshape(-1)
    sinks = np.array(sinks, dtype=int).reshape(-1)

    if csr_remover is not None:
        net_flux = _as_sorted_csr(net_flux)
        total_flux = net_flux[sources, :].sum()
    else:
        if scipy.sparse.issparse(net_flux):
            net_flux = net_flux.toarray()
        net_flux = np.array(net_flux, copy=True)
        total_flux = net_flux[sources, :].sum()

    found_paths = []
    fluxes = []

    counter = 0
    expl_flux = 0.0
    while True:
        if csr_remover is not None:
            path, flux = _top_path_csr(sources, sinks, net_flux)
        else:
            path, flux = top_path(sources, sinks, net_flux)
        if np.isinf(flux) or flux <= 0:
            break

        found_paths.append(path)
        fluxes.append(flux)

        expl_flux += flux / total_flux
        counter += 1
        if counter >= num_paths or expl_flux >= flux_cutoff:
            break

        if csr_remover is not None:
            csr_remover(net_flux, path)     # in-place on the CSR copy
        else:
            net_flux = remove_path(net_flux, path)

    return found_paths, np.array(fluxes)
