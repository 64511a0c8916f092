"""Bootstrap resampling of trajectory sets (counterpart of
``enspara_tpu/msm/bootstrap.py``, host code with numpy's
``default_rng``: the same ``random_state`` resamples the same rows as
the JAX package; reference: enspara/msm/bootstrap.py).

The reference copies assignments into POSIX shared memory and fans out
over a process pool; here trajectories are resampled by index (zero-copy
row views of the same arrays) and trials fan out over threads — the
heavy work (counting, builders, eigensolves) runs in C/scipy/torch and
releases the GIL.
"""

from concurrent.futures import ThreadPoolExecutor

import numpy as np

from . import msm as msm_mod
from ..ra import RaggedArray

__all__ = ['bootstrap', 'MSMs']


def bootstrap(func, data, n_trials, n_procs=1, random_state=None,
              **kwargs):
    """Evaluate ``func`` on ``n_trials`` with-replacement resamplings of
    the rows of ``data``. Extra kwargs pass through to ``func``.
    (reference: bootstrap.py:10)"""
    rng = np.random.default_rng(random_state)
    n_rows = len(data)
    samplings = [rng.choice(n_rows, n_rows) for _ in range(n_trials)]

    def one(iis):
        if isinstance(data, RaggedArray):
            resampled = RaggedArray([np.asarray(data[i]) for i in iis])
        else:
            resampled = np.asarray(data)[iis]
        return func(resampled, **kwargs)

    if n_procs and n_procs > 1:
        with ThreadPoolExecutor(max_workers=n_procs) as ex:
            return list(ex.map(one, samplings))
    return [one(iis) for iis in samplings]


def _chunk_assignments(assignments, chunk_by):
    rows = []
    for row in assignments:
        row = np.asarray(row)
        for start in range(0, len(row), chunk_by):
            chunk = row[start:start + chunk_by]
            if len(chunk):
                rows.append(chunk)
    lengths = [len(r) for r in rows]
    if len(set(lengths)) == 1:
        return np.array(rows)
    return RaggedArray(rows)


def MSMs(assignments, lag_time, method, n_trials, max_n_states=None,
         n_procs=1, chunk_by=None, random_state=None, fast=True,
         **kwargs):
    """Bootstrap an ensemble of MSMs. (reference: bootstrap.py:51)

    With ``fast=True`` (default) per-trajectory transition counts are
    computed ONCE and each replicate's counts are the
    multiplicity-weighted sum — exactly equal to re-counting the
    resampled rows (counts are additive over trajectories) but O(rows)
    instead of O(frames) per trial. ``fast=False`` re-counts per trial
    (the reference's shape of work).
    """
    if chunk_by is not None:
        assignments = _chunk_assignments(assignments, chunk_by)
    if not fast:
        return bootstrap(
            msm_mod.MSM.from_assignments, assignments,
            lag_time=lag_time, method=method, n_trials=n_trials,
            max_n_states=max_n_states, n_procs=n_procs,
            random_state=random_state, **kwargs)

    from .transition_matrices import assigns_to_counts

    rows = [np.asarray(assignments[i]) for i in range(len(assignments))]
    row_max = np.array([int(r[r != -1].max()) if (r != -1).any()
                        else -1 for r in rows])
    n_states_global = (int(max_n_states) if max_n_states is not None
                       else int(row_max.max()) + 1)
    sliding = kwargs.pop('sliding_window', True)
    per_row = [assigns_to_counts(
        r.reshape(1, -1), lag_time=lag_time,
        max_n_states=n_states_global,
        sliding_window=sliding).tocsr() for r in rows]

    rng = np.random.default_rng(random_state)
    n_rows = len(rows)
    samplings = [rng.choice(n_rows, n_rows) for _ in range(n_trials)]

    def one(iis):
        mult = np.bincount(iis, minlength=n_rows)
        C = None
        for i in np.nonzero(mult)[0]:
            term = per_row[i] * int(mult[i])
            C = term if C is None else C + term
        if max_n_states is None:
            # match per-trial shape semantics of the naive path: each
            # trial sizes its matrix by its own sampled rows
            k = int(row_max[iis].max()) + 1
            C = C[:k, :k]
        m = msm_mod.MSM(lag_time=lag_time, method=method,
                        max_n_states=max_n_states,
                        sliding_window=sliding, **kwargs)
        return m.fit_from_counts(C.tocoo())

    if n_procs and n_procs > 1:
        with ThreadPoolExecutor(max_workers=n_procs) as ex:
            return list(ex.map(one, samplings))
    return [one(iis) for iis in samplings]
