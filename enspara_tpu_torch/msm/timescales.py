"""Implied timescales over a range of lag times (counterpart of
``enspara_tpu/msm/timescales.py:22-64``, host code; reference:
enspara/msm/timescales.py).

Each lag time is independent (the reference computes them serially,
timescales.py:88-92); here they fan out over a thread pool — the
eigensolves release the GIL (scipy).
"""

import logging
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from .transition_matrices import (assigns_to_counts, eigenspectrum,
                                  trim_disconnected)

logger = logging.getLogger(__name__)

__all__ = ['implied_timescales', 'calc_imp_times']


def calc_imp_times(assigns, lag_time, n_states, n_times, method,
                   sliding_window, trim):
    """Implied timescales at a single lag: counts -> [trim] -> builder
    -> top (n_times+1) eigenvalues -> -lag/ln(lambda).
    (reference: timescales.py:12)"""
    counts = assigns_to_counts(
        assigns, max_n_states=n_states, lag_time=lag_time,
        sliding_window=sliding_window)
    if trim:
        counts = trim_disconnected(counts)[1]

    tprobs = method(counts)[1]

    # n_times+1 eigenpairs: the stationary mode is dropped below
    spectrum = eigenspectrum(tprobs, n_eigs=n_times + 1)[0]
    return -lag_time / np.log(spectrum[1:])


def implied_timescales(assigns, lag_times, method, n_times=None,
                       sliding_window=True, trim=False, n_procs=None):
    """Implied timescales for every lag in ``lag_times``; returns an
    array of shape (len(lag_times), n_times).
    (reference: timescales.py:43; fan-out over lags is new.)"""
    n_states = int(np.max(np.asarray(assigns)
                          if not hasattr(assigns, '_data')
                          else assigns._data)) + 1

    if n_times is None:
        n_times = int(np.floor(n_states / 10.0)) + 1
    if n_times > n_states - 1:
        n_times = n_states - 1

    def one(t):
        return calc_imp_times(assigns, t, n_states, n_times, method,
                              sliding_window, trim)

    if n_procs is not None and n_procs > 1 and len(lag_times) > 1:
        with ThreadPoolExecutor(max_workers=n_procs) as ex:
            results = list(ex.map(one, lag_times))
    else:
        results = [one(t) for t in lag_times]

    return np.array(results)
