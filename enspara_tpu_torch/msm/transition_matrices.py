"""Masked transition counting on a device (counterpart of
``assigns_to_counts_device`` in ``enspara_tpu/msm/transition_matrices.py``)."""

import numbers

import numpy as np
import torch

from enspara_tpu import exception

from ..util.device import resolve_device

__all__ = ['assigns_to_counts_device']


def assigns_to_counts_device(assigns_padded, mask, lag_time, n_states,
                             sliding_window=True, device=None):
    """Count the pairs ``(a[t], a[t + lag])`` of padded (n_traj, max_len)
    assignment rows whose two ends are masked in and assigned (>= 0),
    never across rows.

    On gapped (-1-containing) rows this differs from the host
    ``assigns_to_counts``, which compacts the gaps before pairing; on
    gap-free rows the two agree. Runs on ``device`` (default: where
    ``assigns_padded`` lies) and returns a dense (n_states, n_states)
    int32 tensor there.
    """
    if not isinstance(lag_time, numbers.Integral) or lag_time < 1:
        raise exception.DataInvalid(
            'lag_time must be a positive integer; got %r' % (lag_time,))
    if isinstance(assigns_padded, np.ndarray) \
            and isinstance(mask, np.ndarray) and assigns_padded.size:
        # bincount would silently drop out-of-range states: check host
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
    valid = (m[:, :-lag_time] & m[:, lag_time:] & (start >= 0)
             & (end >= 0))
    if not sliding_window:
        stride = torch.zeros_like(valid)
        stride[:, ::lag_time] = True
        valid &= stride
    # invalid pairs go to the sentinel bin n_states**2, sliced off
    sentinel = n_states * n_states
    flat = torch.where(valid, start * n_states + end, sentinel)
    counts = torch.bincount(flat.reshape(-1), minlength=sentinel + 1)
    return counts[:sentinel].to(torch.int32).reshape(n_states, n_states)
