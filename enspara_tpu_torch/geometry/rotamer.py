"""Rotamer-state featurization with hysteresis ("buffered transition")
assignment (counterpart of ``enspara_tpu/geometry/rotamer.py``;
reference: enspara/geometry/rotamer.py).

A dihedral keeps its basin until its angle crosses that basin's buffered
gates. Each frame's update is therefore a map over the 2-3 basins, and
maps compose associatively: :func:`rotamer_states` builds the per-frame
maps of every dihedral at once and composes them with a Hillis-Steele
doubling scan in torch ops (``log2(chunk)`` passes a chunk of frames,
the state carried from chunk to chunk). The gates compare float32
angles against float32 gate values, as the JAX package's device path
does (``rotamers_device``); :func:`_rotamers` is the sequential host
version in float64, the plain version and test oracle.
"""

import numpy as np
import torch

from ..exception import DataInvalid
from ..util.device import resolve_device
from . import dihedrals as dih

__all__ = ['dihedral_angles', 'all_rotamers', 'phi_rotamers',
           'psi_rotamers', 'chi_rotamers', '_rotamers',
           'rotamers_device', 'rotamer_states', 'get_gates',
           'is_buffered_transition']


_DIHEDRAL_KINDS = ('phi', 'psi', 'chi1', 'chi2', 'chi3', 'chi4')

# frames a chunk of the scan
_SCAN_CHUNK = 1 << 16


def _degrees(traj, kinds, device):
    """Quartets (n, 4) and angles of the dihedrals of ``kinds``, an
    (n_frames, n) float64 tensor of degrees in [0, 359.5] on the device:
    float64 from the float32 radians, as the JAX package converts them on
    the host, capped just below the seam so that a digitize never lands
    on 360."""
    q = np.concatenate([dih.atom_quartets(traj.top, k) for k in kinds])
    rad = dih.dihedrals_tensor(traj.xyz, q, device)
    deg = torch.remainder(torch.rad2deg(rad.double()), 360.0)
    return q, deg.clamp_(max=359.5)


def dihedral_angles(traj, dihedral_type, device=None):
    """Angles in degrees spanning [0, 360), float64 numpy, and their atom
    quartets. (reference: rotamer.py:6)"""
    if dihedral_type not in _DIHEDRAL_KINDS:
        return None, None
    q, deg = _degrees(traj, (dihedral_type,), device)
    return deg.cpu().numpy(), q


def _validate_basins(hard_boundaries, buffer_width):
    if not 0 <= buffer_width < 360.0 / (len(hard_boundaries) - 1):
        raise DataInvalid(
            'Buffer width must sit in [0, 360/n_basins) degrees; got %s.'
            % buffer_width)
    if (hard_boundaries[0], hard_boundaries[-1]) != (0, 360):
        raise DataInvalid(
            'hard_boundaries must run from 0 to 360; got %s.'
            % (hard_boundaries,))


def _gates(cur_state, hard_boundaries, buffer_width):
    """(reference: rotamer.py:162 get_gates)"""
    s = int(cur_state)
    below, above = hard_boundaries[s], hard_boundaries[s + 1]
    # a basin touching the 0/360 seam gates on the far side of it
    below = below if below else 360
    above = 0 if above == 360 else above
    return below - buffer_width, above + buffer_width


def _crossed(lower, upper, angles):
    """Where ``angles`` (a numpy array or a tensor) lie past the gates
    ``(lower, upper)``; a wrap-around basin has ``upper < lower``, and
    coinciding gates are never crossed."""
    if upper < lower:
        return (upper <= angles) & (angles <= lower)
    if upper > lower:
        return ~((lower <= angles) & (angles <= upper))
    return (angles < lower) & (angles > lower)


def _is_buffered_transition(cur_state, new_angle, hard_boundaries,
                            buffer_width):
    """(reference: rotamer.py:98)"""
    lower, upper = _gates(cur_state, hard_boundaries, buffer_width)
    if upper < lower:
        return upper <= new_angle <= lower
    if upper > lower:
        return not (lower <= new_angle <= upper)
    return False


def get_gates(cur_state, hard_boundaries, buffer_width):
    """Gate angles a dihedral must exit to leave its buffered basin —
    public name-compat with the reference (rotamer.py:163). Returns
    ``(lower_bound, upper_bound)``; a wrap-around basin has
    ``upper < lower``."""
    return _gates(cur_state, hard_boundaries, buffer_width)


def is_buffered_transition(cur_state, new_angle, hard_boundaries,
                           buffer_width):
    """Whether moving to ``new_angle`` is a real (buffer-crossing)
    transition out of basin ``cur_state`` — public name-compat with
    the reference (rotamer.py:98)."""
    return _is_buffered_transition(cur_state, new_angle,
                                   hard_boundaries, buffer_width)


def _rotamers(angles, hard_boundaries, buffer_width=15):
    """Hysteresis state assignment of one dihedral's time series, int16,
    sequential on the host in float64 (reference: rotamer.py:28).

    The frame-by-frame recurrence of the JAX package, walked from one
    gate crossing to the next: for each basin, the next frame at or
    after every frame whose angle crosses that basin's gates is found
    in one vectorized pass, and the walk jumps from crossing to
    crossing."""
    _validate_basins(hard_boundaries, buffer_width)
    angles = np.asarray(angles)
    bounds = np.asarray(hard_boundaries, dtype=float)
    n = len(angles)
    dig = np.digitize(angles, bounds) - 1
    frames = np.arange(n)
    next_crossing = []
    for s in range(len(bounds) - 1):
        hit = _crossed(*_gates(s, hard_boundaries, buffer_width), angles)
        # first crossing frame at or after each frame; n when none
        next_crossing.append(np.minimum.accumulate(
            np.where(hit, frames, n)[::-1])[::-1])

    out = np.empty(n, dtype='int16')
    state, t = dig[0], 0
    while True:
        nxt = next_crossing[state][t + 1] if t + 1 < n else n
        out[t:nxt] = state
        if nxt >= n:
            return out
        state, t = dig[nxt], nxt


def _gate_tables(hard_boundaries, buffer_width):
    """float32 (interior boundaries, lower gates, upper gates), as the
    JAX device path computes them."""
    bounds = np.asarray(hard_boundaries, np.float32)
    lower = np.where(bounds[:-1] == 0, np.float32(360), bounds[:-1]) \
        - np.float32(buffer_width)
    upper = np.where(bounds[1:] == 360, np.float32(0), bounds[1:]) \
        + np.float32(buffer_width)
    return bounds[1:-1], lower.astype(np.float32), upper.astype(np.float32)


def _digitize(a, interior):
    """Basin of each float32 angle: the count of interior boundaries at
    or below it (np.digitize's rule, clipped to the basins), int8."""
    dig = torch.zeros(a.shape, dtype=torch.int8, device=a.device)
    for b in interior:
        dig += a >= float(b)
    return dig


def _apply(g, f):
    """``out[s] = g[f[s]]`` elementwise over frames and dihedrals: the
    map ``f`` (first) then ``g``; ``g`` is (S, t, F), ``f`` (S, t, F) or
    (t, F). A select chain over the S planes of ``g``."""
    n_basins = g.shape[0]
    out = g[n_basins - 1].expand(f.shape)
    for s in reversed(range(n_basins - 1)):
        out = torch.where(f == s, g[s], out)
    return out


def _scan_chunk(a, carry, interior, lower, upper):
    """States (t, F) int8 of the float32 angles ``a`` (t, F) that follow
    the states ``carry`` (F,)."""
    n_basins = len(lower)
    dig = _digitize(a, interior)
    maps = torch.empty((n_basins,) + tuple(a.shape), dtype=torch.int8,
                       device=a.device)
    for s in range(n_basins):
        maps[s] = torch.where(_crossed(float(lower[s]), float(upper[s]), a),
                              dig, s)
    # Hillis-Steele: after the pass of step d, maps[:, t] composes the
    # frames (t - 2d, t]; each pass reads the maps of the pass before
    d = 1
    while d < a.shape[0]:
        maps[:, d:] = _apply(maps[:, d:], maps[:, :-d])
        d *= 2
    return _apply(maps, carry.expand(a.shape))


def rotamer_states(angles, hard_boundaries, buffer_width=15, device=None,
                   chunk=_SCAN_CHUNK):
    """Hysteresis assignment of many dihedrals at once: ``angles``
    (n_frames, n_dihedrals) in degrees in [0, 360), numpy or a tensor;
    returns (n_frames, n_dihedrals) int16 states, a tensor on ``device``
    (default: where ``angles`` lies; host input goes to the card).
    Equal, column by column, to :func:`_rotamers` of the float32 angles."""
    _validate_basins(hard_boundaries, buffer_width)
    dev = resolve_device(angles, device)
    angles = torch.as_tensor(angles)
    interior, lower, upper = _gate_tables(hard_boundaries, buffer_width)
    T = angles.shape[0]
    out = torch.empty(tuple(angles.shape), dtype=torch.int16, device=dev)
    if T == 0:
        return out
    carry = _digitize(angles[0].to(dev, torch.float32), interior)
    out[0] = carry
    for lo in range(1, T, chunk):
        states = _scan_chunk(angles[lo:lo + chunk].to(dev, torch.float32),
                             carry, interior, lower, upper)
        out[lo:lo + chunk] = states
        carry = states[-1]
    return out


def rotamers_device(angles, hard_boundaries, buffer_width=15,
                    chunk=_SCAN_CHUNK, device=None):
    """:func:`rotamer_states` as (n_frames, n_dihedrals) int16 numpy
    (the JAX package's ``rotamers_device``)."""
    return rotamer_states(angles, hard_boundaries, buffer_width, device,
                          chunk).cpu().numpy()


# the dihedral families: kinds, basin boundaries, and the shift in degrees
# that puts the family's basin boundaries on the 0/360 seam
PHI = (('phi',), [0, 180, 360], 0.0)
PSI = (('psi',), [0, 160, 360], 100.0)
CHI = (('chi1', 'chi2', 'chi3', 'chi4'), [0, 120, 240, 360], 0.0)


def _rotamer_families(traj, families, buffer_width, device):
    """Featurize dihedral families on the device from one evaluation of
    their angles: each family's angles rotated by its shift and
    hysteresis-assigned. Returns ``(states, atom_inds, n_states)``."""
    atom_inds, deg = _degrees(
        traj, [k for kinds, _, _ in families for k in kinds], device)
    states, n_states, lo = [], [], 0
    for kinds, hard_boundaries, shift in families:
        n = sum(len(dih.atom_quartets(traj.top, k)) for k in kinds)
        angles = deg[:, lo:lo + n]
        lo += n
        if shift:
            angles = torch.remainder(angles - shift, 360.0)
        states.append(rotamer_states(angles, hard_boundaries, buffer_width))
        n_states.append(np.full(n, len(hard_boundaries) - 1, dtype='int16'))
    return (torch.cat(states, dim=1).cpu().numpy(), atom_inds,
            np.concatenate(n_states))


def phi_rotamers(traj, buffer_width=15, device=None):
    """(reference: rotamer.py:222)"""
    return _rotamer_families(traj, (PHI,), buffer_width, device)


def psi_rotamers(traj, buffer_width=15, device=None):
    """psi angles shifted by -100 degrees so the basin boundaries land
    on 0/360. (reference: rotamer.py:236)"""
    return _rotamer_families(traj, (PSI,), buffer_width, device)


def chi_rotamers(traj, buffer_width=15, device=None):
    """chi1-chi4 concatenated, 3 basins each. (reference:
    rotamer.py:255)"""
    return _rotamer_families(traj, (CHI,), buffer_width, device)


def all_rotamers(traj, buffer_width=15, device=None):
    """All phi/psi/chi rotamer state assignments:
    ``(states (n_frames, n_dihedrals) int16, atom_inds (n_dihedrals, 4),
    n_states (n_dihedrals,))``, on ``device`` (default: the card).
    (reference: rotamer.py:276)"""
    return _rotamer_families(traj, (PHI, PSI, CHI), buffer_width, device)
