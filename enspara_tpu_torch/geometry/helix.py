"""Alpha-helix axis vectors and per-residue orthogonal frames, host
numpy (counterpart of ``enspara_tpu/geometry/helix.py``).

Capability parity with enspara/geometry/helix.py, formulated as pure
broadcast algebra:

* the helix axis per frame comes from sliding-window means of the
  backbone trace — and since the mean of consecutive window-mean
  differences telescopes, it reduces to (first window - last window) /
  (n windows - 1), one subtraction instead of a difference stack;
* the per-residue orthogonal frames are one batched
  project-out-the-axis operation over all (frame, residue) pairs — no
  per-residue Python loop.
"""

import numpy as np

from ..exception import ImproperlyConfigured

__all__ = ['calculate_piecewise_helix_vectors',
           'calculate_summary_helix_vectors',
           'angles_from_plane_projection', 'angles_from_vecs']


def _normalized(vecs):
    """Rows scaled to unit length (any leading batch shape)."""
    return vecs / np.linalg.norm(vecs, axis=-1, keepdims=True)


def _axis_from_backbone(coords, n_avg=4):
    """Helix direction per frame from (frames, atoms, 3) backbone
    coordinates.

    Window means smooth the helical wobble; the average step between
    consecutive window means telescopes to a single difference. The
    window count mirrors the reference's convention of
    ``n_atoms - n_avg - 1`` (helix.py:141-151), and the sign points
    from the helix end toward its start, as there.
    """
    n_windows = coords.shape[1] - n_avg - 1
    windows = np.lib.stride_tricks.sliding_window_view(
        coords, n_avg, axis=1)          # (frames, slots, 3, n_avg)
    smoothed = windows.mean(axis=-1)[:, :n_windows]
    axis = (smoothed[:, 0] - smoothed[:, -1]) / (n_windows - 1)
    return _normalized(axis)


def _atom_indices(top, resnums, names):
    """Atom indices for the given names, residue-major order."""
    queries = [f'name {nm} and resSeq {int(r)}'
               for r in resnums for nm in names]
    return np.asarray([top.select(q)[0] for q in queries])


def _get_backbone_nums(top, resnums):
    return _atom_indices(top, np.sort(resnums), ('N', 'CA', 'C'))


def _get_CA_nums(top, resnums):
    return _atom_indices(top, resnums, ('CA',))


def calculate_piecewise_helix_vectors(trj, helix_resnums=None,
                                      helix_start=None, helix_end=None):
    """Per-frame unit vectors along a helix plus the helix centroid.

    The helix is named either by an explicit residue list or by an
    inclusive [start, end] resSeq range.
    """
    if helix_resnums is None:
        if helix_start is None or helix_end is None:
            raise ImproperlyConfigured(
                "Either 'helix_resnums' or 'helix_start' and "
                "'helix_end' are required.")
        helix_resnums = np.arange(helix_start, helix_end + 1)

    trace = trj.xyz[:, _get_backbone_nums(trj.topology, helix_resnums)]
    # n_avg=12 spans one full turn of N/CA/C triples (4 residues)
    return _axis_from_backbone(trace, n_avg=12), trace.mean(axis=1)


def calculate_summary_helix_vectors(trj, res_refs, helix_resnums=None,
                                    helix_start=None, helix_end=None):
    """Helix axis plus, for each reference residue, the orthogonal
    in-plane vector (axis -> CA, with the axial component projected
    out) and its cross product with the axis — a full right-handed
    frame per (residue, frame).

    Returns ``(axis (frames,3), ref_vectors (refs,frames,3),
    cross_vectors (refs,frames,3), centers (frames,3))``.
    """
    axis, centers = calculate_piecewise_helix_vectors(
        trj, helix_resnums=helix_resnums, helix_start=helix_start,
        helix_end=helix_end)

    ca_xyz = trj.xyz[:, _get_CA_nums(trj.topology, res_refs)]
    toward_ca = centers[:, None, :] - ca_xyz     # (frames, refs, 3)
    axial = np.einsum('frk,fk->fr', toward_ca, axis)
    in_plane = toward_ca - axis[:, None, :] * axial[..., None]

    ref_vectors = _normalized(in_plane).transpose(1, 0, 2)
    cross_vectors = np.cross(ref_vectors, axis)
    return axis, ref_vectors, cross_vectors, centers


def angles_from_plane_projection(vectors, v1, v2, degree=True):
    """Signed angle of each vector's projection onto the (v1, v2)
    plane, measured from v1 (positive toward v2). Also returns the
    in-plane magnitudes.
    """
    basis = np.stack([v1, v2], axis=-1)          # (3, 2)
    uv = np.asarray(vectors) @ basis             # (n, 2) plane coords
    mags = np.hypot(uv[:, 0], uv[:, 1])

    angles = np.arccos(np.round(uv[:, 0] / mags, 5))
    angles = np.where(uv[:, 1] < 0, -angles, angles)
    return (np.degrees(angles) if degree else angles), mags


def angles_from_vecs(vecs, to=0):
    """Angle between every vector and ``vecs[to]``."""
    lengths = np.linalg.norm(vecs, axis=-1)
    cosines = (vecs @ vecs[to]) / (lengths * lengths[to])
    return np.arccos(np.round(cosines, 5))
