"""Geometry on the host (counterpart of ``enspara_tpu/geometry``): so far
the point-against-set distances of :mod:`.libdist`."""

from . import libdist  # noqa: F401
