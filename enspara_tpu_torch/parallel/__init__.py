"""The frame mesh, its collectives and striped loading: sharded jobs on
one card (virtual shards), several cards, or several processes over
``torch.distributed``."""

from .mesh import (frame_mesh, shard_frames, replicated, n_devices,  # noqa: F401
                   initialize_distributed, FRAME_AXIS, FrameMesh,
                   host_fetch, job_mesh, placement)
from . import ops  # noqa: F401
