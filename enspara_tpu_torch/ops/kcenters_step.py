"""K-centers chunk: ``n_iters`` Gonzalez iterations by QCP RMSD with
tile-granular triangle-inequality skipping.

Counterpart of ``enspara_tpu/ops/kcenters_skip_pallas.py ::
kcenters_chunk_skip_pallas`` and, with ``skip=False``, of
``enspara_tpu/ops/kcenters_chunk_pallas.py :: kcenters_chunk_pallas``.
One call places up to ``n_iters`` centers. Each iteration computes the
RMSD of every frame to the newest center, applies the strict-``<`` min
update of (dist, assig), refreshes the per-tile maxima ``tmax`` and
picks the next center as the first global argmax of ``dist`` (the
``np.argmax`` tie-break). The chunk stops placing centers once the
max distance is ``<= dist_cutoff`` or the budget ``n_total`` is
reached.

A tile whose max distance is ``<= md/2`` (``md`` the finite distance
that chose the new center) cannot change: every existing center is at
least ``md`` from the new one, so the triangle inequality keeps each of
its frames at or below its current distance, and the update is
strict. The CUDA kernel skips such tiles without reading their frames;
``skipcnt`` counts them per iteration by that rule (-1 once stopped).

:func:`kcenters_chunk` runs ``csrc/kcenters_step.cu`` on CUDA tensors
and :func:`kcenters_chunk_plain`, the plain PyTorch version with the
same semantics and no skipping, on CPU tensors. Both update the state
in place.

Frames are float32 or bfloat16 (the TPU kernels' bf16 frame stream: the
frames cross device memory at half width). bf16 frames launch the bf16
entry points of the same source, which upconvert each coordinate at
load; the plain versions upconvert the frames first. Everything else
(G, the center column, the distance state, the arithmetic) is float32
in both.

:func:`kcenters_iteration_skip` is one iteration of one shard of the
sharded loop (counterpart of ``kcenters_iteration_skip_pallas``): the
center was chosen across the shards and arrives as device tensors (its
column, G, ordinal, and the global max distance ``md`` that chose it),
the same skip rule holds against that global ``md``, and the call
returns the shard's (max, first argmax) and skip count for the
collective. Its CUDA kernel is ``kc_iter_skip`` of the same source;
:func:`kcenters_iteration_skip_plain` is its plain version.
"""

import ctypes
import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from . import _build
from .qcp import _einsum_fp32, rmsd_from_S_components_unrolled

__all__ = ['KCentersState', 'make_state', 'start_state', 'tile_summaries',
           'skip_t_pad', 'center_g', 'kcenters_chunk', 'kcenters_chunk_plain',
           'kcenters_iteration_skip', 'kcenters_iteration_skip_plain']

# slots of the int32[8] scalar block, the KcState struct of the CUDA source
_GIDX, _MD, _GC, _I, _NTOT, _CUTOFF, _STOPPED, _TICKET = range(8)

# the center column is staged in 48 KB of static shared memory
_MAX_ROWS = 48 * 1024 // 4


class KCentersState(NamedTuple):
    """Running k-centers state on one device, updated in place."""
    dist: torch.Tensor     # (1, n_pad) float32; padding frames -inf
    assig: torch.Tensor    # (1, n_pad) int32; -1 = unassigned
    tmax: torch.Tensor     # (1, t_pad) float32 per-tile max of dist
    col: torch.Tensor      # (3*A_pad,) float32 column of the placed center
    scal: torch.Tensor     # (8,) int32: gidx, md, gc, i, n_total,
    #                        cutoff, stopped, ticket (floats as bits)

    def scalars(self):
        """``(gidx, md, i)`` on the host: the next center, its
        distance and the ordinal it would take (one 32-byte read)."""
        v = self.scal.cpu().numpy()
        return int(v[_GIDX]), float(v.view(np.float32)[_MD]), int(v[_I])


def skip_t_pad(n_tiles):
    """Length of the ``tmax`` carry: the 128 multiple covering
    ``n_tiles`` (the JAX kernel's layout, kept so the two compare one
    to one)."""
    return max(128, ((n_tiles + 127) // 128) * 128)


def tile_summaries(dist, tile, t_pad):
    """Per-tile max of a (1, n_pad) distance row in the ``tmax`` carry
    layout; entries past the last tile are -inf."""
    n_tiles = dist.shape[1] // tile
    tmax = torch.full((1, t_pad), -math.inf, dtype=torch.float32,
                      device=dist.device)
    tmax[0, :n_tiles] = dist.reshape(n_tiles, tile).amax(dim=1)
    return tmax


def make_state(dist, assig, tmax, rows, gidx0, max0, i_offset, n_total,
               dist_cutoff):
    """A state from explicit values, the arguments the JAX chunk kernel
    takes: the next center ``gidx0`` with distance ``max0``, the
    ordinal ``i_offset`` it takes, the budget and the cutoff."""
    v = np.zeros(8, np.int32)
    f = v.view(np.float32)
    v[_GIDX], f[_MD], v[_I] = int(gidx0), np.float32(max0), int(i_offset)
    v[_NTOT], f[_CUTOFF] = int(n_total), np.float32(dist_cutoff)
    return KCentersState(
        dist, assig, tmax,
        torch.zeros(rows, dtype=torch.float32, device=dist.device),
        torch.from_numpy(v).to(dist.device))


def start_state(dist, assig, rows, tile, n_start, n_total, dist_cutoff):
    """The state a k-centers run starts from: the next center is the
    first argmax of ``dist``."""
    gidx0 = int(torch.argmax(dist[0]))
    n_tiles = dist.shape[1] // tile
    return make_state(dist, assig,
                      tile_summaries(dist, tile, skip_t_pad(n_tiles)), rows,
                      gidx0, float(dist[0, gidx0]), n_start, n_total,
                      dist_cutoff)


FRAME_DTYPES = (torch.float32, torch.bfloat16)


def check_layout(frames, tile):
    """Raise ``ValueError`` unless ``frames`` is the kernels' (3*A_pad,
    n_pad) float32 or bfloat16 layout and ``tile`` a block size that
    divides it."""
    if frames.dtype not in FRAME_DTYPES or frames.ndim != 2:
        raise ValueError('frames_r must be 2-D float32 or bfloat16, got '
                         '%s %s' % (frames.dtype, tuple(frames.shape)))
    rows, n_pad = frames.shape
    if rows % 24 or rows > _MAX_ROWS:
        raise ValueError('frames_r needs 3*A_pad rows with A_pad a '
                         'multiple of 8 and 3*A_pad <= %d, got %d'
                         % (_MAX_ROWS, rows))
    if tile % 32 or not 32 <= tile <= 1024 or n_pad % tile:
        raise ValueError('tile must be a multiple of 32 in [32, 1024] '
                         'dividing n_pad=%d, got %d' % (n_pad, tile))
    if n_pad >= 2 ** 31:
        raise ValueError('at most 2**31 - 1 frames, got %d' % n_pad)


def check_args(want, device):
    """Raise ``ValueError`` unless each ``(tensor, dtype, shape)`` of
    ``want`` has that dtype and shape, is contiguous and lies on
    ``device``."""
    for k, (t, dtype, shape) in enumerate(want):
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError('argument %d: want %s %s, got %s %s'
                             % (k, dtype, shape, t.dtype, tuple(t.shape)))
        if not t.is_contiguous():
            raise ValueError('argument %d must be contiguous' % k)
        if t.device != device:
            raise ValueError('argument %d lies on %s, frames on %s'
                             % (k, t.device, device))


def check_device(device, what):
    """Raise ``ValueError`` unless ``device`` is CPU or CUDA: the two
    places a kernel wrapper runs (its plain version, its kernel)."""
    if device.type not in ('cpu', 'cuda'):
        raise ValueError('%s runs on CUDA or CPU tensors, got %s'
                         % (what, device))


def center_g(col):
    """G = sum(col^2) of a (3*A_pad,) center column, added atom by atom,
    x y z, in float32 with each product and sum rounded on its own: the
    order of the CUDA kernel and of the ingest's G, so a center's G is
    its prepared G bit for bit."""
    v = col.view(3, -1).t().reshape(-1).cpu().numpy()
    return float(np.add.accumulate(v * v)[-1])


def _check(prep, state, n_iters):
    frames, tile = prep.frames_r, int(prep.tile)
    check_layout(frames, tile)
    if not isinstance(n_iters, int) or n_iters < 1:
        raise ValueError('n_iters must be a positive int, got %r'
                         % (n_iters,))
    rows, n_pad = frames.shape
    t_pad = skip_t_pad(n_pad // tile)
    check_args(((frames, frames.dtype, (rows, n_pad)),
                (prep.g, torch.float32, (1, n_pad)),
                (state.dist, torch.float32, (1, n_pad)),
                (state.assig, torch.int32, (1, n_pad)),
                (state.tmax, torch.float32, (1, t_pad)),
                (state.col, torch.float32, (rows,)),
                (state.scal, torch.int32, (8,))), frames.device)


def kcenters_chunk_plain(prep, state, n_iters):
    """The plain PyTorch version of the chunk on any device: every tile
    is computed (nothing skipped), with the kernel's semantics for the
    update, the tie-break, the stop rule and ``skipcnt``. Returns
    ``(ctr, skipcnt)``, each (n_iters,) int32, -1 for unplaced slots."""
    _check(prep, state, n_iters)
    frames, tile = prep.frames_r, int(prep.tile)
    rows, n_pad = frames.shape
    a_pad, n_tiles = rows // 3, n_pad // tile
    v = state.scal.cpu().numpy().copy()
    f = v.view(np.float32)
    gidx, md, i = int(v[_GIDX]), float(f[_MD]), int(v[_I])
    n_total, cutoff = int(v[_NTOT]), float(f[_CUTOFF])
    ctr = torch.full((n_iters,), -1, dtype=torch.int32, device=frames.device)
    skipcnt = torch.full_like(ctr, -1)
    dist, assig = state.dist[0], state.assig[0]
    tmax = state.tmax[0, :n_tiles]
    frames = frames.float()
    frames3 = frames.view(3, a_pad, n_pad)
    gc, stopped = float(f[_GC]), 0
    for ik in range(n_iters):
        if md <= cutoff or i >= n_total:
            stopped = 1
            break
        col = state.col.copy_(frames[:, gidx])
        gc = center_g(col)
        ctr[ik] = gidx
        skipcnt[ik] = int((tmax <= 0.5 * md).sum()) if math.isfinite(md) \
            else 0
        S = _einsum_fp32('ian,ja->ijn', frames3, col.view(3, a_pad))
        d_new = rmsd_from_S_components_unrolled(
            tuple(S[p, q] for p in range(3) for q in range(3)),
            prep.g[0] + gc, float(prep.n_atoms),
            float64_finish=False)
        upd = d_new < dist
        dist.copy_(torch.where(upd, d_new, dist))
        assig.masked_fill_(upd, i)
        tmax.copy_(dist.view(n_tiles, tile).amax(dim=1))
        i += 1
        gidx = int(torch.argmax(dist))
        md = float(dist[gidx])
    v[_GIDX], f[_MD], f[_GC], v[_I] = gidx, md, gc, i
    v[_STOPPED] = stopped
    state.scal.copy_(torch.from_numpy(v))
    return ctr, skipcnt


@functools.lru_cache(maxsize=None)
def _kernel():
    lib = _build.load_library('kcenters_step')
    p = ctypes.c_void_p
    for name in ('kc_chunk', 'kc_chunk_bf16'):
        fn = getattr(lib, name)
        fn.argtypes = [p] * 9 + [ctypes.c_longlong, ctypes.c_int,
                                 ctypes.c_int, ctypes.c_int, ctypes.c_float,
                                 ctypes.c_int, p]
        fn.restype = ctypes.c_int
    for name in ('kc_iter_skip', 'kc_iter_skip_bf16'):
        fn = getattr(lib, name)
        fn.argtypes = [p] * 14 + [ctypes.c_longlong, ctypes.c_int,
                                  ctypes.c_int, ctypes.c_float, p]
        fn.restype = ctypes.c_int
    lib.kc_error_string.argtypes = [ctypes.c_int]
    lib.kc_error_string.restype = ctypes.c_char_p
    return lib


def entry_point(lib, name, frames):
    """The C entry point ``name`` of ``lib`` for ``frames``' dtype:
    ``name`` for float32, ``name + '_bf16'`` for bfloat16."""
    return getattr(lib, name + ('_bf16' if frames.dtype == torch.bfloat16
                                else ''))


def kcenters_chunk(prep, state, n_iters, skip=True):
    """Run ``n_iters`` k-centers iterations on ``prep``'s frames from
    ``state``, updating the state in place.

    ``prep`` is a :class:`~enspara_tpu_torch.cluster.engine.
    PreparedRMSDFrames` (frames (3*A_pad, n_pad) float32 or bfloat16, g
    (1, n_pad), tile); ``state`` a :class:`KCentersState` on the same
    device. On CUDA tensors this launches ``csrc/kcenters_step.cu`` (one
    launch to place the first center, then one per iteration; its bf16
    entry point for bfloat16 frames) and raises if the build or a launch
    fails; ``skip=False`` computes every tile. On CPU tensors it runs
    :func:`kcenters_chunk_plain`.

    Returns ``(ctr, skipcnt)``: (n_iters,) int32 center indices and
    skipped-tile counts, -1 for slots past the stop.
    """
    _check(prep, state, n_iters)
    device = prep.frames_r.device
    check_device(device, 'kcenters_chunk')
    if device.type == 'cpu':
        return kcenters_chunk_plain(prep, state, n_iters)
    lib = _kernel()
    ctr = torch.full((n_iters,), -1, dtype=torch.int32, device=device)
    skipcnt = torch.full_like(ctr, -1)
    rows, n_pad = prep.frames_r.shape

    def ptr(t):
        return ctypes.c_void_p(t.data_ptr())

    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = entry_point(lib, 'kc_chunk', prep.frames_r)(
            ptr(prep.frames_r), ptr(prep.g), ptr(state.dist),
            ptr(state.assig), ptr(state.tmax), ptr(state.col),
            ptr(state.scal), ptr(ctr), ptr(skipcnt), n_pad, rows // 3,
            int(prep.tile), n_iters, float(prep.n_atoms), int(bool(skip)),
            ctypes.c_void_p(stream))
    if err:
        raise RuntimeError('kcenters_step launch failed: %s (cudaError %d)'
                           % (lib.kc_error_string(err).decode(), err))
    kcenters_chunk.n_launches += 1 + n_iters
    if prep.frames_r.dtype == torch.bfloat16:
        kcenters_chunk.n_bf16_launches += 1 + n_iters
    return ctr, skipcnt


# CUDA kernel launches made by kcenters_chunk, and those of them on bf16
# frames (the plain version adds none)
kcenters_chunk.n_launches = 0
kcenters_chunk.n_bf16_launches = 0


# ---------------------------------------------------------------------
# one iteration of one shard of the sharded loop
# ---------------------------------------------------------------------

_SCRATCH = {}


def device_scratch(device):
    """The per-device int32[4] scratch of the one-iteration kernels:
    [0] the last-block ticket, [1] the skipped-tile count (both zero
    between launches: the last block resets them), [2] always 0, the
    stop flag of a call given none. Launches that share it run on one
    stream, one after another."""
    key = str(device)
    if key not in _SCRATCH:
        _SCRATCH[key] = torch.zeros(4, dtype=torch.int32, device=device)
    return _SCRATCH[key]


def _check_iteration(frames, g, dist, assig, tile, scalars):
    check_layout(frames, tile)
    n_pad = frames.shape[1]
    check_args(((g, torch.float32, (1, n_pad)),
                (dist, torch.float32, (1, n_pad)),
                (assig, torch.int32, (1, n_pad))) + tuple(scalars),
               frames.device)


def _stop_flag(stop, device):
    return device_scratch(device)[2:3].view(1, 1) if stop is None else stop


def kcenters_iteration_skip_plain(frames_r, g, dist, assig, tmax, col,
                                  g_center, center_id, md, n_atoms_real,
                                  tile=256, stop=None):
    """The plain PyTorch version of :func:`kcenters_iteration_skip` on
    any device: every tile is computed (nothing skipped), with the
    kernel's update, tie-break, ``tmax`` and ``skipcnt`` (the tiles the
    rule lets skip, counted from ``tmax`` before the update)."""
    _check_iteration(frames_r, g, dist, assig, tile, _skip_scalars(
        frames_r, tmax, col, g_center, center_id, md, stop, tile))
    dev = frames_r.device
    lmax = torch.full((1, 1), -math.inf, dtype=torch.float32, device=dev)
    largmax = torch.zeros((1, 1), dtype=torch.int32, device=dev)
    skipcnt = torch.zeros((1, 1), dtype=torch.int32, device=dev)
    if stop is not None and int(stop.reshape(())):
        return dist, assig, tmax, lmax, largmax, skipcnt
    rows, n_pad = frames_r.shape
    a_pad, n_tiles = rows // 3, n_pad // tile
    md = md.reshape(())
    tm = tmax[0, :n_tiles]
    if torch.isfinite(md):
        skipcnt.fill_(int((tm <= 0.5 * md).sum()))
    S = _einsum_fp32('ian,ja->ijn', frames_r.float().view(3, a_pad, n_pad),
                     col.view(3, a_pad))
    d_new = rmsd_from_S_components_unrolled(
        tuple(S[p, q] for p in range(3) for q in range(3)),
        g[0] + g_center.reshape(()), float(n_atoms_real),
        float64_finish=False)
    upd = d_new < dist[0]
    dist[0] = torch.where(upd, d_new, dist[0])
    assig[0] = torch.where(upd, center_id.reshape(()), assig[0])
    tm.copy_(dist[0].view(n_tiles, tile).amax(dim=1))
    arg = torch.argmax(dist[0])
    lmax.fill_(dist[0, arg])
    largmax.fill_(arg)
    return dist, assig, tmax, lmax, largmax, skipcnt


def _skip_scalars(frames, tmax, col, g_center, center_id, md, stop, tile):
    rows, n_pad = frames.shape
    want = ((tmax, torch.float32, (1, skip_t_pad(n_pad // tile))),
            (col, torch.float32, (rows, 1)),
            (g_center, torch.float32, (1, 1)),
            (center_id, torch.int32, (1, 1)),
            (md, torch.float32, (1, 1)))
    if stop is not None:
        want += ((stop, torch.int32, (1, 1)),)
    return want


def kcenters_iteration_skip(frames_r, g, dist, assig, tmax, col, g_center,
                            center_id, md, n_atoms_real, tile=256,
                            stop=None):
    """One k-centers iteration of one shard against a center chosen
    across the shards, skipping the tiles whose max is ``<= md/2``.

    ``frames_r`` (3*A_pad, n_local), float32 or bfloat16, and ``g``,
    ``dist``, ``assig`` (1, n_local) float32/int32 are the shard's;
    ``tmax`` (1, t_pad) its per-tile max carry (-inf past the last
    tile, see :func:`tile_summaries`); ``col``
    (3*A_pad, 1) the center's column; ``g_center``, ``md`` (1, 1)
    float32 and ``center_id`` (1, 1) int32 device tensors; ``stop``, an
    optional (1, 1) int32 device flag: nonzero leaves the state as it
    is. On CUDA tensors this launches ``kc_iter_skip`` of
    ``csrc/kcenters_step.cu`` (``kc_iter_skip_bf16`` for bfloat16
    frames) and raises if the launch fails; on CPU tensors it runs
    :func:`kcenters_iteration_skip_plain`.

    Returns ``(dist, assig, tmax, lmax, largmax, skipcnt)``: the first
    three updated in place, then this shard's max and first argmax of
    the updated distances and the skipped-tile count, (1, 1) device
    tensors (``-inf, 0, 0`` when stopped).
    """
    device = frames_r.device
    check_device(device, 'kcenters_iteration_skip')
    if device.type == 'cpu':
        return kcenters_iteration_skip_plain(
            frames_r, g, dist, assig, tmax, col, g_center, center_id, md,
            n_atoms_real, tile, stop)
    _check_iteration(frames_r, g, dist, assig, tile, _skip_scalars(
        frames_r, tmax, col, g_center, center_id, md, stop, tile))
    lib = _kernel()
    lmax = torch.empty((1, 1), dtype=torch.float32, device=device)
    largmax = torch.empty((1, 1), dtype=torch.int32, device=device)
    skipcnt = torch.empty((1, 1), dtype=torch.int32, device=device)
    scratch = device_scratch(device)
    rows, n_pad = frames_r.shape

    def ptr(t):
        return ctypes.c_void_p(t.data_ptr())

    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = entry_point(lib, 'kc_iter_skip', frames_r)(
            ptr(frames_r), ptr(g), ptr(dist), ptr(assig), ptr(tmax),
            ptr(col), ptr(g_center), ptr(center_id), ptr(md),
            ptr(_stop_flag(stop, device)), ptr(lmax), ptr(largmax),
            ptr(skipcnt), ptr(scratch), n_pad, rows // 3, int(tile),
            float(n_atoms_real), ctypes.c_void_p(stream))
    if err:
        raise RuntimeError('kc_iter_skip launch failed: %s (cudaError %d)'
                           % (lib.kc_error_string(err).decode(), err))
    kcenters_iteration_skip.n_launches += 1
    if frames_r.dtype == torch.bfloat16:
        kcenters_iteration_skip.n_bf16_launches += 1
    return dist, assig, tmax, lmax, largmax, skipcnt


# CUDA kernel launches made by kcenters_iteration_skip, and those of them
# on bf16 frames (the plain version adds none)
kcenters_iteration_skip.n_launches = 0
kcenters_iteration_skip.n_bf16_launches = 0
