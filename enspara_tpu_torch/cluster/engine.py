"""Device clustering engine (counterpart of
``enspara_tpu/cluster/engine.py``): k-centers and the batched
nearest-center assignment, by QCP RMSD of coordinates or by the
euclidean, manhattan (cityblock) and hamming distances of feature
vectors.

Feature vectors (:func:`prepare_sharded`, :class:`PreparedFeatures`)
lie as ``(n_pad, d)`` rows, float32 (int32 for hamming), on one device
or cut into the contiguous blocks of a mesh. Their k-centers loop
(:func:`kcenters_device`) is the JAX package's ``_kcenters_loop``
(``engine.py:79-116``) in torch ops: the distance to one frame in the
difference form, the first-max argmax, a strict ``<`` update, ``-inf``
on pad frames; ``CHUNK`` iterations run between host reads, a device
flag freezing the state once the stop rule holds. Their assignment
takes the Gram form for euclidean (:mod:`enspara_tpu_torch.ops.
distances`), so a center frame's own distance there is about
``sqrt(eps * |x|^2)``, not 0, as in the JAX package.

RMSD frames are ingested once into the kernels' layout: ``(3*A_pad, n_pad)``
float32 with row ``i*A_pad + a`` holding coordinate ``i`` of atom ``a``
and the frame axis minor, plus a per-frame G row. A host loop then runs
the k-centers chunk (:mod:`enspara_tpu_torch.ops.kcenters_step`, the
tri-skip CUDA kernel on the card) ``CHUNK`` centers at a time, reading
32 bytes of state back after each chunk to decide whether to go on.
``precision='bf16'`` stores the layout in bfloat16 (centered in
float32, rounded once, G from the rounded coordinates), which the
k-centers kernels stream at half the bytes; ``sort='locality'`` lays
the frames out in the order of their RMSD to frame 0, so that tiles
hold similar frames and the tri-skip finds tiles to skip in shuffled
data, and results come back in the caller's order. A host array larger
than one ``_STREAM_CHUNK_BYTES`` chunk crosses to the card in chunks
through pinned buffers, each laid out while the next one is copied.

Padding frames carry ``g = 1.0`` and ``distance = -inf``: they are
never chosen as a center, never count toward the stop rule and keep
assignment -1.

Nearest-center assignment (:func:`assign_device`) and the PAM sweeps
(``engine_kmedoids``) take their RMSD blocks from
:mod:`enspara_tpu_torch.ops.qcp_matrix`: on the card, the all-pairs
CUDA kernel.

With a :class:`~enspara_tpu_torch.parallel.mesh.FrameMesh` of more than
one shard, the frames are laid out per shard (:class:`ShardedRMSDFrames`,
shard s holding global frames ``[s*n_local, (s+1)*n_local)``), and
k-centers runs the sharded loop of the JAX package
(:func:`_kcenters_loop_fused_sharded`): each shard runs one iteration
kernel on its frames (``kcenters_iteration_skip``, or
``kcenters_iteration`` with ``tri_skip=False``), and the argmax across
shards and the broadcast of the center's column are torch ops on the
mesh's lead device, then ``torch.distributed`` collectives when the
mesh spans processes; where every local shard lies on one card and the
processes, if any, join over NCCL, the loop replays its chunks as one
CUDA graph. Assignment runs per shard, and so does the
all-pairs block of the PAM sweeps (:func:`_pairwise_block` on a sharded
container: each shard's rows against columns brought to it by one
owner-masked sum). With no mesh, every function runs on one device
(``device=``, or where the input lies); the results do not depend on
the shard count.
"""

import math
from typing import NamedTuple

import numpy as np
import torch

from ..ops.distances import distance_to_point, pairwise_distance
from ..ops.kcenters_step import (kcenters_chunk, kcenters_iteration_skip,
                                 skip_t_pad, start_state, tile_summaries)
from ..ops.qcp import qcp_rmsd_vector
from ..ops.qcp_matrix import (TILE_C, pad_centers, pad_frames,
                              qcp_rmsd_matrix_block, to_layout)
from ..ops.qcp_update import kcenters_iteration
from ..parallel.mesh import (FrameMesh, host_fetch, pad_to_multiple,
                             resolve_placement, shard_frames)
from ..parallel.ops import (argmax_over_shards, distribute_frames,
                            global_argmax, owned_rows)
from ..util.device import resolve_device
from ..util.log import trace_region

__all__ = ['KCentersDeviceResult', 'PreparedRMSDFrames', 'ShardedRMSDFrames',
           'PreparedFeatures', 'ShardedFeatures', 'prepare_rmsd_frames',
           'prepare_sharded', 'kcenters_device', 'kcenters_device_fused',
           'assign_device']

FEATURE_METRICS = ('euclidean', 'manhattan', 'cityblock', 'hamming')
METRICS = FEATURE_METRICS + ('rmsd',)
# centers per block of the feature assignment
ASSIGN_BLOCK = 512

# frames per tile: one CUDA block of one thread per frame
TILE = 256
# centers per chunk: the host reads the loop state once per chunk
CHUNK = 64
# the frame types of the k-centers layout
_FRAME_DTYPE = {'fp32': torch.float32, 'bf16': torch.bfloat16}
# host bytes of float32 coordinates a chunk of the streamed ingest
_STREAM_CHUNK_BYTES = 64 * (1 << 20)


class KCentersDeviceResult(NamedTuple):
    distances: np.ndarray       # (n,) float64
    assignments: np.ndarray     # (n,) int64
    center_indices: np.ndarray  # (n_found,) int64 frame indices
    n_found: int


class PreparedRMSDFrames(NamedTuple):
    """Frames ingested once into the k-centers layout on one device;
    build with :func:`prepare_rmsd_frames` and pass to
    :func:`kcenters_device_fused` in place of coordinates to reuse the
    layout across runs (warm starts, cutoff scans). ``perm``
    (``sort='locality'``) is the layout's frame order: position ``i``
    holds the caller's frame ``perm[i]``."""
    frames_r: torch.Tensor     # (3*A_pad, n_pad) float32 or bfloat16
    g: torch.Tensor            # (1, n_pad) float32; 1.0 past n
    n: int                     # real frame count
    n_atoms: int               # real atom count
    tile: int
    precision: str = 'fp32'    # 'bf16': frames_r holds bfloat16
    perm: object = None        # (n,) int64 numpy layout order, or None

    @property
    def metric(self):
        return 'rmsd'

    @property
    def device(self):
        return self.g.device

    @property
    def n_pad(self):
        return int(self.frames_r.shape[1])


class PreparedFeatures(NamedTuple):
    """Feature vectors on one device, as :func:`prepare_sharded` lays
    them out for ``metric``: ``(n_pad, d)`` float32 rows (int32 for
    hamming), zero rows past ``n``."""
    data: torch.Tensor         # (n_pad, d)
    n: int                     # real frame count
    metric: str

    @property
    def device(self):
        return self.data.device

    @property
    def n_pad(self):
        return int(self.data.shape[0])


class ShardedFeatures(NamedTuple):
    """Feature vectors cut into the contiguous frame blocks of a mesh
    (the JAX package's ``P('frames')`` layout): ``shards`` holds this
    process's blocks, each a :class:`PreparedFeatures` on its device of
    ``n_local`` rows, shard s holding global frames
    ``[s*n_local, (s+1)*n_local)``."""
    shards: tuple              # PreparedFeatures, one per local shard
    n: int                     # real frame count
    metric: str
    n_shards: int              # shards of the whole mesh
    first_shard: int = 0       # global index of shards[0]

    @property
    def n_local(self):
        return self.shards[0].n_pad


class ShardedRMSDFrames(NamedTuple):
    """Frames ingested once into the k-centers layout, cut into the
    contiguous frame blocks of a mesh: shard s holds global frames
    ``[s*n_local, (s+1)*n_local)``. ``shards`` holds this process's
    shards, each a :class:`PreparedRMSDFrames` on its device whose ``n``
    counts its real frames; ``n_pad = n_local * n_shards`` is a multiple
    of ``tile * n_shards``."""
    shards: tuple              # PreparedRMSDFrames, one per local shard
    n: int                     # real frame count
    n_atoms: int
    tile: int
    n_shards: int              # shards of the whole mesh
    first_shard: int = 0       # global index of shards[0]
    precision: str = 'fp32'
    perm: object = None        # (n,) int64 global layout order, or None

    @property
    def n_local(self):
        return int(self.shards[0].frames_r.shape[1])

    @property
    def metric(self):
        return 'rmsd'


def _center(X):
    """``(n, A, 3)`` float32 frames less each frame's centroid. The
    centroid adds the atoms one after another, so a frame's result does
    not depend on the other frames of the call: a chunk of the streamed
    ingest rounds as the whole array does."""
    s = X[:, 0, :].clone()
    for a in range(1, X.shape[1]):
        s += X[:, a, :]
    return X - (s / X.shape[1])[:, None, :]


def _ingest(X, frames3, g, off, centered=False):
    """Lay ``(m, A, 3)`` float32 frames ``X`` (centered here unless
    ``centered``) into columns ``[off, off + m)`` of the ``(3, A_pad,
    n_pad)`` layout ``frames3``, rounding once to its dtype, and their G
    into ``g`` (1, n_pad). G sums the squares of the stored (rounded)
    coordinates, so G and the kernels' S see the same values and a
    frame's self-distance stays ~0; it adds them atom by atom, x y z,
    each product and sum rounded on its own, the order in which the
    chunk kernel sums a center's G (``ops.kcenters_step.center_g``).
    No result depends on the chunk a frame came in."""
    m, A = int(X.shape[0]), int(X.shape[1])
    if not centered:
        X = _center(X)
    dst = frames3[:, :A, off:off + m]
    dst.copy_(X.permute(2, 1, 0))
    sq = [v * v for v in dst.float()]
    acc = sq[0][0].clone()
    for a in range(A):     # XLA's order on the CPU too
        for i in range(3):
            if a or i:
                acc += sq[i][a]
    g[0, off:off + m] = acc


def _empty_layout(n_pad, a_pad, precision, device):
    """Zero ``(3, a_pad, n_pad)`` frames of the precision's dtype and a
    (1, n_pad) G row of 1.0, the padding's values."""
    return (torch.zeros((3, a_pad, n_pad), dtype=_FRAME_DTYPE[precision],
                        device=device),
            torch.ones((1, n_pad), dtype=torch.float32, device=device))


def _layout(X, n_pad, a_pad, precision='fp32', centered=False):
    """``(n, A, 3)`` float32 frames -> the ``(3*a_pad, n_pad)`` layout
    and the (1, n_pad) G row, 1.0 past n, on X's device."""
    frames3, g = _empty_layout(n_pad, a_pad, precision, X.device)
    _ingest(X, frames3, g, 0, centered)
    return frames3.view(3 * a_pad, n_pad), g


def _layout_streamed(X, n_pad, a_pad, precision, device):
    """The layout of host coordinates ``X`` (numpy, or anything that
    slices to numpy), crossing in chunks of ``_STREAM_CHUNK_BYTES`` of
    float32: on a CUDA device through two pinned host buffers, each
    chunk copied on a side stream while the one before it is laid out on
    the current stream; on the CPU one chunk after another. Bit for bit
    the monolithic layout (:func:`_ingest` rounds a frame alike in any
    chunk). The last chunk stops at the real frames: nothing is written
    past them, and the padding keeps its zeros and G = 1.0."""
    n, A = int(X.shape[0]), int(X.shape[1])
    cf = max(1, _STREAM_CHUNK_BYTES // (A * 3 * 4))
    frames3, g = _empty_layout(n_pad, a_pad, precision, device)
    if device.type != 'cuda':
        for off in range(0, n, cf):
            chunk = np.array(X[off:off + cf], dtype=np.float32)
            _ingest(torch.from_numpy(chunk).to(device), frames3, g, off)
        return frames3.view(3 * a_pad, n_pad), g
    main = torch.cuda.current_stream(device)
    side = torch.cuda.Stream(device)
    host = [torch.empty((cf, A, 3), dtype=torch.float32, pin_memory=True)
            for _ in range(2)]
    dev = [torch.empty((cf, A, 3), dtype=torch.float32, device=device)
           for _ in range(2)]
    copied, laid = [None, None], [None, None]
    for k, off in enumerate(range(0, n, cf)):
        b, m = k % 2, min(cf, n - off)
        if copied[b] is not None:
            copied[b].synchronize()        # host[b] has left for the card
        host[b][:m].numpy()[...] = X[off:off + m]
        with torch.cuda.stream(side):
            if laid[b] is not None:
                side.wait_event(laid[b])   # dev[b]'s last chunk is laid out
            dev[b][:m].copy_(host[b][:m], non_blocking=True)
            copied[b] = side.record_event()
        main.wait_event(copied[b])
        _ingest(dev[b][:m], frames3, g, off)
        laid[b] = main.record_event()
    for ev in copied:
        if ev is not None:
            ev.synchronize()
    return frames3.view(3 * a_pad, n_pad), g


def _check_coordinates(X):
    if X.ndim != 3 or X.shape[-1] != 3:
        raise ValueError('prepare_rmsd_frames requires (n, n_atoms, 3) '
                         'coordinates, got %s' % (tuple(X.shape),))


def _locality_sort(X, device):
    """Frames reordered by a one-pivot key, their QCP RMSD to frame 0
    (JAX ``engine.py:789-809``), so that a tile holds similar frames and
    the tri-skip, which skips a tile only when every frame of it is
    provably unmoved, finds tiles to skip in temporally shuffled data.
    The covering found is another one, as valid, than the unsorted
    order's. Returns the centered sorted frames on ``device`` and the
    permutation (layout position -> the caller's index) as int64 numpy;
    ``torch.argsort`` is stable, as ``jnp.argsort`` is."""
    X = torch.as_tensor(X if isinstance(X, torch.Tensor) else np.asarray(X),
                        dtype=torch.float32, device=device)
    _check_coordinates(X)
    data = _center(X)
    g_all = (data * data).sum(dim=(1, 2))
    key = qcp_rmsd_vector(data, data[0], g_all, g_all[0])
    perm = torch.argsort(key, stable=True)
    return data[perm], perm.cpu().numpy().astype(np.int64)


def prepare_rmsd_frames(X, tile=TILE, device=None, mesh=None,
                        precision='fp32', stream='auto', sort=None):
    """Ingest ``(n, n_atoms, 3)`` coordinates (numpy or a tensor) into
    the k-centers layout on ``device`` (default: where a tensor ``X``
    lies, the card for host data), with the JAX package's contract
    (``engine.py:812-897``).
    Frames are centered here in float32; ``A_pad`` is the atom count
    rounded up to a multiple of 8 and ``n_pad`` the frame count rounded
    up to a multiple of ``tile``.

    ``precision='bf16'`` rounds the centered coordinates once to
    bfloat16 and takes G from the rounded ones: the k-centers kernels
    then stream half the bytes and compute in float32. (The JAX package
    pads atoms to 16 in bf16 for the TPU's tiling; here ``A_pad`` stays
    a multiple of 8, and padding atoms are zero either way.)

    ``stream='auto'`` (or True) ingests a host array larger than one
    ``_STREAM_CHUNK_BYTES`` chunk on one device chunk by chunk
    (:func:`_layout_streamed`), bit for bit the monolithic layout;
    ``stream=False`` forces the one copy.

    ``sort='locality'`` lays the frames out in the order of their RMSD
    to frame 0 (:func:`_locality_sort`) and keeps the permutation in
    ``perm``; :func:`kcenters_device_fused` maps its results back to the
    caller's order.

    With a ``mesh`` of more than one shard, returns a
    :class:`ShardedRMSDFrames`: ``n_pad`` rounded up to a multiple of
    ``tile * mesh.size`` and each of this process's shards laid out on
    its device. A one-shard mesh prepares on its device."""
    if precision not in _FRAME_DTYPE:
        raise ValueError("precision must be 'fp32' or 'bf16', got %r"
                         % (precision,))
    if sort not in (None, 'locality'):
        raise ValueError("sort must be None or 'locality', got %r"
                         % (sort,))
    if mesh is not None:
        if device is not None:
            raise ValueError('pass device= or mesh=, not both')
        if mesh.size == 1:
            device, mesh = mesh.devices[0], None
    device = mesh.lead if mesh is not None else resolve_device(X, device)
    perm = None
    if sort == 'locality':
        X, perm = _locality_sort(X, device)
    if mesh is not None:
        return _prepare_sharded(X, tile, mesh, precision, perm)
    if not isinstance(X, torch.Tensor) and not hasattr(X, 'shape'):
        X = np.asarray(X)
    _check_coordinates(X)
    n, A = int(X.shape[0]), int(X.shape[1])
    n_pad, a_pad = -(-n // tile) * tile, -(-A // 8) * 8
    if (stream in ('auto', True) and not isinstance(X, torch.Tensor)
            and n > _STREAM_CHUNK_BYTES // (A * 3 * 4)):
        frames, g = _layout_streamed(X, n_pad, a_pad, precision, device)
    else:
        X = torch.as_tensor(X if isinstance(X, torch.Tensor)
                            else np.asarray(X), dtype=torch.float32,
                            device=device)
        frames, g = _layout(X, n_pad, a_pad, precision,
                            centered=perm is not None)
    return PreparedRMSDFrames(frames, g, n, A, int(tile), precision, perm)


def _prepare_sharded(X, tile, mesh, precision='fp32', perm=None):
    if not isinstance(X, torch.Tensor):
        X = np.asarray(X)
    _check_coordinates(X)
    n, A = int(X.shape[0]), int(X.shape[1])
    n_local = pad_to_multiple(max(n, 1), tile * mesh.size) // mesh.size
    a_pad = -(-A // 8) * 8
    shards = []
    for s, dev in enumerate(mesh.devices):
        lo = min((mesh.first_shard + s) * n_local, n)
        part = torch.as_tensor(X[lo:min(lo + n_local, n)],
                               dtype=torch.float32, device=dev)
        frames, g = _layout(part, n_local, a_pad, precision,
                            centered=perm is not None)
        shards.append(PreparedRMSDFrames(frames, g, int(part.shape[0]), A,
                                         int(tile), precision))
    return ShardedRMSDFrames(tuple(shards), n, A, int(tile), mesh.size,
                             mesh.first_shard, precision, perm)


def _prepare_data(X, metric):
    """Shape and dtype checks (JAX ``engine.py:124-139``): ``(n,
    n_atoms, 3)`` float32 for 'rmsd', ``(n, d)`` int32 for hamming and
    float32 for the other metrics. Host data stays on the host; a
    tensor keeps its device."""
    if not isinstance(X, torch.Tensor):
        X = np.asarray(X)
    if metric == 'rmsd':
        if X.ndim != 3 or X.shape[-1] != 3:
            raise ValueError("metric='rmsd' requires (n, n_atoms, 3) "
                             'coordinates, got %s' % (tuple(X.shape),))
    elif X.ndim != 2:
        raise ValueError('metric=%r requires (n, n_features) feature '
                         'vectors, got %s' % (metric, tuple(X.shape)))
    if isinstance(X, torch.Tensor):
        return X.to(torch.int32 if metric == 'hamming' else torch.float32)
    return X.astype(np.int32 if metric == 'hamming' else np.float32,
                    copy=False)


def prepare_sharded(X, metric, mesh=None, device=None):
    """Ingest frames once for ``metric`` (JAX ``engine.py:142-159``):
    on ``device``, over the shards of ``mesh``, or where a tensor ``X``
    lies; otherwise over :func:`~enspara_tpu_torch.parallel.mesh.
    frame_mesh`, every visible card, as in the JAX package (one card is
    the one-device path). Feature vectors become a
    :class:`PreparedFeatures` on one device or a :class:`ShardedFeatures`
    of zero-padded contiguous blocks; 'rmsd' coordinates go through
    :func:`prepare_rmsd_frames`. Returns the container, where the JAX
    function returns ``(sharded array, n)``."""
    device, mesh = resolve_placement(X, device, mesh)
    if metric == 'rmsd':
        return prepare_rmsd_frames(X, device=device, mesh=mesh)
    return _prepare_features(X, metric, device, mesh)


def _prepare_features(X, metric, device=None, mesh=None):
    """Feature vectors as a :class:`PreparedFeatures` on ``device``
    (default: where a tensor ``X`` lies, the card for host data) or,
    over a mesh of more than one shard, a :class:`ShardedFeatures`."""
    data = _prepare_data(X, metric)
    if mesh is not None:
        if device is not None:
            raise ValueError('pass device= or mesh=, not both')
        if mesh.size > 1:
            shards, n = shard_frames(data, mesh)
            n_local = shards[0].shape[0]
            return ShardedFeatures(tuple(
                PreparedFeatures(sh, min(max(n - (mesh.first_shard + s)
                                             * n_local, 0), n_local), metric)
                for s, sh in enumerate(shards)), n, metric, mesh.size,
                mesh.first_shard)
        device = mesh.devices[0]
    return PreparedFeatures(
        torch.as_tensor(data, device=resolve_device(X, device)), len(data),
        metric)


def _canonical(metric):
    return 'manhattan' if metric == 'cityblock' else metric


_PREPARED = (PreparedRMSDFrames, ShardedRMSDFrames, PreparedFeatures,
             ShardedFeatures)


def _prepared(X, metric, device=None, mesh=None, tile=None, **kw):
    """``X`` when it is already prepared for ``metric`` and ``mesh``
    (raising when its metric, shard count or tile disagree), else ``X``
    prepared (RMSD frames with the keywords ``kw`` of
    :func:`prepare_rmsd_frames`)."""
    if isinstance(X, _PREPARED):
        if _canonical(X.metric) != _canonical(metric):
            raise ValueError('frames prepared for metric %r, got metric=%r'
                             % (X.metric, metric))
        got = X.n_shards if isinstance(
            X, (ShardedRMSDFrames, ShardedFeatures)) else 1
        expect = 1 if mesh is None else mesh.size
        if got != expect:
            raise ValueError('prepared frames were laid out for %d '
                             'shard(s), mesh has %d' % (got, expect))
        if tile is not None and tile != X.tile:
            raise ValueError('prepared frames use tile=%d, got tile=%d'
                             % (X.tile, tile))
        return X
    if metric == 'rmsd':
        return prepare_rmsd_frames(X, tile=tile or TILE, device=device,
                                   mesh=mesh, **kw)
    return _prepare_features(X, metric, device, mesh)


def _sharded(prep):
    """Whether a prepared container is cut into the shards of a mesh."""
    return isinstance(prep, (ShardedRMSDFrames, ShardedFeatures))


def _shards(prep):
    """``(shards, n_local, first_shard)`` of a prepared container: this
    process's shards, their frame count and the global index of the
    first; a one-device container is its own one shard."""
    if _sharded(prep):
        return prep.shards, prep.n_local, prep.first_shard
    return (prep,), prep.n_pad, 0


def _local_rows(prep, values, pad, dtype, order=None):
    """Per-frame host ``values`` (the caller's order; ``order`` maps
    layout positions to it) as ``dtype`` over the layout's whole frame
    axis, ``pad`` past the real frames, cut into this process's shards
    of ``prep``: one (n_local,) tensor per local shard, on its
    device."""
    shards, n_local, first = _shards(prep)
    a = np.full(n_local * getattr(prep, 'n_shards', 1), pad, dtype)
    a[:prep.n] = values if order is None else np.asarray(values)[order]
    return [torch.from_numpy(a[(first + s) * n_local:][:n_local].copy())
            .to(sh.device) for s, sh in enumerate(shards)]


def _on_shards(values):
    """Whether a warm start's ``values`` are this process's per-shard
    tensors (a list or tuple of them) rather than host values."""
    return isinstance(values, (list, tuple)) and len(values) > 0 \
        and all(isinstance(v, torch.Tensor) for v in values)


def _lines_up(src, prep):
    """Whether per-shard rows of container ``src`` are rows of ``prep``
    as they lie: the same frame order (``prep`` not locality-sorted),
    shards of the same length and the same devices."""
    return getattr(prep, 'perm', None) is None \
        and _shards(src)[1:] == _shards(prep)[1:] \
        and [sh.device for sh in _shards(src)[0]] \
        == [sh.device for sh in _shards(prep)[0]]


def _loop_start(prep, n_clusters, dist_cutoff, k_max, init_distances,
                init_assignments):
    """The k-centers loops' set-up: ``(k_max, n_clusters, cutoff)`` as
    the loops take them, and the state ``(dist, assig)`` as lists of
    this process's (n_local,) float32/int32 shards: the warm start, in
    layout order, or inf and -1; -inf and -1 past the real frames.

    The public loops take a warm start as host values in the caller's
    order, cut into shards here by :func:`_local_rows`. Internally,
    ``kcenters._kcenters_fast`` passes per-shard tensors instead
    (:func:`_on_shards`: what :func:`_assign_shards` returns on ``prep``
    or a container that :func:`_lines_up` with it); they become the
    state as they lie, their rows past the real frames set on the
    device."""
    n = prep.n
    if k_max is None:
        k_max = int(n_clusters) if n_clusters is not None else n
    k_max = int(min(k_max, n))
    head = (k_max, int(min(n_clusters or n, k_max)),
            float(np.float32(dist_cutoff if dist_cutoff is not None
                             else 0.0)))
    if _on_shards(init_distances):
        for sh, d, a in zip(_shards(prep)[0], init_distances,
                            init_assignments):
            d[sh.n:] = -math.inf
            a[sh.n:] = -1
        return head + (list(init_distances), list(init_assignments))
    # the warm start comes in the caller's order, the layout may not
    perm = getattr(prep, 'perm', None)
    if init_distances is None:
        init_distances, init_assignments, perm = np.inf, -1, None
    return head + (
        _local_rows(prep, init_distances, -math.inf, np.float32, perm),
        _local_rows(prep, init_assignments, -1, np.int32, perm))


def _loop_results(prep, mesh, dist, assig, ctr, n_found, n_init_centers,
                  init_center_indices, skipped=None):
    """The k-centers loops' tear-down: the per-shard state fetched to
    the host (from every process of ``mesh``) in the caller's frame
    order, and the centers found, the warm start's as given, as a
    :class:`KCentersDeviceResult`. ``skipped``, the one-device loop's
    0-d int64 count of skipped tile visits, crosses in the centers' own
    copy and becomes ``kcenters_device_fused.n_tiles_skipped``."""
    n, perm = prep.n, getattr(prep, 'perm', None)
    dists, assigs = (host_fetch([t.reshape(-1) for t in x], mesh)[:n]
                     for x in (dist, assig))
    head = ctr[:n_found]
    if skipped is not None:
        head = torch.cat((head.long(), skipped.reshape(1)))
    head = head.cpu().numpy().astype(np.int64)
    ctr_inds = head[:n_found]
    if skipped is not None:
        kcenters_device_fused.n_tiles_skipped = int(head[n_found])
    if perm is not None:
        # layout position i is the caller's frame perm[i]
        dists_o, assigs_o = np.empty_like(dists), np.empty_like(assigs)
        dists_o[perm], assigs_o[perm] = dists, assigs
        dists, assigs = dists_o, assigs_o
        placed = ctr_inds >= 0
        ctr_inds[placed] = perm[ctr_inds[placed]]
    if init_center_indices is not None:
        ctr_inds[:n_init_centers] = init_center_indices
    return KCentersDeviceResult(dists.astype(np.float64),
                                assigs.astype(np.int64), ctr_inds, n_found)


def _kcenters_loop(prep, dist, assig, n_start, n_clusters, dist_cutoff,
                   k_max, skip=True):
    """Chunked k-centers from the (1, n_pad) ``dist``/``assig`` state
    (updated in place), with tile skipping or (``skip=False``) without.
    Returns ``(ctr (k_max,), n_found, skipped)``; ``ctr`` holds -1 in
    the warm-start slots, ``skipped`` (0-d int64, on the device) sums
    the chunks' ``skipcnt``: the tile visits at or below ``md/2``, which
    the kernel skips (with ``skip=False`` it reads them all the same)."""
    G = int(min(CHUNK, k_max))
    state = start_state(dist, assig, prep.frames_r.shape[0], prep.tile,
                        n_start, n_clusters, dist_cutoff)
    ctr = torch.full((k_max + G,), -1, dtype=torch.int32, device=dist.device)
    skipcnt = torch.full_like(ctr, -1)
    _, md, i = state.scalars()
    while i < n_clusters and md > dist_cutoff:
        with trace_region('enspara/kcenters.chunk'):
            ctr[i:i + G], skipcnt[i:i + G] = kcenters_chunk(prep, state, G,
                                                            skip=skip)
            _, md, i = state.scalars()
    return ctr[:k_max], i, skipcnt.clamp(min=0).sum()


class ShardedKCentersState(NamedTuple):
    """The sharded loop's state: this process's per-shard rows and the
    replicated scalars, (1, 1) tensors on the mesh's lead device."""
    dist: list                 # (1, n_local) float32 per local shard
    assig: list                # (1, n_local) int32 per local shard
    tmax: list                 # (1, t_pad) float32 per local shard
    gidx: torch.Tensor         # int32: the next center's global index
    md: torch.Tensor           # float32: its distance, the global max
    i: torch.Tensor            # int32: the ordinal it would take
    skipped: torch.Tensor      # int64 (0-d): tile visits skipped


def _graph_fits(mesh, devices):
    """Whether the sharded loop may replay its chunks as one CUDA graph:
    every local shard (``devices``) on the mesh's lead card, and no
    process group or an NCCL one. Gloo stages its collectives through
    host memory and a process with shards on several cards would need a
    graph over them all: those loops run eagerly."""
    return (mesh.lead.type == 'cuda'
            and all(d == mesh.lead for d in devices)
            and mesh.backend in (None, 'nccl'))


class _ChunkGraph:
    """``CHUNK`` calls of the sharded loop's ``step`` captured as one
    CUDA graph on the mesh's lead card, collectives included, in a
    memory pool of its own. The loop's state ``(md, gidx, i, skipped)``
    lives in static tensors that each replay updates in place.

    Host counters of the work a chunk runs (the mesh's collectives, the
    iteration kernels' launches) count at each replay, not at the
    capture, where nothing runs."""

    def __init__(self, step, state, mesh):
        self.state = tuple(t.clone() for t in state)
        self.counters = [(mesh, 'n_collectives')] + [
            (fn, attr) for fn in (kcenters_iteration_skip, kcenters_iteration)
            for attr in ('n_launches', 'n_bf16_launches')]
        before = [getattr(o, a) for o, a in self.counters]
        self.graph = torch.cuda.CUDAGraph()
        lead = mesh.lead
        side = torch.cuda.Stream(lead)
        side.wait_stream(torch.cuda.current_stream(lead))
        # thread_local: c10d's watchdog thread polls the NCCL work events
        # at any time, which a global-mode capture refuses
        with torch.cuda.device(lead), torch.cuda.stream(side):
            self.graph.capture_begin(capture_error_mode='thread_local')
            try:
                out = self.state
                for _ in range(CHUNK):
                    out = step(*out)
                for t, o in zip(self.state, out):
                    t.copy_(o)
            finally:
                self.graph.capture_end()
        torch.cuda.current_stream(lead).wait_stream(side)
        self.per_replay = []
        for (o, a), b in zip(self.counters, before):
            self.per_replay.append(getattr(o, a) - b)
            setattr(o, a, b)

    def replay(self):
        self.graph.replay()
        for (o, a), n in zip(self.counters, self.per_replay):
            setattr(o, a, getattr(o, a) + n)
        return self.state

    def release(self):
        self.graph.reset()
        self.graph = None


def _kcenters_loop_fused_sharded(prep, dist, assig, n_start, n_clusters,
                                 dist_cutoff, k_max, mesh, tri_skip=True):
    """K-centers over the shards of ``mesh`` (the JAX package's
    ``engine.py :: _kcenters_loop_fused_sharded``).

    ``prep`` is a :class:`ShardedRMSDFrames`; ``dist``/``assig`` are
    this process's (1, n_local) per-shard state, updated in place. Each
    iteration places the center chosen across the shards: its column
    and G are the owner-masked sum of every shard's copy (the
    reference's Bcast from the owner rank); each shard runs one
    iteration kernel against it, ``kcenters_iteration_skip`` (tiles at
    or below md/2 skip, md the global max) or, with ``tri_skip=False``,
    ``kcenters_iteration``; the next center is the global first argmax
    of the shards' (max, argmax). All of it stays on the devices: the
    host reads ``(i, md)`` once per ``CHUNK`` iterations, and a device
    flag makes the iterations past the stop leave the state untouched.

    Where :func:`_graph_fits` the mesh and more than a chunk remains
    after the first (eager) chunk, the loop captures ``CHUNK`` steps as
    one CUDA graph (an ``enspara/kcenters.capture`` span) and replays it
    for every later chunk (an ``enspara/kcenters.replay`` span each,
    counted in ``kcenters_device_fused.n_replays``); the steps past the
    stop are the flag's no-ops. The replays run the eager steps'
    kernels and collectives in the same order on the same data, so the
    results are the same bits. The graph and its pool go when the loop
    ends.

    Returns ``(state, ctr (k_max,) int32, n_found)``; ``ctr`` holds -1
    in the warm-start slots.
    """
    lead, tile, n_local = mesh.lead, prep.tile, prep.n_local
    rows = int(prep.shards[0].frames_r.shape[0])
    starts = [(prep.first_shard + s) * n_local
              for s in range(len(prep.shards))]

    with trace_region('enspara/kcenters.global_best'):
        md, gidx = global_argmax([d[0] for d in dist], mesh)
    md, gidx = md.reshape(1, 1), gidx.reshape(1, 1).to(torch.int32)
    t_pad = skip_t_pad(n_local // tile)
    tmax = [tile_summaries(d, tile, t_pad) for d in dist]
    i = torch.full((1, 1), int(n_start), dtype=torch.int32, device=lead)
    skipped = torch.zeros((), dtype=torch.int64, device=lead)
    # slot k_max takes the writes of the iterations past the stop
    ctr = torch.full((k_max + 1,), -1, dtype=torch.int32, device=lead)
    cutoff = float(np.float32(dist_cutoff))

    def step(md, gidx, i, skipped):
        go = (i < n_clusters) & (md > cutoff)
        stop = (~go).to(torch.int32)
        ctr.index_put_((torch.where(go, i, k_max).reshape(1).long(),),
                       gidx.reshape(1))
        # the center's column and G on every shard, from its owner
        cgs = _columns(prep, gidx.reshape(1), mesh)
        lms, las, skcs = [], [], []
        for s, sh in enumerate(prep.shards):
            c, g1 = cgs[s][:rows], cgs[s][rows:]
            i1, m1, st = (t.to(sh.g.device) for t in (i, md, stop))
            if tri_skip:
                out = kcenters_iteration_skip(
                    sh.frames_r, sh.g, dist[s], assig[s], tmax[s], c, g1,
                    i1, m1, prep.n_atoms, tile=tile, stop=st)
                lm, la = out[3], out[4]
                skcs.append(out[5].to(lead))
            else:
                lm, la = kcenters_iteration(
                    sh.frames_r, sh.g, dist[s], assig[s],
                    c.view(3, rows // 3).t().contiguous(), g1, i1,
                    prep.n_atoms, tile=tile, with_argmax=True, stop=st)[2:]
            lms.append(lm)
            las.append(la + starts[s])
        with trace_region('enspara/kcenters.global_best'):
            md2, gidx2 = argmax_over_shards(lms, las, mesh)
        if skcs:
            skipped = skipped + torch.stack(skcs).sum()
        return (torch.where(go, md2, md), torch.where(go, gidx2, gidx),
                i + go.to(torch.int32), skipped)

    graph, warm = None, False
    fits = _graph_fits(mesh, [sh.g.device for sh in prep.shards])
    kcenters_device_fused.n_replays = 0
    try:
        while True:
            h = torch.cat((i.reshape(1).double(),
                           md.reshape(1).double())).cpu()
            n_found, md_h = int(h[0]), float(h[1])
            if n_found >= n_clusters or not md_h > cutoff:
                break
            if graph is None and fits and warm \
                    and n_clusters - n_found > CHUNK:
                with trace_region('enspara/kcenters.capture'):
                    graph = _ChunkGraph(step, (md, gidx, i, skipped), mesh)
            if graph is not None:
                with trace_region('enspara/kcenters.replay'):
                    md, gidx, i, skipped = graph.replay()
                kcenters_device_fused.n_replays += 1
            else:
                for _ in range(min(CHUNK, n_clusters - n_found)):
                    md, gidx, i, skipped = step(md, gidx, i, skipped)
                warm = True
    finally:
        if graph is not None:
            graph.release()
    state = ShardedKCentersState(dist, assig, tmax, gidx, md, i,
                                 mesh.all_reduce(skipped))
    return state, ctr[:k_max], n_found


def kcenters_device_fused(X, n_clusters=None, dist_cutoff=None,
                          k_max=None, init_distances=None,
                          init_assignments=None, n_init_centers=0,
                          init_center_indices=None, tile=None,
                          device=None, mesh=None, tri_skip=True,
                          precision=None, sort=None):
    """K-centers by QCP RMSD on one device or over the shards of a
    mesh (JAX ``engine.py:900-1030``).

    ``X`` is a :class:`PreparedRMSDFrames`, which clusters where its
    frames lie, a :class:`ShardedRMSDFrames` laid out for ``mesh``, or
    ``(n, n_atoms, 3)`` coordinates, prepared on ``device`` (default:
    where a tensor ``X`` lies, the card for host data) or, given a
    ``mesh`` (:class:`~enspara_tpu_torch.parallel.mesh.FrameMesh`), over
    its shards. Prepared frames whose shard count differs from the
    mesh's raise.
    Stops at ``n_clusters`` centers or once the max distance is
    ``<= dist_cutoff``. A warm start passes the previous run's
    ``init_distances``/``init_assignments`` with ``n_init_centers``
    (and optionally ``init_center_indices``). On one CUDA device the
    loop runs the tri-skip chunk kernel, or with ``tri_skip=False`` its
    twin that skips nothing; over several shards, the sharded loop with
    the one-iteration tri-skip kernel, or with ``tri_skip=False`` the
    one-iteration kernel that skips nothing. The results are the same
    either way. On the CPU each kernel takes its plain version.

    ``precision`` ('fp32' or 'bf16') and ``sort`` (None or 'locality')
    are :func:`prepare_rmsd_frames`'s for coordinates (``None`` is
    'fp32'). Prepared frames keep their own: ``precision=None`` inherits
    it, a different explicit one raises, and ``sort='locality'`` on
    unsorted frames raises. bf16 frames run the same loops on the bf16
    kernels, whose distances carry the coordinates' rounding (about
    4e-3 relative); a sorted layout finds another, as valid, covering
    and its results come back in the caller's frame order, a warm start
    given in it too.

    Returns a :class:`KCentersDeviceResult` of host arrays (on every
    process of a mesh that spans processes). On one device, the loop is
    one ``enspara/kcenters.loop`` span, each of its chunks an
    ``enspara/kcenters.chunk`` span, and
    ``kcenters_device_fused.n_tiles_skipped`` counts the tile visits the
    chunk kernel skipped. Over shards, the sharded loop is one
    ``enspara/kcenters.sharded`` span, each global argmax the host
    issues an ``enspara/kcenters.global_best`` span,
    ``kcenters_device_fused.n_collectives`` counts the call's collectives
    over the processes (those its CUDA graph replays ran included) and
    ``kcenters_device_fused.n_replays`` the replays. Either way the
    fetch of the results is one ``enspara/kcenters.results`` span.
    """
    if isinstance(X, (PreparedRMSDFrames, ShardedRMSDFrames)):
        if precision is not None and precision != X.precision:
            raise ValueError('prepared frames are %s, got precision=%s'
                             % (X.precision, precision))
        if sort is not None and X.perm is None:
            raise ValueError("sort='locality' applies at preparation "
                             'time; these prepared frames are unsorted: '
                             "rebuild with prepare_rmsd_frames(..., "
                             "sort='locality')")
    prep = _prepared(X, 'rmsd', device, mesh, tile,
                     precision=precision or 'fp32', sort=sort)
    k_max, n_clusters, cutoff, dist, assig = _loop_start(
        prep, n_clusters, dist_cutoff, k_max, init_distances,
        init_assignments)
    dist, assig = [d[None] for d in dist], [a[None] for a in assig]
    if _sharded(prep):
        before = mesh.n_collectives
        with trace_region('enspara/kcenters.sharded'):
            _, ctr, n_found = _kcenters_loop_fused_sharded(
                prep, dist, assig, int(n_init_centers), n_clusters, cutoff,
                k_max, mesh, tri_skip=tri_skip)
        with trace_region('enspara/kcenters.results'):
            res = _loop_results(prep, mesh, dist, assig, ctr, n_found,
                                n_init_centers, init_center_indices)
        kcenters_device_fused.n_collectives = mesh.n_collectives - before
        return res
    with trace_region('enspara/kcenters.loop'):
        ctr, n_found, skipped = _kcenters_loop(
            prep, dist[0], assig[0], int(n_init_centers), n_clusters, cutoff,
            k_max, skip=tri_skip)
    with trace_region('enspara/kcenters.results'):
        return _loop_results(prep, None, dist, assig, ctr, n_found,
                             n_init_centers, init_center_indices, skipped)


# the collectives over the processes of the last sharded call (the loop
# and the fetch of its results; the mesh's n_collectives counts them)
kcenters_device_fused.n_collectives = 0
# the CUDA graph replays of the last sharded call's loop
kcenters_device_fused.n_replays = 0
# the tile visits at or below md/2 in the last one-device call's loop:
# those the chunk kernel skipped (``skipcnt`` summed on the device)
kcenters_device_fused.n_tiles_skipped = 0


def _kcenters_loop_features(prep, dist, assig, n_start, n_clusters,
                            dist_cutoff, k_max, mesh=None):
    """The k-centers loop of the JAX package's ``_kcenters_loop``
    (``engine.py:79-116``) over feature vectors, on one device (a mesh
    of one shard) or over the shards of ``mesh``.

    ``prep`` is a :class:`PreparedFeatures` (``mesh=None``) or a
    :class:`ShardedFeatures` laid out for ``mesh``; ``dist``/``assig``
    are lists of this process's per-shard (n_local,) float32/int32 state
    (-inf past the real frames), rebound in place. Each iteration takes
    the first max of the distances as the next center (each shard's max
    and first argmax, then the global first max of
    :func:`~enspara_tpu_torch.parallel.ops.global_argmax`; the owner's
    row reaches every shard by
    :func:`~enspara_tpu_torch.parallel.ops.distribute_frames`), measures
    every frame against it in the difference form and keeps the strictly
    smaller distance. The host reads ``(i, md)`` once per ``CHUNK``
    iterations; a device flag leaves the state untouched past the stop
    rule (``n_clusters`` centers, or ``max(dist) <= dist_cutoff``).

    Returns ``(ctr (k_max,) int32, n_found)``; ``ctr`` holds -1 in the
    warm-start slots.
    """
    shards = _shards(prep)[0]
    if mesh is None:
        mesh = FrameMesh((prep.device,))
    cutoff = float(np.float32(dist_cutoff))

    def best():
        """(md, gidx): the max distance and its first global index."""
        with trace_region('enspara/kcenters.global_best'):
            md, gidx = global_argmax(dist, mesh)
        return md, gidx.to(torch.int32)

    i = torch.full((), int(n_start), dtype=torch.int32, device=mesh.lead)
    # slot k_max takes the writes of the iterations past the stop
    ctr = torch.full((k_max + 1,), -1, dtype=torch.int32, device=mesh.lead)
    md, gidx = best()
    while True:
        h = torch.stack((i.double(), md.double())).cpu()
        n_found, md_h = int(h[0]), float(h[1])
        if n_found >= n_clusters or not md_h > cutoff:
            break
        for _ in range(min(CHUNK, n_clusters - n_found)):
            go = (i < n_clusters) & (md > cutoff)
            ctr.index_put_((torch.where(go, i, k_max).reshape(1).long(),),
                           gidx.reshape(1))
            rows = distribute_frames([sh.data for sh in shards],
                                     gidx.reshape(1), mesh)
            for s, sh in enumerate(shards):
                g1, i1 = go.to(sh.device), i.to(sh.device)
                d_new = distance_to_point(sh.data, rows[s][0], prep.metric)
                upd = (d_new < dist[s]) & g1
                dist[s] = torch.where(upd, d_new, dist[s])
                assig[s] = torch.where(upd, i1, assig[s])
            md, gidx = best()
            i = i + go.to(torch.int32)
    return ctr[:k_max], n_found


def kcenters_device(X, metric='euclidean', n_clusters=None,
                    dist_cutoff=None, k_max=None, init_distances=None,
                    init_assignments=None, n_init_centers=0,
                    init_center_indices=None, mesh=None, precision=None,
                    sort=None, device=None):
    """K-centers on one device or over the shards of ``mesh`` (JAX
    ``engine.py:162-257``, same parameters and errors, plus the port's
    ``device=``).

    ``X`` is ``(n, d)`` feature vectors, ``(n, n_atoms, 3)``
    coordinates for ``metric='rmsd'`` (which runs
    :func:`kcenters_device_fused`), or a prepared container of either.
    It runs on ``device``, over ``mesh``, or where a tensor or container
    ``X`` lies; otherwise on the current card for frames of fewer than
    ``SMALL_JOB_FEATURES`` features and over every visible card for more
    (:func:`~enspara_tpu_torch.parallel.mesh.resolve_placement`, the JAX
    function's default mesh).
    Stops at ``n_clusters`` centers or once the max distance is ``<=
    dist_cutoff``; warm starts pass the previous run's
    ``init_distances``/``init_assignments`` with ``n_init_centers`` and
    optionally ``init_center_indices``. The results do not depend on the
    shard count. ``precision`` and ``sort`` pass to
    :func:`kcenters_device_fused` for 'rmsd' ('bf16' and 'locality' run
    on any device here, the CPU's plain kernel versions included); with
    a feature metric they raise the JAX package's ``ValueError``.

    Returns a :class:`KCentersDeviceResult` of host arrays.
    """
    if metric not in METRICS:
        raise ValueError('device engine supports metrics %s, got %r'
                         % (sorted(METRICS), metric))
    if n_clusters is None and dist_cutoff is None:
        raise ValueError('Either n_clusters or dist_cutoff is required')
    device, mesh = resolve_placement(X, device, mesh, small_job_rule=True)
    if metric == 'rmsd':
        return kcenters_device_fused(
            X, n_clusters=n_clusters, dist_cutoff=dist_cutoff, k_max=k_max,
            init_distances=init_distances, init_assignments=init_assignments,
            n_init_centers=n_init_centers,
            init_center_indices=init_center_indices, device=device,
            mesh=mesh, precision=precision, sort=sort)
    if precision not in (None, 'fp32'):
        raise ValueError("precision='bf16' requires metric='rmsd' on "
                         "a TPU backend (the bf16 stream lives in the "
                         "fused Pallas path)")
    if sort is not None:
        raise ValueError("sort='locality' requires metric='rmsd' "
                         '(the tri-skip layout lives in the fused '
                         'Pallas path)')
    prep = _prepared(X, metric, device, mesh)
    k_max, n_clusters, cutoff, dist, assig = _loop_start(
        prep, n_clusters, dist_cutoff, k_max, init_distances,
        init_assignments)
    ctr, n_found = _kcenters_loop_features(
        prep, dist, assig, int(n_init_centers), n_clusters, cutoff, k_max,
        mesh)
    return _loop_results(prep, mesh, dist, assig, ctr, n_found,
                         n_init_centers, init_center_indices)


# ---------------------------------------------------------------------
# all-pairs RMSD blocks and the batched nearest-center assignment
# ---------------------------------------------------------------------

def _center_structures(X):
    """Remove each structure's centroid: ``(n, n_atoms, 3)`` tensor."""
    return X - X.mean(dim=1, keepdim=True)


def _all_frames(prep):
    """``prep``'s layout and G as the matrix block takes them: the frame
    axis padded to a multiple of 256 if its tile left it shorter."""
    fr, g = prep.frames_r, prep.g[0]
    n_pad = fr.shape[1]
    if n_pad % 256:
        want = pad_frames(n_pad)
        fr = torch.nn.functional.pad(fr, (0, want - n_pad))
        g = torch.nn.functional.pad(g, (0, want - n_pad), value=1.0)
    return fr, g


def _gather(prep, idx, width):
    """Frames ``idx`` of ``prep`` as ``width`` layout columns and their
    G, zero columns with G = 1.0 past ``len(idx)``."""
    idx = torch.as_tensor(idx, dtype=torch.long, device=prep.g.device)
    cols = torch.zeros((prep.frames_r.shape[0], width), dtype=torch.float32,
                       device=prep.g.device)
    cols[:, :len(idx)] = prep.frames_r[:, idx]
    g = torch.ones(width, dtype=torch.float32, device=prep.g.device)
    g[:len(idx)] = prep.g[0, idx]
    return cols, g


def _pairwise_block(prep, cols, rows=None, mesh=None):
    """Distances of frames ``rows`` (default: all ``n_pad`` of them) to
    frames ``cols`` of ``prep``, ``(n_rows, len(cols))`` float32, under
    the metric ``prep`` was prepared for: for RMSD one all-pairs block,
    the CUDA kernel on the card; for features
    :func:`~enspara_tpu_torch.ops.distances.pairwise_distance` (the
    Gram form for euclidean).

    For a sharded container (with its ``mesh``), one block per local
    shard: that shard's rows (``rows``: one vector of local indices per
    shard) against the columns ``cols``, given by global frame index and
    brought to every shard by :func:`_columns`."""
    if _sharded(prep):
        return _pairwise_blocks_sharded(prep, cols, rows, mesh)
    if isinstance(prep, PreparedFeatures):
        data = prep.data
        cols = torch.as_tensor(cols, dtype=torch.long, device=prep.device)
        if rows is not None:
            rows = torch.as_tensor(rows, dtype=torch.long,
                                   device=prep.device)
        return pairwise_distance(data if rows is None else data[rows],
                                 data[cols], prep.metric)
    if rows is None:
        fr, gf = _all_frames(prep)
        n_rows = prep.frames_r.shape[1]
    else:
        n_rows = len(rows)
        fr, gf = _gather(prep, rows, pad_frames(n_rows))
    cr, gc = _gather(prep, cols, pad_centers(len(cols)))
    return qcp_rmsd_matrix_block(fr, gf, cr, gc, prep.n_atoms)[
        :n_rows, :len(cols)]


def _columns(prep, cols, mesh):
    """Frames ``cols`` (global indices) of a sharded container on every
    local shard, in one owner-masked collective: feature rows as they
    lie, or RMSD layout columns with their G as a ``(3*A_pad + 1,
    len(cols))`` float32 block (G the last row)."""
    cols = torch.as_tensor(cols, dtype=torch.long, device=mesh.lead)
    if isinstance(prep, ShardedFeatures):
        return distribute_frames([sh.data for sh in prep.shards], cols, mesh)
    parts = []
    for s, sh in enumerate(prep.shards):
        li, own = owned_rows(cols.to(sh.device), prep.n_local,
                             prep.first_shard + s)
        cg = torch.cat((sh.frames_r.index_select(1, li).float(),
                        sh.g.index_select(1, li)))
        parts.append(torch.where(own, cg, 0.0))
    cg = mesh.reduce(parts)
    return [cg.to(d) for d in mesh.devices]


def _pairwise_blocks_sharded(prep, cols, rows, mesh):
    """:func:`_pairwise_block` on a :class:`ShardedRMSDFrames` or
    :class:`ShardedFeatures`: a list of per-shard blocks."""
    if mesh is None or mesh.size != prep.n_shards:
        raise ValueError('a sharded container needs the mesh it was laid '
                         'out for (%d shards)' % prep.n_shards)
    colset = _columns(prep, cols, mesh)
    out = []
    for s, sh in enumerate(prep.shards):
        r = None if rows is None else torch.as_tensor(
            rows[s], dtype=torch.long, device=sh.device)
        if isinstance(prep, ShardedFeatures):
            out.append(pairwise_distance(sh.data if r is None else sh.data[r],
                                         colset[s], prep.metric))
            continue
        c = colset[s].shape[1]
        width = pad_centers(c)
        cr = torch.nn.functional.pad(colset[s][:-1], (0, width - c))
        gc = torch.nn.functional.pad(colset[s][-1], (0, width - c),
                                     value=1.0)
        if r is None:
            fr, gf = _all_frames(sh)
            n_rows = prep.n_local
        else:
            n_rows = len(r)
            fr, gf = _gather(sh, r, pad_frames(n_rows))
        out.append(qcp_rmsd_matrix_block(fr, gf, cr, gc, sh.n_atoms)[
            :n_rows, :c])
    return out


def _assign_all_rmsd(prep, centers):
    """Every frame of ``prep`` to its nearest of ``centers`` (k, A, 3),
    centered, on ``prep``'s device: a loop over 256-wide center blocks
    (one 64-multiple block below 256 centers) carrying the running
    (min, argmin). First-min ties: ``min`` keeps the lowest index
    inside a block and a strict ``<`` the earlier block; padded centers
    are masked to +inf. Each block is dropped before the next is made,
    so peak memory is the frames plus one ``(n_pad, width)`` block, as
    in the JAX package. Returns ``(assigs (n_pad,) int32, dists (n_pad,)
    float32)``."""
    k = int(centers.shape[0])
    fr, gf = _all_frames(prep)
    n_pad = prep.frames_r.shape[1]
    a_pad = fr.shape[0] // 3
    width = pad_centers(k) if k < TILE_C else TILE_C
    best_d = torch.full((n_pad,), math.inf, dtype=torch.float32,
                        device=fr.device)
    best_i = torch.zeros((n_pad,), dtype=torch.int32, device=fr.device)
    for lo in range(0, k, width):
        cr, gc = to_layout(centers[lo:lo + width], width, a_pad)
        d = qcp_rmsd_matrix_block(fr, gf, cr, gc, prep.n_atoms)[:n_pad]
        if lo + width > k:
            d[:, k - lo:] = math.inf
        local_min, local_arg = d.min(dim=1)
        del d
        upd = local_min < best_d
        best_d = torch.where(upd, local_min, best_d)
        best_i = torch.where(upd, (local_arg + lo).to(torch.int32), best_i)
    return best_i, best_d


def _assign_all(data, centers, metric):
    """Every row of ``data`` (n_pad, d) to its nearest row of
    ``centers`` (k, d) on data's device (JAX ``engine.py:264-331``):
    blocks of ``min(ASSIGN_BLOCK, k)`` centers carrying the running
    (min, first argmin), a strict ``<`` between blocks, so that the
    lowest index wins a tie. Peak memory is one (n_pad, block) block.
    Returns ``(assigs (n_pad,) int32, dists (n_pad,) float32)``."""
    k = int(centers.shape[0])
    block = min(ASSIGN_BLOCK, k)
    best_d = torch.full((data.shape[0],), math.inf, dtype=torch.float32,
                        device=data.device)
    best_i = torch.zeros((data.shape[0],), dtype=torch.int32,
                         device=data.device)
    for lo in range(0, k, block):
        d = pairwise_distance(data, centers[lo:lo + block], metric)
        local_min, local_arg = d.min(dim=1)
        del d
        upd = local_min < best_d
        best_d = torch.where(upd, local_min, best_d)
        best_i = torch.where(upd, (local_arg + lo).to(torch.int32), best_i)
    return best_i, best_d


def _centers_tensor(centers, prep):
    C = torch.as_tensor(np.asarray(centers) if not isinstance(
        centers, torch.Tensor) else centers, dtype=torch.float32,
        device=prep.g.device)
    if C.ndim != 3 or C.shape[1:] != (prep.n_atoms, 3):
        raise ValueError('centers must be (k, %d, 3), got %s'
                         % (prep.n_atoms, tuple(C.shape)))
    return _center_structures(C)


def _assign_shards(prep, centers, metric):
    """Every frame of the prepared container ``prep`` to its nearest of
    ``centers`` on its own shard, with no communication: ``(assigs,
    dists)``, lists of this process's (n_local,) int32/float32 tensors,
    one per local shard on its device, in layout order (rows past a
    shard's real frames hold whatever the blocks gave them). Feature
    rows take :func:`_assign_all`, RMSD frames :func:`_assign_all_rmsd`
    (the all-pairs kernel)."""
    shards = _shards(prep)[0]
    if metric == 'rmsd':
        out = [_assign_all_rmsd(sh, _centers_tensor(centers, sh))
               for sh in shards]
    else:
        C = _prepare_data(centers, metric)
        if C.shape[1] != shards[0].data.shape[1]:
            raise ValueError('centers must be (k, %d), got %s'
                             % (shards[0].data.shape[1], tuple(C.shape)))
        out = [_assign_all(sh.data, torch.as_tensor(C, device=sh.device),
                           metric) for sh in shards]
    return [a for a, _ in out], [d for _, d in out]


def _first_minima(prep, assigs, dists, n_centers, mesh=None):
    """For each label ``0..n_centers-1`` of a per-shard assignment of
    ``prep`` (:func:`_assign_shards`), the global index of its
    smallest-distance frame, the first such frame on ties: what
    :func:`~enspara_tpu_torch.cluster.util.find_cluster_centers` finds
    on the fetched assignment, found on the devices. Frames past each
    shard's real ones are left out. Each shard takes its minima and the
    first frame holding each (one center: a ``max`` of the negated
    distances; more: a scatter by label), then one
    :func:`~enspara_tpu_torch.parallel.ops.argmax_over_shards` (one
    collective over the processes) takes the global first minimum of
    the negated minima: negating a float32 is exact, so ties and order
    are the host's. Returns the ``(n_centers,)`` int64 indices as
    numpy, read in one copy; a label that no frame holds reads
    ``prep.n``."""
    shards, n_local, first = _shards(prep)
    n = int(prep.n)
    vals, args = [], []
    for s, (sh, a, d) in enumerate(zip(shards, assigs, dists)):
        start = (first + s) * n_local
        real = torch.arange(n_local, device=d.device) < sh.n
        neg = torch.where(real, -d, -math.inf)
        if n_centers == 1:
            v, i = neg.max(0)
            vals.append(v.reshape(1))
            args.append((i + start).reshape(1))
            continue
        # frames past the real ones land in bucket n_centers, dropped
        lab = torch.where(real, a.long(), n_centers)
        v = torch.full((n_centers + 1,), -math.inf, device=d.device) \
            .scatter_reduce(0, lab, neg, 'amax')
        gi = torch.arange(start, start + n_local, device=d.device)
        at = torch.where(neg == v[lab], gi, n)
        i = torch.full((n_centers + 1,), n, dtype=torch.int64,
                       device=d.device).scatter_reduce(0, lab, at, 'amin')
        vals.append(v[:n_centers])
        args.append(i[:n_centers])
    if mesh is None:
        mesh = FrameMesh((shards[0].device,))
    return argmax_over_shards(vals, args, mesh)[1].cpu().numpy()


def assign_device(X, centers, metric='euclidean', device=None, mesh=None):
    """Assign every frame to its nearest center: the batched device
    form of ``assign_to_nearest_center`` (JAX ``engine.py:406``, whose
    default metric this keeps).

    ``X`` is ``(n, d)`` feature vectors or, for ``metric='rmsd'``,
    ``(n, n_atoms, 3)`` coordinates (numpy or a tensor), prepared on
    ``device`` (default: where a tensor ``X`` lies, the card for host
    data) or over the shards of ``mesh``, or a container prepared for
    the metric (:class:`PreparedFeatures`, :class:`ShardedFeatures`,
    :class:`PreparedRMSDFrames`, :class:`ShardedRMSDFrames`); ``centers``
    is ``(k, d)`` or ``(k, n_atoms, 3)``. Host data with neither goes to
    the JAX function's default: the current card for frames of fewer
    than ``SMALL_JOB_FEATURES`` features, every visible card for more.
    RMSD frames and centers are centered on the device, and their blocks
    are the all-pairs kernel.
    Over a mesh each shard assigns its own frames, centers replicated,
    with no communication until the results are gathered.

    Returns ``(assignments (n,) int64, distances (n,) float64)`` as
    numpy arrays.
    """
    if metric not in METRICS:
        raise ValueError('device engine supports metrics %s, got %r'
                         % (sorted(METRICS), metric))
    device, mesh = resolve_placement(X, device, mesh, small_job_rule=True)
    prep = _prepared(X, metric, device, mesh)
    if metric == 'rmsd' and (prep.precision != 'fp32'
                             or prep.perm is not None):
        raise ValueError('assignment takes float32 frames in the caller\'s '
                         'order: pass the coordinates, not frames prepared '
                         'with precision=%r, sort=%r'
                         % (prep.precision, None if prep.perm is None
                            else 'locality'))
    assigs, dists = _assign_shards(prep, centers, metric)
    return (host_fetch(assigs, mesh)[:prep.n].astype(np.int64),
            host_fetch(dists, mesh)[:prep.n].astype(np.float64))
