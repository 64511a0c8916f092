"""The frame mesh: where the shards of a frame-sharded job live
(counterpart of ``enspara_tpu/parallel/mesh.py``).

The frame axis of a sharded job is cut into ``mesh.size`` contiguous
blocks: shard ``s`` owns global frames ``[s*n_local, (s+1)*n_local)``,
the JAX package's layout, so global indices compare one to one with it.

A :class:`FrameMesh` holds this process's shards as an ordered tuple of
``torch.device``s. A device may appear more than once (virtual shards):
that is how one card runs a 4-shard mesh, and how the CPU tests run an
8-shard one, the counterpart of the JAX suite's 8 virtual CPU devices.
When the job spans processes, the mesh also carries a
``torch.distributed`` process group; every process then holds the same
number of shards, and process ``r``'s shards are the global shards
``r*n_local_shards ..``. Collectives reduce over the local shards with
torch ops on the lead device (``devices[0]``), then over the group with
``torch.distributed``. Over a gloo group a CUDA tensor crosses through
host memory: the mesh copies it to the host, runs the collective there
and copies the result back (gloo does not take CUDA tensors for every
collective). :func:`job_mesh` picks the group: NCCL when every process
leads its shards from a card of its own, gloo otherwise (CPU shards, or
processes that share a card, which NCCL refuses).

Multi-process jobs call :func:`initialize_distributed` first.

Each collective over the processes is an ``enspara/mesh.all_reduce`` or
``enspara/mesh.all_gather`` span (``util.log.trace_region``: the host's
time to enqueue it, and for a staged one its copies; it does not
synchronise) and counts in the mesh's ``n_collectives``. A caller that
captures collectives into a CUDA graph (the sharded k-centers loop)
takes the capture's counts back and adds them at each replay, so that
``n_collectives`` counts the collectives that ran.

``mesh=None`` means what it means in the JAX package: every visible
card (:func:`frame_mesh`), but for a clustering, assignment or PAM
job too small to pay for several cards, which runs on the current card
(:func:`small_job_device`). :func:`resolve_placement` applies that
rule, after an explicit ``mesh=`` or ``device=`` and the place the
input already lies. No job leaves the card for the CPU.
"""

import os

import numpy as np
import torch

from ..util.log import trace_region

FRAME_AXIS = 'frames'

__all__ = ['FRAME_AXIS', 'FrameMesh', 'frame_mesh', 'n_devices',
           'pad_to_multiple', 'shard_frames', 'replicated', 'host_fetch',
           'initialize_distributed', 'install_abort_excepthook',
           'job_mesh', 'placement', 'mesh_platform', 'SMALL_JOB_FEATURES',
           'small_job_device', 'resolve_placement', 'job_features']

# A clustering, assignment or PAM job whose frames hold fewer features
# than this (n_frames * features-per-frame: 3 * n_atoms for RMSD) runs
# on the current card rather than over every visible card. Over k cards
# each k-centers iteration and each PAM proposal batch pays a fixed cost
# of cross-card copies and launches (~2 ms an iteration on 4 H100s),
# against a per-iteration time on one card that grows with the frames,
# so the crossover is a count of frames, whatever the centers. On 4
# H100s k-centers to 1000 centers from the host took as long on one card
# as on four at 16M 64-atom frames (3.07e9 features) and was faster on
# one card below (chip_mesh_crossover.py). The JAX package's rule
# (SMALL_JOB_WORK, pair-feature elements n * k * features) guards a TPU
# compile instead. 0 turns the rule off.
SMALL_JOB_FEATURES = float(os.environ.get('ENSPARA_TPU_SMALL_JOB_FEATURES',
                                          3e9))


def _world_group():
    """The default process group when one with more than one process is
    set up, else None."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized() \
            and dist.get_world_size() > 1:
        return dist.group.WORLD
    return None


class FrameMesh:
    """This process's frame shards, in order, and the process group the
    job spans (None for a single process).

    ``FrameMesh((cuda0,) * 4)`` runs four shards on one card;
    ``FrameMesh(['cpu'] * 8)`` eight on the CPU. The devices are never
    changed: a shard on a CUDA device runs its kernels there or raises.
    """

    def __init__(self, devices, group=None):
        devs = []
        for d in devices:
            d = torch.device(d)
            if d.type == 'cuda' and d.index is None:
                d = torch.device('cuda', torch.cuda.current_device())
            devs.append(d)
        if not devs:
            raise ValueError('a FrameMesh needs at least one device')
        if len({d.type for d in devs}) != 1:
            raise ValueError('a FrameMesh holds devices of one type, got %s'
                             % [str(d) for d in devs])
        self.devices = tuple(devs)
        self.group = group
        # collectives over the processes this mesh has run
        self.n_collectives = 0

    @property
    def n_local(self):
        """Shards held by this process."""
        return len(self.devices)

    @property
    def process_count(self):
        if self.group is None:
            return 1
        import torch.distributed as dist
        return dist.get_world_size(self.group)

    @property
    def process_index(self):
        if self.group is None:
            return 0
        import torch.distributed as dist
        return dist.get_rank(self.group)

    @property
    def size(self):
        """Shards of the whole job."""
        return self.n_local * self.process_count

    @property
    def shape(self):
        return {FRAME_AXIS: self.size}

    @property
    def first_shard(self):
        """Global index of this process's first shard."""
        return self.process_index * self.n_local

    @property
    def lead(self):
        """The device the local reductions land on."""
        return self.devices[0]

    @property
    def spans_processes(self):
        return self.process_count > 1

    def __repr__(self):
        return 'FrameMesh(%s, processes=%d)' % (
            ', '.join(str(d) for d in self.devices), self.process_count)

    # -- collectives ----------------------------------------------------

    @property
    def backend(self):
        """The process group's backend ('nccl', 'gloo'); None without a
        group."""
        if self.group is None:
            return None
        import torch.distributed as dist
        return dist.get_backend(self.group)

    def _staged(self, t):
        """Whether a collective on ``t`` crosses through host memory: a
        CUDA tensor over a gloo group."""
        return t.is_cuda and self.backend == 'gloo'

    def all_reduce(self, t, op='sum'):
        """Reduce ``t`` (on the lead device) in place over the processes;
        no-op for a single process. Returns ``t``."""
        if not self.spans_processes:
            return t
        import torch.distributed as dist
        ops = {'sum': dist.ReduceOp.SUM, 'max': dist.ReduceOp.MAX}
        self.n_collectives += 1
        with trace_region('enspara/mesh.all_reduce'):
            if self._staged(t):
                host = t.cpu()
                dist.all_reduce(host, op=ops[op], group=self.group)
                t.copy_(host)
            else:
                dist.all_reduce(t, op=ops[op], group=self.group)
        return t

    def all_gather(self, t, dim=0):
        """Concatenate ``t`` of every process along ``dim``, in process
        order (every process passes the same shape); ``t`` itself for a
        single process. Over NCCL the processes' tensors land in one
        buffer (``all_gather_into_tensor``), one collective that a CUDA
        graph can capture."""
        if not self.spans_processes:
            return t
        import torch.distributed as dist
        self.n_collectives += 1
        with trace_region('enspara/mesh.all_gather'):
            src = t.contiguous()
            if self.backend == 'nccl':
                out = src.new_empty((self.process_count * src.shape[0],)
                                    + tuple(src.shape[1:]))
                dist.all_gather_into_tensor(out, src, group=self.group)
                if dim == 0:
                    return out
                return torch.cat(out.chunk(self.process_count), dim=dim)
            staged = self._staged(t)
            if staged:
                src = src.cpu()
            parts = [torch.empty_like(src)
                     for _ in range(self.process_count)]
            dist.all_gather(parts, src, group=self.group)
            out = torch.cat(parts, dim=dim)
            return out.to(t.device) if staged else out

    def reduce(self, tensors, op='sum'):
        """Reduce one same-shaped tensor per local shard: over the local
        shards with torch ops on the lead device (keeping the dtype),
        then over the processes."""
        stacked = torch.stack([t.to(self.lead) for t in tensors])
        if op == 'sum':
            out = stacked.sum(0, dtype=stacked.dtype)
        elif op == 'max':
            out = stacked.amax(0)
        else:
            raise ValueError('op must be sum or max, got %r' % (op,))
        return self.all_reduce(out, op)


def initialize_distributed(**kwargs):
    """Join this process to a multi-process job:
    ``torch.distributed.init_process_group(**kwargs)`` (for example
    ``backend='nccl', init_method='tcp://host:port', world_size=4,
    rank=r``), then :func:`install_abort_excepthook`. A second call in an
    initialized process does nothing; a failed bootstrap raises, since N
    processes that each believed they were rank 0 of a 1-process world
    would race to write the same output files."""
    import torch.distributed as dist
    if not dist.is_initialized():
        try:
            dist.init_process_group(**kwargs)
        except (RuntimeError, ValueError) as e:
            # a double init by another thread is the one benign failure
            if not dist.is_initialized() or \
                    ('already' not in str(e) and 'twice' not in str(e)):
                raise
    install_abort_excepthook()


def install_abort_excepthook():
    """Make an uncaught exception on one process end the whole job
    instead of leaving the others waiting inside a collective: the hook
    prints the traceback, destroys the process group and hard-exits.
    No-op for a single process."""
    import sys

    if _world_group() is None:
        return
    original = sys.excepthook

    def _abort_hook(exc_type, value, tb):
        original(exc_type, value, tb)
        try:
            import torch.distributed as dist
            dist.destroy_process_group()
        except Exception:
            pass
        os._exit(1)

    sys.excepthook = _abort_hook


def n_devices():
    """Visible CUDA devices."""
    return torch.cuda.device_count()


def frame_mesh(n=None, devices=None):
    """A mesh of ``devices``, or of the first ``n`` visible CUDA devices
    (default: all), as the JAX package takes the first ``n`` of
    ``jax.devices()``. Under ``$ENSPARA_TPU_PLATFORM=cpu`` it holds ``n``
    (default 1) CPU shards. Without a card (and no such setting) it
    raises. The default process group joins it when it spans more than
    one process."""
    if devices is None:
        from ..util.backend import select_device
        dev = select_device()
        if dev.type == 'cuda':
            count = n_devices()
            n = count if n is None else int(n)
            if not 1 <= n <= count:
                raise ValueError('frame_mesh(n=%d): %d CUDA device(s) '
                                 'visible' % (n, count))
            devices = [torch.device('cuda', k) for k in range(n)]
        else:
            devices = [dev] * (1 if n is None else int(n))
    return FrameMesh(devices, _world_group())


def job_mesh(n=None):
    """The frame mesh of a multi-process job, after
    :func:`initialize_distributed` joined it over gloo: ``frame_mesh(n)``
    (this process's visible cards, or ``n`` CPU shards), whose
    collectives run over NCCL when its shards are CUDA devices and every
    process's lead card is a card of its own (by UUID), and over the
    gloo world group otherwise: CPU shards, or processes that share a
    card, which NCCL refuses. Every process takes the same decision, so
    every process creates the NCCL group or none does. The NCCL group
    runs one collective at once, so that its communicator is built (or
    fails) here, not inside the first job collective; a group that
    cannot be made raises, with no return to gloo."""
    mesh = frame_mesh(n)
    if mesh.group is None or mesh.lead.type != 'cuda':
        return mesh
    import torch.distributed as dist
    uuids = [None] * mesh.process_count
    dist.all_gather_object(
        uuids, str(torch.cuda.get_device_properties(mesh.lead).uuid),
        group=mesh.group)
    if len(set(uuids)) < len(uuids):
        return mesh
    torch.cuda.set_device(mesh.lead)
    group = dist.new_group(backend='nccl')
    one = torch.ones(1, device=mesh.lead)
    dist.all_reduce(one, group=group)
    if int(one.item()) != mesh.process_count:
        raise RuntimeError('the NCCL group summed %s over %d processes'
                           % (one.item(), mesh.process_count))
    return FrameMesh(mesh.devices, group)


def placement(mesh, device):
    """``(device, mesh)`` for a function that takes either: ``device``
    without a mesh, the device of a one-shard mesh, or the mesh itself
    when it has more shards (``device`` then None). Both given raise
    ``ValueError``."""
    if mesh is None:
        return device, None
    if device is not None:
        raise ValueError('pass device= or mesh=, not both')
    if mesh.size == 1:
        return mesh.devices[0], None
    return None, mesh


def small_job_device(features):
    """The current device of the default platform (the current card; the
    CPU under ``$ENSPARA_TPU_PLATFORM=cpu``) for a job whose frames hold
    fewer than :data:`SMALL_JOB_FEATURES` features, else None (the
    caller takes :func:`frame_mesh`); None when
    :data:`SMALL_JOB_FEATURES` is 0.

    The counterpart of the JAX package's ``maybe_small_job_mesh``, which
    sends jobs below ``n * k * features`` of ``SMALL_JOB_WORK`` to a
    one-device CPU mesh to spare a TPU compile and does nothing on a CPU
    backend. Here they stay on the card, and the reason is the fixed
    cost a job split over several cards pays at every iteration. On the
    CPU the default mesh is one device already, so the rule changes
    nothing there."""
    if not SMALL_JOB_FEATURES or features >= SMALL_JOB_FEATURES:
        return None
    from ..util.backend import select_device
    dev = select_device()
    if dev.type == 'cuda':
        dev = torch.device('cuda', torch.cuda.current_device())
    return dev


def resolve_placement(X, device=None, mesh=None, small_job_rule=False):
    """Where a function that takes ``device=`` and ``mesh=`` runs, as
    ``(device, mesh)`` in the form of :func:`placement` (one of them
    None), the first rule that applies deciding:

    1. ``mesh`` given: that mesh (with ``device`` too: ``ValueError``);
    2. ``device`` given: that device;
    3. ``X`` (or its ``.xyz``) a tensor: its device; a prepared
       container: where it lies (a sharded one over its shards'
       devices);
    4. ``small_job_rule`` and :func:`job_features` of ``X`` below
       :data:`SMALL_JOB_FEATURES`: the current card
       (:func:`small_job_device`);
    5. :func:`frame_mesh`, every visible card; one card (or the CPU) is
       the one-device path.

    The clustering and assignment entry points set ``small_job_rule``;
    the others (``prepare_sharded``, the implied CLI's batched solve)
    take the default mesh whatever the size, as in the JAX package. The
    public entry points resolve once and pass the result down."""
    if mesh is not None or device is not None:
        return placement(mesh, device)
    X = X.xyz if hasattr(X, 'xyz') else X
    if isinstance(X, torch.Tensor):
        return X.device, None
    if hasattr(X, 'shards'):      # a sharded container, with the job's group
        return placement(FrameMesh(tuple(sh.device for sh in X.shards),
                                   _world_group()), None)
    if isinstance(getattr(X, 'device', None), torch.device):
        return X.device, None
    if small_job_rule:
        small = small_job_device(job_features(X))
        if small is not None:
            return small, None
    return placement(frame_mesh(), None)


def job_features(X):
    """``n_frames * features-per-frame`` of ``X`` (``(n, d)`` features or
    ``(n, n_atoms, 3)`` coordinates, or anything with such an
    ``.xyz``), the small-job rule's measure."""
    shape = np.shape(X.xyz if hasattr(X, 'xyz') else X)
    return float(shape[0]) * (int(np.prod(shape[1:])) or 1)


def mesh_platform(mesh):
    """The platform of the mesh's devices: 'gpu' for CUDA shards, 'cpu'
    for CPU ones (the JAX package's names)."""
    return 'gpu' if mesh.lead.type == 'cuda' else mesh.lead.type


def pad_to_multiple(n, m):
    """Smallest multiple of ``m`` that is >= ``n``."""
    return ((n + m - 1) // m) * m


def _pad_rows(arr, n_pad, pad_value):
    n = arr.shape[0]
    if n_pad == n:
        return arr
    if isinstance(arr, torch.Tensor):
        pad = torch.full((n_pad - n,) + tuple(arr.shape[1:]), pad_value,
                         dtype=arr.dtype, device=arr.device)
        return torch.cat([arr, pad])
    pad = np.full((n_pad - n,) + arr.shape[1:], pad_value, dtype=arr.dtype)
    return np.concatenate([arr, pad])


def shard_frames(arr, mesh=None, pad_value=0):
    """Pad the leading axis to a multiple of the mesh size and cut it
    into contiguous blocks, one per shard. Returns ``(shards, n)``:
    this process's blocks as tensors on their devices, and the real
    row count."""
    if mesh is None:
        mesh = frame_mesh()
    if not isinstance(arr, torch.Tensor):
        arr = np.asarray(arr)
    n = arr.shape[0]
    n_pad = pad_to_multiple(max(n, mesh.size), mesh.size)
    arr = _pad_rows(arr, n_pad, pad_value)
    n_local = n_pad // mesh.size
    shards = []
    for s, dev in enumerate(mesh.devices):
        lo = (mesh.first_shard + s) * n_local
        shards.append(torch.as_tensor(arr[lo:lo + n_local], device=dev))
    return shards, n


def replicated(arr, mesh=None):
    """``arr`` on every local shard's device: one tensor per shard
    (read-only; shards on one device share one copy)."""
    if mesh is None:
        mesh = frame_mesh()
    if not isinstance(arr, torch.Tensor):
        arr = np.asarray(arr)
    copies = {d: torch.as_tensor(arr, device=d) for d in set(mesh.devices)}
    return [copies[d] for d in mesh.devices]


def host_fetch(x, mesh=None, axis=0):
    """A host (numpy) copy of ``x`` on every process.

    ``x`` is a tensor holding the same value on every process (a
    replicated result), or a sequence of this process's per-shard
    tensors, which are joined along ``axis`` and, when ``mesh`` spans
    processes, gathered from every process in shard order (the
    counterpart of the JAX package's ``process_allgather``)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if mesh is None or not mesh.spans_processes:
        return np.concatenate([t.detach().cpu().numpy() for t in x],
                              axis=axis)
    local = torch.cat([t.detach().to(mesh.lead) for t in x], dim=axis)
    return mesh.all_gather(local, dim=axis).cpu().numpy()
