"""One k-centers iteration against a given center (counterpart of
``enspara_tpu/ops/qcp_update_pallas.py :: kcenters_iteration_pallas``).

One call computes the RMSD of every frame to the center by QCP, applies
the strict-``<`` min update of ``(dist, assig)`` in place and, with
``with_argmax``, returns the (max, first argmax) of the updated
distances (the ``np.argmax`` tie-break), so a loop needs no separate
argmax pass. It serves the sharded k-centers loop with
``tri_skip=False``.

:func:`kcenters_iteration` launches ``csrc/qcp_update.cu`` on CUDA
tensors and runs :func:`kcenters_iteration_plain`, the plain PyTorch
version, on CPU tensors. The center's G, its ordinal and the optional
stop flag are (1, 1) device tensors, so an iteration needs no host
value. Frames are float32 or bfloat16 (the bf16 frame stream, as in
:mod:`~enspara_tpu_torch.ops.kcenters_step`); the center and all
arithmetic are float32.
"""

import ctypes
import functools
import math

import torch

from . import _build
from .kcenters_step import (_check_iteration, _stop_flag, check_device,
                            device_scratch, entry_point)
from .qcp import _einsum_fp32, rmsd_from_S_components_unrolled

__all__ = ['TILE', 'kcenters_iteration', 'kcenters_iteration_plain']

# frames per tile: one CUDA block of one thread per frame
TILE = 256


def _scalars(frames, cvec, g_center, center_id, stop):
    want = ((cvec, torch.float32, (frames.shape[0] // 3, 3)),
            (g_center, torch.float32, (1, 1)),
            (center_id, torch.int32, (1, 1)))
    if stop is not None:
        want += ((stop, torch.int32, (1, 1)),)
    return want


def kcenters_iteration_plain(frames_r, g, dist, assig, cvec, g_center,
                             center_id, n_atoms_real, tile=TILE,
                             with_argmax=False, stop=None):
    """The plain PyTorch version of :func:`kcenters_iteration` on any
    device, with its semantics."""
    _check_iteration(frames_r, g, dist, assig, tile,
                     _scalars(frames_r, cvec, g_center, center_id, stop))
    dev = frames_r.device
    lmax = torch.full((1, 1), -math.inf, dtype=torch.float32, device=dev)
    largmax = torch.zeros((1, 1), dtype=torch.int32, device=dev)
    if stop is None or not int(stop.reshape(())):
        rows, n_pad = frames_r.shape
        S = _einsum_fp32('ian,aj->ijn',
                         frames_r.float().view(3, rows // 3, n_pad), cvec)
        d_new = rmsd_from_S_components_unrolled(
            tuple(S[p, q] for p in range(3) for q in range(3)),
            g[0] + g_center.reshape(()), float(n_atoms_real),
            float64_finish=False)
        upd = d_new < dist[0]
        dist[0] = torch.where(upd, d_new, dist[0])
        assig[0] = torch.where(upd, center_id.reshape(()), assig[0])
        arg = torch.argmax(dist[0])
        lmax.fill_(dist[0, arg])
        largmax.fill_(arg)
    if with_argmax:
        return dist, assig, lmax, largmax
    return dist, assig


@functools.lru_cache(maxsize=None)
def _kernel():
    lib = _build.load_library('qcp_update')
    p = ctypes.c_void_p
    for name in ('qu_iteration', 'qu_iteration_bf16'):
        fn = getattr(lib, name)
        fn.argtypes = [p] * 12 + [ctypes.c_longlong, ctypes.c_int,
                                  ctypes.c_int, ctypes.c_float, ctypes.c_int,
                                  p]
        fn.restype = ctypes.c_int
    lib.qu_error_string.argtypes = [ctypes.c_int]
    lib.qu_error_string.restype = ctypes.c_char_p
    return lib


def kcenters_iteration(frames_r, g, dist, assig, cvec, g_center, center_id,
                       n_atoms_real, tile=TILE, with_argmax=False,
                       stop=None):
    """One fused k-centers iteration.

    ``frames_r`` (3*A_pad, n) is the frame layout, float32 or bfloat16
    (n a multiple of ``tile``, A_pad of 8, padding zero); ``g``,
    ``dist``, ``assig`` (1, n) the state (padding frames at -inf); ``cvec`` (A_pad, 3) the
    center's coordinates; ``g_center`` (1, 1) float32 its G and
    ``center_id`` (1, 1) int32 the id newly claimed frames take;
    ``stop``, an optional (1, 1) int32 device flag: nonzero leaves the
    state as it is. On CUDA tensors this launches ``csrc/qcp_update.cu``
    (``qu_iteration_bf16`` for bfloat16 frames) and raises if the launch
    fails; on CPU tensors it runs
    :func:`kcenters_iteration_plain`.

    Returns ``(dist, assig)``, updated in place, plus with
    ``with_argmax`` ``(lmax (1, 1) float32, largmax (1, 1) int32)``,
    the max and first argmax of the updated distances (``-inf, 0``
    when stopped).
    """
    device = frames_r.device
    check_device(device, 'kcenters_iteration')
    if device.type == 'cpu':
        return kcenters_iteration_plain(frames_r, g, dist, assig, cvec,
                                        g_center, center_id, n_atoms_real,
                                        tile, with_argmax, stop)
    _check_iteration(frames_r, g, dist, assig, tile,
                     _scalars(frames_r, cvec, g_center, center_id, stop))
    lib = _kernel()
    rows, n_pad = frames_r.shape
    tmax = torch.empty(n_pad // tile, dtype=torch.float32, device=device)
    lmax = torch.empty((1, 1), dtype=torch.float32, device=device)
    largmax = torch.empty((1, 1), dtype=torch.int32, device=device)

    def ptr(t):
        return ctypes.c_void_p(t.data_ptr())

    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = entry_point(lib, 'qu_iteration', frames_r)(
            ptr(frames_r), ptr(g), ptr(dist), ptr(assig), ptr(cvec),
            ptr(g_center), ptr(center_id), ptr(_stop_flag(stop, device)),
            ptr(tmax), ptr(lmax), ptr(largmax), ptr(device_scratch(device)),
            n_pad, rows // 3, int(tile), float(n_atoms_real),
            int(bool(with_argmax)), ctypes.c_void_p(stream))
    if err:
        raise RuntimeError('qcp_update launch failed: %s (cudaError %d)'
                           % (lib.qu_error_string(err).decode(), err))
    kcenters_iteration.n_launches += 1
    if frames_r.dtype == torch.bfloat16:
        kcenters_iteration.n_bf16_launches += 1
    if with_argmax:
        return dist, assig, lmax, largmax
    return dist, assig


# CUDA kernel launches made by kcenters_iteration, and those of them on
# bf16 frames (the plain version adds none)
kcenters_iteration.n_launches = 0
kcenters_iteration.n_bf16_launches = 0
