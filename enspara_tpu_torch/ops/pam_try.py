"""One tried proposal of the device PAM sweeps
(``cluster/engine_kmedoids.py :: _pam_sweeps``) over one shard's
frames: :func:`pam_try_eval` scores the swap of medoid ``cid`` for the
proposal, :func:`pam_try_commit` applies it in place.

They replace no TPU kernel: the JAX sweep's ``lax.cond`` bodies are
fused by XLA, where the port ran each try as about a hundred eager ops.
On CUDA tensors each wrapper launches ``csrc/pam_try.cu`` and raises if
the launch fails; on CPU tensors it runs its plain version
(:func:`pam_try_eval_plain`, :func:`pam_try_commit_plain`), the sweep's
torch expressions.

Every function takes one shard's state: ``d1``, ``d2`` (n,) float32,
the nearest and second-nearest medoid distances; ``a1``, ``a2`` (n,)
int32, their medoid ids; ``dnew`` (n,) float32, each frame's distance
to the proposal; ``stale`` (n,) bool, the points whose ``(d2, a2)`` is
an upper bound until the next repair; ``cid`` the displaced medoid;
``n_valid`` the shard's real frames, a prefix (the rest are padding at
inf / -1).
"""

import ctypes
import functools
import math

import torch

from . import _build
from .kcenters_step import check_args, check_device, device_scratch

__all__ = ['pam_try_commit', 'pam_try_commit_plain', 'pam_try_eval',
           'pam_try_eval_plain']


def _check(d1, a1, d2, a2, dnew, stale, n_valid):
    n = d1.shape[0] if d1.dim() == 1 else -1
    check_args(((d1, torch.float32, (n,)), (a1, torch.int32, (n,)),
                (d2, torch.float32, (n,)), (a2, torch.int32, (n,)),
                (dnew, torch.float32, (n,)), (stale, torch.bool, (n,))),
               d1.device)
    if not 0 <= n_valid <= n:
        raise ValueError('n_valid must lie in [0, %d], got %r'
                         % (n, n_valid))
    check_device(d1.device, 'pam_try')
    return n


def _swap(d1, a1, d2, a2, dnew, cid, n_valid):
    """The sweep's expressions of a swap: the real frames, the members
    of ``cid``, the points whose (d2, a2) the swap would leave inexact
    (``unc``), and the post-swap nearest distances."""
    valid = torch.arange(d1.shape[0], device=d1.device) < n_valid
    members = (a1 == cid) & valid
    unc = (members | (a2 == cid)) & (dnew > d2) & valid
    cand_d1 = torch.where(members, torch.minimum(d2, dnew),
                          torch.minimum(d1, dnew))
    return valid, members, unc, cand_d1


def pam_try_eval_plain(d1, a1, d2, a2, dnew, stale, cid, n_valid):
    """The plain PyTorch version of :func:`pam_try_eval` on any
    device."""
    valid, members, unc, cand_d1 = _swap(d1, a1, d2, a2, dnew, cid, n_valid)
    return torch.stack(((members & stale).sum().double(),
                        (stale | unc).sum().double(),
                        torch.where(valid, cand_d1 * cand_d1, 0.0).sum(
                            dtype=torch.float64)))


def pam_try_commit_plain(d1, a1, d2, a2, dnew, stale, cid, n_valid):
    """The plain PyTorch version of :func:`pam_try_commit` on any
    device."""
    valid, _, unc, cand_d1 = _swap(d1, a1, d2, a2, dnew, cid, n_valid)
    w = torch.where
    in1, in2 = dnew < d1, dnew < d2
    caseB = a1 == cid     # nearest displaced
    caseC = a2 == cid     # second-nearest displaced
    na1 = w(caseB, w(in2, cid, a2), w(in1, cid, a1))
    nd2 = w(caseB, torch.maximum(dnew, d2),
            w(caseC, torch.maximum(dnew, d1),
              w(in1, d1, w(in2, dnew, d2))))
    na2 = w(caseB, w(in2, a2, cid),
            w(caseC, w(in1, a1, cid),
              w(in1, a1, w(in2, cid, a2))))
    d1.copy_(w(valid, cand_d1, math.inf))
    a1.copy_(w(valid, na1, -1).to(torch.int32))
    d2.copy_(w(valid, nd2, math.inf))
    a2.copy_(w(valid, na2, -1).to(torch.int32))
    stale |= unc


@functools.lru_cache(maxsize=None)
def _kernel():
    lib = _build.load_library('pam_try')
    p, ll = ctypes.c_void_p, ctypes.c_longlong
    lib.pt_threads.argtypes = []
    lib.pt_threads.restype = ctypes.c_int
    lib.pt_eval.argtypes = [p] * 6 + [ctypes.c_int, ll, ll] + [p] * 4
    lib.pt_eval.restype = ctypes.c_int
    lib.pt_commit.argtypes = [p] * 6 + [ctypes.c_int, ll, ll, p]
    lib.pt_commit.restype = ctypes.c_int
    lib.pt_error_string.argtypes = [ctypes.c_int]
    lib.pt_error_string.restype = ctypes.c_char_p
    return lib


def _ptrs(*ts):
    return [t.data_ptr() for t in ts]


def _raise(lib, err, what):
    if err:
        raise RuntimeError('%s launch failed: %s (cudaError %d)'
                           % (what, lib.pt_error_string(err).decode(), err))


def pam_try_eval(d1, a1, d2, a2, dnew, stale, cid, n_valid):
    """Score the swap of medoid ``cid`` for the proposal whose
    distances are ``dnew``, over one shard.

    Returns a (3,) float64 tensor on the shard's device: the members of
    ``cid`` that are stale, the points stale or left inexact by the swap
    (``stale | unc``), and the float64 sum of the float32 squares of the
    post-swap nearest distances. On CUDA tensors one launch, its
    reduction in a fixed order (the same bits on every run).
    """
    n = _check(d1, a1, d2, a2, dnew, stale, n_valid)
    if d1.device.type == 'cpu':
        return pam_try_eval_plain(d1, a1, d2, a2, dnew, stale, cid, n_valid)
    lib = _kernel()
    nb = -(-n // lib.pt_threads())
    buf = torch.empty(3 + 3 * nb, dtype=torch.float64, device=d1.device)
    out = buf[:3]
    with torch.cuda.device(d1.device):
        stream = torch.cuda.current_stream(d1.device).cuda_stream
        err = lib.pt_eval(
            *_ptrs(d1, a1, d2, a2, dnew, stale), int(cid), n, int(n_valid),
            *_ptrs(buf[3:], out, device_scratch(d1.device)), stream)
    _raise(lib, err, 'pam_try_eval')
    pam_try_eval.n_launches += 1
    return out


def pam_try_commit(d1, a1, d2, a2, dnew, stale, cid, n_valid):
    """Commit the swap of medoid ``cid`` for the proposal whose
    distances are ``dnew``, in place over one shard: ``(d1, a1)`` exact,
    ``(d2, a2)`` exact unless the point becomes stale (``stale |=
    unc``), the padding at inf / -1. On CUDA tensors one launch.
    """
    n = _check(d1, a1, d2, a2, dnew, stale, n_valid)
    if d1.device.type == 'cpu':
        return pam_try_commit_plain(d1, a1, d2, a2, dnew, stale, cid,
                                    n_valid)
    lib = _kernel()
    with torch.cuda.device(d1.device):
        stream = torch.cuda.current_stream(d1.device).cuda_stream
        err = lib.pt_commit(*_ptrs(d1, a1, d2, a2, dnew, stale), int(cid),
                            n, int(n_valid), stream)
    _raise(lib, err, 'pam_try_commit')
    pam_try_commit.n_launches += 1


# CUDA kernel launches made by each wrapper (the plain versions add none)
pam_try_eval.n_launches = 0
pam_try_commit.n_launches = 0
