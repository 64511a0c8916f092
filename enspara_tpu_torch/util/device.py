"""Device helpers: where a function of the port runs.

A function runs on the device its caller names (``device=``), else where
its input tensor lies: a CPU tensor is the caller asking for the CPU.
Host input (numpy, scipy, lists) with no ``device=`` goes to
:func:`~enspara_tpu_torch.util.backend.select_device`: the CUDA device,
unless ``$ENSPARA_TPU_PLATFORM=cpu``. There is no "cuda else cpu":
without a card that default raises.
"""

import contextlib

import torch

__all__ = ['require_cuda', 'resolve_device', 'full_fp32_matmul']


@contextlib.contextmanager
def full_fp32_matmul():
    """Matrix products in full float32 inside the block, whatever the
    caller set, and the caller's ``allow_tf32`` back afterwards: TF32
    keeps about three decimal digits, far outside the port's distance
    and eigenvalue bars (the JAX package asks for ``Precision.HIGHEST``)."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def require_cuda():
    """The CUDA device, or ``RuntimeError`` when PyTorch sees none."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            'enspara_tpu_torch: a CUDA device is required but '
            'torch.cuda.is_available() is False (torch %s, built for '
            'CUDA %s)' % (torch.__version__, torch.version.cuda))
    return torch.device('cuda')


def resolve_device(x, device=None):
    """``device`` when given, else the device ``x`` lies on when it is a
    tensor, else :func:`~enspara_tpu_torch.util.backend.select_device`
    (the card; raises without one unless ``$ENSPARA_TPU_PLATFORM=cpu``)."""
    if device is not None:
        return torch.device(device)
    if isinstance(x, torch.Tensor):
        return x.device
    from .backend import select_device
    return select_device()
