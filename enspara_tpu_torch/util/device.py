"""Device helpers: where a function of the port runs.

The port has no "cuda else cpu" default: a function runs where its
input tensor lies, or on the device its caller names. Host (numpy)
inputs with no ``device=`` stay on the CPU, where they already are.
"""

import torch

__all__ = ['require_cuda', 'resolve_device']


def require_cuda():
    """The CUDA device, or ``RuntimeError`` when PyTorch sees none."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            'enspara_tpu_torch: a CUDA device is required but '
            'torch.cuda.is_available() is False (torch %s, built for '
            'CUDA %s)' % (torch.__version__, torch.version.cuda))
    return torch.device('cuda')


def resolve_device(x, device=None):
    """``device`` when given, else the device ``x`` lies on (the CPU
    for anything that is not a tensor)."""
    if device is not None:
        return torch.device(device)
    if isinstance(x, torch.Tensor):
        return x.device
    return torch.device('cpu')
