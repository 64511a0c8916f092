"""enspara_tpu_torch: the PyTorch and CUDA port of enspara_tpu.

The port runs the north-star pipeline on one NVIDIA GPU: k-centers by
QCP RMSD (``cluster``, on the hand-written CUDA kernel of
``ops.kcenters_step``), lag-time transition counts and the transpose
builder's implied timescales (``msm``). It imports torch and never
jax; from the JAX package it uses only the numpy-only modules
``enspara_tpu.exception``, ``enspara_tpu.ra`` and
``enspara_tpu.citation``.
"""

__version__ = '0.1.0'
