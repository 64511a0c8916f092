"""enspara_tpu_torch: the PyTorch and CUDA port of enspara_tpu.

The port runs three workflows on one NVIDIA GPU: the north-star pipeline
(k-centers by QCP RMSD on the hand-written CUDA kernel of
``ops.kcenters_step``, lag-time transition counts and the transpose
builder's implied timescales, ``msm``), the RMSD ``cluster`` ->
``reassign`` apps (``apps``; k-centers, k-medoids and k-hybrid, with
every all-pairs RMSD block on the CUDA kernel of ``ops.qcp_matrix``),
and the sparse eigensolve of a large MSM
(``msm.eigenspectrum_reversible`` and ``msm.implied_timescales_device``,
whose Chebyshev-filtered subspace iteration runs every sparse product on
the CUDA kernel of ``ops.ell_spmm``).

Entry points run on the CUDA device unless the caller asks for the CPU
(a CPU tensor, ``device='cpu'`` or ``$ENSPARA_TPU_PLATFORM=cpu``), where
every kernel takes its plain PyTorch version. The package imports torch,
numpy and scipy, never jax, sklearn, psutil or the JAX package: its
host code (``exception``, ``citation``, ``ra``, ``io``, ``util.load``,
``util.parallel``, ``util.log`` and the C++ codecs of ``native``) is its
own copy.
"""

__version__ = '0.1.0'
