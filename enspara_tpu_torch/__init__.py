"""enspara_tpu_torch: the PyTorch and CUDA port of enspara_tpu.

The port runs two workflows on one NVIDIA GPU: the north-star pipeline
(k-centers by QCP RMSD on the hand-written CUDA kernel of
``ops.kcenters_step``, lag-time transition counts and the transpose
builder's implied timescales, ``msm``) and the RMSD ``cluster`` ->
``reassign`` apps (``apps``; k-centers, k-medoids and k-hybrid, with
every all-pairs RMSD block on the CUDA kernel of ``ops.qcp_matrix``).
It imports torch and never jax, sklearn or psutil; from the JAX package
it uses only the host-only modules ``enspara_tpu.exception``, ``ra``,
``citation``, ``io`` (with the XTC codec of ``native``) and
``util.load``, ``util.parallel`` and ``util.log``.
"""

__version__ = '0.1.0'
