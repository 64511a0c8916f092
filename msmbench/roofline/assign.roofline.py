"""The work of assigning ``n`` frames of ``A`` atoms to their nearest of
``k`` centers by QCP RMSD, counted from the unpadded shapes; the
algorithm's work, not any one kernel's.

Pairs: ``n * k``.

Flops a pair:

- the cross-covariance ``S = X^T Y``, nine sums of ``A`` products:
  ``18 * A`` (a multiply and an add each);
- the QCP epilogue, counted once from Theobald's coefficient algebra
  (``msmbench/reference/qcp.py :: _lambda_max_scaled``), each term that
  two expressions share taken once: the nine squares and their sum
  (9 + 8); the three 2x2 minors and the determinant from them (9 + 5);
  ``c2`` and ``c1`` (2); the eight sums and differences of
  off-diagonal and diagonal pairs (8); ``D`` (4); ``E`` from the shared
  base and minor (8); ``F``, ``G``, ``H``, ``I``: four shared
  differences with ``Szz``, eight factors of two products and an add,
  four products (4 + 24 + 4); ``c0`` (5); ``ga + gb`` (1); and the RMSD
  from ``lambda_max`` (``gsum - 2 lambda``, the divide by ``A``, the
  square root: 4). That is 95. The scaling by ``lambda0`` and the
  Newton steps that find ``lambda_max`` are left out, and with them any
  work that differs between implementations, so that no implementation
  needs fewer.

Bytes: each frame's and each center's unpadded float32 coordinates read
once (``12 * A`` each), and one int32 label and one float32 distance
written a frame (8).

The least time is the largest of: the cross-covariance flops at the
TF32 tensor peak (no float32-accurate product can be had faster), the
epilogue flops at the float32 peak, and the bytes at the HBM bandwidth.
"""

from msmbench.harness import spec

EPILOGUE_FLOPS = 95


def counts(n, k, A):
    """``(cross-covariance flops, epilogue flops, bytes)``."""
    pairs = float(n) * float(k)
    return (18.0 * A * pairs, EPILOGUE_FLOPS * pairs,
            12.0 * A * (n + k) + 8.0 * n)


def least_seconds(n, k, A):
    peaks = spec.roofline('peaks')
    cross, epi, nbytes = counts(n, k, A)
    return max(cross / peaks.TF32_FLOPS, epi / peaks.FP32_FLOPS,
               nbytes / peaks.HBM_BYTES)
