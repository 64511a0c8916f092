"""Host helpers of ``enspara_tpu/tpt/core.py`` (reference:
enspara/tpt/core.py). Committors and mean first passage times are not
ported yet; this module holds the detailed-balance check that
:func:`enspara_tpu_torch.msm.implied_timescales_device` uses."""

import numpy as np
import scipy.sparse

__all__ = []


def _is_reversible(T_csr, pi, rtol=1e-8):
    """max |pi_i T_ij - pi_j T_ji| <= rtol * max flux, in O(nnz)."""
    F = scipy.sparse.diags(pi) @ T_csr
    D = (F - F.T).tocoo()
    if D.nnz == 0:
        return True
    return np.abs(D.data).max() <= rtol * np.abs(F.data).max()
