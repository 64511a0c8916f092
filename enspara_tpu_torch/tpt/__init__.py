"""Transition path theory (counterpart of ``enspara_tpu/tpt``); only the
reversibility check the MSM eigensolver needs is ported so far."""
