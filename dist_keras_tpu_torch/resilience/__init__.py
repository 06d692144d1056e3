"""Resilience — counterpart of ``resilience/``: the NaN/Inf sentinel
(:mod:`~dist_keras_tpu_torch.resilience.guards`) so far."""
