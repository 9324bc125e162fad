"""Tensor ops: padded-ELL containers, losses and metrics (counterpart of
``photon_ml_tpu/ops``)."""
