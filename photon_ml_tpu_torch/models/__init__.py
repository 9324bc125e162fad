"""GLMs and their training over the regularization path (counterpart of
``photon_ml_tpu/models``)."""
