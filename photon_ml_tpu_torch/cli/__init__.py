"""Command-line drivers (counterpart of ``photon_ml_tpu/cli``)."""
