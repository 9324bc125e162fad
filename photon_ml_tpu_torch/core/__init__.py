"""Core containers and task types (counterpart of ``photon_ml_tpu/core``)."""
