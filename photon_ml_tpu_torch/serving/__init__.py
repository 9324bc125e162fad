"""Serving helpers (counterpart of ``photon_ml_tpu/serving``): only the
padded-batch policy of ``engine`` that the offline scoring driver shares.
The online engine is not ported yet."""
