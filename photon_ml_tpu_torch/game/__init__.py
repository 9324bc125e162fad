"""GAME (generalized additive mixed effects) models (counterpart of
``photon_ml_tpu/game``). ``data`` holds the dataset and the per-entity
random-effect designs, ``factored`` the factored random-effect parameters,
``scoring`` the model-level scorer ``score_game_data``, ``coordinates``
the fixed- and random-effect training coordinates and ``descent`` the
coordinate-descent loop. Projected and factored training coordinates are
not ported yet."""
