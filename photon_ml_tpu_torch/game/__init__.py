"""GAME (generalized additive mixed effects) models: the scoring side
(counterpart of ``photon_ml_tpu/game``). ``data`` holds the scored dataset,
``factored`` the factored random-effect parameters and ``scoring`` the
model-level scorer ``score_game_data``. GAME training is not ported yet."""
