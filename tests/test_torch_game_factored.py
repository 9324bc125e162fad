"""The port's factored random effects (``game/factored.py``) and the
matrix-factorization model files against the JAX package's on the CPU in
float64, on the same seeded numpy inputs: one update of the factored
coordinate (TRON, NEWTON and OWL-QN per-entity solves; TRON, L-BFGS and
OWL-QN for B) with gamma and B within 1e-10, its scores, penalty and full
table; the MF model's scores; ``save_mf_model`` / ``load_mf_model`` both
ways; and the training driver on a factored configuration (the same best
combo, objectives within 1e-10 relative, gamma and B within 1e-8)."""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_ml_tpu.cli.game_train import run_game_training as jax_run_game_training
from photon_ml_tpu.core.tasks import TaskType as JTask
from photon_ml_tpu.game import coordinates as jcoords
from photon_ml_tpu.game import data as jdata
from photon_ml_tpu.game import factored as jfactored
from photon_ml_tpu.io import models as jmodels
from photon_ml_tpu.models.training import OptimizerType as JOpt
from photon_ml_tpu_torch import interop
from photon_ml_tpu_torch.cli import game_train as tgame
from photon_ml_tpu_torch.core.tasks import TaskType
from photon_ml_tpu_torch.game import coordinates as tcoords
from photon_ml_tpu_torch.game import data as tdata
from photon_ml_tpu_torch.game import factored as tfactored
from photon_ml_tpu_torch.io import models as tmodels
from photon_ml_tpu_torch.models.training import OptimizerType

N, E, D, K = 360, 14, 5, 3


def _data(seed=11):
    rng = np.random.default_rng(seed)
    ents = rng.integers(0, E, N)
    ents[::23] = -1
    x = rng.normal(size=(N, D))
    x[:, -1] = 1.0
    b = rng.normal(size=(D, K))
    g = rng.normal(size=(E, K))
    margin = np.einsum("nd,nd->n", x, (g @ b.T)[np.maximum(ents, 0)])
    y = (rng.uniform(size=N) < 1 / (1 + np.exp(-margin))).astype(float)
    args = ({"u": x}, y, rng.normal(size=N) * 0.2, rng.uniform(0.5, 2.0, N), {"uid": ents})
    return jdata.GameData.create(*args), tdata.GameData.create(*args)


def _coords(re_opt, latent_opt, l1_ratio=0.0, latent_l1=0.0):
    jd, td = _data()
    common = dict(random_effect="uid", max_iters=25, tolerance=1e-8, reg_weight=0.8)
    jre = jcoords.CoordinateConfig(shard="u", task=JTask.LOGISTIC_REGRESSION,
                                   optimizer=JOpt[re_opt], l1_ratio=l1_ratio, **common)
    tre = tcoords.CoordinateConfig(shard="u", task=TaskType.LOGISTIC_REGRESSION,
                                   optimizer=OptimizerType[re_opt], l1_ratio=l1_ratio, **common)
    jlat = dataclasses.replace(jre, optimizer=JOpt[latent_opt], reg_weight=1.5,
                               l1_ratio=latent_l1)
    tlat = dataclasses.replace(tre, optimizer=OptimizerType[latent_opt], reg_weight=1.5,
                               l1_ratio=latent_l1)
    jdes = jdata.build_bucketed_random_effect_design(jd, "uid", "u", E, num_buckets=2,
                                                     dtype=jnp.float64)
    tdes = tdata.build_bucketed_random_effect_design(td, "uid", "u", E, num_buckets=2,
                                                     dtype=torch.float64)
    x, ents, off = (np.asarray(jd.features["u"]), np.asarray(jd.entity_ids["uid"]),
                    np.asarray(jd.offsets))
    jc = jfactored.FactoredRandomEffectCoordinate(
        jdes, jnp.asarray(x), jnp.asarray(ents), jnp.asarray(off), jre,
        jfactored.FactoredConfig(latent_dim=K, num_inner_iterations=2,
                                 latent_factor_config=jlat), seed=3)
    tc = tfactored.FactoredRandomEffectCoordinate(
        tdes, torch.from_numpy(x), torch.from_numpy(ents.astype(np.int64)),
        torch.from_numpy(off), tre,
        tfactored.FactoredConfig(latent_dim=K, num_inner_iterations=2,
                                 latent_factor_config=tlat), seed=3)
    return jc, tc


CASES = [("TRON", "TRON", 0.0, 0.0), ("NEWTON", "LBFGS", 0.0, 0.0),
         ("LBFGS", "LBFGS", 0.5, 0.5)]


@pytest.mark.parametrize("re_opt,latent_opt,l1_ratio,latent_l1", CASES,
                         ids=["tron-tron", "newton-lbfgs", "owlqn-owlqn"])
def test_factored_update_matches_jax(re_opt, latent_opt, l1_ratio, latent_l1):
    jc, tc = _coords(re_opt, latent_opt, l1_ratio, latent_l1)
    jp, tp = jc.initial_params(), tc.initial_params()
    np.testing.assert_array_equal(tp.projection.numpy(), np.asarray(jp.projection))
    partial = np.random.default_rng(5).normal(size=N) * 0.3
    jp, jres, js = jc.update_step(jp, jnp.asarray(partial))
    tp, tres, ts = tc.update_and_score(tp, torch.from_numpy(partial))
    np.testing.assert_allclose(tp.gamma.numpy(), np.asarray(jp.gamma), rtol=0, atol=1e-10)
    np.testing.assert_allclose(tp.projection.numpy(), np.asarray(jp.projection), rtol=0,
                               atol=1e-10)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=0, atol=1e-10)
    # the update's result is the last bucket's batched solve, as in JAX
    np.testing.assert_array_equal(tres.reason.numpy(), np.asarray(jres.reason))
    np.testing.assert_array_equal(tres.iterations.numpy(), np.asarray(jres.iterations))
    np.testing.assert_allclose(float(tc.reg_term(tp)), float(jc.reg_term(jp)), rtol=1e-12)
    np.testing.assert_allclose(tc.to_full_table(tp).numpy(),
                               np.asarray(jc.to_full_table(jp)), rtol=0, atol=1e-10)


def test_factored_config_checks():
    with pytest.raises(ValueError, match="latent_dim"):
        tfactored.FactoredConfig(latent_dim=0)
    with pytest.raises(ValueError, match="num_inner_iterations"):
        tfactored.FactoredConfig(latent_dim=2, num_inner_iterations=0)


def test_mf_model_scores_and_files_both_ways(tmp_path):
    jm = jfactored.MatrixFactorizationModel.random(6, 4, 3, seed=2, dtype=jnp.float64)
    tm = tfactored.MatrixFactorizationModel.random(6, 4, 3, seed=2, dtype=torch.float64)
    np.testing.assert_array_equal(tm.row_factors.numpy(), np.asarray(jm.row_factors))
    rows = np.asarray([0, 5, -1, 2, 3], np.int32)
    cols = np.asarray([1, 3, 2, -1, 0], np.int32)
    np.testing.assert_allclose(tm.score(torch.from_numpy(rows), torch.from_numpy(cols)).numpy(),
                               np.asarray(jm.score(jnp.asarray(rows), jnp.asarray(cols))),
                               rtol=1e-13, atol=0)
    assert tm.latent_dim == 3
    row_vocab = {f"u{i}": i for i in range(6)}
    col_vocab = {f"a{i}": i for i in range(4)}
    # the port writes, the JAX package reads
    tmodels.save_mf_model(str(tmp_path / "t"), tm, "userId", "adId", row_vocab, col_vocab)
    got, rv, cv = jmodels.load_mf_model(str(tmp_path / "t"), "userId", "adId")
    np.testing.assert_array_equal(np.asarray(got.row_factors), tm.row_factors.numpy())
    np.testing.assert_array_equal(np.asarray(got.col_factors), tm.col_factors.numpy())
    assert rv == row_vocab and cv == col_vocab
    # the JAX package writes, the port reads
    jmodels.save_mf_model(str(tmp_path / "j"), jm, "userId", "adId", row_vocab, col_vocab)
    back, rv, cv = tmodels.load_mf_model(str(tmp_path / "j"), "userId", "adId", row_vocab)
    np.testing.assert_array_equal(back.row_factors.numpy(), np.asarray(jm.row_factors))
    np.testing.assert_array_equal(back.col_factors.numpy(), np.asarray(jm.col_factors))
    assert rv == row_vocab and cv == col_vocab
    with pytest.raises(ValueError, match="differ"):
        tmodels.save_mf_model(str(tmp_path / "x"), tm, "userId", "userId")
    assert os.path.exists(tmp_path / "t" / "adId" / "part-00000.avro")


def test_factored_driver_matches_jax(tmp_path):
    """A fixed effect and a factored per-user effect with the latent
    solve's own settings, OWL-QN for gamma, a warm start of the factored
    coordinate from the first run's saved model."""
    from test_torch_game_train import D_G, D_U, N_USERS, _records  # noqa: F401
    from photon_ml_tpu.io.avro import write_avro_file
    from photon_ml_tpu.io.schemas import TRAINING_EXAMPLE_SCHEMA
    from photon_ml_tpu.io.vocab import FeatureVocabulary, feature_key

    rng = np.random.default_rng(31)
    truth = (rng.normal(size=D_G), rng.normal(size=(N_USERS, D_U)) * 1.5)
    write_avro_file(str(tmp_path / "train.avro"), TRAINING_EXAMPLE_SCHEMA,
                    _records(rng, 240, truth))
    shards = {}
    for shard, keys in (("gshard", [f"g{j}" for j in range(D_G)]),
                        ("ushard", [f"u{j}" for j in range(D_U)])):
        shards[shard] = str(tmp_path / f"{shard}.txt")
        FeatureVocabulary([feature_key(k, "") for k in keys], add_intercept=True).save(
            shards[shard])

    def params(out, **extra):
        return {
            "train_input": [str(tmp_path / "train.avro")],
            "validate_input": [str(tmp_path / "train.avro")],
            "output_dir": str(tmp_path / out),
            "num_iterations": 2,
            "updating_sequence": ["global", "per-user"],
            "feature_shards": shards,
            "coordinates": {
                "global": {"shard": "gshard", "reg_weights": [0.5], "max_iters": 30,
                           "tolerance": 1e-7},
                "per-user": {"shard": "ushard", "random_effect": "userId",
                             "optimizer": "LBFGS", "l1_ratio": 0.5, "latent_dim": 2,
                             "num_inner_iterations": 2, "latent_reg_weight": 2.0,
                             "latent_max_iters": 15, "latent_tolerance": 1e-7,
                             "reg_weights": [1.0, 0.2], "max_iters": 30, "tolerance": 1e-7},
            },
            "model_output_mode": "BEST",
            **extra,
        }

    ref = jax_run_game_training({**params("jax"), "quality_fingerprint": False})
    got = tgame.run_game_training(params("torch"), device="cpu")
    assert got.best_index == ref.best_index
    for g, r in zip(got.sweep, ref.sweep):
        for hg, hr in zip(g["history"], r["history"]):
            np.testing.assert_allclose(hg.objective, hr.objective, rtol=1e-10)
            np.testing.assert_allclose(hg.validation_metric, hr.validation_metric, atol=1e-10)
        gp, rp = g["model"].params["per-user"], r["model"].params["per-user"]
        np.testing.assert_allclose(gp.gamma.numpy(), np.asarray(rp.gamma), rtol=0, atol=1e-8)
        np.testing.assert_allclose(gp.projection.numpy(), np.asarray(rp.projection), rtol=0,
                                   atol=1e-8)
    # each package warm-starts from the other's saved factored model
    warm = {"initial_model_dir": got.output_dirs[0], "num_iterations": 1}
    ref_w = jax_run_game_training({**params("jax-warm", **warm), "quality_fingerprint": False})
    got_w = tgame.run_game_training(
        params("torch-warm", **{**warm, "initial_model_dir": ref.output_dirs[0]}), device="cpu")
    for g, r in zip(got_w.sweep, ref_w.sweep):
        gp, rp = g["model"].params["per-user"], r["model"].params["per-user"]
        np.testing.assert_allclose(gp.gamma.numpy(), np.asarray(rp.gamma), rtol=0, atol=1e-8)
    # the port's GameModel bridge carries FactoredParams both ways
    model = interop.game_model_from_numpy({"per-user": rp})
    back = interop.game_model_to_numpy(model)["per-user"]
    np.testing.assert_array_equal(back["gamma"], np.asarray(rp.gamma))
