"""The port's projected random effects (``game/projectors.py``,
``game/projected.py``) against the JAX package's on the CPU in float64, on
the same seeded numpy inputs: the RANDOM matrix and the INDEX_MAP columns
bit for bit, a wide ELL shard's rows projected exactly (duplicate slots
included), the back-projection, one update of a RANDOM, a dense INDEX_MAP
and a sparse INDEX_MAP coordinate within 1e-10, and the training driver on
``examples/run_wide_game.sh``'s configuration (the same best combo,
objectives within 1e-10 relative, tables within 1e-8)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_ml_tpu.cli.game_train import run_game_training as jax_run_game_training
from photon_ml_tpu.core.tasks import TaskType as JTask
from photon_ml_tpu.game import coordinates as jcoords
from photon_ml_tpu.game import data as jdata
from photon_ml_tpu.game import projected as jproj
from photon_ml_tpu.game import projectors as jprojectors
from photon_ml_tpu.io.avro import write_avro_file
from photon_ml_tpu.io.ingest import make_training_example
from photon_ml_tpu.io.schemas import TRAINING_EXAMPLE_SCHEMA
from photon_ml_tpu.io.vocab import FeatureVocabulary
from photon_ml_tpu.models.training import OptimizerType as JOpt
from photon_ml_tpu.ops import sparse as jsparse
from photon_ml_tpu_torch import interop
from photon_ml_tpu_torch.cli import game_train as tgame
from photon_ml_tpu_torch.core.tasks import TaskType
from photon_ml_tpu_torch.game import coordinates as tcoords
from photon_ml_tpu_torch.game import data as tdata
from photon_ml_tpu_torch.game import projected as tproj
from photon_ml_tpu_torch.game import projectors as tprojectors
from photon_ml_tpu_torch.models.training import OptimizerType

N, E, D, D_WIDE = 300, 12, 6, 400


def _dense_data(seed=7):
    """A dense per-user shard whose users touch subsets of its columns
    (the INDEX_MAP case), an intercept column, unknown users."""
    rng = np.random.default_rng(seed)
    ents = rng.integers(0, E, N)
    ents[::17] = -1
    x = rng.normal(size=(N, D))
    x *= rng.uniform(size=(E, D))[np.maximum(ents, 0)] < 0.6
    x[:, -1] = 1.0
    w = rng.normal(size=(E, D))
    margin = np.einsum("nd,nd->n", x, w[np.maximum(ents, 0)])
    y = (rng.uniform(size=N) < 1 / (1 + np.exp(-margin))).astype(float)
    offsets = rng.normal(size=N) * 0.2
    args = ({"u": x}, y, offsets, rng.uniform(0.5, 2.0, N), {"uid": ents})
    return jdata.GameData.create(*args), tdata.GameData.create(*args)


def _wide_data(seed=8):
    """A wide ELL shard: each user a private pool of 12 columns, 5 slots
    a row, duplicate (row, column) slots and padding."""
    rng = np.random.default_rng(seed)
    pools = rng.choice(D_WIDE, size=(E, 12))
    ents = rng.integers(0, E, N)
    ents[::19] = -1
    cols = pools[np.maximum(ents, 0)[:, None], rng.integers(0, 12, (N, 5))]
    vals = rng.normal(size=cols.shape)
    cols[::7, -1] = D_WIDE  # padding slots
    vals[::7, -1] = 0.0
    cols[::5, 1] = cols[::5, 0]  # duplicate slots
    w = rng.normal(size=D_WIDE)
    margin = np.sum(vals * np.append(w, 0.0)[cols], axis=1)
    y = (rng.uniform(size=N) < 1 / (1 + np.exp(-margin))).astype(float)
    offsets = rng.normal(size=N) * 0.2
    jx = jsparse.SparseFeatures(jnp.asarray(cols, jnp.int32), jnp.asarray(vals), D_WIDE)
    tx = interop.sparse_from_numpy(cols, vals, D_WIDE)
    common = (y, offsets, np.ones(N), {"uid": ents})
    return (jdata.GameData.create({"w": jx}, *common),
            tdata.GameData.create({"w": tx}, *common), cols, vals, ents)


def _configs(**extra):
    common = dict(random_effect="uid", max_iters=30, tolerance=1e-8, reg_weight=0.7, **extra)
    jopt = {k: v for k, v in common.items() if k != "optimizer"}
    opt = extra.get("optimizer", "TRON")
    return (jcoords.CoordinateConfig(shard="u", task=JTask.LOGISTIC_REGRESSION,
                                     **{**jopt, "optimizer": JOpt[opt]}),
            tcoords.CoordinateConfig(shard="u", task=TaskType.LOGISTIC_REGRESSION,
                                     **{**jopt, "optimizer": OptimizerType[opt]}))


def test_random_projection_same_bits():
    for icpt in (None, 3):
        j = jprojectors.build_random_projection(9, 4, seed=5, intercept_index=icpt,
                                                 dtype=jnp.float64)
        t = tprojectors.build_random_projection(9, 4, seed=5, intercept_index=icpt,
                                                dtype=torch.float64)
        np.testing.assert_array_equal(t.matrix.numpy(), np.asarray(j.matrix))


def test_index_map_columns_rows_and_back_projection_are_exact():
    jd, td = _dense_data()
    j = jproj.build_index_map_columns(jd, "uid", "u", E)
    t = tproj.build_index_map_columns(td, "uid", "u", E)
    np.testing.assert_array_equal(t.columns.numpy(), np.asarray(j.columns))

    jw, tw, cols, vals, ents = _wide_data()
    j = jproj.build_index_map_columns(jw, "uid", "w", E)
    t = tproj.build_index_map_columns(tw, "uid", "w", E)
    np.testing.assert_array_equal(t.columns.numpy(), np.asarray(j.columns))
    rows_j = jproj.project_sparse_rows(jw.features["w"], ents, j, dtype=np.float64)
    rows_t = tproj.project_sparse_rows(tw.features["w"], ents, t, dtype=np.float64)
    np.testing.assert_array_equal(rows_t, rows_j)
    # the dense rows' margins equal the ELL rows' at any coefficients
    table = np.random.default_rng(1).normal(size=(E, t.projected_dim))
    back_j = np.asarray(j.project_coefficients_back(jnp.asarray(table), D_WIDE))
    back_t = t.project_coefficients_back(torch.from_numpy(table), D_WIDE).numpy()
    np.testing.assert_array_equal(back_t, back_j)
    known = ents >= 0
    proj_margin = np.einsum("nk,nk->n", rows_t, table[np.maximum(ents, 0)])[known]
    wide = np.hstack([back_t, np.zeros((E, 1))])[np.maximum(ents, 0)[:, None], cols]
    np.testing.assert_allclose(proj_margin, np.sum(vals * wide, axis=1)[known], atol=1e-12)

    # the projected design of one bucket and the row view, exactly; the
    # design-tensor builder of the columns
    design_j = jdata.build_random_effect_design(jd, "uid", "u", E, dtype=jnp.float64)
    design_t = tdata.build_random_effect_design(td, "uid", "u", E, dtype=torch.float64)
    np.testing.assert_array_equal(
        tprojectors.build_index_map_projection(design_t).columns.numpy(),
        np.asarray(jprojectors.build_index_map_projection(design_j).columns))
    jcols = jproj.build_index_map_columns(jd, "uid", "u", E)
    tcols = interop.index_map_from_numpy(np.asarray(jcols.columns))
    np.testing.assert_array_equal(tcols.project_design(design_t).features.numpy(),
                                  np.asarray(jcols.project_design(design_j).features))
    ents_t = torch.from_numpy(np.asarray(jd.entity_ids["uid"], np.int64))
    np.testing.assert_array_equal(
        tcols.project_row_features(torch.from_numpy(np.asarray(jd.features["u"])),
                                   ents_t).numpy(),
        np.asarray(jcols.project_row_features(jnp.asarray(jd.features["u"]),
                                              jnp.asarray(jd.entity_ids["uid"]))))


def test_random_back_projection():
    """RANDOM's back-projection is a matrix product: the same within 1e-14
    (summation order)."""
    j = jprojectors.build_random_projection(D, 3, seed=2, intercept_index=D - 1,
                                             dtype=jnp.float64)
    t = interop.random_projection_from_numpy(np.asarray(j.matrix))
    table = np.random.default_rng(3).normal(size=(E, 4))
    np.testing.assert_allclose(
        t.project_coefficients_back(torch.from_numpy(table)).numpy(),
        np.asarray(j.project_coefficients_back(jnp.asarray(table))), rtol=0, atol=1e-14)


def _assert_update(jcoord, tcoord):
    """One update from the cold start, both packages: the tables within
    1e-10, the scores and penalty too, the same per-entity reasons and
    iterations."""
    jt, tt = jcoord.initial_params(), tcoord.initial_params()
    partial = np.random.default_rng(4).normal(size=N) * 0.3
    jt, jres, js = jcoord.update_and_score(jt, jnp.asarray(partial))
    tt, tres, ts = tcoord.update_and_score(tt, torch.from_numpy(partial))
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), rtol=0, atol=1e-10)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=0, atol=1e-10)
    np.testing.assert_array_equal(tres.reason, jres.reason)
    np.testing.assert_array_equal(tres.iterations, jres.iterations)
    np.testing.assert_allclose(float(tcoord.reg_term(tt)), float(jcoord.reg_term(jt)),
                               rtol=1e-12)
    np.testing.assert_allclose(tcoord.back_project(tt).numpy(),
                               np.asarray(jcoord.back_project(jt)), rtol=0, atol=1e-10)


@pytest.mark.parametrize("kind,extra", [("RANDOM", {}), ("INDEX_MAP", {}),
                                        ("RANDOM", {"optimizer": "NEWTON"}),
                                        ("INDEX_MAP", {"l1_ratio": 0.5, "optimizer": "LBFGS"})],
                         ids=["random-tron", "index-map-tron", "random-newton",
                              "index-map-owlqn"])
def test_projected_update_matches_jax(kind, extra):
    jd, td = _dense_data()
    jcfg, tcfg = _configs(**extra)
    jdes = jdata.build_bucketed_random_effect_design(jd, "uid", "u", E, num_buckets=2,
                                                     dtype=jnp.float64)
    tdes = tdata.build_bucketed_random_effect_design(td, "uid", "u", E, num_buckets=2,
                                                     dtype=torch.float64)
    if kind == "RANDOM":
        jp = jprojectors.build_random_projection(D, 3, seed=0, intercept_index=D - 1,
                                                  dtype=jnp.float64)
        tp = tprojectors.build_random_projection(D, 3, seed=0, intercept_index=D - 1,
                                                 dtype=torch.float64)
    else:
        jp = jproj.build_index_map_columns(jd, "uid", "u", E)
        tp = tproj.build_index_map_columns(td, "uid", "u", E)
    x, ents = np.asarray(jd.features["u"]), np.asarray(jd.entity_ids["uid"])
    jcoord = jproj.ProjectedRandomEffectCoordinate(
        jdes, jnp.asarray(x), jnp.asarray(ents), jnp.asarray(jd.offsets), jcfg, jp, D)
    tcoord = tproj.ProjectedRandomEffectCoordinate(
        tdes, torch.from_numpy(x), torch.from_numpy(ents.astype(np.int64)),
        torch.from_numpy(np.asarray(jd.offsets)), tcfg, tp, D)
    _assert_update(jcoord, tcoord)
    # the grid's reuse hook keeps the projection and takes the new weight
    again = tcoord.with_config(dataclasses.replace(tcfg, reg_weight=2.0))
    assert again.projector is tcoord.projector and again.config.reg_weight == 2.0
    assert float(again.inner.reg_weights[0]) == 2.0


def test_sparse_index_map_update_matches_jax():
    jw, tw, _, _, _ = _wide_data()
    jcfg, tcfg = _configs()
    jcfg = dataclasses.replace(jcfg, shard="w")
    tcfg = dataclasses.replace(tcfg, shard="w")
    jcoord = jproj.ProjectedRandomEffectCoordinate.from_sparse_shard(
        jw, "uid", "w", E, jcfg, num_buckets=2, dtype=jnp.float64, min_support=1)
    tcoord = tproj.ProjectedRandomEffectCoordinate.from_sparse_shard(
        tw, "uid", "w", E, tcfg, num_buckets=2, dtype=torch.float64, min_support=1)
    assert tcoord.original_dim == D_WIDE and tcoord.dim == jcoord.dim
    _assert_update(jcoord, tcoord)


def _write_wide_inputs(tmp, seed=0, n=600, users=15):
    """``examples/make_wide_game_data.py`` at a small size: a 2-column
    global shard and a 20,000-column user shard, each user a private pool
    of 25 columns, 5 a row."""
    rng = np.random.default_rng(seed)
    pools = rng.choice(20_000, size=(users, 25))
    w_wide = rng.normal(size=20_000) * 0.8
    records = []
    for i in range(n):
        u = int(rng.integers(0, users))
        cols = np.unique(pools[u][rng.integers(0, 25, 5)])
        vals = rng.normal(size=cols.size)
        xg = rng.normal(size=2)
        margin = float(vals @ w_wide[cols] + xg @ np.asarray([1.5, -1.0]))
        feats = {(f"g{j}", ""): float(xg[j]) for j in range(2)}
        feats.update({(f"w{c}", ""): float(v) for c, v in zip(cols, vals)})
        rec = make_training_example(label=float(rng.uniform() < 1 / (1 + np.exp(-margin))),
                                    features=feats, uid=f"r{i}")
        rec["metadataMap"] = {"userId": f"user{u}"}
        records.append(rec)
    write_avro_file(str(tmp / "wide.avro"), TRAINING_EXAMPLE_SCHEMA, records)
    FeatureVocabulary([f"g{j}\x01" for j in range(2)], add_intercept=True).save(
        str(tmp / "global.txt"))
    FeatureVocabulary([f"w{c}\x01" for c in range(20_000)]).save(str(tmp / "user.txt"))


def test_wide_game_driver_matches_jax(tmp_path):
    """``examples/run_wide_game.sh``'s configuration (two passes, TRON at
    1e-8 on both coordinates, ``min_support`` 1) with a two-point grid on
    the wide coordinate."""
    _write_wide_inputs(tmp_path)

    def params(out):
        return {
            "train_input": [str(tmp_path / "wide.avro")],
            "validate_input": [str(tmp_path / "wide.avro")],
            "output_dir": str(tmp_path / out),
            "task": "LOGISTIC_REGRESSION",
            "num_iterations": 2,
            "updating_sequence": ["global", "per-user"],
            "feature_shards": {"globalShard": str(tmp_path / "global.txt"),
                               "wideShard": str(tmp_path / "user.txt")},
            "sparse_shards": ["wideShard"],
            "coordinates": {
                "global": {"shard": "globalShard", "optimizer": "TRON", "reg_weights": [1.0],
                           "max_iters": 30, "tolerance": 1e-8},
                "per-user": {"shard": "wideShard", "optimizer": "TRON",
                             "reg_weights": [1.0, 0.3], "random_effect": "userId",
                             "projector": "INDEX_MAP", "min_support": 1, "max_iters": 30,
                             "tolerance": 1e-8},
            },
            "model_output_mode": "ALL",
        }

    ref = jax_run_game_training({**params("jax"), "quality_fingerprint": False})
    got = tgame.run_game_training(params("torch"), device="cpu")
    assert got.best_index == ref.best_index
    for g, r in zip(got.sweep, ref.sweep):
        for hg, hr in zip(g["history"], r["history"]):
            np.testing.assert_allclose(hg.objective, hr.objective, rtol=1e-10)
            np.testing.assert_allclose(hg.validation_metric, hr.validation_metric, atol=1e-10)
            assert hg.convergence_histogram == hr.convergence_histogram
        for name, p in r["model"].params.items():
            got_p = g["model"].params[name].numpy()
            np.testing.assert_allclose(got_p, np.asarray(p), rtol=0, atol=1e-8, err_msg=name)
        # the back-projected table: zero outside each user's active columns
        table = g["model"].params["per-user"].numpy()
        assert table.shape[1] == 20_000
        np.testing.assert_array_equal(table != 0, np.asarray(r["model"].params["per-user"]) != 0)
