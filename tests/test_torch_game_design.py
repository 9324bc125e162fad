"""The port's random-effect designs against the JAX package's, on the CPU:
the same numpy inputs and seed give the same padded tensors, buckets,
entity indices, feature filters and offset gathers, exactly."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_ml_tpu.game import data as jdata
from photon_ml_tpu_torch.game import data as tdata


def _game_data(seed=7, n=400, n_entities=30, d=5, zipf=True):
    rng = np.random.default_rng(seed)
    ents = ((rng.zipf(1.3, n) - 1) % n_entities) if zipf else rng.integers(0, n_entities, n)
    ents = np.where(rng.uniform(size=n) < 0.08, -1, ents)
    x = rng.normal(size=(n, d))
    x[:, -1] = 1.0  # an intercept column
    x[rng.uniform(size=(n, d)) < 0.3] = 0.0
    labels = (rng.uniform(size=n) < 0.4).astype(float)
    offsets = rng.normal(size=n) * 0.3
    weights = rng.uniform(0.5, 2.0, n)
    args = ({"u": x}, labels, offsets, weights, {"uid": ents})
    return jdata.GameData.create(*args), tdata.GameData.create(*args), n_entities


def _assert_design_equal(t, j):
    for field in ("features", "labels", "weights", "mask", "row_index"):
        np.testing.assert_array_equal(getattr(t, field).numpy(),
                                      np.asarray(getattr(j, field)), err_msg=field)


@pytest.mark.parametrize("kw", [
    {}, {"active_cap": 7}, {"feature_ratio": 0.5}, {"min_support": 3},
    {"active_cap": 5, "feature_ratio": 0.4, "min_support": 2, "seed": 3},
], ids=["plain", "cap", "pearson", "support", "all"])
def test_global_cap_design_equals_jax(kw):
    jd, td, e = _game_data()
    j = jdata.build_random_effect_design(jd, "uid", "u", e, dtype=jnp.float64, **kw)
    t = tdata.build_random_effect_design(td, "uid", "u", e, dtype=torch.float64, **kw)
    _assert_design_equal(t, j)
    assert (t.num_entities, t.rows_per_entity, t.dim) == (j.num_entities, j.rows_per_entity,
                                                          j.dim)


@pytest.mark.parametrize("kw", [
    {"num_buckets": 1}, {"num_buckets": 2}, {"num_buckets": 4},
    {"num_buckets": 3, "active_cap": 6}, {"num_buckets": 2, "entity_multiple": 4},
    {"num_buckets": 3, "feature_ratio": 0.6, "min_support": 2, "seed": 11},
], ids=["1", "2", "4", "cap", "multiple", "filters"])
def test_bucketed_design_equals_jax(kw):
    jd, td, e = _game_data(seed=3, n=600)
    j = jdata.build_bucketed_random_effect_design(jd, "uid", "u", e, dtype=jnp.float64, **kw)
    t = tdata.build_bucketed_random_effect_design(td, "uid", "u", e, dtype=torch.float64,
                                                  **kw)
    assert t.num_buckets == j.num_buckets and t.num_entities == j.num_entities
    assert t.active_slots == j.active_slots
    for tb, jb, ti, ji in zip(t.buckets, j.buckets, t.entity_index, j.entity_index):
        _assert_design_equal(tb, jb)
        np.testing.assert_array_equal(ti, np.asarray(ji))
        assert ti.dtype == np.int32


def test_all_unknown_entities_give_one_masked_bucket():
    jd, td, e = _game_data()
    for data in (jd, td):
        data.entity_ids["uid"] = np.full(data.num_rows, -1, np.int32)
    j = jdata.build_bucketed_random_effect_design(jd, "uid", "u", e, entity_multiple=2)
    t = tdata.build_bucketed_random_effect_design(td, "uid", "u", e, entity_multiple=2)
    _assert_design_equal(t.buckets[0], j.buckets[0])
    np.testing.assert_array_equal(t.entity_index[0], np.asarray(j.entity_index[0]))


def test_gather_offsets_and_device_placement():
    jd, td, e = _game_data()
    j = jdata.build_random_effect_design(jd, "uid", "u", e, dtype=jnp.float64)
    t = tdata.build_random_effect_design(td, "uid", "u", e, dtype=torch.float64, device="cpu")
    full = np.random.default_rng(1).normal(size=jd.num_rows)
    np.testing.assert_array_equal(t.gather_offsets(torch.from_numpy(full)).numpy(),
                                  np.asarray(j.gather_offsets(jnp.asarray(full))))
    assert t.features.device.type == "cpu"


def test_pearson_scores_and_padding_split_equal_jax():
    rng = np.random.default_rng(5)
    feats = rng.normal(size=(12, 9, 6))
    feats[:, :, 2] = 1.0
    feats[:, :, 4] = 1.0  # a second constant column scores 0
    feats[3, :, 1] = 0.0  # absent: -inf
    labels = (rng.uniform(size=(12, 9)) < 0.5).astype(float)
    labels[7] = 1.0  # constant labels
    mask = (rng.uniform(size=(12, 9)) < 0.8).astype(float)
    np.testing.assert_array_equal(
        tdata.pearson_correlation_scores(feats, labels, mask),
        jdata.pearson_correlation_scores(feats, labels, mask))
    for counts, k in ((np.sort(rng.integers(1, 40, 200)), 4), (np.array([3, 3, 3]), 2),
                      (np.array([], np.int64), 3), (np.arange(1, 30), 30)):
        assert (tdata._split_minimizing_padding(counts, k)
                == jdata._split_minimizing_padding(counts, k))


def test_sparse_shard_is_refused():
    from photon_ml_tpu_torch.ops.sparse import from_dense

    _, td, e = _game_data()
    td.features["s"] = from_dense(np.asarray(td.features["u"]))
    with pytest.raises(ValueError, match="sparse"):
        tdata.build_bucketed_random_effect_design(td, "uid", "s", e)
    with pytest.raises(ValueError, match="active_cap"):
        tdata.build_random_effect_design(td, "uid", "u", e, active_cap=0)
