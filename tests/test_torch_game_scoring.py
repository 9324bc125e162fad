"""The port's GAME scorer (``photon_ml_tpu_torch.game.scoring``) against
the JAX package's ``score_game_data`` on the same seeded numpy inputs,
carried across by ``interop.game_params_from_numpy``, on the CPU in f64.

Each coordinate kind alone and all together: a fixed effect on a dense
shard and on a padded-ELL shard (the port's ``ell_matvec``), a dense
random effect, a wide random effect on an ELL shard (compacted, joined by
``searchsorted``), a pre-compacted table against dense rows, and a
factored random effect; unknown entities (-1) score 0. Scores agree within
1e-12 (f64; summation order only). Also: ``precompact_model``,
``compact_table_rows``, the compaction cache after an in-place edit, the
refusals, ``GameData``, the entity vocabularies and the padded bucket.
"""

import numpy as np
import pytest
import torch

from photon_ml_tpu.game import data as jax_data
from photon_ml_tpu.game import scoring as jax_scoring
from photon_ml_tpu.game.factored import FactoredParams as JaxFactoredParams
from photon_ml_tpu.ops.sparse import SparseFeatures as JaxSparseFeatures
from photon_ml_tpu.serving import engine as jax_engine
from photon_ml_tpu_torch.game import scoring
from photon_ml_tpu_torch.game.data import (
    GameData,
    apply_entity_vocabulary,
    build_entity_vocabulary,
)
from photon_ml_tpu_torch.game.factored import FactoredParams, is_factored_params
from photon_ml_tpu_torch.interop import game_params_from_numpy, sparse_from_numpy
from photon_ml_tpu_torch.kernels import dispatch
from photon_ml_tpu_torch.ops.sparse import is_sparse
from photon_ml_tpu_torch.serving.engine import bucket_size, pad_game_data

TOL = 1e-12
N, N_USERS, N_ADS = 53, 9, 7
D_G, D_GS, D_U, D_W, D_F, POOL, LATENT = 6, 40, 5, 60, 4, 6, 3


def _ell(rng, n, d, k, pools=None, ents=None):
    """(n, k) int32 ids ascending within a row (pad d at the end) and f64
    values; with ``pools``, row i draws from its entity's pool."""
    idx = np.full((n, k), d, np.int32)
    val = np.zeros((n, k))
    for i in range(n):
        m = int(rng.integers(1, k + 1))
        src = pools[max(ents[i], 0)] if pools is not None else np.arange(d)
        cols = np.unique(rng.choice(src, size=m))
        # a column outside the entity's pool now and then: misses the join
        if pools is not None and i % 5 == 0:
            cols = np.unique(np.append(cols, rng.integers(0, d)))[:k]
        idx[i, : cols.size] = cols
        val[i, : cols.size] = rng.standard_normal(cols.size)
    return idx, val


@pytest.fixture(scope="module")
def game():
    rng = np.random.default_rng(20261017)
    users = rng.integers(-1, N_USERS, size=N).astype(np.int32)
    ads = rng.integers(-1, N_ADS, size=N).astype(np.int32)
    pools = np.stack([rng.choice(D_W, POOL, replace=False) for _ in range(N_USERS)])
    x_g = rng.standard_normal((N, D_G))
    x_g[:, -1] = 1.0  # intercept
    gs_idx, gs_val = _ell(rng, N, D_GS, 7)
    x_u = rng.standard_normal((N, D_U))
    w_idx, w_val = _ell(rng, N, D_W, 4, pools, users)
    x_f = rng.standard_normal((N, D_F))
    wide = np.zeros((N_USERS, D_W))
    for e in range(N_USERS):
        wide[e, pools[e]] = rng.standard_normal(POOL)
    wide[3] = 0.0  # an entity with no coefficients at all
    dense_u = rng.standard_normal((N_USERS, D_U))
    dense_u[:, 1] = 0.0
    params = {
        "global": rng.standard_normal(D_G),
        "global-sparse": rng.standard_normal(D_GS),
        "per-user": dense_u,
        "per-user-wide": wide,
        "per-user-compact": jax_scoring.CompactReTable(
            *jax_scoring._compact_table(dense_u)
        ),
        "per-ad-latent": JaxFactoredParams(
            gamma=rng.standard_normal((N_ADS, LATENT)),
            projection=rng.standard_normal((D_F, LATENT)),
        ),
    }
    shards = {"global": "g", "global-sparse": "gs", "per-user": "u",
              "per-user-wide": "w", "per-user-compact": "u", "per-ad-latent": "f"}
    res = {"global": None, "global-sparse": None, "per-user": "userId",
           "per-user-wide": "userId", "per-user-compact": "userId",
           "per-ad-latent": "adId"}
    labels = rng.integers(0, 2, N).astype(np.float64)
    offsets = rng.normal(0, 0.1, N)
    entity_ids = {"userId": users, "adId": ads}
    jdata = jax_data.GameData.create(
        {"g": x_g, "gs": JaxSparseFeatures(gs_idx, gs_val, D_GS), "u": x_u,
         "w": JaxSparseFeatures(w_idx, w_val, D_W), "f": x_f},
        labels, offsets=offsets, entity_ids=entity_ids,
    )
    tdata = GameData.create(
        {"g": x_g, "gs": sparse_from_numpy(gs_idx, gs_val, D_GS), "u": x_u,
         "w": sparse_from_numpy(w_idx, w_val, D_W), "f": x_f},
        labels, offsets=offsets, entity_ids=entity_ids,
    )
    return {"params": params, "shards": shards, "res": res, "jdata": jdata,
            "tdata": tdata, "users": users}


def _jax_scores(game, names, params=None):
    params = params or game["params"]
    return np.asarray(jax_scoring.score_game_data(
        {k: params[k] for k in names}, game["shards"], game["res"], game["jdata"]
    ))


def _port_scores(game, names, params=None):
    params = params or game_params_from_numpy(game["params"])
    out = scoring.score_game_data(
        {k: params[k] for k in names}, game["shards"], game["res"], game["tdata"],
        device="cpu",
    )
    assert out.dtype == torch.float64 and out.device.type == "cpu"
    return out.numpy()


COORDS = ["global", "global-sparse", "per-user", "per-user-wide",
          "per-user-compact", "per-ad-latent"]


@pytest.mark.parametrize("names", [[c] for c in COORDS] + [COORDS], ids=COORDS + ["all"])
def test_scores_match_jax(game, names):
    before = dispatch.launch_counts()
    ref = _jax_scores(game, names)
    got = _port_scores(game, names)
    np.testing.assert_allclose(got, ref, rtol=TOL, atol=TOL)
    assert np.any(got != 0.0)
    # the CPU runs every kernel's plain version: no launch is counted
    assert dispatch.launch_counts() == before
    re_key = game["res"][names[0]]
    if len(names) == 1 and re_key is not None:
        unknown = np.asarray(game["jdata"].entity_ids[re_key]) < 0
        assert unknown.any() and np.all(got[unknown] == 0.0)


def test_numpy_params_score_like_tensors(game):
    """The driver passes the loaded numpy tables straight through."""
    names = ["global", "global-sparse", "per-user", "per-user-wide"]
    got = _port_scores(game, names, params=game["params"])
    np.testing.assert_allclose(got, _jax_scores(game, names), rtol=TOL, atol=TOL)


def test_float32_scores(game):
    names = ["global", "global-sparse", "per-user", "per-user-wide", "per-ad-latent"]
    ref = _jax_scores(game, names)
    got = scoring.score_game_data(
        {k: game_params_from_numpy(game["params"])[k] for k in names},
        game["shards"], game["res"], game["tdata"], dtype=torch.float32, device="cpu",
    )
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)


def test_precompact_model_matches_jax(game):
    jax_pre = jax_scoring.precompact_model(dict(game["params"]))
    port_pre = scoring.precompact_model(game_params_from_numpy(game["params"]))
    for name in COORDS:
        j, t = jax_pre[name], port_pre[name]
        compacted = isinstance(j, jax_scoring.CompactReTable)
        assert isinstance(t, scoring.CompactReTable) == compacted, name
        if compacted:
            np.testing.assert_array_equal(np.asarray(t.columns), np.asarray(j.columns))
            np.testing.assert_array_equal(np.asarray(t.values), np.asarray(j.values))
            assert np.asarray(t.columns).dtype == np.int32
    # fixed effects and factored params pass through unchanged
    params = game_params_from_numpy(game["params"])
    port_pre = scoring.precompact_model(params)
    for name in ("global", "global-sparse", "per-ad-latent", "per-user-compact"):
        assert port_pre[name] is params[name]
    assert is_factored_params(port_pre["per-ad-latent"])
    np.testing.assert_allclose(
        _port_scores(game, COORDS, params=port_pre),
        _jax_scores(game, COORDS, params=jax_pre), rtol=TOL, atol=TOL,
    )


@pytest.mark.parametrize("k", [6, 9])
def test_compact_table_rows_matches_jax(game, k):
    rows = game["params"]["per-user-wide"][2:7]
    jc, jv = jax_scoring.compact_table_rows(rows, k)
    tc, tv = scoring.compact_table_rows(rows, k)
    np.testing.assert_array_equal(tc, jc)
    np.testing.assert_array_equal(tv, jv)
    assert tc.dtype == np.int32 and tc.shape == (5, k)
    empty_c, _ = scoring.compact_table_rows(rows[:0], k)
    assert empty_c.shape == (0, k)


def test_compact_table_rows_refuses_narrow_width(game):
    rows = game["params"]["per-user-wide"]
    with pytest.raises(ValueError, match="cannot compact at width k=5"):
        jax_scoring.compact_table_rows(rows, 5)
    with pytest.raises(ValueError, match="cannot compact at width k=5"):
        scoring.compact_table_rows(rows, 5)


def test_cache_recompacts_a_tensor_edited_in_place(game):
    """Tensors are cached by identity and version: an in-place edit (here
    a new nonzero column for an entity, which widens the compact table)
    is compacted again, and the scores follow the edit."""
    names = ["per-user-wide"]
    table = torch.from_numpy(game["params"]["per-user-wide"].copy())
    first = scoring._compact_table_cached(table)
    assert scoring._compact_table_cached(table) is first  # cached
    before = _port_scores(game, names, params={"per-user-wide": table})
    edited = game["params"]["per-user-wide"].copy()
    row = int(game["users"][0])
    col = int(game["tdata"].features["w"].indices[0, 0])
    edited[row, col] += 2.5
    edited[row, (col + 1) % D_W] = 1.25
    table[row, col] += 2.5
    table[row, (col + 1) % D_W] = 1.25
    second = scoring._compact_table_cached(table)
    assert second is not first
    np.testing.assert_array_equal(second.columns, scoring._compact_table(edited)[0])
    after = _port_scores(game, names, params={"per-user-wide": table})
    ref = _jax_scores(game, names, params={"per-user-wide": edited})
    np.testing.assert_allclose(after, ref, rtol=TOL, atol=TOL)
    assert after[0] != before[0]


def test_cache_keeps_read_only_numpy_and_skips_writeable(game):
    table = game["params"]["per-user-wide"].copy()
    assert scoring._compact_table_cached(table) is not scoring._compact_table_cached(table)
    table.flags.writeable = False
    first = scoring._compact_table_cached(table)
    assert scoring._compact_table_cached(table) is first
    # a read-only view over a writeable base is not cached
    base = game["params"]["per-user-wide"].copy()
    view = base[:]
    view.flags.writeable = False
    assert scoring._compact_table_cached(view) is not scoring._compact_table_cached(view)


def test_factored_on_a_sparse_shard_is_refused(game):
    shards = {**game["shards"], "per-ad-latent": "w"}
    msg = "factored effects need the dense per-row latent projection"
    with pytest.raises(ValueError, match=msg):
        jax_scoring.score_game_data(
            {"per-ad-latent": game["params"]["per-ad-latent"]}, shards, game["res"],
            game["jdata"],
        )
    port = game_params_from_numpy({"per-ad-latent": game["params"]["per-ad-latent"]})
    with pytest.raises(ValueError, match=msg):
        scoring.score_game_data(port, shards, game["res"], game["tdata"], device="cpu")


def test_default_device_is_cuda(game):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device runs")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        scoring.score_game_data({}, {}, {}, game["tdata"])


def test_game_data_create_matches_jax(game):
    t, j = game["tdata"], game["jdata"]
    assert t.num_rows == j.num_rows == N
    for a, b in ((t.labels, j.labels), (t.offsets, j.offsets), (t.weights, j.weights)):
        np.testing.assert_array_equal(a, b)
    for k in j.entity_ids:
        np.testing.assert_array_equal(t.entity_ids[k], j.entity_ids[k])
        assert t.entity_ids[k].dtype == np.int32
    assert is_sparse(t.features["w"]) and isinstance(t.features["g"], np.ndarray)
    msg = "column 'u' has 5 rows, labels have 4"
    for create in (GameData.create, jax_data.GameData.create):
        with pytest.raises(ValueError, match=msg):
            create({"u": np.zeros((5, 2))}, np.zeros(4))
    batch = t.fixed_effect_batch("gs", dtype=torch.float64)
    jbatch = j.fixed_effect_batch("gs", dtype=np.float64)
    np.testing.assert_array_equal(batch.features.indices.numpy(),
                                  np.asarray(jbatch.features.indices))
    np.testing.assert_array_equal(batch.features.values.numpy(),
                                  np.asarray(jbatch.features.values))
    for name in ("labels", "offsets", "weights"):
        np.testing.assert_array_equal(getattr(batch, name).numpy(),
                                      np.asarray(getattr(jbatch, name)))


def test_entity_vocabulary_matches_jax():
    raw = np.asarray(["u3", "u1", "u10", "u1", "u2", "u3"], object)
    tv, ti = build_entity_vocabulary(raw)
    jv, ji = jax_data.build_entity_vocabulary(raw)
    assert list(tv.items()) == list(jv.items())  # np.unique order
    np.testing.assert_array_equal(ti, ji)
    new = np.asarray(["u2", "u9", "u10"], object)
    np.testing.assert_array_equal(
        apply_entity_vocabulary(tv, new), jax_data.apply_entity_vocabulary(jv, new)
    )
    assert apply_entity_vocabulary(tv, new).tolist() == [2, -1, 1]


@pytest.mark.parametrize("n", [1, 8, 9, 53, 1024])
def test_bucket_size_matches_jax(n):
    assert bucket_size(n) == jax_engine.bucket_size(n)


def test_pad_game_data_matches_jax(game):
    rows = bucket_size(N)
    t = pad_game_data(game["tdata"], rows)
    j = jax_engine.pad_game_data(game["jdata"], rows)
    assert t.num_rows == j.num_rows == rows
    for shard, jv in j.features.items():
        tv = t.features[shard]
        if is_sparse(tv):
            np.testing.assert_array_equal(tv.indices.numpy(), np.asarray(jv.indices))
            np.testing.assert_array_equal(tv.values.numpy(), np.asarray(jv.values))
            assert tv.indices.dtype == torch.int32
            assert bool((tv.indices[N:] == tv.d).all()) and bool((tv.values[N:] == 0).all())
        else:
            np.testing.assert_array_equal(tv, np.asarray(jv))
    for k in j.entity_ids:
        np.testing.assert_array_equal(t.entity_ids[k], j.entity_ids[k])
        assert (t.entity_ids[k][N:] == -1).all()
    np.testing.assert_array_equal(t.offsets, j.offsets)
    assert pad_game_data(game["tdata"], N) is game["tdata"]
    with pytest.raises(ValueError, match="cannot pad"):
        pad_game_data(game["tdata"], N - 1)
    # padding is invisible to the scores
    params = game_params_from_numpy(game["params"])
    padded = scoring.score_game_data(params, game["shards"], game["res"], t, device="cpu")
    plain = scoring.score_game_data(params, game["shards"], game["res"], game["tdata"],
                                    device="cpu")
    np.testing.assert_allclose(padded[:N].numpy(), plain.numpy(), rtol=TOL, atol=TOL)
    assert bool((padded[N:] == 0).all())


def test_game_params_from_numpy_forms(game):
    p = game_params_from_numpy(game["params"])
    assert p["global"].dtype == torch.float64 and p["global"].shape == (D_G,)
    assert p["per-user"].shape == (N_USERS, D_U)
    assert isinstance(p["per-user-compact"], scoring.CompactReTable)
    assert p["per-user-compact"].columns.dtype == torch.int32
    assert isinstance(p["per-ad-latent"], FactoredParams)
    assert p["per-ad-latent"].projection.shape == (D_F, LATENT)
