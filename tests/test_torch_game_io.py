"""The GAME half of the port's model files and ingest against the JAX
package's: a model directory written by either package loads in the other
with identical coefficients (fixed, random and factored effects, entity
ids that read back as ints or strings, two coordinates sharing one
random-effect type), manifests written by one verify in the other, and
``game_data_from_avro`` / ``IngestSource.game_data`` build the same
shards, entity ids, labels, offsets, weights and uids.
"""

import os

import numpy as np
import pytest
import torch

from photon_ml_tpu.game.factored import FactoredParams as JaxFactoredParams
from photon_ml_tpu.io import ingest as jax_ingest
from photon_ml_tpu.io import models as jax_models
from photon_ml_tpu.io.avro import write_avro_file
from photon_ml_tpu.io.schemas import TRAINING_EXAMPLE_SCHEMA
from photon_ml_tpu.io.vocab import FeatureVocabulary as JaxVocabulary
from photon_ml_tpu_torch.game.factored import FactoredParams, is_factored_params
from photon_ml_tpu_torch.io import ingest, models
from photon_ml_tpu_torch.io.vocab import FeatureVocabulary, feature_key
from photon_ml_tpu_torch.ops.sparse import is_sparse

D_G, D_U, D_F, LATENT = 5, 4, 3, 2
G_KEYS = [feature_key(f"g{j}", "t" if j % 2 else "") for j in range(D_G)]
U_KEYS = [feature_key(f"u{j}", "") for j in range(D_U)]
F_KEYS = [feature_key(f"f{j}", "") for j in range(D_F)]


def _vocabs(cls):
    return {
        "gshard": cls(G_KEYS, add_intercept=True),
        "ushard": cls(U_KEYS),
        "fshard": cls(F_KEYS, add_intercept=True),
    }


@pytest.fixture(scope="module")
def model():
    rng = np.random.default_rng(20261017)
    per_user = rng.standard_normal((4, D_U))
    per_user[1, 2] = 0.0  # zeros are not written, and read back as 0
    per_user_b = rng.standard_normal((3, D_U))
    gamma = rng.standard_normal((3, LATENT))
    projection = rng.standard_normal((D_F + 1, LATENT))
    return {
        "params": {
            "global": rng.standard_normal(D_G + 1),
            "per-user": per_user,
            "per-user-b": per_user_b,
            "per-ad": (gamma, projection),
        },
        "shards": {"global": "gshard", "per-user": "ushard", "per-user-b": "ushard",
                   "per-ad": "fshard"},
        "res": {"global": None, "per-user": "userId", "per-user-b": "userId",
                "per-ad": "adId"},
        # different entity sets and orders for the two userId coordinates;
        # int ids come back from disk as strings and are matched by value
        "entity_vocabs": {"per-user": {"u0": 0, "u1": 1, "u2": 2, "u3": 3},
                          "per-user-b": {"u5": 0, "u2": 1, "u0": 2},
                          "per-ad": {101: 0, 205: 1, 33: 2}},
    }


def _save(pkg, model, root):
    jax = pkg == "jax"
    vocabs = _vocabs(JaxVocabulary if jax else FeatureVocabulary)
    params = dict(model["params"])
    gamma, projection = params["per-ad"]
    params["per-ad"] = (JaxFactoredParams if jax else FactoredParams)(
        gamma=gamma if jax else torch.from_numpy(gamma),
        projection=projection if jax else torch.from_numpy(projection),
    )
    if not jax:  # the port also takes tensors
        params["per-user"] = torch.from_numpy(params["per-user"])
    (jax_models if jax else models).save_game_model(
        root, params, model["shards"], {c: vocabs[s] for c, s in model["shards"].items()},
        model["entity_vocabs"], model["res"],
    )
    for shard, vocab in vocabs.items():
        vocab.save(os.path.join(root, f"feature-index-{shard}.txt"))


def _as_numpy(p):
    if hasattr(p, "gamma"):
        return np.asarray(p.gamma), np.asarray(p.projection)
    return np.asarray(p)


@pytest.mark.parametrize("writer,reader", [("port", "jax"), ("jax", "port"), ("port", "port")])
def test_game_model_round_trips_across_packages(model, tmp_path, writer, reader):
    root = str(tmp_path / "m")
    _save(writer, model, root)
    jax = reader == "jax"
    vocabs = _vocabs(JaxVocabulary if jax else FeatureVocabulary)
    coord_vocabs = {c: vocabs[s] for c, s in model["shards"].items()}
    load = (jax_models if jax else models).load_game_model
    for evocabs in (None, model["entity_vocabs"]):
        params, shards, res, evs = load(root, coord_vocabs, evocabs)
        assert shards == model["shards"] and res == model["res"]
        assert set(params) == set(model["params"])
        for name, want in model["params"].items():
            got = _as_numpy(params[name])
            if name == "global":
                np.testing.assert_array_equal(got, want)
                continue
            rows = evs[name]  # the table's {raw id: row}, read or given
            order = [rows[k] if k in rows else rows[str(k)]
                     for k in model["entity_vocabs"][name]]
            if name == "per-ad":
                np.testing.assert_array_equal(got[0][order], want[0])
                np.testing.assert_array_equal(got[1], want[1])
                assert is_factored_params(params[name]) != jax
            else:
                np.testing.assert_array_equal(got[order], want)
        if evocabs is not None:
            assert evs == {k: dict(v) for k, v in evocabs.items()}


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_load_game_model_auto_matches_jax(model, tmp_path, writer):
    """Two userId coordinates with different entity sets: both packages
    build the same union vocabulary and remap each table into it."""
    root = str(tmp_path / "m")
    _save(writer, model, root)
    got = models.load_game_model_auto(root)
    ref = jax_models.load_game_model_auto(root)
    params, shards, res, shard_vocabs, re_vocabs = got
    assert shards == ref[1] and res == ref[2] and re_vocabs == ref[4]
    assert re_vocabs["userId"] == {"u0": 0, "u1": 1, "u2": 2, "u3": 3, "u5": 4}
    assert {s: v.index_to_key for s, v in shard_vocabs.items()} == {
        s: v.index_to_key for s, v in ref[3].items()}
    for name in model["params"]:
        a, b = _as_numpy(params[name]), _as_numpy(ref[0][name])
        for x, y in zip(a if name == "per-ad" else [a], b if name == "per-ad" else [b]):
            np.testing.assert_array_equal(x, y)
    # u2 is row 2 of per-user and row 1 of per-user-b on disk
    row = re_vocabs["userId"]["u2"]
    np.testing.assert_array_equal(params["per-user-b"][row], model["params"]["per-user-b"][1])
    assert not params["per-user-b"][re_vocabs["userId"]["u1"]].any()
    assert isinstance(params["per-ad"], FactoredParams)
    assert params["per-ad"].gamma.dtype == torch.float64


def test_resolve_game_dirs_matches_jax(model, tmp_path):
    root = tmp_path / "out"
    _save("port", model, str(root / "all" / "0"))
    for f in os.listdir(root / "all" / "0"):
        if f.startswith("feature-index-"):
            os.replace(root / "all" / "0" / f, root / f)
    assert models.resolve_game_dirs(str(root)) == jax_models.resolve_game_dirs(str(root))
    assert models.resolve_game_dirs(str(root)) == (str(root / "all" / "0"), str(root))
    for mod in (models, jax_models):
        with pytest.raises(FileNotFoundError, match="no GAME model"):
            mod.resolve_game_dirs(str(tmp_path))


def test_union_and_remap_match_jax():
    own = {"b": 0, "a": 1}
    shared = models.union_entity_vocab([{"a": 0, "c": 1}, own])
    assert shared == jax_models.union_entity_vocab([{"a": 0, "c": 1}, own])
    table = np.arange(4.0).reshape(2, 2)
    np.testing.assert_array_equal(models.remap_entity_rows(table, own, shared),
                                  jax_models.remap_entity_rows(table, own, shared))
    assert models.remap_entity_rows(table, own, dict(own)) is table


@pytest.mark.parametrize("writer,verifier", [("port", "jax"), ("jax", "port")])
def test_manifests_verify_across_packages(model, tmp_path, writer, verifier):
    root = str(tmp_path / "m")
    _save("port", model, root)
    with open(os.path.join(root, "log-message.txt"), "w") as f:
        f.write("not model-bearing\n")
    assert models._manifest_files(root) == jax_models._manifest_files(root)
    assert "log-message.txt" not in models._manifest_files(root)
    (models if writer == "port" else jax_models).write_model_manifest(root)
    mod = models if verifier == "port" else jax_models
    digests = mod.verify_model_manifest(root)
    assert set(digests) == set(models._manifest_files(root))
    coeffs = os.path.join(root, "fixed-effect", "global", "coefficients", "part-00000.avro")
    with open(coeffs, "ab") as f:
        f.write(b"\0")
    with pytest.raises(mod.ModelIntegrityError, match="digest mismatch"):
        mod.verify_model_manifest(root)
    os.remove(coeffs)
    with pytest.raises(mod.ModelIntegrityError, match="missing"):
        mod.verify_model_manifest(root)
    os.remove(os.path.join(root, models.MODEL_MANIFEST))
    with pytest.raises(mod.ModelIntegrityError, match="no model-manifest.json"):
        mod.verify_model_manifest(root)
    assert mod.verify_model_manifest(root, require=False) == {}


def test_empty_manifest_is_refused(tmp_path):
    with pytest.raises(ValueError, match="no model files to manifest"):
        models.write_model_manifest(str(tmp_path))


# -- ingest ------------------------------------------------------------------


def _records(rng, n):
    recs = []
    for i in range(n):
        feats = [{"name": f"g{j}", "term": "t" if j % 2 else "", "value": float(rng.normal())}
                 for j in rng.choice(D_G, 3, replace=False)]
        feats += [{"name": f"u{j}", "term": "", "value": float(rng.normal())}
                  for j in rng.choice(D_U, 2, replace=False)]
        feats.append({"name": "f1", "term": "", "value": float(rng.normal())})
        if i % 4 == 0:  # a duplicate (summed) and a feature no shard knows
            feats += [dict(feats[0]), {"name": "zz", "term": "", "value": 3.0}]
        if i % 6 == 1:  # a raw feature aliasing the intercept is ignored
            feats.append({"name": "(INTERCEPT)", "term": "", "value": 9.0})
        meta = {}
        if i % 5:
            meta["userId"] = f"u{i % 7}"
        if i % 3:
            meta["adId"] = str(100 + i % 4)
        recs.append({
            "uid": f"r{i}" if i % 9 else None,
            "label": None if i % 11 == 4 else float(i % 2),
            "features": feats,
            "metadataMap": meta or None,
            "weight": float(rng.uniform(0.5, 2)) if i % 3 == 2 else None,
            "offset": float(rng.normal(0, 0.2)) if i % 2 else None,
        })
    return recs


@pytest.fixture(scope="module")
def ingested(tmp_path_factory):
    rng = np.random.default_rng(7)
    recs = _records(rng, 40)
    path = str(tmp_path_factory.mktemp("game_ingest") / "p.avro")
    schema = dict(TRAINING_EXAMPLE_SCHEMA)
    schema["fields"] = [
        {"name": "label", "type": ["null", "double"], "default": None}
        if f["name"] == "label" else f for f in TRAINING_EXAMPLE_SCHEMA["fields"]
    ]
    write_avro_file(path, schema, recs)
    return recs, path


def _compare_game_data(got, ref):
    tdata, tvocabs, tuids = got[:3]
    jdata, jvocabs, juids = ref[:3]
    assert tvocabs == jvocabs
    assert list(tuids) == list(juids)
    for name in ("labels", "offsets", "weights"):
        np.testing.assert_array_equal(getattr(tdata, name), getattr(jdata, name))
    assert set(tdata.entity_ids) == set(jdata.entity_ids)
    for k in jdata.entity_ids:
        np.testing.assert_array_equal(tdata.entity_ids[k], jdata.entity_ids[k])
        assert tdata.entity_ids[k].dtype == np.int32
    assert set(tdata.features) == set(jdata.features)
    for shard, jf in jdata.features.items():
        tf = tdata.features[shard]
        if is_sparse(tf):
            assert tf.d == jf.d and tf.values.dtype == torch.float64
            np.testing.assert_array_equal(tf.indices.numpy(), np.asarray(jf.indices))
            np.testing.assert_array_equal(tf.values.numpy(), np.asarray(jf.values))
        else:
            assert isinstance(tf, np.ndarray) and tf.dtype == np.float64
            np.testing.assert_array_equal(tf, np.asarray(jf))


@pytest.mark.parametrize("sparse_shards", [None, {"ushard"}, {"gshard", "ushard", "fshard"}])
@pytest.mark.parametrize("with_vocabs", [False, True])
def test_game_data_from_avro_matches_jax(ingested, sparse_shards, with_vocabs):
    recs, _ = ingested
    evocabs = {"userId": {"u1": 0, "u3": 1, "u6": 2}, "adId": {"101": 1, "103": 0}}
    kw = dict(entity_vocabs=evocabs if with_vocabs else None, allow_null_labels=True,
              sparse_shards=sparse_shards)
    got = ingest.game_data_from_avro(recs, _vocabs(FeatureVocabulary),
                                     ["userId", "adId"], **kw)
    ref = jax_ingest.game_data_from_avro(recs, _vocabs(JaxVocabulary),
                                         ["userId", "adId"], **kw)
    _compare_game_data(got, ref)
    if not with_vocabs:  # built in np.unique order from the rows that carry the key
        assert list(got[1]["userId"]) == sorted({f"u{i % 7}" for i in range(40) if i % 5})


def test_ingest_source_game_data_matches_jax(ingested):
    _, path = ingested
    kw = dict(allow_null_labels=True, sparse_shards={"ushard"})
    got = ingest.IngestSource([path]).game_data(_vocabs(FeatureVocabulary), ["userId"], **kw)
    ref = jax_ingest.IngestSource([path]).game_data(_vocabs(JaxVocabulary), ["userId"], **kw)
    _compare_game_data(got, ref)
    np.testing.assert_array_equal(got[3], ref[3])
    assert not got[3].all()  # null labels are flagged absent


def test_game_data_refusals(ingested):
    recs, _ = ingested
    with pytest.raises(ValueError, match="null/missing label"):
        ingest.game_data_from_avro(recs, _vocabs(FeatureVocabulary), [])
    with pytest.raises(ValueError, match="sparse_shards not in shard_vocabs"):
        ingest.game_data_from_avro(recs, _vocabs(FeatureVocabulary), [],
                                   allow_null_labels=True, sparse_shards={"nope"})


def test_index_entity_strings_matches_jax():
    raw = {"userId": np.asarray(["b", "", "a", "b", "c"], object)}
    for vocabs in (None, {"userId": {"a": 1, "c": 0}}):
        got = ingest.index_entity_strings(raw, vocabs)
        ref = jax_ingest.index_entity_strings(raw, vocabs)
        assert got[1] == ref[1]
        np.testing.assert_array_equal(got[0]["userId"], ref[0]["userId"])
        assert got[0]["userId"][1] == -1
