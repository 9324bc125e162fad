"""The port's native (C++) Avro codec (``photon_ml_tpu_torch/io/native.py``,
``photon_ml_tpu_torch/native/avro_reader.cpp``) on the CPU, held to the JAX
package's native codec and to the port's own pure-Python codec on the same
Avro files: deflate and null codecs, null labels, several files, entity
columns, a schema the native codec refuses, and the scored-output writer.
The arrays must be equal, and a written file must read back equal.
"""

import numpy as np
import pytest
import torch

from photon_ml_tpu.io import native as jax_native
from photon_ml_tpu.io.vocab import FeatureVocabulary as JaxVocabulary
from photon_ml_tpu_torch.cli.score import write_scored_items
from photon_ml_tpu_torch.io import native
from photon_ml_tpu_torch.io.avro import read_avro_file, write_avro_file
from photon_ml_tpu_torch.io.ingest import IngestSource, make_training_example
from photon_ml_tpu_torch.io.schemas import SCORING_RESULT_SCHEMA, TRAINING_EXAMPLE_SCHEMA
from photon_ml_tpu_torch.io.vocab import FeatureVocabulary
from photon_ml_tpu_torch.ops.sparse import to_dense

KEYS = [f"f{i}\x01t" for i in range(200)]


def _records(n, d=200, seed=0, null_labels=False):
    """Seeded TrainingExample records: 8 features each (a duplicate key in
    every third, summed on ingest, one key outside the vocabulary in every
    seventh), optional uid, offset and weight, a metadataMap with two
    entity keys in three rows of four."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        cols = rng.choice(d, 8, replace=False)
        feats = [{"name": f"f{j}", "term": "t", "value": float(rng.standard_normal())}
                 for j in cols]
        if i % 3 == 0:
            feats.append({**feats[0], "value": 0.5})
        if i % 7 == 0:
            feats.append({"name": "unknown", "term": "t", "value": 1.0})
        rec = make_training_example(
            label=float(rng.integers(0, 2)), features={},
            uid=f"u{i}" if i % 3 else None,
            offset=float(rng.standard_normal()) if i % 2 else None,
            weight=float(rng.uniform(0.5, 2.0)) if i % 5 else None,
        )
        rec["features"] = feats
        rec["metadataMap"] = ({"userId": f"user{i % 11}", "adId": f"a{i % 7}"}
                              if i % 4 else None)
        if null_labels and i % 2:
            rec["label"] = None
        out.append(rec)
    return out


# the TrainingExample schema with a nullable label (scoring input)
NULLABLE_LABEL_SCHEMA = {
    **TRAINING_EXAMPLE_SCHEMA,
    "fields": [{"name": "label", "type": ["null", "double"], "default": None}
               if f["name"] == "label" else f for f in TRAINING_EXAMPLE_SCHEMA["fields"]],
}


def _files(tmp_path, parts, codec="deflate", null_labels=False, n=300):
    paths = []
    schema = NULLABLE_LABEL_SCHEMA if null_labels else TRAINING_EXAMPLE_SCHEMA
    for p in range(parts):
        path = str(tmp_path / f"part-{p}.avro")
        write_avro_file(path, schema, _records(n, seed=p, null_labels=null_labels),
                        codec=codec)
        paths.append(path)
    return paths


def test_the_native_codec_builds_here():
    assert native.native_available(), native.native_error()
    assert native.library_path().startswith(native.BUILD_DIR)


@pytest.mark.parametrize("codec", ["deflate", "null"])
@pytest.mark.parametrize("parts", [1, 3])
@pytest.mark.parametrize("null_labels", [False, True])
def test_read_columnar_equals_the_jax_packages(tmp_path, codec, parts, null_labels):
    paths = _files(tmp_path, parts, codec, null_labels)
    vocab = FeatureVocabulary(KEYS, add_intercept=True)
    jvocab = JaxVocabulary(KEYS, add_intercept=True)
    keys = ("adId", "userId")
    got = native.read_columnar(paths, [vocab], keys, allow_null_labels=null_labels)
    want = jax_native.read_columnar(paths, [jvocab], keys, allow_null_labels=null_labels)
    assert got["n"] == want["n"] == 300 * parts
    for name in ("labels", "label_present", "offsets", "weights"):
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    assert list(got["uids"]) == list(want["uids"])
    for key in keys:
        assert list(got["entities"][key]) == list(want["entities"][key])
    for a, b in zip(got["coo"][0], want["coo"][0]):
        np.testing.assert_array_equal(a, b)
    assert native.live_native_handles() == 0


def test_training_input_with_a_null_label_raises(tmp_path):
    paths = _files(tmp_path, 1, null_labels=True)
    with pytest.raises(ValueError, match="null/missing label"):
        native.read_columnar(paths, [FeatureVocabulary(KEYS)], ())


@pytest.mark.parametrize("codec", ["deflate", "null"])
@pytest.mark.parametrize("sparse", [False, True])
@pytest.mark.parametrize("parts", [1, 2])
def test_labeled_batch_equals_the_python_codec(tmp_path, monkeypatch, codec, sparse, parts):
    paths = _files(tmp_path, parts, codec)
    vocab = FeatureVocabulary(KEYS, add_intercept=True)

    def read(source):
        return source.labeled_batch(vocab, sparse=sparse, dtype=torch.float64)

    nat_source = IngestSource(paths)
    nat = read(nat_source)
    with monkeypatch.context() as m:
        m.setattr(native, "native_available", lambda: False)
        py_source = IngestSource(paths)
        py = read(py_source)
    assert (nat_source.codec, py_source.codec) == ("native", "python")
    a, b = nat[0], py[0]
    if sparse:
        assert torch.equal(a.features.indices, b.features.indices)
        assert torch.equal(a.features.values, b.features.values)
        np.testing.assert_array_equal(to_dense(a.features), to_dense(b.features))
    else:
        assert torch.equal(a.features, b.features)
    for name in ("labels", "offsets", "weights", "mask"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name
    assert list(nat[1]) == list(py[1])
    np.testing.assert_array_equal(nat[2], py[2])


@pytest.mark.parametrize("null_labels", [False, True])
def test_game_data_equals_the_python_codec(tmp_path, monkeypatch, null_labels):
    paths = _files(tmp_path, 2, null_labels=null_labels)
    shard_vocabs = {"global": FeatureVocabulary(KEYS, add_intercept=True),
                    "user": FeatureVocabulary(KEYS[:50], add_intercept=False)}

    def read(source, entity_vocabs=None):
        return source.game_data(shard_vocabs, ["adId", "userId"], entity_vocabs=entity_vocabs,
                                allow_null_labels=null_labels, sparse_shards={"global"})

    nat_source = IngestSource(paths)
    nat = read(nat_source)
    with monkeypatch.context() as m:
        m.setattr(native, "native_available", lambda: False)
        py_source = IngestSource(paths)
        py = read(py_source)
        # scoring: vocabularies applied, not built
        py_applied = read(IngestSource(paths), entity_vocabs=py[1])
    nat_applied = read(IngestSource(paths), entity_vocabs=nat[1])
    assert (nat_source.codec, py_source.codec) == ("native", "python")
    for (nd, nv, nu, npres), (pd, pv, pu, ppres) in ((nat, py), (nat_applied, py_applied)):
        assert nv == pv
        assert list(nu) == list(pu)
        np.testing.assert_array_equal(npres, ppres)
        for name in ("labels", "offsets", "weights"):
            np.testing.assert_array_equal(getattr(nd, name), getattr(pd, name))
        for key in ("adId", "userId"):
            np.testing.assert_array_equal(nd.entity_ids[key], pd.entity_ids[key])
        np.testing.assert_array_equal(nd.features["user"], pd.features["user"])
        g_nat, g_py = nd.features["global"], pd.features["global"]
        assert torch.equal(g_nat.indices, g_py.indices)
        assert torch.equal(g_nat.values, g_py.values)


def test_unsupported_schema_takes_the_python_codec(tmp_path):
    # a three-branch union the native program does not take
    schema = dict(TRAINING_EXAMPLE_SCHEMA)
    schema["fields"] = list(TRAINING_EXAMPLE_SCHEMA["fields"]) + [
        {"name": "extra", "type": ["null", "string", "long"], "default": None}]
    recs = _records(50)
    for i, r in enumerate(recs):
        r["extra"] = None if i % 3 == 0 else (f"x{i}" if i % 3 == 1 else i)
    path = str(tmp_path / "extra.avro")
    write_avro_file(path, schema, recs)
    with pytest.raises(native.UnsupportedSchema):
        native.compile_schema(schema)
    with pytest.raises(jax_native.UnsupportedSchema):
        jax_native.compile_schema(schema)
    source = IngestSource([path])
    batch, uids, _ = source.labeled_batch(FeatureVocabulary(KEYS, add_intercept=True))
    assert source.codec == "python" and batch.labels.shape == (50,)


def test_files_of_two_schemas_take_the_python_codec(tmp_path):
    path_a = _files(tmp_path, 1)[0]
    schema_b = dict(TRAINING_EXAMPLE_SCHEMA)
    schema_b["fields"] = [f for f in TRAINING_EXAMPLE_SCHEMA["fields"] if f["name"] != "weight"]
    recs_b = _records(40, seed=9)
    for r in recs_b:
        r.pop("weight", None)
    path_b = str(tmp_path / "b.avro")
    write_avro_file(path_b, schema_b, recs_b)
    source = IngestSource([path_a, path_b])
    batch, _, _ = source.labeled_batch(FeatureVocabulary(KEYS, add_intercept=True))
    assert source.codec == "python" and batch.labels.shape == (340,)


@pytest.mark.parametrize("codec", ["deflate", "null"])
def test_write_columnar_reads_back_equal_to_the_python_writer(tmp_path, codec):
    n = 5000
    rng = np.random.default_rng(4)
    scores = rng.standard_normal(n)
    labels = rng.integers(0, 2, n).astype(np.float64)
    present = np.arange(n) % 3 != 0
    uids = np.asarray([None if i % 5 == 0 else ("" if i % 11 == 0 else f"usér{i}")
                       for i in range(n)], object)
    columns = {"predictionScore": scores, "uid": uids, "label": (labels, present),
               "metadataMap": None}
    nat_path = str(tmp_path / "native.avro")
    jax_path = str(tmp_path / "jax.avro")
    native.write_columnar_avro(nat_path, SCORING_RESULT_SCHEMA, columns, n, codec=codec)
    jax_native.write_columnar_avro(jax_path, SCORING_RESULT_SCHEMA, columns, n, codec=codec)
    _, nat = read_avro_file(nat_path)
    _, ref = read_avro_file(jax_path)
    assert nat == ref and len(nat) == n
    assert [r["predictionScore"] for r in nat] == scores.tolist()
    assert nat[11]["uid"] is None and nat[1]["uid"] == "usér1"
    assert nat[0]["label"] is None and nat[1]["label"] == labels[1]


def test_scored_items_native_and_python_read_back_equal(tmp_path, monkeypatch):
    n = 777
    rng = np.random.default_rng(5)
    scores = rng.standard_normal(n)
    labels = rng.integers(0, 2, n).astype(np.float64)
    present = np.arange(n) % 4 != 0
    uids = np.asarray([None if i % 6 == 0 else f"u{i}" for i in range(n)], object)
    nat_path, py_path = str(tmp_path / "n.avro"), str(tmp_path / "p.avro")
    assert write_scored_items(nat_path, scores, uids, labels, present) == "native"
    with monkeypatch.context() as m:
        m.setattr(native, "native_available", lambda: False)
        assert write_scored_items(py_path, scores, uids, labels, present) == "python"
    assert read_avro_file(nat_path)[1] == read_avro_file(py_path)[1]


def test_decode_threads_default_splits_the_cores(monkeypatch):
    monkeypatch.setattr(native.os, "cpu_count", lambda: 8)
    assert native._default_decode_threads(1) == 8
    assert native._default_decode_threads(4) == 2
    assert native._default_decode_threads(4, max_workers=2) == 4
    assert native._default_decode_threads(32) == 1


def test_threaded_decode_equals_one_thread(tmp_path):
    paths = _files(tmp_path, 1, n=3000)
    vocab = FeatureVocabulary(KEYS, add_intercept=True)
    one = native.read_columnar(paths, [vocab], ("userId",), decode_threads=1)
    many = native.read_columnar(paths, [vocab], ("userId",), decode_threads=4)
    for a, b in zip(one["coo"][0], many["coo"][0]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(one["labels"], many["labels"])
    assert list(one["entities"]["userId"]) == list(many["entities"]["userId"])
