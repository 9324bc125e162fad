"""Cross-package I/O: Avro files, feature vocabularies, GLM model files and
ingest written or built by one package and read by the other."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_ml_tpu.core.tasks import TaskType as JTaskType
from photon_ml_tpu.core.types import Coefficients as JCoefficients
from photon_ml_tpu.io import avro as javro
from photon_ml_tpu.io import ingest as jingest
from photon_ml_tpu.io import models as jmodels
from photon_ml_tpu.io import schemas as jschemas
from photon_ml_tpu.io import vocab as jvocab
from photon_ml_tpu_torch import interop
from photon_ml_tpu_torch.core.tasks import TaskType
from photon_ml_tpu_torch.io import avro as tavro
from photon_ml_tpu_torch.io import ingest as tingest
from photon_ml_tpu_torch.io import models as tmodels
from photon_ml_tpu_torch.io import schemas as tschemas
from photon_ml_tpu_torch.io import vocab as tvocab


def _records(rng, n=25, d=12):
    recs = []
    for i in range(n):
        k = int(rng.integers(1, 6))
        feats = {
            (f"f{int(j)}", "t" if j % 2 else ""): float(rng.standard_normal())
            for j in rng.choice(d, size=k, replace=False)
        }
        recs.append(
            tingest.make_training_example(
                float(rng.uniform() < 0.5), feats,
                uid=f"u{i}" if i % 5 else None,
                offset=float(rng.standard_normal()) if i % 3 else None,
                weight=float(rng.uniform(0.5, 2.0)) if i % 4 else None,
            )
        )
    # a duplicate (name, term) inside one record: dedup-by-sum
    recs[0]["features"].append(dict(recs[0]["features"][0]))
    return recs


def test_schemas_are_identical():
    for name in ("TRAINING_EXAMPLE_SCHEMA", "SCORING_RESULT_SCHEMA",
                 "BAYESIAN_LINEAR_MODEL_SCHEMA", "INTERCEPT_NAME",
                 "NAME_TERM_DELIMITER"):
        assert getattr(tschemas, name) == getattr(jschemas, name)


@pytest.mark.parametrize("codec", ["deflate", "null"])
def test_avro_bytes_identical_and_read_across(rng, tmp_path, codec):
    recs = _records(rng)
    sync = bytes(range(16))
    pt, pj = str(tmp_path / "t.avro"), str(tmp_path / "j.avro")
    tavro.write_avro_file(pt, tschemas.TRAINING_EXAMPLE_SCHEMA, recs,
                          codec=codec, sync_marker=sync, block_size=256)
    javro.write_avro_file(pj, jschemas.TRAINING_EXAMPLE_SCHEMA, recs,
                          codec=codec, sync_marker=sync, block_size=256)
    with open(pt, "rb") as a, open(pj, "rb") as b:
        assert a.read() == b.read()
    assert javro.read_avro_file(pt)[1] == recs
    assert tavro.read_avro_file(pj)[1] == recs


def test_vocabulary_files_round_trip(tmp_path):
    keys = [tvocab.feature_key(f"f{i}", "t" if i % 2 else "") for i in range(20)]
    keys += ["odd\\name\x01with\nnewline"]
    tv = tvocab.FeatureVocabulary(keys, add_intercept=True)
    tv.save(str(tmp_path / "t.txt"))
    jv = jvocab.FeatureVocabulary.load(str(tmp_path / "t.txt"))
    assert jv.index_to_key == tv.index_to_key
    assert jv.intercept_index == tv.intercept_index
    jv.save(str(tmp_path / "j.txt"))
    back = tvocab.FeatureVocabulary.load(str(tmp_path / "j.txt"))
    assert back.index_to_key == tv.index_to_key
    assert tvocab.INTERCEPT_KEY == jvocab.INTERCEPT_KEY


def _vocab_pair(d=12):
    keys = [jvocab.feature_key(f"f{i}", "t" if i % 2 else "") for i in range(d)]
    return (
        tvocab.FeatureVocabulary(keys, add_intercept=True),
        jvocab.FeatureVocabulary(keys, add_intercept=True),
    )


@pytest.mark.parametrize("with_variances", [False, True])
def test_glm_model_jax_to_port(rng, tmp_path, with_variances):
    tv, jv = _vocab_pair()
    means = rng.standard_normal(len(jv))
    means[3] = 0.0  # sparsified away on save, loads back as 0
    var = rng.uniform(0.1, 1.0, len(jv)) if with_variances else None
    path = str(tmp_path / "jax-model.avro")
    jmodels.save_glm_model(
        path,
        JCoefficients(jnp.asarray(means), None if var is None else jnp.asarray(var)),
        jv, task=JTaskType.LOGISTIC_REGRESSION,
    )
    coef, task = tmodels.load_glm_model(path, tv)
    assert task is TaskType.LOGISTIC_REGRESSION
    assert coef.means.dtype == torch.float64
    np.testing.assert_array_equal(coef.means.numpy(), means)
    if var is None:
        assert coef.variances is None
    else:
        np.testing.assert_array_equal(coef.variances.numpy(), var)


def test_glm_model_port_to_jax(rng, tmp_path):
    tv, jv = _vocab_pair()
    means = rng.standard_normal(len(tv))
    var = rng.uniform(0.1, 1.0, len(tv))
    path = str(tmp_path / "port-model.avro")
    tmodels.save_glm_model(
        path, interop.coefficients_from_numpy(means, var), tv,
        task=TaskType.POISSON_REGRESSION, model_id="m",
    )
    coef, task = jmodels.load_glm_model(path, jv)
    assert task is JTaskType.POISSON_REGRESSION
    np.testing.assert_array_equal(np.asarray(coef.means), means)
    np.testing.assert_array_equal(np.asarray(coef.variances), var)


@pytest.mark.parametrize("sparse", [True, False])
def test_ingest_matches_jax(rng, tmp_path, sparse):
    recs = _records(rng, n=40)
    path = str(tmp_path / "in.avro")
    tavro.write_avro_file(path, tschemas.TRAINING_EXAMPLE_SCHEMA, recs)
    tv, jv = _vocab_pair()
    tb, tuids, tpresent = tingest.IngestSource([path]).labeled_batch(
        tv, sparse=sparse, dtype=torch.float64)
    jb, juids, jpresent = jingest.IngestSource([path]).labeled_batch(
        jv, sparse=sparse, dtype=jnp.float64)
    assert list(tuids) == list(juids)
    np.testing.assert_array_equal(tpresent, jpresent)
    for col in ("labels", "offsets", "weights", "mask"):
        np.testing.assert_array_equal(
            getattr(tb, col).numpy(), np.asarray(getattr(jb, col)))
    if sparse:
        from photon_ml_tpu.ops.sparse import to_dense as jdense
        from photon_ml_tpu_torch.ops.sparse import to_dense as tdense

        np.testing.assert_allclose(tdense(tb.features), jdense(jb.features), rtol=1e-15)
    else:
        np.testing.assert_allclose(tb.features.numpy(), np.asarray(jb.features), rtol=1e-15)


def test_labeled_batch_from_numpy(rng):
    from photon_ml_tpu.core.types import LabeledBatch as JBatch
    from photon_ml_tpu.ops.sparse import from_coo

    sf = from_coo(np.array([0, 1, 1]), np.array([2, 0, 3]), np.array([1.0, 2.0, 3.0]),
                  2, 4, dtype=jnp.bfloat16)
    ones = jnp.ones(2, jnp.float32)
    jb = JBatch(sf, jnp.asarray([1.0, 0.0], jnp.float32), 0 * ones, ones, ones)
    tb = interop.labeled_batch_from_numpy(
        interop.sparse_from_numpy(np.asarray(jb.features.indices),
                                  np.asarray(jb.features.values), jb.features.d),
        *(np.asarray(getattr(jb, c)) for c in ("labels", "offsets", "weights", "mask")),
    )
    assert tb.features.values.dtype == torch.bfloat16
    assert tb.labels.dtype == torch.float32
    np.testing.assert_array_equal(tb.features.values.float().numpy(),
                                  np.asarray(jb.features.values, np.float32))
    np.testing.assert_array_equal(tb.effective_weights().numpy(), [1.0, 1.0])


def test_response_prediction_field_names(rng):
    recs = [{"response": 1.0, "features": []}, {"response": 0.0, "features": []}]
    out = tingest.normalize_field_names(recs, tingest.RESPONSE_PREDICTION_FIELDS)
    assert [r["label"] for r in out] == [1.0, 0.0]
    with pytest.raises(ValueError, match="field-name set"):
        tingest.normalize_field_names(recs, "NOPE")
