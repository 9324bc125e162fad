"""The slice as a whole: GLM training through the JAX package's
``run_glm_training`` and the port's (on the CPU, ``device="cpu"``), on the
same Avro fixture: sparse and dense, TRON and L-BFGS, two lambdas with
validation, with and without normalization.

Tolerances (float64): the same iteration count, convergence reason and
CG iterations per lambda, exactly; coefficients within
1e-8 x max(1, ||w||_inf); validation metrics within 1e-8; the same best
index; feature-summary.tsv values within rtol 1e-12. A model written by
either package loads in the other.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_ml_tpu.cli.train import run_glm_training as jax_run
from photon_ml_tpu.io.avro import write_avro_file
from photon_ml_tpu.io.models import load_glm_model as jax_load
from photon_ml_tpu.io.models import save_glm_model as jax_save
from photon_ml_tpu.io.schemas import TRAINING_EXAMPLE_SCHEMA
from photon_ml_tpu.io.vocab import FeatureVocabulary as JVocab
from photon_ml_tpu_torch.cli import train as ttrain
from photon_ml_tpu_torch.cli.config import UNPORTED_GLM_FIELDS, GLMDriverParams
from photon_ml_tpu_torch.cli.stages import DriverStage
from photon_ml_tpu_torch.core.types import Coefficients
from photon_ml_tpu_torch.io.models import load_glm_model, save_glm_model
from photon_ml_tpu_torch.io.vocab import FeatureVocabulary
from photon_ml_tpu_torch.kernels import dispatch

D = 40  # features; 5-8 non-zeros per row


def _records(rng, n, w_true):
    recs = []
    for i in range(n):
        cols = rng.choice(D, size=int(rng.integers(5, 9)), replace=False)
        x = rng.standard_normal(cols.size) * (1.0 + (cols % 5))
        offset = float(rng.normal(0, 0.3)) if i % 2 else None
        margin = x @ w_true[cols] + (offset or 0.0)
        recs.append({
            "uid": f"row{i}",
            "label": float(rng.uniform() < 1 / (1 + np.exp(-margin))),
            "features": [
                {"name": f"f{int(c)}", "term": "t" if c % 3 else "", "value": float(v)}
                for c, v in zip(cols, x)
            ],
            "metadataMap": None,
            "weight": float(rng.uniform(0.5, 2.0)) if i % 4 == 1 else None,
            "offset": offset,
        })
    return recs


@pytest.fixture(scope="module")
def fixture(tmp_path_factory):
    rng = np.random.default_rng(20261016)
    tmp = tmp_path_factory.mktemp("torch_train")
    w_true = rng.normal(size=D) * 0.4
    train = str(tmp / "train.avro")
    valid = str(tmp / "valid.avro")
    write_avro_file(train, TRAINING_EXAMPLE_SCHEMA, _records(rng, 300, w_true))
    write_avro_file(valid, TRAINING_EXAMPLE_SCHEMA, _records(rng, 200, w_true))
    return {"train": train, "valid": valid, "tmp": tmp}


def _params(fixture, out, **kw):
    return {
        "train_input": [fixture["train"]],
        "validate_input": [fixture["valid"]],
        "output_dir": str(fixture["tmp"] / out),
        "reg_weights": [10.0, 1.0],
        **kw,
    }


def _assert_same_runs(got, ref):
    assert len(got.models) == len(ref.models)
    for g, r in zip(got.models, ref.models):
        assert g.reg_weight == r.reg_weight
        assert g.result.iterations == int(r.result.iterations)
        assert g.result.reason == int(r.result.reason)
        if r.result.cg_iterations is not None:
            assert g.result.cg_iterations == int(r.result.cg_iterations)
        w_ref = np.asarray(r.model.coefficients.means)
        tol = 1e-8 * max(1.0, np.abs(w_ref).max())
        assert np.abs(g.model.coefficients.means.numpy() - w_ref).max() <= tol
    assert got.best_index == ref.best_index
    for gm, rm in zip(got.validation_metrics, ref.validation_metrics):
        assert set(gm) == set(rm)
        for k in rm:
            assert abs(gm[k] - rm[k]) <= 1e-8, k
    assert got.stages == [DriverStage(int(s)) for s in ref.stages]
    assert got.num_training_rows == ref.num_training_rows
    assert got.num_features == ref.num_features


@pytest.mark.parametrize("normalization", ["NONE", "SCALE_WITH_STANDARD_DEVIATION"])
@pytest.mark.parametrize("optimizer", ["TRON", "LBFGS"])
@pytest.mark.parametrize("sparse", [True, False], ids=["sparse", "dense"])
def test_port_training_matches_jax(fixture, sparse, optimizer, normalization):
    tag = f"{optimizer}-{sparse}-{normalization}"
    kw = dict(sparse=sparse, optimizer=optimizer, normalization=normalization)
    ref = jax_run({**_params(fixture, f"jax-{tag}", **kw), "quality_fingerprint": False})
    before = dispatch.launch_counts()
    got = ttrain.run_glm_training(_params(fixture, f"port-{tag}", **kw), device="cpu")
    assert dispatch.launch_counts() == before  # CPU: the plain versions
    assert got.device == "cpu"
    _assert_same_runs(got, ref)

    out_j, out_p = ref.params.output_dir, got.params.output_dir
    for name in ("feature-index.txt", "best-model.avro", "validation-metrics.json",
                 "feature-summary.tsv", "models/0_lambda_10.avro", "models/1_lambda_1.avro",
                 "models/0_lambda_10.txt", "log-message.txt"):
        assert os.path.exists(os.path.join(out_p, name)), name
    with open(os.path.join(out_j, "feature-index.txt")) as a, \
            open(os.path.join(out_p, "feature-index.txt")) as b:
        assert a.read() == b.read()
    _same_tsv(os.path.join(out_p, "feature-summary.tsv"),
              os.path.join(out_j, "feature-summary.tsv"))
    with open(os.path.join(out_j, "validation-metrics.json")) as a, \
            open(os.path.join(out_p, "validation-metrics.json")) as b:
        mj, mp = json.load(a), json.load(b)
    assert set(mj) == set(mp)
    assert set(got.timings) == {"ingest", "validate_data", "summary", "summary_write",
                                "train", "validate", "write"}


def _same_tsv(got_path, ref_path):
    with open(got_path) as a, open(ref_path) as b:
        got, ref = a.read().splitlines(), b.read().splitlines()
    assert got[0] == ref[0] and len(got) == len(ref)
    for g, r in zip(got[1:], ref[1:]):
        g, r = g.split("\t"), r.split("\t")
        assert g[:2] == r[:2]
        np.testing.assert_allclose([float(v) for v in g[2:]], [float(v) for v in r[2:]],
                                   rtol=1e-12, atol=1e-12)


def test_models_load_across_packages(fixture):
    got = ttrain.run_glm_training(_params(fixture, "port-cross"), device="cpu")
    ref = jax_run({**_params(fixture, "jax-cross"), "quality_fingerprint": False})
    # the port's best model, read by the JAX package
    jvocab = JVocab.load(os.path.join(got.params.output_dir, "feature-index.txt"))
    jcoef, jtask = jax_load(os.path.join(got.params.output_dir, "best-model.avro"), jvocab)
    np.testing.assert_array_equal(np.asarray(jcoef.means),
                                  got.best.model.coefficients.means.numpy())
    assert jtask.name == "LOGISTIC_REGRESSION"
    # the JAX package's best model, read by the port
    pvocab = FeatureVocabulary.load(os.path.join(ref.params.output_dir, "feature-index.txt"))
    pcoef, ptask = load_glm_model(os.path.join(ref.params.output_dir, "best-model.avro"), pvocab)
    np.testing.assert_array_equal(pcoef.means.numpy(),
                                  np.asarray(ref.best.model.coefficients.means))
    assert ptask.name == "LOGISTIC_REGRESSION"


def test_warm_start_matches_jax(fixture, tmp_path):
    # a model written by the JAX package warm-starts both drivers
    rng = np.random.default_rng(3)
    vocab = JVocab.load(os.path.join(
        ttrain.run_glm_training(_params(fixture, "port-vocab"), device="cpu")
        .params.output_dir, "feature-index.txt"))
    from photon_ml_tpu.core.types import Coefficients as JCoef

    init = str(tmp_path / "init.avro")
    jax_save(init, JCoef(means=jnp.asarray(0.1 * rng.standard_normal(len(vocab)))), vocab)
    kw = dict(optimizer="TRON", sparse=True, initial_model_dir=init)
    ref = jax_run({**_params(fixture, "jax-warm", **kw), "quality_fingerprint": False})
    got = ttrain.run_glm_training(_params(fixture, "port-warm", **kw), device="cpu")
    _assert_same_runs(got, ref)


def test_validate_per_iteration_matches_jax(fixture):
    # dense: the JAX driver's per-iteration margins take a numpy row, which
    # its SparseFeatures matvec does not
    kw = dict(optimizer="LBFGS", sparse=False, validate_per_iteration=True)
    ref = jax_run({**_params(fixture, "jax-periter", **kw), "quality_fingerprint": False,
                   "path_mode": "loop"})
    got = ttrain.run_glm_training(_params(fixture, "port-periter", **kw), device="cpu")
    _assert_same_runs(got, ref)
    name = "per-iteration-metrics.json"
    with open(os.path.join(ref.params.output_dir, name)) as a, \
            open(os.path.join(got.params.output_dir, name)) as b:
        mj, mp = json.load(a), json.load(b)
    assert set(mj) == set(mp)
    for key in mj:
        assert len(mj[key]) == len(mp[key])
        for rj, rp in zip(mj[key], mp[key]):
            for metric, v in rj.items():
                assert abs(rp[metric] - v) <= 1e-8


def test_cli_main_on_cpu(fixture, tmp_path):
    cfg = tmp_path / "params.json"
    cfg.write_text(json.dumps(_params(fixture, "port-cli", sparse=True)))
    ttrain.main(["--config", str(cfg), "--device", "cpu", "--optimizer", "TRON"])
    out = fixture["tmp"] / "port-cli"
    assert (out / "best-model.avro").exists()
    with pytest.raises(FileExistsError):
        ttrain.main(["--config", str(cfg), "--device", "cpu"])
    ttrain.main(["--config", str(cfg), "--device", "cpu", "--overwrite"])


def test_default_device_is_cuda_and_raises_without_a_card(fixture):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device runs")
    params = _params(fixture, "port-nodevice")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttrain.run_glm_training(params)
    assert not os.path.exists(params["output_dir"])


UNPORTED = [(name, value) for name, value in (
    ("out_of_core", True), ("streamed_ingest", True), ("mesh_shape", {"data": 2}),
    ("hot_columns", -1), ("constraint_file", "bounds.json"), ("compute_variances", True),
    ("diagnostics", True), ("quality_fingerprint", True), ("trace_dir", "trace"),
    ("heartbeat_s", 1.0), ("convergence_report", True), ("profile", True),
)] + [("reg_type", "L1"), ("reg_type", "ELASTIC_NET"), ("optimizer", "NEWTON")]


@pytest.mark.parametrize("field,value", UNPORTED)
def test_unported_paths_raise_and_name_their_roadmap_item(fixture, field, value):
    params = {**_params(fixture, f"port-unported-{field}"), field: value}
    with pytest.raises(NotImplementedError, match="ROADMAP.md, queue A"):
        ttrain.run_glm_training(params, device="cpu")
    assert not os.path.exists(params["output_dir"])


def test_the_default_run_takes_no_unported_path():
    params = GLMDriverParams(train_input=["x"], output_dir="y")
    params.validate()
    for name, (off, _) in UNPORTED_GLM_FIELDS.items():
        assert getattr(params, name) == off


def test_port_and_jax_params_have_the_same_fields():
    from photon_ml_tpu.cli.config import GLMDriverParams as JParams
    import dataclasses

    assert [f.name for f in dataclasses.fields(GLMDriverParams)] == [
        f.name for f in dataclasses.fields(JParams)]


def test_model_text_writes_nonzeros_and_the_intercept(tmp_path):
    vocab = FeatureVocabulary(["a\x01", "b\x01t"], add_intercept=True)
    path = tmp_path / "m.txt"
    ttrain.write_model_text(str(path), torch.tensor([0.0, 2.5, 0.0]), vocab)
    lines = path.read_text().splitlines()
    assert lines[0] == "b\tt\t2.5" and len(lines) == 2
    save_glm_model(str(tmp_path / "m.avro"), Coefficients(torch.tensor([0.0, 2.5, 0.0])), vocab)
