"""The slice as a whole: GLM training through the JAX package's
``run_glm_training`` and the port's (on the CPU, ``device="cpu"``), on the
same Avro fixture: sparse and dense, TRON and L-BFGS, two lambdas with
validation, with and without normalization; then every solver option of
the driver — coefficient variances, L1 and elastic net (OWL-QN), NEWTON,
``constraint_file`` box constraints — and the diagnostics report.

Tolerances (float64): the same iteration count, convergence reason and
CG iterations per lambda, exactly; coefficients and variances within
1e-8 x max(1, ||.||_inf); validation metrics within 1e-8; the same best
index; feature-summary.tsv values within rtol 1e-12. A model written by
either package loads in the other; the diagnostic reports are the same
HTML once the output directories are named alike. The quality fingerprint
(the port's default, as in JAX) is the JAX driver's within 1e-12
relative, and both text writers write the JAX writers' bytes.
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
    ("hot_columns", -1), ("quality_fingerprint", True), ("trace_dir", "trace"),
    ("heartbeat_s", 1.0), ("convergence_report", True), ("profile", True),
)]


# the pins of settings this port now runs: each is a parity case of the
# driver against the JAX driver, under the same test id
PORTED = {"quality_fingerprint", "hot_columns"}


def _hybrid_matches_jax(fixture, monkeypatch):
    """With ``hot_columns`` -1 (sized by column counts) and 14, the
    drivers split each batch alike (the same hot ids, training batch
    first, then validation) and train alike: the same iterations and CG
    steps, w within the GLM parity tolerance, and feature-summary.tsv
    within the summary's tolerance."""
    import photon_ml_tpu.ops.sparse as jsparse

    splits = {"jax": [], "port": []}
    jax_split, port_split = jsparse.to_hybrid, ttrain.to_hybrid

    def record(pkg, split):
        def run(sf, **kw):
            hf = split(sf, **kw)
            splits[pkg].append(np.asarray(hf.hot_ids).tolist())
            return hf
        return run

    monkeypatch.setattr(jsparse, "to_hybrid", record("jax", jax_split))
    monkeypatch.setattr(ttrain, "to_hybrid", record("port", port_split))
    for hot in (-1, 14):
        kw = dict(optimizer="TRON", sparse=True, hot_columns=hot)
        ref = jax_run({**_params(fixture, f"jax-hot{hot}", **kw), "quality_fingerprint": False})
        got = ttrain.run_glm_training(
            {**_params(fixture, f"port-hot{hot}", **kw), "quality_fingerprint": False},
            device="cpu")
        _assert_same_runs(got, ref)
        assert len(splits["port"]) == 2 and splits["port"] == splits["jax"]
        if hot > 0:
            assert [len(h) for h in splits["port"]] == [hot, hot]
        _same_tsv(os.path.join(got.params.output_dir, "feature-summary.tsv"),
                  os.path.join(ref.params.output_dir, "feature-summary.tsv"))
        assert "hybridize" in got.timings
        splits["jax"].clear()
        splits["port"].clear()


def _fingerprint_matches_jax(fixture):
    """The dense driver without a feature file (the native vocabulary
    scan) writes quality-fingerprint.json as the JAX driver does: the same
    rows, label, per-column feature sketches and names, and the chosen
    model's margin sketch, within 1e-12 relative."""
    from test_torch_quality import assert_same_doc

    kw = dict(optimizer="TRON", quality_fingerprint=True)
    ref = jax_run(_params(fixture, "jax-fingerprint", **kw))
    got = ttrain.run_glm_training(_params(fixture, "port-fingerprint", **kw), device="cpu")
    _assert_same_runs(got, ref)
    docs = []
    for run in (got, ref):
        with open(os.path.join(run.params.output_dir, "quality-fingerprint.json")) as f:
            docs.append(json.load(f))
    assert_same_doc(*docs)
    assert docs[0]["rows"] == 300 and len(docs[0]["shards"]["features"]) == D + 1
    assert docs[0]["margin"]["moments"]["count"] == 300
    # the flag turns it off as in JAX
    out = fixture["tmp"] / "port-no-fingerprint"
    cfg = fixture["tmp"] / "no-fingerprint.json"
    cfg.write_text(json.dumps(_params(fixture, "port-no-fingerprint", sparse=True)))
    ttrain.main(["--config", str(cfg), "--device", "cpu", "--no-quality-fingerprint"])
    assert not (out / "quality-fingerprint.json").exists() and (out / "best-model.avro").exists()


@pytest.mark.parametrize("field,value", UNPORTED)
def test_unported_paths_raise_and_name_their_roadmap_item(fixture, monkeypatch, field, value):
    """Named for the pins it holds: each setting the port does not run
    raises naming its ROADMAP item; each it now runs matches JAX."""
    if field == "quality_fingerprint":
        _fingerprint_matches_jax(fixture)
        return
    if field == "hot_columns":
        _hybrid_matches_jax(fixture, monkeypatch)
        return
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


# every value the writers must print as Python's float repr does
SPECIAL = [float("nan"), float("inf"), -0.0, 1e-05, float("-inf"), 0.0, 1.5e300, 5e-324,
           -1e-05, 0.1, 2.0 / 3.0, 123456789.0, 1e16, -7.0]


def _writer_vocab(intercept=True):
    keys = (["a\x01", "b\x01t", "naïve\x01térm", "x\x01y\x01z", "noterm", "é\x01",
             "\u00e9\x01\u4e2d"] + [f"h\x01{i}" for i in range(300)])
    return keys, FeatureVocabulary(keys, add_intercept=intercept), JVocab(
        keys, add_intercept=intercept)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("intercept_value", [0.0, -0.0, 0.75])
def test_model_text_bytes_equal_jax(tmp_path, dtype, intercept_value):
    """The column-wise writer against the JAX driver's per-row loop:
    non-ASCII and odd keys, nan/inf/-0.0/1e-05 and zeros (skipped but for
    the intercept), in the model's dtype."""
    from photon_ml_tpu.cli.train import write_model_text as jax_write

    _, vocab, jvocab = _writer_vocab()
    rng = np.random.default_rng(3)
    values = rng.normal(size=len(vocab)) * 10.0 ** rng.integers(-8, 8, len(vocab))
    values[::4] = 0.0
    values[:len(SPECIAL)] = SPECIAL
    values[vocab.intercept_index] = intercept_value
    with np.errstate(over="ignore"):
        values = values.astype(dtype)
    ttrain.write_model_text(str(tmp_path / "p.txt"), torch.from_numpy(values), vocab)
    jax_write(str(tmp_path / "j.txt"), values, jvocab)
    got, want = (tmp_path / "p.txt").read_bytes(), (tmp_path / "j.txt").read_bytes()
    assert got == want and b"nan" in got and b"-inf" in got
    assert (b"\t1e-05\n" in got) == (dtype == "float64")


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_feature_summary_bytes_equal_jax(tmp_path, dtype):
    from types import SimpleNamespace

    from photon_ml_tpu.cli.train import write_feature_summary as jax_write

    _, vocab, jvocab = _writer_vocab()
    rng = np.random.default_rng(4)
    cols = {}
    for i, c in enumerate(ttrain.SUMMARY_COLUMNS):
        v = rng.normal(size=len(vocab))
        v[::3] = 0.0
        v[i:i + len(SPECIAL)] = SPECIAL
        with np.errstate(over="ignore"):
            cols[c] = v.astype(dtype)
    cols["num_nonzeros"] = rng.integers(0, 9, len(vocab)).astype(dtype)
    ttrain.write_feature_summary(
        str(tmp_path / "p.tsv"),
        SimpleNamespace(**{c: torch.from_numpy(v) for c, v in cols.items()}), vocab)
    jax_write(str(tmp_path / "j.tsv"), SimpleNamespace(**cols), jvocab)
    got, want = (tmp_path / "p.tsv").read_bytes(), (tmp_path / "j.tsv").read_bytes()
    assert got == want and got.count(b"\n") == len(vocab) + 1


# -- the solver options and the diagnostics report ----------------------------

CONSTRAINTS = [
    {"name": "*", "term": "*", "lowerBound": -1.0, "upperBound": 1.0},
    {"name": "f3", "term": "*", "lowerBound": 0.0},
    {"name": "f4", "term": "t", "upperBound": 0.0},
]

OPTION_CASES = {
    "tron_variances_diagnostics": dict(
        optimizer="TRON", sparse=True, compute_variances=True, diagnostics=True,
        training_diagnostics=True),
    "owlqn_elastic_net_variances": dict(
        optimizer="LBFGS", reg_type="ELASTIC_NET", sparse=True, compute_variances=True,
        tolerance=1e-9),
    "owlqn_l1_dense": dict(optimizer="LBFGS", reg_type="L1", sparse=False),
    # one lambda and a tolerance the projected L-BFGS meets (ROADMAP queue C)
    "lbfgs_constraint_file_variances": dict(
        optimizer="LBFGS", sparse=True, compute_variances=True, reg_weights=[10.0],
        tolerance=1e-5, constraint_file=True),
    "newton_dense_scaled_variances": dict(
        optimizer="NEWTON", sparse=False, normalization="SCALE_WITH_MAX_MAGNITUDE",
        compute_variances=True, diagnostics=True),
    # a hybrid design through the variances (colsum per cold segment) and
    # both reports (their training batch in the hybrid's row order)
    "tron_hybrid_variances_diagnostics": dict(
        optimizer="TRON", sparse=True, hot_columns=-1, compute_variances=True,
        diagnostics=True, training_diagnostics=True),
}


def _load_models(out_dir, n_models, load, vocab_cls):
    vocab = vocab_cls.load(os.path.join(out_dir, "feature-index.txt"))
    names = sorted(os.listdir(os.path.join(out_dir, "models")))
    avros = [n for n in names if n.endswith(".avro")]
    assert len(avros) == n_models
    return [load(os.path.join(out_dir, "models", n), vocab)[0] for n in avros]


@pytest.mark.parametrize("case", list(OPTION_CASES))
def test_solver_options_and_diagnostics_match_jax(fixture, monkeypatch, case):
    from test_torch_diagnostics import _same_draws

    _same_draws(monkeypatch)  # the bootstrap replicas see the same weights
    kw = dict(OPTION_CASES[case])
    if kw.pop("constraint_file", False):
        path = fixture["tmp"] / "bounds.json"
        path.write_text(json.dumps(CONSTRAINTS))
        kw["constraint_file"] = str(path)
    # both drivers at their default, the quality fingerprint on: the
    # report's parameter table names it
    ref = jax_run(_params(fixture, f"jax-{case}", **kw))
    got = ttrain.run_glm_training(_params(fixture, f"port-{case}", **kw), device="cpu")
    _assert_same_runs(got, ref)
    for g, r in zip(got.models, ref.models):
        gv, rv = g.model.coefficients.variances, r.model.coefficients.variances
        if not kw.get("compute_variances"):
            assert gv is None and rv is None
            continue
        rv = np.asarray(rv)
        assert np.abs(gv.numpy() - rv).max() <= 1e-8 * max(1.0, np.abs(rv).max())
    if "constraint_file" in kw:
        w = got.models[0].model.coefficients.means.numpy()
        assert np.all(np.abs(np.delete(w, got.vocab.intercept_index)) <= 1.0)
        assert got.models[0].result.reason == int(ref.models[0].result.reason) != 1
    if kw.get("reg_type") in ("L1", "ELASTIC_NET"):
        for g, r in zip(got.models, ref.models):
            assert np.array_equal(g.model.coefficients.means.numpy() == 0.0,
                                  np.asarray(r.model.coefficients.means) == 0.0)

    # the written models, means and variances, read back by the port
    out_j, out_p = ref.params.output_dir, got.params.output_dir
    n_models = len(got.models)
    for gm, rm in zip(_load_models(out_p, n_models, load_glm_model, FeatureVocabulary),
                      _load_models(out_j, n_models, load_glm_model, FeatureVocabulary)):
        np.testing.assert_allclose(gm.means.numpy(), rm.means.numpy(), rtol=0, atol=1e-8)
        assert (gm.variances is None) == (rm.variances is None)
        if gm.variances is not None:
            np.testing.assert_allclose(gm.variances.numpy(), rm.variances.numpy(),
                                       rtol=1e-8, atol=0)

    if kw.get("diagnostics"):
        assert got.stages[-1] == DriverStage.DIAGNOSED and "diagnose" in got.timings
        with open(os.path.join(out_j, "model-diagnostic.html"), encoding="utf-8") as a, \
                open(os.path.join(out_p, "model-diagnostic.html"), encoding="utf-8") as b:
            html_j, html_p = a.read(), b.read()
        # the driver parameters table names each run's own output directory
        assert html_p == html_j.replace(out_j, out_p)
        assert "Hosmer&ndash;Lemeshow" in html_p and "Kendall tau" in html_p
        if kw.get("training_diagnostics"):
            assert "Bootstrap (15 replicas, 70% samples)" in html_p


NEWLY_PORTED = [("constraint_file", "bounds.json"), ("compute_variances", True),
                ("diagnostics", True), ("reg_type", "L1"), ("reg_type", "ELASTIC_NET"),
                ("optimizer", "NEWTON")]


@pytest.mark.parametrize("field,value", NEWLY_PORTED)
def test_newly_ported_options_pass_validation(fixture, field, value):
    params = GLMDriverParams(**{**_params(fixture, "unused"), field: value})
    params.validate()


@pytest.mark.parametrize("kw,match", [
    (dict(training_diagnostics=True), "requires diagnostics"),
    (dict(diagnostics=True, validate_input=[]), "requires validate_input"),
    (dict(optimizer="NEWTON", reg_type="L1"), "L2 only"),
    (dict(optimizer="TRON", reg_type="ELASTIC_NET"), "TRON"),
])
def test_option_cross_checks_refuse_like_jax(fixture, kw, match):
    from photon_ml_tpu.cli.config import GLMDriverParams as JParams

    params = {**_params(fixture, "unused"), **kw}
    with pytest.raises(ValueError, match=match):
        GLMDriverParams(**params).validate()
    with pytest.raises(ValueError, match=match):
        JParams(**params).validate()


def test_constraints_with_normalization_are_refused(fixture, tmp_path):
    path = tmp_path / "b.json"
    path.write_text(json.dumps(CONSTRAINTS))
    params = _params(fixture, "port-constrained-norm", constraint_file=str(path),
                     normalization="SCALE_WITH_STANDARD_DEVIATION")
    with pytest.raises(ValueError, match="normalization"):
        ttrain.run_glm_training(params, device="cpu")
