"""The slice as a whole: GLM scoring through the JAX package's
``run_scoring`` and the port's (on the CPU), on the same Avro input and the
same model directory trained by the JAX ``run_glm_training``.

Scores agree within rtol 1e-10, atol 1e-12 (f64; summation order only),
every metric in ``metrics.json`` within 1e-10, and the ScoringResult
records carry equal uids and labels.
"""

import json
import os

import numpy as np
import pytest
import torch

from photon_ml_tpu.cli.score import run_scoring as jax_run_scoring
from photon_ml_tpu.cli.train import run_glm_training
from photon_ml_tpu.io.avro import read_avro_file, write_avro_file
from photon_ml_tpu.io.schemas import TRAINING_EXAMPLE_SCHEMA
from photon_ml_tpu_torch.cli import score as tscore
from photon_ml_tpu_torch.kernels import dispatch

D = 40  # features; 5-8 non-zeros per row


def _records(rng, n, w_true, null_labels=False):
    recs = []
    for i in range(n):
        cols = rng.choice(D, size=int(rng.integers(5, 9)), replace=False)
        x = rng.standard_normal(cols.size)
        offset = float(rng.normal(0, 0.3)) if i % 2 else None
        margin = x @ w_true[cols] + (offset or 0.0)
        label = float(rng.uniform() < 1 / (1 + np.exp(-margin)))
        if null_labels and i % 7 == 3:
            label = None
        recs.append({
            "uid": f"row{i}" if i % 11 else "",
            "label": label,
            "features": [
                {"name": f"f{int(c)}", "term": "t" if c % 3 else "", "value": float(v)}
                for c, v in zip(cols, x)
            ],
            "metadataMap": None,
            "weight": float(rng.uniform(0.5, 2.0)) if i % 4 == 1 else None,
            "offset": offset,
        })
    return recs


def _nullable_label_schema():
    schema = dict(TRAINING_EXAMPLE_SCHEMA)
    schema["fields"] = [
        {"name": "label", "type": ["null", "double"], "default": None}
        if f["name"] == "label" else f
        for f in TRAINING_EXAMPLE_SCHEMA["fields"]
    ]
    return schema


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    rng = np.random.default_rng(20261016)
    tmp = tmp_path_factory.mktemp("torch_score")
    w_true = rng.normal(size=D) * 1.2
    train = str(tmp / "train.avro")
    valid = str(tmp / "valid.avro")
    write_avro_file(train, TRAINING_EXAMPLE_SCHEMA, _records(rng, 300, w_true))
    write_avro_file(valid, TRAINING_EXAMPLE_SCHEMA, _records(rng, 200, w_true))
    nulls = str(tmp / "nulls.avro")
    write_avro_file(nulls, _nullable_label_schema(),
                    _records(rng, 150, w_true, null_labels=True))
    run_glm_training({
        "train_input": [train],
        "validate_input": [valid],
        "output_dir": str(tmp / "model"),
        "optimizer": "TRON",
        "reg_weights": [1.0],
        "max_iters": 50,
        "tolerance": 1e-9,
        "sparse": True,
    })
    return {"valid": valid, "nulls": nulls, "model": str(tmp / "model"), "tmp": tmp}


def _params(trained, inp, out, sparse=True):
    return {
        "input": [trained[inp]],
        "model_dir": trained["model"],
        "output_dir": str(trained["tmp"] / out),
        "model_kind": "glm",
        "sparse": sparse,
        "evaluate": True,
    }


@pytest.mark.parametrize("sparse", [True, False])
@pytest.mark.parametrize("inp", ["valid", "nulls"])
def test_port_scoring_matches_jax(trained, inp, sparse):
    tag = f"{inp}-{'sparse' if sparse else 'dense'}"
    ref = jax_run_scoring(_params(trained, inp, f"jax-{tag}", sparse))
    before = dispatch.launch_counts()["ell_matvec"]
    got = tscore.run_scoring(_params(trained, inp, f"port-{tag}", sparse), device="cpu")
    assert dispatch.launch_counts()["ell_matvec"] == before  # CPU: plain version
    assert got.device == "cpu"
    assert got.scores.dtype == np.float64
    np.testing.assert_allclose(got.scores, ref.scores, rtol=1e-10, atol=1e-12)
    np.testing.assert_array_equal(got.labels, ref.labels)

    with open(os.path.join(ref.params.output_dir, "metrics.json")) as f:
        ref_metrics = json.load(f)
    with open(os.path.join(got.params.output_dir, "metrics.json")) as f:
        got_metrics = json.load(f)
    assert set(got_metrics) == set(ref_metrics) and got_metrics == got.metrics
    assert "AREA_UNDER_RECEIVER_OPERATOR_CHARACTERISTICS" in got_metrics
    for name, v in ref_metrics.items():
        np.testing.assert_allclose(got_metrics[name], v, rtol=1e-10, atol=1e-10,
                                   err_msg=name)

    _, ref_recs = read_avro_file(ref.output_path)
    _, got_recs = read_avro_file(got.output_path)
    assert [r["uid"] for r in got_recs] == [r["uid"] for r in ref_recs]
    assert [r["label"] for r in got_recs] == [r["label"] for r in ref_recs]
    np.testing.assert_allclose(
        [r["predictionScore"] for r in got_recs],
        [r["predictionScore"] for r in ref_recs], rtol=1e-10, atol=1e-12,
    )
    if inp == "nulls":
        assert any(r["label"] is None for r in got_recs)
    assert set(got.timings) == {"ingest", "margins", "write", "evaluate"}


def test_cli_main_on_cpu(trained, tmp_path):
    cfg = tmp_path / "params.json"
    cfg.write_text(json.dumps(_params(trained, "valid", "port-cli")))
    tscore.main(["--config", str(cfg), "--device", "cpu"])
    out = trained["tmp"] / "port-cli"
    assert (out / "metrics.json").exists()
    assert (out / "scores" / "part-00000.avro").exists()
    with pytest.raises(FileExistsError):
        tscore.main(["--config", str(cfg), "--device", "cpu"])
    tscore.main(["--config", str(cfg), "--device", "cpu", "--overwrite"])


def test_default_device_is_cuda_and_raises_without_a_card(trained):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device runs")
    params = _params(trained, "valid", "port-nodevice")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tscore.run_scoring(params)
    # it raised before doing any work on the CPU
    assert not os.path.exists(params["output_dir"])


def test_game_model_kind_is_not_ported(trained):
    params = {**_params(trained, "valid", "port-game"), "model_kind": "game"}
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        tscore.run_scoring(params, device="cpu")
    assert not os.path.exists(params["output_dir"])
