"""The scoring driver as a whole: GLM and GAME scoring through the JAX
package's ``run_scoring`` and the port's (on the CPU), on the same Avro
input and the same model directory, trained by the JAX
``run_glm_training`` / ``run_game_training`` or written by the JAX
``save_game_model``.

Scores agree within rtol 1e-10, atol 1e-12 (f64; summation order only),
every metric in ``metrics.json`` within 1e-10, and the ScoringResult
records carry equal uids and labels.
"""

import json
import os

import numpy as np
import pytest
import torch

from photon_ml_tpu.cli.game_train import run_game_training
from photon_ml_tpu.cli.score import run_scoring as jax_run_scoring
from photon_ml_tpu.cli.train import run_glm_training
from photon_ml_tpu.io.avro import read_avro_file, write_avro_file
from photon_ml_tpu.io.models import save_game_model
from photon_ml_tpu.io.schemas import TRAINING_EXAMPLE_SCHEMA
from photon_ml_tpu.io.vocab import FeatureVocabulary, feature_key
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


# -- GAME ------------------------------------------------------------------

N_USERS, D_G, D_W, POOL, D_F = 12, 4, 30, 5, 2


def _game_records(rng, n, truth, n_users_seen):
    """Global features g*, a wide per-user shard w* (each user draws 3 of
    a private pool of 5 columns), latent-shard features f*, and userId in
    the metadata (users at or past ``n_users_seen`` are unknown to a model
    trained on the first ones; every 13th row carries no userId)."""
    w_g, w_w, w_f, pools = truth
    recs = []
    for i in range(n):
        u = int(rng.integers(0, n_users_seen))
        xg = rng.normal(size=D_G)
        cols = np.unique(pools[u % N_USERS][rng.integers(0, POOL, 3)])
        xw = rng.normal(size=cols.size)
        xf = rng.normal(size=D_F)
        margin = xg @ w_g + xw @ w_w[u % N_USERS, cols] + xf @ w_f[u % N_USERS]
        feats = ([{"name": f"g{j}", "term": "", "value": float(xg[j])} for j in range(D_G)]
                 + [{"name": f"w{c}", "term": "", "value": float(v)} for c, v in zip(cols, xw)]
                 + [{"name": f"f{j}", "term": "", "value": float(xf[j])} for j in range(D_F)])
        recs.append({
            "uid": f"row{i}",
            "label": float(rng.uniform() < 1 / (1 + np.exp(-margin))),
            "features": feats,
            "metadataMap": None if i % 13 == 5 else {"userId": f"user{u}"},
            "weight": float(rng.uniform(0.5, 2.0)) if i % 4 == 1 else None,
            "offset": float(rng.normal(0, 0.2)) if i % 3 else None,
        })
    return recs


@pytest.fixture(scope="module")
def game_trained(tmp_path_factory):
    """A GAME model trained by the JAX driver: a fixed effect, a random
    effect on a wide shard and a factored random effect of the same
    userId type; scoring records that hold unknown users."""
    rng = np.random.default_rng(20261017)
    tmp = tmp_path_factory.mktemp("torch_game_score")
    pools = np.stack([rng.choice(D_W, POOL, replace=False) for _ in range(N_USERS)])
    truth = (rng.normal(size=D_G), rng.normal(size=(N_USERS, D_W)) * 1.5,
             rng.normal(size=(N_USERS, D_F)), pools)
    train = str(tmp / "train.avro")
    score = str(tmp / "score.avro")
    write_avro_file(train, TRAINING_EXAMPLE_SCHEMA, _game_records(rng, 240, truth, N_USERS))
    write_avro_file(score, TRAINING_EXAMPLE_SCHEMA, _game_records(rng, 150, truth, N_USERS + 3))
    shards = {}
    for shard, keys, icpt in (("gshard", [f"g{j}" for j in range(D_G)], True),
                              ("wshard", [f"w{j}" for j in range(D_W)], False),
                              ("fshard", [f"f{j}" for j in range(D_F)], True)):
        shards[shard] = str(tmp / f"{shard}.txt")
        FeatureVocabulary([feature_key(k, "") for k in keys], add_intercept=icpt).save(
            shards[shard])
    coord = {"optimizer": "TRON", "max_iters": 20, "tolerance": 1e-8}
    run_game_training({
        "train_input": [train],
        "output_dir": str(tmp / "model"),
        "task": "LOGISTIC_REGRESSION",
        "num_iterations": 1,
        "updating_sequence": ["global", "per-user", "per-user-latent"],
        "feature_shards": shards,
        "coordinates": {
            "global": {"shard": "gshard", "reg_weights": [0.1], **coord},
            "per-user": {"shard": "wshard", "random_effect": "userId",
                         "reg_weights": [1.0], **coord},
            "per-user-latent": {"shard": "fshard", "random_effect": "userId",
                                "reg_weights": [1.0], "latent_dim": 2, **coord},
        },
    })
    return {"score": score, "model": str(tmp / "model"), "tmp": tmp}


@pytest.fixture(scope="module")
def game_shared_type(tmp_path_factory):
    """Two random effects of one userId type with different entity sets
    and orders on disk, and records for users known to one, both or
    neither (the JAX driver's shared-type regression case)."""
    tmp = tmp_path_factory.mktemp("torch_game_shared")
    root = str(tmp / "model")
    vocab = FeatureVocabulary([feature_key("uf0", ""), feature_key("uf1", "")])
    save_game_model(
        root,
        params={"a": np.asarray([[1.0, 0.5], [2.0, 0.0]]),  # u0, u1
                "b": np.asarray([[30.0, 0.0], [40.0, -4.0]])},  # u1, u2
        shards={"a": "us", "b": "us"},
        vocabs={"a": vocab, "b": vocab},
        entity_vocabs={"a": {"u0": 0, "u1": 1}, "b": {"u1": 0, "u2": 1}},
        random_effects={"a": "userId", "b": "userId"},
    )
    vocab.save(os.path.join(root, "feature-index-us.txt"))
    recs = [
        {"uid": f"r{i}", "label": float(i % 2),
         "features": [{"name": "uf0", "term": "", "value": 1.0},
                      {"name": "uf1", "term": "", "value": 0.5 * i}],
         "metadataMap": {"userId": u}, "weight": None, "offset": None}
        for i, u in enumerate(["u0", "u1", "u2", "u3", "u1", "u0"])
    ]
    score = str(tmp / "score.avro")
    write_avro_file(score, TRAINING_EXAMPLE_SCHEMA, recs)
    return {"score": score, "model": root, "tmp": tmp}


def _game_params(fixture, out, sparse_shards=()):
    return {
        "input": [fixture["score"]],
        "model_dir": fixture["model"],
        "output_dir": str(fixture["tmp"] / out),
        "model_kind": "game",
        "sparse_shards": list(sparse_shards),
        "evaluate": True,
    }


def _assert_same_outputs(got, ref):
    np.testing.assert_allclose(got.scores, ref.scores, rtol=1e-10, atol=1e-12)
    with open(os.path.join(ref.params.output_dir, "metrics.json")) as f:
        ref_metrics = json.load(f)
    with open(os.path.join(got.params.output_dir, "metrics.json")) as f:
        got_metrics = json.load(f)
    assert set(got_metrics) == set(ref_metrics) and got_metrics == got.metrics
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


@pytest.mark.parametrize(
    "sparse_shards", [(), ("gshard",), ("wshard",), ("gshard", "wshard")],
    ids=["dense", "sparse-fixed", "sparse-wide-re", "both-sparse"],
)
def test_game_model_kind_is_not_ported(game_trained, sparse_shards):
    """Named for the pin it replaces: GAME scoring through the port's
    driver (on the CPU) matches the JAX driver on a model the JAX trainer
    wrote, with a fixed effect (dense or ELL), a wide random effect (dense
    or compact join), a factored random effect sharing its type, and
    unknown users."""
    tag = "-".join(sparse_shards) or "dense"
    ref = jax_run_scoring(_game_params(game_trained, f"jax-game-{tag}", sparse_shards))
    before = dispatch.launch_counts()
    got = tscore.run_scoring(_game_params(game_trained, f"port-game-{tag}", sparse_shards),
                             device="cpu")
    assert dispatch.launch_counts() == before  # CPU: plain versions
    assert got.device == "cpu" and got.scores.dtype == np.float64
    _assert_same_outputs(got, ref)
    assert set(got.timings) == {"load", "ingest", "margins", "write", "evaluate"}
    assert os.path.isdir(os.path.join(game_trained["model"], "best",
                                      "factored-random-effect", "per-user-latent"))


def test_game_scoring_of_a_shared_random_effect_type(game_shared_type):
    ref = jax_run_scoring(_game_params(game_shared_type, "jax-shared"))
    got = tscore.run_scoring(_game_params(game_shared_type, "port-shared"), device="cpu")
    _assert_same_outputs(got, ref)
    # u0 -> a only; u1 -> a + b; u2 -> b only; u3 -> neither
    np.testing.assert_allclose(got.scores[:4], [1.0, 32.0, 36.0, 0.0], rtol=1e-12)


def test_game_default_device_raises_without_a_card(game_shared_type):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device runs")
    params = _game_params(game_shared_type, "port-game-nodevice")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tscore.run_scoring(params)
    assert not os.path.exists(params["output_dir"])
