"""The port's GAME training driver against the JAX package's, on the CPU,
in float64, on small Avro inputs made from a numpy seed: a global fixed
effect (dense or padded-ELL) and a per-user random effect, two grid combos
and validation after every update. Both drivers pick the same combo; the
history, metrics and coefficients agree; each package's saved model loads
in the other and scores the same. Then every setting the port does not run
yet raises, naming its ROADMAP item, and the settings that used to raise
(projectors, factored effects, a sparse random effect, checkpoints and
resume, the quality fingerprint, shards without a feature file) train as
the JAX driver does; the fingerprints in every export subdir are the JAX
driver's within 1e-12 relative."""

import json
import os

import numpy as np
import pytest
import torch

from photon_ml_tpu.cli.game_train import run_game_training as jax_run_game_training
from photon_ml_tpu.game.scoring import score_game_data as jax_score_game_data
from photon_ml_tpu.io.avro import write_avro_file
from photon_ml_tpu.io.ingest import IngestSource as JaxIngestSource
from photon_ml_tpu.io.models import load_game_model as jax_load_game_model
from photon_ml_tpu.io.schemas import TRAINING_EXAMPLE_SCHEMA
from photon_ml_tpu.io.vocab import FeatureVocabulary, feature_key
from photon_ml_tpu_torch.cli import game_train as tgame
from photon_ml_tpu_torch.cli.config import (
    UNPORTED_COORDINATE_FIELDS,
    UNPORTED_GAME_FIELDS,
    GameDriverParams,
    load_params,
)
from photon_ml_tpu_torch.game.scoring import score_game_data
from photon_ml_tpu_torch.io.ingest import IngestSource
from photon_ml_tpu_torch.io.models import load_game_model

N_USERS, D_G, D_U = 9, 4, 2


def _records(rng, n, truth):
    """Global features g*, user features u*, userId in the metadata (every
    11th row without one); weights and offsets on some rows."""
    w_g, w_u = truth
    recs = []
    for i in range(n):
        u = int(rng.integers(0, N_USERS))
        xg = rng.normal(size=D_G)
        xu = rng.normal(size=D_U)
        margin = xg @ w_g + xu @ w_u[u]
        recs.append({
            "uid": f"row{i}",
            "label": float(rng.uniform() < 1 / (1 + np.exp(-margin))),
            "features": ([{"name": f"g{j}", "term": "", "value": float(xg[j])}
                          for j in range(D_G)]
                         + [{"name": f"u{j}", "term": "", "value": float(xu[j])}
                            for j in range(D_U)]),
            "metadataMap": None if i % 11 == 4 else {"userId": f"user{u}"},
            "weight": float(rng.uniform(0.5, 2.0)) if i % 4 == 1 else None,
            "offset": float(rng.normal(0, 0.2)) if i % 3 else None,
        })
    return recs


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    rng = np.random.default_rng(20261017)
    tmp = tmp_path_factory.mktemp("torch_game_train")
    truth = (rng.normal(size=D_G), rng.normal(size=(N_USERS, D_U)) * 1.5)
    train = str(tmp / "train.avro")
    validate = str(tmp / "validate.avro")
    write_avro_file(train, TRAINING_EXAMPLE_SCHEMA, _records(rng, 260, truth))
    write_avro_file(validate, TRAINING_EXAMPLE_SCHEMA, _records(rng, 120, truth))
    shards = {}
    for shard, keys in (("gshard", [f"g{j}" for j in range(D_G)]),
                        ("ushard", [f"u{j}" for j in range(D_U)])):
        shards[shard] = str(tmp / f"{shard}.txt")
        FeatureVocabulary([feature_key(k, "") for k in keys], add_intercept=True).save(
            shards[shard])
    return {"train": train, "validate": validate, "shards": shards, "tmp": tmp}


def _assert_same_runs(got, ref):
    """The same best combo and history; objectives within 1e-10 relative,
    validation metrics within 1e-10, every table within 1e-8 (FactoredParams
    leaf by leaf)."""
    assert got.best_index == ref.best_index
    assert [s["combo"] for s in got.sweep] == [s["combo"] for s in ref.sweep]
    for g, r in zip(got.sweep, ref.sweep):
        assert [(h.iteration, h.coordinate) for h in g["history"]] == [
            (h.iteration, h.coordinate) for h in r["history"]]
        for hg, hr in zip(g["history"], r["history"]):
            np.testing.assert_allclose(hg.objective, hr.objective, rtol=1e-10)
            if hr.validation_metric is not None:
                np.testing.assert_allclose(hg.validation_metric, hr.validation_metric,
                                           rtol=0, atol=1e-10)
            assert hg.convergence_histogram == hr.convergence_histogram
        for name, p in r["model"].params.items():
            q = g["model"].params[name]
            pairs = ([(q.gamma, p.gamma), (q.projection, p.projection)]
                     if hasattr(p, "gamma") else [(q, p)])
            for a, b in pairs:
                np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-8,
                                           err_msg=name)


def _params(inputs, out, sparse_shards=(), **extra):
    coord = {"optimizer": "TRON", "max_iters": 30, "tolerance": 1e-6}
    return {
        "train_input": [inputs["train"]],
        "validate_input": [inputs["validate"]],
        "output_dir": str(inputs["tmp"] / out),
        "task": "LOGISTIC_REGRESSION",
        "num_iterations": 3,
        "updating_sequence": ["global", "per-user"],
        "feature_shards": inputs["shards"],
        "coordinates": {
            "global": {"shard": "gshard", "reg_weights": [0.5], **coord},
            "per-user": {"shard": "ushard", "random_effect": "userId",
                         "reg_weights": [3.0, 0.1], "num_buckets": 2, **coord},
        },
        "sparse_shards": list(sparse_shards),
        "model_output_mode": "ALL",
        **extra,
    }


def _score_with(score_fn, source_cls, load_fn, model_dir, inputs, sparse_shards):
    """Score the validation records with one package's loader and scorer."""
    vocabs = {s: FeatureVocabulary.load(p) for s, p in inputs["shards"].items()}
    shards = {"global": "gshard", "per-user": "ushard"}
    params, _, res, evocabs = load_fn(model_dir, {n: vocabs[s] for n, s in shards.items()})
    data, _, _, _ = source_cls([inputs["validate"]]).game_data(
        vocabs, ["userId"], entity_vocabs={"userId": evocabs["per-user"]},
        sparse_shards=set(sparse_shards),
    )
    return np.asarray(score_fn(params, shards, res, data))


@pytest.mark.parametrize("sparse_shards", [(), ("gshard",)], ids=["dense", "ell-global"])
def test_game_training_matches_jax(inputs, sparse_shards):
    ref = jax_run_game_training(
        _params(inputs, f"jax-{len(sparse_shards)}", sparse_shards, quality_fingerprint=False))
    got = tgame.run_game_training(
        _params(inputs, f"torch-{len(sparse_shards)}", sparse_shards), device="cpu")

    assert got.best_index == ref.best_index
    assert [s["combo"] for s in got.sweep] == [s["combo"] for s in ref.sweep]
    for g, r in zip(got.sweep, ref.sweep):
        np.testing.assert_allclose(g["validation_metric"], r["validation_metric"],
                                   rtol=0, atol=1e-10)
        assert [(h.iteration, h.coordinate) for h in g["history"]] == [
            (h.iteration, h.coordinate) for h in r["history"]]
        for hg, hr in zip(g["history"], r["history"]):
            np.testing.assert_allclose(hg.objective, hr.objective, rtol=1e-10)
            np.testing.assert_allclose(hg.validation_metric, hr.validation_metric,
                                       rtol=0, atol=1e-10)
            assert hg.convergence_histogram == hr.convergence_histogram
            assert hg.solver_iterations == hr.solver_iterations
        for name, p in r["model"].params.items():
            np.testing.assert_allclose(g["model"].params[name].numpy(), np.asarray(p),
                                       rtol=0, atol=1e-8, err_msg=name)
    assert got.entity_vocabs == ref.entity_vocabs

    # the saved models: the same files, and each loads in the other
    # package and scores the same
    for g_dir, r_dir in zip(got.output_dirs, ref.output_dirs):
        with open(os.path.join(g_dir, "model-spec.json")) as f:
            g_spec = json.load(f)
        with open(os.path.join(r_dir, "model-spec.json")) as f:
            r_spec = json.load(f)
        assert g_spec.pop("combo") == r_spec.pop("combo")
        np.testing.assert_allclose(g_spec.pop("validation_metric"),
                                   r_spec.pop("validation_metric"), rtol=0, atol=1e-10)
        assert g_spec == r_spec
        by_jax = _score_with(jax_score_game_data, JaxIngestSource, jax_load_game_model,
                             g_dir, inputs, sparse_shards)
        by_torch = _score_with(
            lambda *a: score_game_data(*a, device="cpu"), IngestSource, load_game_model,
            r_dir, inputs, sparse_shards)
        np.testing.assert_allclose(by_jax, by_torch, rtol=1e-10, atol=1e-10)
    for shard in inputs["shards"]:
        assert os.path.exists(os.path.join(got.params.output_dir,
                                           f"feature-index-{shard}.txt"))
    assert os.path.exists(os.path.join(got.params.output_dir, "model-manifest.json"))


def test_warm_start_and_collapse_match_jax(inputs):
    """A warm start from the JAX run's model and the collapsed BEST output,
    with the validation metric only at the end of each combo."""
    base = jax_run_game_training(_params(inputs, "jax-base", quality_fingerprint=False,
                                         model_output_mode="BEST"))
    extra = {"initial_model_dir": base.output_dirs[0], "model_output_mode": "BEST",
             "collapse_output": True, "validate_per_coordinate": False,
             "num_iterations": 1}
    ref = jax_run_game_training(_params(inputs, "jax-warm", quality_fingerprint=False,
                                        **extra))
    got = tgame.run_game_training(_params(inputs, "torch-warm", **extra), device="cpu")
    assert got.best_index == ref.best_index
    for g, r in zip(got.sweep, ref.sweep):
        np.testing.assert_allclose(g["validation_metric"], r["validation_metric"],
                                   rtol=0, atol=1e-10)
        assert all(h.validation_metric is None for h in g["history"])
        for name, p in r["model"].params.items():
            np.testing.assert_allclose(g["model"].params[name].numpy(), np.asarray(p),
                                       rtol=0, atol=1e-8)
    collapsed = sorted(os.listdir(os.path.join(got.output_dirs[0], "fixed-effect"))
                       + os.listdir(os.path.join(got.output_dirs[0], "random-effect")))
    assert collapsed == ["fixed-effect-gshard", "userId-ushard"]


def test_cli_main_on_cpu(inputs):
    cfg = str(inputs["tmp"] / "cli.json")
    with open(cfg, "w") as f:
        json.dump(_params(inputs, "cli", num_iterations=1), f)
    tgame.main(["--config", cfg, "--device", "cpu"])
    assert os.path.exists(os.path.join(str(inputs["tmp"] / "cli"), "all", "1",
                                       "model-spec.json"))


def test_cli_writes_the_fingerprint_unless_told_not_to(inputs):
    """The fingerprint is the default, in every export subdir;
    ``--no-quality-fingerprint`` turns it off, as in the JAX CLI."""
    for flag, out in (([], "cli-fp"), (["--no-quality-fingerprint"], "cli-no-fp")):
        cfg = str(inputs["tmp"] / f"{out}.json")
        with open(cfg, "w") as f:
            json.dump(_params(inputs, out, num_iterations=1), f)
        tgame.main(["--config", cfg, "--device", "cpu", *flag])
        for sub in ("0", "1"):
            path = os.path.join(str(inputs["tmp"] / out), "all", sub, "quality-fingerprint.json")
            assert os.path.exists(path) == (not flag)


def test_default_device_is_cuda_and_raises_without_a_card(inputs):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tgame.run_game_training(_params(inputs, "nocard"))
    # build_coordinates resolves its device before it reads anything
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tgame.build_coordinates(None, None, None, {}, {})


# a value that turns each unported setting on
_ON = {"streamed_ingest": True,
       "trace_dir": "trace", "metrics_every": 5.0,
       "profile_dir": "profile", "flight_dir": "flight", "convergence_report": True,
       "entity_shards": 2, "heartbeat_s": 1.0, "collective_timeout_s": 30.0,
       "sharded_ckpt": True, "collective_mode": "fused", "hot_columns": 3}
_UNPORTED_CASES = (
    [(name, {name: _ON[name]}, item) for name, (_, item) in UNPORTED_GAME_FIELDS.items()]
    + [(f"coordinate.{name}", {"coordinate": {name: _ON[name]}}, item)
       for name, (_, item) in UNPORTED_COORDINATE_FIELDS.items()]
    + [("passes with a tolerance", {"passes_per_dispatch": 2,
                                    "convergence_tolerance": 1e-6},
        "Combo grid and dispatch chunks")]
)


# the pins of settings this port now runs: each becomes a parity case of
# the driver against the JAX driver, under the same test id
_PORTED_CASES = [
    ("checkpoint_every", {"checkpoint_every": 1}),
    ("resume", {"checkpoint_every": 1, "resume": True}),
    ("coordinate.projector", {"coordinate": {"projector": "RANDOM=2"}}),
    ("coordinate.latent_dim", {"coordinate": {"latent_dim": 2}}),
    ("sparse random effect", {"sparse_shards": ["ushard"],
                              "coordinate": {"projector": "INDEX_MAP"}}),
    ("quality_fingerprint", {"quality_fingerprint": True}),
    # both shards take the vocabulary of every key in the records (the
    # native scan), with the fingerprint in both packages
    ("no feature file", {"feature_shards": {}, "quality_fingerprint": True}),
    # the JAX package's tests/test_sparse_game.py hybrid case
    ("coordinate.hot_columns", {"coordinate": {"hot_columns": -1}}),
    # the same fixture with 3 hot columns: cold segments that hold entries
    ("coordinate.hot_columns=3", {"coordinate": {"hot_columns": 3}}),
]
_PORTED = dict(_PORTED_CASES)
_ALL_CASES = ([(name, change, None) for name, change in _PORTED_CASES]
              + [c for c in _UNPORTED_CASES if c[0] not in _PORTED])


def _hybrid_game_matches_jax(tmp, monkeypatch, hot_columns):
    """``hot_columns`` on the sparse global shard of the JAX package's
    sparse-GAME fixture (500 rows, 6 of 24 global columns each, 4 user
    columns, 20 users): both drivers split the shard alike, once for the
    run, and train alike."""
    import photon_ml_tpu.ops.sparse as jsparse
    from photon_ml_tpu.io.ingest import make_training_example
    from photon_ml_tpu_torch.game import coordinates as tcoords

    rng = np.random.default_rng(20261018)
    n, d_global, d_user = 500, 24, 4
    recs = []
    for i in range(n):
        feats = {(f"g{j}", ""): float(rng.normal())
                 for j in rng.choice(d_global, 6, replace=False)}
        feats.update({(f"u{j}", ""): float(rng.normal()) for j in range(d_user)})
        rec = make_training_example(label=float(i % 2), features=feats)
        rec["metadataMap"] = {"userId": f"user{i % 20}"}
        recs.append(rec)
    write_avro_file(str(tmp / "train" / "p.avro"), TRAINING_EXAMPLE_SCHEMA, recs)
    (tmp / "global.txt").write_text(
        "".join(f"g{j}\x01\n" for j in range(d_global)) + "(INTERCEPT)\x01\n")
    (tmp / "user.txt").write_text("".join(f"u{j}\x01\n" for j in range(d_user)))
    coord = {"optimizer": "TRON", "reg_weights": [1.0], "max_iters": 40, "tolerance": 1e-9}

    def params(out):
        return {
            "train_input": [str(tmp / "train")], "validate_input": [str(tmp / "train")],
            "output_dir": str(tmp / out), "task": "LOGISTIC_REGRESSION",
            "num_iterations": 2, "updating_sequence": ["global", "per-user"],
            "feature_shards": {"globalShard": str(tmp / "global.txt"),
                               "userShard": str(tmp / "user.txt")},
            "coordinates": {
                "global": {"shard": "globalShard", "hot_columns": hot_columns, **coord},
                "per-user": {"shard": "userShard", "random_effect": "userId", **coord},
            },
            "sparse_shards": ["globalShard"], "quality_fingerprint": False,
        }

    splits = {"jax": [], "port": []}

    def record(pkg, split):
        def run(sf, **kw):
            hf = split(sf, **kw)
            cold = sum(int((np.asarray(seg.indices) < seg.d).sum()) for seg in hf.cold_segments)
            splits[pkg].append((np.asarray(hf.hot_ids).tolist(), hf.segment_bounds(), cold))
            return hf
        return run

    monkeypatch.setattr(jsparse, "to_hybrid", record("jax", jsparse.to_hybrid))
    monkeypatch.setattr(tcoords, "to_hybrid", record("port", tcoords.to_hybrid))
    ref = jax_run_game_training(params("jax-hybrid"))
    got = tgame.run_game_training(params("port-hybrid"), device="cpu")
    _assert_same_runs(got, ref)
    assert len(splits["port"]) == 1 and splits["port"] == splits["jax"]
    hot_ids, bounds, cold = splits["port"][0]
    if hot_columns == -1:
        # every column is stored in about 125 of the 500 rows, above the
        # split's 64: all of them are hot and the cold segment is all padding
        assert len(hot_ids) == d_global + 1 and cold == 0
    else:
        # the intercept and 2 global columns hot; the other 22 columns' 6
        # entries a row (fewer where a row names a hot one) stored in cold
        # segments
        assert len(hot_ids) == hot_columns and len(bounds) > 1
        assert cold > n * (6 - 2)


def _ported_setting_matches_jax(inputs, name, change):
    change = dict(change)
    coord = change.pop("coordinate", {})
    tag = name.replace(" ", "-").replace(".", "-")
    both = []
    # the JAX driver writes its fingerprint only where the case asks for it
    jax_extra = {"quality_fingerprint": change.get("quality_fingerprint", False)}
    for pkg in ("jax", "torch"):
        p = _params(inputs, f"ported-{pkg}-{tag}", num_iterations=2, **change)
        p["coordinates"]["per-user"].update(coord)
        if name == "resume":
            # a first run stops after one pass with its checkpoint; the
            # resumed run continues it to two
            first = {**p, "num_iterations": 1, "resume": False}
            (jax_run_game_training if pkg == "jax" else
             lambda q: tgame.run_game_training(q, device="cpu"))(
                {**first, **(jax_extra if pkg == "jax" else {})})
        if pkg == "jax":
            both.append(jax_run_game_training({**p, **jax_extra}))
        else:
            both.append(tgame.run_game_training(p, device="cpu"))
    ref, got = both
    _assert_same_runs(got, ref)
    if "feature_shards" in change:
        assert {s: v.index_to_key for s, v in got.shard_vocabs.items()} == {
            s: v.index_to_key for s, v in ref.shard_vocabs.items()}
        assert len(got.shard_vocabs["gshard"]) == D_G + D_U + 1
    if change.get("quality_fingerprint"):
        from test_torch_quality import assert_same_doc

        assert got.output_dirs and len(got.output_dirs) == len(ref.output_dirs)
        for gdir, rdir in zip(got.output_dirs, ref.output_dirs):
            docs = []
            for d in (gdir, rdir):
                with open(os.path.join(d, "quality-fingerprint.json")) as f:
                    docs.append(json.load(f))
            assert_same_doc(*docs)
            assert docs[0]["rows"] == 260 and docs[0]["categoricals"]["userId"]["weight"] > 0
            assert sorted(docs[0]["shards"]) == ["gshard", "ushard"]
    if "checkpoint_every" in change:
        from photon_ml_tpu.io.checkpoint import latest_checkpoint as jax_latest

        for combo in range(len(got.sweep)):
            ckdir = os.path.join(got.params.output_dir, "checkpoints", f"combo-{combo}")
            # the port's step loads in the JAX package
            ck = jax_latest(ckdir)
            assert ck.step == 2 and sorted(ck.params) == ["global", "per-user"]
            assert len(ck.history) == 4


@pytest.mark.parametrize("name,change,item", _ALL_CASES, ids=[c[0] for c in _ALL_CASES])
def test_unported_setting_raises(inputs, tmp_path, monkeypatch, name, change, item):
    """Named for the pins it holds: each setting the port does not run
    raises, naming its ROADMAP item; each setting it now runs (``item``
    None) trains as the JAX driver does."""
    if name.startswith("coordinate.hot_columns"):
        _hybrid_game_matches_jax(tmp_path, monkeypatch, change["coordinate"]["hot_columns"])
        return
    if item is None:
        _ported_setting_matches_jax(inputs, name, change)
        return
    params = _params(inputs, "unported")
    change = dict(change)
    coord = change.pop("coordinate", None)
    if name == "resume":
        change["checkpoint_every"] = 1
    if coord is not None:
        if name == "coordinate.hot_columns":
            params["sparse_shards"] = ["gshard"]
        params["coordinates"]["global"].update(coord)
    params.update(change)
    with pytest.raises(NotImplementedError, match=f"'{item}'"):
        load_params(params, GameDriverParams).validate()


def test_factored_and_projector_are_exclusive(inputs):
    params = _params(inputs, "exclusive")
    params["coordinates"]["per-user"].update(latent_dim=2, projector="RANDOM=2")
    with pytest.raises(ValueError, match="mutually exclusive"):
        tgame.run_game_training(params, device="cpu")


def test_sparse_random_effect_needs_index_map(inputs):
    params = _params(inputs, "needs-index-map", sparse_shards=("ushard",))
    with pytest.raises(ValueError, match="INDEX_MAP"):
        load_params(params, GameDriverParams).validate()


def test_settings_that_stay_off_validate(inputs):
    """IDENTITY projectors, one entity shard and several passes per
    dispatch without a tolerance run (the same math)."""
    params = _params(inputs, "on", entity_shards=1, passes_per_dispatch=3)
    params["coordinates"]["per-user"]["projector"] = "IDENTITY"
    load_params(params, GameDriverParams).validate()
