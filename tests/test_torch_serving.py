"""The port's online serving stack (``photon_ml_tpu_torch.serving`` and
``cli/serve.py``) against the JAX package's, on the CPU in float64, on the
same seeded numpy inputs (params carried across by
``interop.game_params_from_numpy``; model directories written by either
package's ``save_game_model``).

Each class mirrors one of ``tests/test_serving.py``: the bucket ladder;
the engine's ``score`` / ``score_arrays`` / ``score_data`` / ``featurize``
against the JAX engine (cold-start rows included) within
1e-10 * max(1, |s|); the engine against the port's ``score_game_data``;
``from_model_dir`` on a JAX-written and a port-written export; zero new
bucket builds over 1000 mixed-size calls after warmup;
``precompact_model``; the micro-batcher; the registry (manifest, bad
export, hot reload under load, the watch root); the tiered entity cache;
and the serve protocol, whose ``metrics`` command is held to the JAX
CLI's Prometheus text on the same model and lines. Every thread is joined
with a timeout.
"""

import json
import os
import subprocess
import sys
import threading
from io import StringIO

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_ml_tpu.cli import serve as jax_serve
from photon_ml_tpu.game.factored import FactoredParams as JaxFactoredParams
from photon_ml_tpu.io import models as jax_models
from photon_ml_tpu.io.vocab import FeatureVocabulary as JaxVocab
from photon_ml_tpu.io.vocab import feature_key as jax_feature_key
from photon_ml_tpu.serving import engine as jax_engine
from photon_ml_tpu.serving import MicroBatcher as JaxMicroBatcher
from photon_ml_tpu.serving import ModelRegistry as JaxModelRegistry
from photon_ml_tpu_torch.cli import serve as port_serve
from photon_ml_tpu_torch.game.data import GameData
from photon_ml_tpu_torch.game.factored import FactoredParams
from photon_ml_tpu_torch.game.scoring import CompactReTable, precompact_model, score_game_data
from photon_ml_tpu_torch.interop import game_params_from_numpy
from photon_ml_tpu_torch.io import models as port_models
from photon_ml_tpu_torch.io.vocab import FeatureVocabulary, feature_key
from photon_ml_tpu_torch.resilience import GracefulShutdown
from photon_ml_tpu_torch.serving import (
    Backpressure,
    MicroBatcher,
    ModelRegistry,
    ScoreRequest,
    ScoringEngine,
    SharedCompileCache,
    bucket_builds,
    bucket_size,
    warmup_buckets,
)
from photon_ml_tpu_torch.serving.cache import TieredEntityCache

pytestmark = pytest.mark.serving

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = {"device": "cpu"}
N_USERS, D_G, D_U, LATENT = 6, 5, 4, 2


def _close(got, want):
    """Scores within 1e-10 * max(1, |s|)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = np.maximum(1.0, np.abs(want))
    assert np.all(np.abs(got - want) <= 1e-10 * scale), np.max(np.abs(got - want) / scale)


def _join(threads, timeout=30.0):
    for t in threads:
        t.join(timeout)
        assert not t.is_alive(), f"thread {t.name} did not finish"


# ---------------------------------------------------------------------------
# fixtures: tests/test_serving.py's, in both packages
# ---------------------------------------------------------------------------


def _dense_model(rng, n_users=N_USERS, d_g=D_G, d_u=D_U, latent_k=LATENT):
    """(JAX params, port params, shards, random effects): a fixed effect,
    a sparse per-user table and a factored per-user effect."""
    raw = {
        "global": rng.normal(size=d_g),
        "per-user": rng.normal(size=(n_users, d_u)) * (rng.uniform(size=(n_users, d_u)) < 0.5),
        "gamma": rng.normal(size=(n_users, latent_k)),
        "projection": rng.normal(size=(d_u, latent_k)),
    }
    jax_params = {
        "global": raw["global"],
        "per-user": raw["per-user"],
        "fact": JaxFactoredParams(gamma=jnp.asarray(raw["gamma"]),
                                  projection=jnp.asarray(raw["projection"])),
    }
    port_params = game_params_from_numpy({
        "global": raw["global"],
        "per-user": raw["per-user"],
        "fact": JaxFactoredParams(gamma=raw["gamma"], projection=raw["projection"]),
    })
    shards = {"global": "g", "per-user": "u", "fact": "u"}
    res = {"global": None, "per-user": "userId", "fact": "userId"}
    return jax_params, port_params, shards, res


def _dense_arrays(rng, n, d_g=D_G, d_u=D_U, n_users=N_USERS, cold_every=4):
    ents = rng.integers(0, n_users, size=n).astype(np.int32)
    ents[::cold_every] = -1  # cold-start rows
    return {"g": rng.normal(size=(n, d_g)), "u": rng.normal(size=(n, d_u))}, {"userId": ents}


def _datas(feats, ents):
    from photon_ml_tpu.game.data import GameData as JaxGameData

    n = next(iter(ents.values())).shape[0]
    return (JaxGameData.create(features=feats, labels=np.zeros(n), entity_ids=ents),
            GameData.create(features=feats, labels=np.zeros(n), entity_ids=ents))


def _save_disk_model(root, scale=1.0, n_users=4, d_u=3, package="port"):
    """tests/test_serving.py's GAME export (fixed + random effect on one
    shard, vocabs + manifest), written by either package."""
    mod, vocab_cls, key = ((port_models, FeatureVocabulary, feature_key) if package == "port"
                           else (jax_models, JaxVocab, jax_feature_key))
    u_vocab = vocab_cls([key(f"uf{j}", "") for j in range(d_u)])
    table = scale * np.arange(1, n_users * d_u + 1, dtype=float).reshape(n_users, d_u)
    mod.save_game_model(
        root,
        params={"global": scale * np.asarray([1.0, 2.0, 3.0]), "per-user": table},
        shards={"global": "us", "per-user": "us"},
        vocabs={"global": u_vocab, "per-user": u_vocab},
        entity_vocabs={"per-user": {f"u{i}": i for i in range(n_users)}},
        random_effects={"global": None, "per-user": "userId"},
    )
    u_vocab.save(os.path.join(root, "feature-index-us.txt"))
    mod.write_model_manifest(root)
    return root


def _save_wide_model(root, rng, package="port"):
    """A two-shard export with an intercept, a factored per-ad effect and
    entity vocabularies that differ per coordinate: the featurizer's key
    forms, intercepts, shared entity spaces and cold starts."""
    mod, vocab_cls, key, fact = (
        (port_models, FeatureVocabulary, feature_key,
         lambda g, p: FactoredParams(torch.from_numpy(g), torch.from_numpy(p)))
        if package == "port" else
        (jax_models, JaxVocab, jax_feature_key,
         lambda g, p: JaxFactoredParams(jnp.asarray(g), jnp.asarray(p))))
    g_vocab = vocab_cls([key("g", str(j)) for j in range(7)], add_intercept=True)
    a_vocab = vocab_cls([key("a", str(j)) for j in range(3)] + [key("g", "2")],
                        add_intercept=True)
    user = rng.normal(size=(5, len(g_vocab))) * (rng.uniform(size=(5, len(g_vocab))) < 0.4)
    mod.save_game_model(
        root,
        params={"global": rng.normal(size=len(g_vocab)), "per-user": user,
                "per-ad": rng.normal(size=(4, len(a_vocab))),
                "per-ad-latent": fact(rng.normal(size=(3, 2)),
                                      rng.normal(size=(len(a_vocab), 2)))},
        shards={"global": "g", "per-user": "g", "per-ad": "a", "per-ad-latent": "a"},
        vocabs={"global": g_vocab, "per-user": g_vocab, "per-ad": a_vocab,
                "per-ad-latent": a_vocab},
        entity_vocabs={"per-user": {f"user{u}": u for u in range(5)},
                       "per-ad": {"ad0": 0, "ad1": 1, "ad2": 2, "ad5": 3},
                       "per-ad-latent": {"ad5": 0, "ad1": 1, "ad7": 2}},
        random_effects={"global": None, "per-user": "userId", "per-ad": "adId",
                        "per-ad-latent": "adId"},
    )
    g_vocab.save(os.path.join(root, "feature-index-g.txt"))
    a_vocab.save(os.path.join(root, "feature-index-a.txt"))
    mod.write_model_manifest(root)
    return root


def _wide_requests(rng, n=40):
    """Requests in every key form, with unknown keys, unknown users, ads
    one coordinate lacks, absent ads and integer-looking ids."""
    out = []
    for i in range(n):
        feats = {}
        for j in rng.choice(7, size=3, replace=False).tolist():
            k = [f"g\x01{j}", ("g", str(j))][i % 2]
            feats[k] = float(rng.normal())
        feats[f"a\x01{i % 3}"] = float(rng.normal())
        if i % 5 == 0:
            feats["nosuch"] = 9.0
        ents = {"userId": f"user{i % 7}"}  # users 5 and 6 are unknown
        if i % 6 != 4:
            ents["adId"] = f"ad{i % 9}"
        out.append(ScoreRequest(features=feats, entities=ents, offset=float(i % 3) * 0.25))
    return out


def _jax_requests(reqs):
    return [jax_engine.ScoreRequest(features=r.features, entities=r.entities, offset=r.offset)
            for r in reqs]


# ---------------------------------------------------------------------------
# bucketing
# ---------------------------------------------------------------------------


class TestBucketing:
    @pytest.mark.parametrize("min_bucket", [1, 8, 16])
    def test_bucket_size_equals_jax(self, min_bucket):
        for n in range(1, 300):
            assert bucket_size(n, min_bucket) == jax_engine.bucket_size(n, min_bucket)
        with pytest.raises(ValueError):
            bucket_size(0)

    @pytest.mark.parametrize("max_batch,min_bucket", [(1, 8), (64, 8), (100, 8), (128, 16),
                                                      (1024, 8), (5, 1)])
    def test_warmup_ladder_equals_jax(self, max_batch, min_bucket):
        got = list(warmup_buckets(max_batch, min_bucket))
        assert got == list(jax_engine.warmup_buckets(max_batch, min_bucket))
        assert got[0] == bucket_size(1, min_bucket) and got[-1] == bucket_size(max_batch, min_bucket)


# ---------------------------------------------------------------------------
# the engine against the JAX engine
# ---------------------------------------------------------------------------


class TestEngineParity:
    @pytest.mark.parametrize("n,cold_every", [(23, 4), (9, 1), (64, 3), (1, 2)])
    def test_score_data_equals_jax_engine(self, rng, n, cold_every):
        jp, pp, shards, res = _dense_model(rng)
        feats, ents = _dense_arrays(rng, n, cold_every=cold_every)
        jd, td = _datas(feats, ents)
        want = jax_engine.ScoringEngine(jp, shards, res).score_data(jd)
        _close(ScoringEngine(pp, shards, res, **CPU).score_data(td), want)

    @pytest.mark.parametrize("fixed_only", [False, True])
    def test_score_arrays_equals_jax_engine(self, rng, fixed_only):
        jp, pp, shards, res = _dense_model(rng)
        feats, ents = _dense_arrays(rng, 37)
        offsets = rng.normal(size=37)
        want = jax_engine.ScoringEngine(jp, shards, res).score_arrays(
            feats, ents, offsets, fixed_only=fixed_only)
        got = ScoringEngine(pp, shards, res, **CPU).score_arrays(
            feats, ents, offsets, fixed_only=fixed_only)
        _close(got, want)

    def test_cold_start_is_fixed_effect_only(self, rng):
        _, pp, shards, res = _dense_model(rng)
        feats, ents = _dense_arrays(rng, 9, cold_every=1)  # every row cold
        engine = ScoringEngine(pp, shards, res, **CPU)
        _close(engine.score_arrays(feats, ents), feats["g"] @ pp["global"].numpy())
        _close(engine.score_arrays(feats, ents),
               engine.score_arrays(feats, ents, fixed_only=True))

    @pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
    def test_engine_equals_port_score_game_data(self, rng, dtype):
        _, pp, shards, res = _dense_model(rng)
        feats, ents = _dense_arrays(rng, 29)
        _, td = _datas(feats, ents)
        want = score_game_data(pp, shards, res, td, dtype=dtype, **CPU).numpy()
        got = ScoringEngine(pp, shards, res, dtype=dtype, **CPU).score_data(td)
        assert got.dtype == np.dtype(str(dtype).split(".")[-1])
        if dtype == torch.float64:
            _close(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)

    @pytest.mark.parametrize("writer", ["jax", "port"])
    def test_score_and_featurize_equal_jax_engine(self, rng, tmp_path, writer):
        root = _save_wide_model(str(tmp_path / "m"), rng, package=writer)
        reqs = _wide_requests(np.random.default_rng(7))
        jeng = jax_engine.ScoringEngine.from_model_dir(root)
        peng = ScoringEngine.from_model_dir(root, **CPU)
        jf, je, jo = jeng.featurize(_jax_requests(reqs))
        pf, pe, po = peng.featurize(reqs)
        assert sorted(pf) == sorted(jf) and sorted(pe) == sorted(je)
        for s in jf:
            np.testing.assert_array_equal(pf[s], np.asarray(jf[s]))
        for rk in je:
            np.testing.assert_array_equal(pe[rk], je[rk])
        np.testing.assert_array_equal(po, jo)
        assert (pe["userId"] < 0).any() and (pe["adId"] < 0).any()  # cold starts
        _close(peng.score(reqs), jeng.score(_jax_requests(reqs)))
        _close(peng.score(reqs, fixed_only=True),
               jeng.score(_jax_requests(reqs), fixed_only=True))

    @pytest.mark.parametrize("writer", ["jax", "port"])
    def test_from_model_dir_equals_jax_engine(self, rng, tmp_path, writer):
        root = _save_disk_model(str(tmp_path / "model"), package=writer)
        ents = np.asarray([0, 1, 2, 3, -1, 0, 1, -1, 2, 3, 0], np.int32)
        feats = {"us": rng.normal(size=(11, 3))}
        jd, td = _datas(feats, {"userId": ents})
        want = jax_engine.ScoringEngine.from_model_dir(root).score_data(jd)
        engine = ScoringEngine.from_model_dir(root, **CPU)
        _close(engine.score_data(td), want)
        params, shards, res, _, _ = port_models.load_game_model_auto(root)
        _close(engine.score_data(td), score_game_data(params, shards, res, td, **CPU).numpy())

    def test_featurize_requests(self, tmp_path):
        """tests/test_serving.py's key forms: tuple, delimited, bare name;
        unknown features ignored, unknown entity -> cold start, offsets."""
        engine = ScoringEngine.from_model_dir(_save_disk_model(str(tmp_path / "m")), **CPU)
        reqs = [
            ScoreRequest(features={("uf0", ""): 2.0, "uf1": 3.0, "nosuch": 9.9},
                         entities={"userId": "u1"}, offset=0.5),
            ScoreRequest(features={"uf0\x01": 1.0}, entities={"userId": "never-seen"}),
        ]
        want0 = (2 * 1 + 3 * 2) + (2 * 4 + 3 * 5) + 0.5
        _close(engine.score(reqs), [want0, 1.0])

    def test_refusals(self, rng, tmp_path):
        _, pp, shards, res = _dense_model(rng)
        with pytest.raises(NotImplementedError, match="item 5"):
            ScoringEngine(pp, shards, res, baseline=object(), **CPU)
        engine = ScoringEngine(pp, shards, res, **CPU)
        with pytest.raises(ValueError, match="shard vocabularies"):
            engine.featurize([ScoreRequest({"x": 1.0})])
        with pytest.raises(KeyError, match="missing feature shard"):
            engine.score_arrays({"g": np.zeros((2, D_G))})
        from photon_ml_tpu_torch.interop import sparse_from_numpy

        sp = sparse_from_numpy(np.zeros((3, 2), np.int32), np.zeros((3, 2)), D_G)
        data = GameData.create(features={"g": sp, "u": np.zeros((3, D_U))},
                               labels=np.zeros(3), entity_ids={"userId": np.zeros(3, np.int32)})
        with pytest.raises(ValueError, match="featurizes densely"):
            engine.score_data(data)

    def test_default_device_is_the_card(self, rng, tmp_path):
        if torch.cuda.is_available():
            pytest.skip("a card is present: the default device resolves")
        _, pp, shards, res = _dense_model(rng)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ScoringEngine(pp, shards, res)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ModelRegistry().load(_save_disk_model(str(tmp_path / "m")))
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TieredEntityCache("k", num_entities=2, capacity=1)


# ---------------------------------------------------------------------------
# zero new builds after warmup
# ---------------------------------------------------------------------------


class TestZeroBuilds:
    def test_1000_mixed_size_calls_zero_new_builds(self, rng):
        """tests/test_serving.py:254's oracle: the engine's build count
        and the process-wide one stay put over 1000 mixed-size calls."""
        jp, pp, shards, res = _dense_model(rng, n_users=8, d_g=6, d_u=4)
        engine = ScoringEngine(pp, shards, res, **CPU)
        warmed = engine.warmup(max_batch=128)
        assert list(warmed) == [8, 16, 32, 64, 128]
        assert engine.compile_count == len(warmed) == engine.stats.compile_count
        pool_g = rng.normal(size=(128, 6))
        pool_u = rng.normal(size=(128, 4))
        pool_e = rng.integers(-1, 8, size=128).astype(np.int32)
        builds, sizes = bucket_builds(), []
        for i in range(1000):
            n = 1 + (i * 37) % 128
            sizes.append(n)
            engine.score_arrays({"g": pool_g[:n], "u": pool_u[:n]}, {"userId": pool_e[:n]})
        assert engine.compile_count == len(warmed), "the engine built a bucket"
        assert bucket_builds() == builds, "a bucket scorer was built in steady state"
        assert len({bucket_size(n) for n in sizes}) == 5
        assert engine.stats.bucket_misses == len(warmed)
        assert engine.stats.bucket_hits >= 1000
        n = 77
        jd, td = _datas({"g": pool_g[:n], "u": pool_u[:n]}, {"userId": pool_e[:n]})
        _close(engine.score_data(td), jax_engine.ScoringEngine(jp, shards, res).score_data(jd))

    def test_degraded_ladder_and_shared_cache(self, rng):
        _, pp, shards, res = _dense_model(rng)
        shared = SharedCompileCache()
        a = ScoringEngine(pp, shards, res, compile_cache=shared, **CPU)
        a.warmup(max_batch=32, include_degraded=True)
        assert a.compile_count == 6 and shared.snapshot()["compiles"] == 6
        # a same-shaped tenant with other weights builds nothing ...
        _, pp2, _, _ = _dense_model(np.random.default_rng(99))
        b = ScoringEngine(pp2, shards, res, compile_cache=shared, **CPU)
        builds = bucket_builds()
        b.warmup(max_batch=32, include_degraded=True)
        assert b.compile_count == 0 and b.shared_compile_hits == 6 and bucket_builds() == builds
        # ... and scores with its own weights
        feats, ents = _dense_arrays(rng, 20)
        _close(b.score_arrays(feats, ents),
               ScoringEngine(pp2, shards, res, **CPU).score_arrays(feats, ents))


# ---------------------------------------------------------------------------
# precompaction
# ---------------------------------------------------------------------------


class TestPrecompact:
    def test_precompact_model_compacts_only_re_tables(self, rng):
        _, pp, _, _ = _dense_model(rng)
        out = precompact_model(pp)
        assert isinstance(out["per-user"], CompactReTable)
        assert out["global"] is pp["global"] and out["fact"] is pp["fact"]
        assert precompact_model(out)["per-user"] is out["per-user"]
        dense = np.zeros(tuple(pp["per-user"].shape))
        for i, (cols, vals) in enumerate(zip(out["per-user"].columns, out["per-user"].values)):
            for c, v in zip(np.asarray(cols), np.asarray(vals)):
                if c < dense.shape[1]:
                    dense[i, c] += v
        np.testing.assert_array_equal(dense, pp["per-user"].numpy())

    def test_precompacted_params_score_like_dense(self, rng):
        jp, pp, shards, res = _dense_model(rng)
        feats, ents = _dense_arrays(rng, 30)
        want = jax_engine.ScoringEngine(jp, shards, res).score_arrays(feats, ents)
        engine = ScoringEngine(precompact_model(pp), shards, res, **CPU)
        _close(engine.score_arrays(feats, ents), want)
        assert engine.stats.snapshot()["resident_re_bytes_per_process"] == (
            N_USERS * engine._params["per-user"].columns.shape[1] * 12 + N_USERS * LATENT * 8)


# ---------------------------------------------------------------------------
# micro-batcher
# ---------------------------------------------------------------------------


class TestMicroBatcher:
    def test_coalesces_queued_requests_into_one_call(self):
        calls = []

        def score_fn(reqs):
            calls.append(len(reqs))
            return np.asarray([float(r) * 2 for r in reqs])

        b = MicroBatcher(score_fn, max_batch=16, max_wait_ms=5.0, auto_start=False)
        futs = [b.submit(i) for i in range(10)]
        b.start()
        assert [f.result(timeout=10) for f in futs] == [2.0 * i for i in range(10)]
        assert b.drain()
        assert calls and max(calls) > 1, f"no coalescing: {calls}"
        assert sum(calls) == 10 and b.stats.batches == len(calls) and b.stats.requests == 10

    def test_backpressure_bounded_queue(self):
        b = MicroBatcher(lambda reqs: np.zeros(len(reqs)), queue_depth=4, auto_start=False)
        for i in range(4):
            b.submit(i)
        with pytest.raises(Backpressure, match="full"):
            b.submit(99)
        assert b.stats.rejected == 1
        b.start()
        assert b.drain()

    def test_score_errors_propagate_to_futures(self):
        def boom(reqs):
            raise RuntimeError("device on fire")

        b = MicroBatcher(boom, auto_start=False)
        f = b.submit(1)
        b.start()
        with pytest.raises(RuntimeError, match="device on fire"):
            f.result(timeout=10)
        assert b.drain()
        assert b.stats.errors == 1

    def test_drain_on_shutdown_drops_nothing(self):
        b = MicroBatcher(lambda reqs: np.asarray([float(r) for r in reqs]), auto_start=False)
        shutdown = GracefulShutdown()
        shutdown.register_drain(b.begin_drain)
        futs = [b.submit(i) for i in range(5)]
        shutdown.request()  # as the SIGTERM handler would
        with pytest.raises(Backpressure, match="draining"):
            b.submit(99)
        b.start()
        assert b.drain()
        assert [f.result(timeout=10) for f in futs] == [float(i) for i in range(5)]

    def test_drain_hook_errors_do_not_block_shutdown(self):
        shutdown = GracefulShutdown()
        fired = []
        shutdown.register_drain(lambda: 1 / 0)
        shutdown.register_drain(lambda: fired.append(True))
        shutdown.request()
        assert shutdown.requested and fired == [True]
        shutdown.request()
        assert fired == [True]

    def test_engine_behind_batcher_equals_direct(self, rng, tmp_path):
        engine = ScoringEngine.from_model_dir(_save_wide_model(str(tmp_path / "m"), rng), **CPU)
        reqs = _wide_requests(np.random.default_rng(3), n=48)
        direct = engine.score(reqs)
        with MicroBatcher(engine.score, max_batch=16, max_wait_ms=1.0) as b:
            futs = [b.submit(r) for r in reqs]
            got = [f.result(timeout=10) for f in futs]
        _close(got, direct)


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------


class TestRegistry:
    def test_manifest_roundtrip_and_tamper_detection(self, tmp_path):
        from photon_ml_tpu_torch.io.models import ModelIntegrityError, verify_model_manifest

        root = _save_disk_model(str(tmp_path / "m"))
        assert verify_model_manifest(root) == jax_models.verify_model_manifest(root)
        victim = os.path.join(root, "random-effect", "per-user", "coefficients",
                              "part-00000.avro")
        blob = bytearray(open(victim, "rb").read())
        blob[len(blob) // 2] ^= 0xFF
        open(victim, "wb").write(bytes(blob))
        with pytest.raises(ModelIntegrityError, match="digest mismatch"):
            verify_model_manifest(root)
        os.remove(victim)
        with pytest.raises(ModelIntegrityError, match="missing"):
            verify_model_manifest(root)
        assert verify_model_manifest(str(tmp_path), require=False) == {}
        with pytest.raises(ModelIntegrityError, match="no model-manifest"):
            verify_model_manifest(str(tmp_path))

    def test_bad_export_never_serves(self, tmp_path):
        from photon_ml_tpu_torch.io.models import ModelIntegrityError

        root_a = _save_disk_model(str(tmp_path / "v1"), scale=1.0)
        root_b = _save_disk_model(str(tmp_path / "v2"), scale=2.0)
        victim = os.path.join(root_b, "fixed-effect", "global", "coefficients", "part-00000.avro")
        blob = bytearray(open(victim, "rb").read())
        blob[-3] ^= 0xFF
        open(victim, "wb").write(bytes(blob))
        reg = ModelRegistry(warmup_max_batch=8, **CPU)
        reg.load(root_a)
        probe = ScoreRequest(features={"uf0": 1.0}, entities={})
        s_a = reg.score([probe])[0]
        with pytest.raises(ModelIntegrityError):
            reg.load(root_b)
        assert reg.version() == "v1" and reg.score([probe])[0] == s_a
        assert reg.poll(str(tmp_path)) is None and reg.version() == "v1"
        assert reg.stats.reload_failures == 2

    def test_hot_reload_under_concurrent_load_drops_nothing(self, tmp_path):
        root_a = _save_disk_model(str(tmp_path / "v1"), scale=1.0)
        root_b = _save_disk_model(str(tmp_path / "v2"), scale=3.0)
        reg = ModelRegistry(warmup_max_batch=16, **CPU)
        v1 = reg.load(root_a)
        probe = ScoreRequest(features={"uf0": 1.0, "uf2": 0.5}, entities={"userId": "u2"})
        s_a = reg.score([probe])[0]
        s_b = ScoringEngine.from_model_dir(root_b, **CPU).score([probe])[0]
        assert abs(s_a - s_b) > 1e-6
        batcher = MicroBatcher(reg.score, max_batch=16, max_wait_ms=0.5, stats=reg.stats)
        results = [[] for _ in range(4)]
        errors = []
        started = threading.Barrier(5)

        def client(ci):
            started.wait(10)
            try:
                for _ in range(40):
                    results[ci].append(batcher.submit(probe).result(timeout=30))
            except Exception as e:  # noqa: BLE001
                errors.append(e)

        threads = [threading.Thread(target=client, args=(ci,)) for ci in range(4)]
        for t in threads:
            t.start()
        started.wait(10)
        v2 = reg.load(root_b)  # hot reload mid-storm
        _join(threads)
        assert batcher.drain()
        assert not errors, errors
        flat = [s for chunk in results for s in chunk]
        assert len(flat) == 160, "requests were dropped"
        assert all(min(abs(s - s_a), abs(s - s_b)) < 1e-9 for s in flat)
        assert reg.version() == "v2" and abs(reg.score([probe])[0] - s_b) < 1e-9
        assert v1.retired and v1.engine is None and v1.inflight == 0
        assert reg.retired_versions == ["v1"] and v2.inflight == 0 and reg.stats.reloads == 1

    def test_poll_watch_root_picks_up_new_version(self, tmp_path):
        watch = tmp_path / "watch"
        watch.mkdir()
        _save_disk_model(str(watch / "000"), scale=1.0)
        reg = ModelRegistry(warmup_max_batch=8, **CPU)
        assert reg.poll(str(watch)) == "000"
        assert reg.poll(str(watch)) is None
        _save_disk_model(str(watch / "001"), scale=2.0, package="jax")
        assert reg.poll(str(watch)) == "001" and reg.version() == "001"

    def test_reload_fault_site_opens_breaker(self, tmp_path):
        from photon_ml_tpu_torch.resilience import FaultSpec, InjectedFault, inject
        from photon_ml_tpu_torch.serving import ReloadQuarantined

        root = _save_disk_model(str(tmp_path / "v1"))
        reg = ModelRegistry(warmup_max_batch=8, breaker_threshold=2, **CPU)
        with inject(FaultSpec("serving.reload", "raise", nth=1, count=-1)):
            for _ in range(2):
                with pytest.raises(InjectedFault):
                    reg.load(root)
            with pytest.raises(ReloadQuarantined):
                reg.load(root)
        assert reg.health()["breaker"]["state"] == "open"
        assert reg.load(root, force=True).version_id == "v1"
        assert reg.health()["breaker"]["state"] == "closed"
        with pytest.raises(NotImplementedError, match="item 9"):
            ModelRegistry(serving_shards=2, **CPU)


# ---------------------------------------------------------------------------
# tiered entity cache
# ---------------------------------------------------------------------------


class TestTieredCache:
    def test_hits_equal_uncached_and_misses_score_cold_start(self, rng):
        """Capacity 3 of 8 users, promotion driven by hand: a resident
        user's row scores as the uncached engine's, a cold one as cold
        start, and the slots, scores and counters equal the JAX engine's
        cache driven the same way."""
        jp, pp, shards, res = _dense_model(rng, n_users=8)
        plain = ScoringEngine(pp, shards, res, **CPU)
        cached = ScoringEngine(pp, shards, res, hbm_cache_entities=3, **CPU)
        jcached = jax_engine.ScoringEngine(jp, shards, res, hbm_cache_entities=3)
        caches = (cached._caches["userId"], jcached._caches["userId"])
        for c in caches:
            c.close()  # deterministic: no worker
        assert caches[0].capacity == 3 and caches[0].resident() == 3  # the preloaded head
        assert cached.stats.snapshot()["resident_re_bytes_per_process"] < (
            plain.stats.snapshot()["resident_re_bytes_per_process"])
        feats, _ = _dense_arrays(rng, 16)
        cold = plain.score_arrays(feats, {"userId": np.full(16, -1, np.int32)})
        for step, users in enumerate(([0, 1, 2, 5, 6, -1, 7, 1], [5, 6, 7, 3, 3, 0, -1, 4],
                                      [4, 4, 0, 1, 2, 3, 5, 6])):
            ents = {"userId": np.asarray(users * 2, np.int32)}
            hit = np.isin(ents["userId"], np.flatnonzero(caches[0].slot_of >= 0))
            got = cached.score_arrays(feats, ents)
            _close(got, jcached.score_arrays(feats, ents))
            _close(got[hit], plain.score_arrays(feats, ents)[hit])
            _close(got[~hit], cold[~hit])
            assert (~hit).any() and hit.any()
            assert caches[0].promote_pending() == caches[1].promote_pending() > 0
            np.testing.assert_array_equal(caches[0].slot_of, caches[1].slot_of)
            np.testing.assert_array_equal(caches[0].entity_of, caches[1].entity_of)
            assert caches[0].generation == caches[1].generation > step
        assert cached.cache_snapshot() == jcached.cache_snapshot()
        assert cached.stats.snapshot()["cache"] == jcached.stats.snapshot()["cache"]

    def test_worker_promotes_and_cache_tier_fault_keeps_entities_cold(self, rng):
        from photon_ml_tpu_torch.resilience import FaultSpec, inject

        _, pp, shards, res = _dense_model(rng, n_users=8)
        plain = ScoringEngine(pp, shards, res, **CPU)
        cached = ScoringEngine(pp, shards, res, hbm_cache_entities=4, **CPU)
        feats, _ = _dense_arrays(rng, 8)
        ents = {"userId": np.full(8, 6, np.int32)}
        with inject(FaultSpec("serving.cache_tier", "raise", nth=1, count=-1)):
            cached.score_arrays(feats, ents)
            cached._caches["userId"].flush(timeout=5.0)
        assert cached.stats.snapshot()["cache"]["tier_errors"] >= 1
        assert cached._caches["userId"].slot_of[6] < 0
        cached.score_arrays(feats, ents)  # the miss enqueues it again
        cached._caches["userId"].flush(timeout=5.0)
        assert cached._caches["userId"].slot_of[6] >= 0
        _close(cached.score_arrays(feats, ents), plain.score_arrays(feats, ents))
        cached.close()
        assert cached._caches["userId"]._thread is None

    def test_concurrent_scoring_and_promotion(self, rng):
        """Threads scoring through a 4-slot cache while its worker promotes
        and evicts, with a short switch interval: every row scores as the
        uncached engine's or as cold start, never with another entity's
        rows (a slot read after its eviction would)."""
        import sys

        _, pp, shards, res = _dense_model(rng, n_users=40)
        plain = ScoringEngine(pp, shards, res, **CPU)
        cached = ScoringEngine(pp, shards, res, hbm_cache_entities=4, **CPU)
        feats, _ = _dense_arrays(rng, 16)
        cold = plain.score_arrays(feats, {"userId": np.full(16, -1, np.int32)})
        bad = []

        def worker(seed):
            r = np.random.default_rng(seed)
            for _ in range(40):
                ents = {"userId": r.integers(0, 40, 16).astype(np.int32)}
                got = cached.score_arrays(feats, ents)
                full = plain.score_arrays(feats, ents)
                ok = (np.abs(got - full) <= 1e-10 * np.maximum(1, np.abs(full))) | (
                    np.abs(got - cold) <= 1e-10 * np.maximum(1, np.abs(cold)))
                if not ok.all():
                    bad.append((seed, np.flatnonzero(~ok).tolist()))

        prev = sys.getswitchinterval()
        sys.setswitchinterval(1e-6)
        try:
            threads = [threading.Thread(target=worker, args=(i,), name=f"scorer-{i}")
                       for i in range(12)]
            for t in threads:
                t.start()
            _join(threads, timeout=120)
        finally:
            sys.setswitchinterval(prev)
        cached.close()
        assert not bad, bad
        snap = cached.stats.snapshot()["cache"]
        assert snap["promotions"] > 4 and snap["demotions"] > 0 and snap["hits"] > 0

    def test_cache_alone_on_the_cpu(self):
        cache = TieredEntityCache("k", num_entities=5, capacity=2, worker=False, device="cpu")
        cache.add_table("c", "values", np.arange(10.0).reshape(5, 2))
        cache.seal()
        slots = cache.translate(np.asarray([0, 4, -1, 1], np.int32))
        assert slots[0] >= 0 and slots[1] == -1 and slots[2] == -1 and slots[3] >= 0
        assert cache.promote_pending() == 1
        tier = cache.device_tables()[("c", "values")]
        np.testing.assert_array_equal(tier[cache.slot_of[4]].numpy(), [8.0, 9.0])


# ---------------------------------------------------------------------------
# the serve protocol
# ---------------------------------------------------------------------------


def _port_registry(root, **kw):
    reg = ModelRegistry(warmup_max_batch=8, **CPU, **kw)
    reg.load(root)
    return reg


class TestServeStream:
    def test_serve_lines_json_protocol(self, tmp_path):
        reg = _port_registry(_save_disk_model(str(tmp_path / "m")))
        batcher = MicroBatcher(reg.score, max_wait_ms=0.5, stats=reg.stats)
        lines = [
            json.dumps({"features": {"uf0": 1.0}, "entities": {"userId": "u0"}}),
            json.dumps({"features": {"uf1": 2.0}, "offset": 1.0}),
            json.dumps({"cmd": "version"}),
            json.dumps({"cmd": "stats"}),
            "this is not json",
            json.dumps({"cmd": "nope"}),
            json.dumps({"cmd": "health"}),
            json.dumps({"cmd": "feedback", "label": 1, "score": 0.5}),
            json.dumps({"cmd": "drift"}),
            json.dumps({"cmd": "tenants"}),
            json.dumps({"features": "no"}),
        ]
        out = StringIO()
        scored = port_serve.serve_lines(iter(lines), out, batcher, reg, reg.stats)
        assert batcher.drain()
        replies = [json.loads(s) for s in out.getvalue().splitlines()]
        assert scored == 2
        expect0 = reg.score([ScoreRequest({"uf0": 1.0}, {"userId": "u0"})])[0]
        assert abs(replies[0]["score"] - expect0) < 1e-9
        assert abs(replies[1]["score"] - (2.0 * 2 + 1.0)) < 1e-9
        assert replies[2] == {"version": "m"}
        assert "request_latency" in replies[3] and "qps" in replies[3]
        assert "bad JSON" in replies[4]["error"]
        assert "unknown cmd" in replies[5]["error"]
        assert replies[6]["version"] == "m" and replies[6]["breaker"]["state"] == "closed"
        assert "item 5" in replies[7]["error"] and "item 5" in replies[8]["error"]
        assert "item 10" in replies[9]["error"]
        assert "'features' must be an object" in replies[10]["error"]

    def test_interactive_client_gets_prompt_reply(self, tmp_path):
        engine = ScoringEngine.from_model_dir(_save_disk_model(str(tmp_path / "m")), **CPU)
        batcher = MicroBatcher(engine.score, max_wait_ms=0.5)

        class Out:
            def __init__(self):
                self.lines = []
                self.got_reply = threading.Event()

            def write(self, s):
                self.lines.append(s)
                self.got_reply.set()

            def flush(self):
                pass

        out = Out()

        def client_lines():
            yield json.dumps({"features": {"uf0": 1.0}})
            if not out.got_reply.wait(timeout=10):
                raise AssertionError("no reply to the first request before the second was sent")
            yield json.dumps({"features": {"uf1": 1.0}})

        assert port_serve.serve_lines(client_lines(), out, batcher) == 2
        assert batcher.drain()
        replies = [json.loads(s) for s in out.lines]
        assert abs(replies[0]["score"] - 1.0) < 1e-9 and abs(replies[1]["score"] - 2.0) < 1e-9

    def test_metrics_command_equals_jax_cli(self, tmp_path):
        """The serving registry's Prometheus text after the same lines on
        the same model, held to the JAX CLI's: the same metric names and
        types, and the same values but for timings (the latency
        histograms' sums and buckets, qps, uptime, the build/compile
        counters' own names)."""
        root = _save_disk_model(str(tmp_path / "m"), package="jax")
        lines = [json.dumps({"features": {"uf0": 1.0}, "entities": {"userId": "u1"}}),
                 json.dumps({"features": {"uf2": 2.0}, "offset": 0.5}),
                 json.dumps({"cmd": "metrics"})]

        def run(serve_mod, reg):
            b = (MicroBatcher if serve_mod is port_serve else JaxMicroBatcher)(
                reg.score, max_batch=1, max_wait_ms=0.5, stats=reg.stats)
            out = StringIO()
            serve_mod.serve_lines(iter(lines[:2]), out, b, reg, reg.stats)
            assert b.drain()
            replies = [json.loads(s) for s in out.getvalue().splitlines()]
            text = serve_mod.make_admin_handler(b, reg, reg.stats)({"cmd": "metrics"})
            return [r["score"] for r in replies], reg.stats.registry.to_prometheus(), text

        jreg = JaxModelRegistry(warmup_max_batch=8, dtype=jnp.float64)
        jreg.load(root)
        j_scores, j_text, j_full = run(jax_serve, jreg)
        p_scores, p_text, p_full = run(port_serve, _port_registry(root))
        _close(p_scores, j_scores)
        assert p_full["prometheus"].startswith(p_text) and "photon_serving_requests" in p_text

        def parse(text):
            out = {}
            for line in text.splitlines():
                if not line or line.startswith("# HELP"):
                    continue
                key, _, value = line.rpartition(" ")
                out[key] = value
            return out

        timing = ("_ms", "qps", "uptime", "slo")
        j, p = parse(j_text), parse(p_text)
        assert sorted(p) == sorted(j)
        for key in j:
            if not any(t in key for t in timing):
                assert p[key] == j[key], key
        assert p["photon_serving_requests"] == "2" and p["photon_serving_batches"] == "2"


class TestServeMain:
    def test_main_over_a_pipe_on_the_cpu(self, tmp_path):
        """``python -m photon_ml_tpu_torch.cli.serve --device cpu`` end to
        end: scores equal the engine's, the commands answer, stdin's end
        drains and exits 0, and the stats file is written."""
        root = _save_disk_model(str(tmp_path / "m"))
        reqs = [{"features": {"uf0": 1.0, "uf1": 0.5}, "entities": {"userId": "u3"}},
                {"features": {"uf2": 2.0}, "entities": {"userId": "nobody"}, "offset": 1.0}]
        lines = [json.dumps(r) for r in reqs] + [json.dumps({"cmd": c}) for c in
                                                 ("stats", "metrics", "health", "slo")]
        stats_json = str(tmp_path / "stats.json")
        proc = subprocess.run(
            [sys.executable, "-m", "photon_ml_tpu_torch.cli.serve", "--model-dir", root,
             "--device", "cpu", "--dtype", "float64", "--max-wait-ms", "0.5",
             "--stats-json", stats_json],
            input="\n".join(lines) + "\n", capture_output=True, text=True, timeout=120,
            cwd=ROOT, env={**os.environ, "PYTHONPATH": ROOT},
        )
        assert proc.returncode == 0, proc.stderr
        replies = [json.loads(s) for s in proc.stdout.splitlines()]
        engine = ScoringEngine.from_model_dir(root, **CPU)
        _close([r["score"] for r in replies[:2]],
               engine.score([ScoreRequest(r["features"], r["entities"], r.get("offset", 0.0))
                             for r in reqs]))
        assert "qps" in replies[2] and "photon_serving_requests" in replies[3]["prometheus"]
        assert replies[4]["version"] == "m" and "p99_ms" in replies[5]
        assert json.load(open(stats_json))["requests"] == 2

    def test_sigterm_drains_and_exits_clean(self, tmp_path):
        """SIGTERM reaches the batcher through the port's
        ``GracefulShutdown.register_drain``: the answered request stays
        answered, the next line is not read as work, and the process
        exits 0 with its stats written."""
        import signal

        root = _save_disk_model(str(tmp_path / "m"))
        stats_json = str(tmp_path / "stats.json")
        proc = subprocess.Popen(
            [sys.executable, "-m", "photon_ml_tpu_torch.cli.serve", "--model-dir", root,
             "--device", "cpu", "--max-wait-ms", "0.5", "--stats-json", stats_json],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            cwd=ROOT, env={**os.environ, "PYTHONPATH": ROOT},
        )
        try:
            proc.stdin.write(json.dumps({"features": {"uf0": 1.0}}) + "\n")
            proc.stdin.flush()
            assert abs(json.loads(proc.stdout.readline())["score"] - 1.0) < 1e-9
            proc.send_signal(signal.SIGTERM)
            proc.stdin.write(json.dumps({"features": {"uf1": 1.0}}) + "\n")
            proc.stdin.flush()
            out, err = proc.communicate(timeout=60)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        assert proc.returncode == 0, err
        assert out == "" and "received SIGTERM" in err
        assert json.load(open(stats_json))["requests"] == 1

    @pytest.mark.parametrize("flag", [["--frontend-port", "0"], ["--tenant", "{}"],
                                      ["--replicas", "2"], ["--serving-shards", "2"]])
    def test_unported_flags_are_refused(self, flag, capsys):
        with pytest.raises(SystemExit) as exc:
            port_serve.main(["--model-dir", "unused", *flag])
        assert exc.value.code == 2
        err = capsys.readouterr().err
        assert f"{flag[0]} is not ported" in err and "ROADMAP.md queue A item" in err
