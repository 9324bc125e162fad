"""The port's entity-sharded serving (``photon_ml_tpu_torch/serving/
sharding.py``) against the JAX package, on the CPU in float64:

- ``route_batch`` field for field equal to the JAX function at 1, 2, 3 and
  4 shards, with cold rows, requests whose entities span shards and a
  faulted shard; ``RoutedBatch.merge`` and the routed arrays, and
  ``shard_compact_table``, equal to JAX's;
- ``load_sharded_re_table`` / ``iter_checkpoint_re_blocks`` equal to JAX's
  on shard sets written by either package's writer, at serving shard
  counts other than the checkpoint's and with ``only_shard``;
- the sharded engine (dense fixed effects, plain, compact and factored
  random effects, cold rows; an ELL fixed effect held to the JAX offline
  scorer on the ELL shard) within 1e-10 * max(1, |s|) of the JAX unsharded
  ``ScoringEngine``; a faulted shard's entities score fixed-effect-only;
  no build after warmup;
- the registry's hot reload under load at ``serving_shards`` 2, the engine
  stood up from a sharded checkpoint, and ``cli.serve --serving-shards 2``
  over a pipe.

The JAX ``ShardedScoringEngine`` itself needs ``shard_map(check_rep=)``,
which the JAX on this machine no longer takes, so the JAX unsharded engine
(whose equality is that engine's own contract) is the oracle; the JAX host
pieces above never reach ``shard_map`` and are compared directly.
"""

import json
import os
import subprocess
import sys
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_ml_tpu.game import data as jdata
from photon_ml_tpu.game import scoring as jscoring
from photon_ml_tpu.game.factored import FactoredParams as JFactoredParams
from photon_ml_tpu.io import checkpoint as jckpt
from photon_ml_tpu.ops.sparse import SparseFeatures as JSparseFeatures
from photon_ml_tpu.resilience import faults as jfaults
from photon_ml_tpu.serving import engine as jengine
from photon_ml_tpu.serving import sharding as jsharding
from photon_ml_tpu_torch.cli import serve as port_serve
from photon_ml_tpu_torch.game import data as tdata
from photon_ml_tpu_torch.game import scoring as tscoring
from photon_ml_tpu_torch.game.factored import FactoredParams
from photon_ml_tpu_torch.io import checkpoint as tckpt
from photon_ml_tpu_torch.resilience import faults as tfaults
from photon_ml_tpu_torch.serving import (
    MicroBatcher,
    ModelRegistry,
    ScoreRequest,
    ScoringEngine,
    ShardedScoringEngine,
    bucket_builds,
    iter_checkpoint_re_blocks,
    load_sharded_re_table,
    route_batch,
)
from photon_ml_tpu_torch.serving import sharding as tsharding

from test_torch_serving import _save_disk_model

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = {"device": "cpu"}
N_USERS, N_ITEMS, D_G, D_U, D_I, LATENT = 23, 17, 5, 4, 3, 2


def _close(got, want):
    """Within 1e-10 * max(1, |s|) per score."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.all(np.abs(got - want) <= 1e-10 * np.maximum(1.0, np.abs(want))), (
        np.max(np.abs(got - want)))


def _model(rng):
    """tests/test_serving_sharded.py's model in both packages: two RE keys
    (userId, itemId) so that requests span shards, and a factored
    coordinate sharing the user key."""
    raw = {
        "global": rng.normal(size=D_G),
        "per-user": rng.normal(size=(N_USERS, D_U)) * (rng.uniform(size=(N_USERS, D_U)) < 0.5),
        "per-item": rng.normal(size=(N_ITEMS, D_I)),
        "gamma": rng.normal(size=(N_USERS, LATENT)),
        "projection": rng.normal(size=(D_U, LATENT)),
    }
    jax_params = {k: raw[k] for k in ("global", "per-user", "per-item")}
    jax_params["fact"] = JFactoredParams(gamma=jnp.asarray(raw["gamma"]),
                                         projection=jnp.asarray(raw["projection"]))
    port_params = {k: raw[k] for k in ("global", "per-user", "per-item")}
    port_params["fact"] = FactoredParams(gamma=torch.from_numpy(raw["gamma"]),
                                         projection=torch.from_numpy(raw["projection"]))
    shards = {"global": "g", "per-user": "u", "per-item": "i", "fact": "u"}
    res = {"global": None, "per-user": "userId", "per-item": "itemId", "fact": "userId"}
    return jax_params, port_params, shards, res


def _batch(rng, n, cold_every=5):
    feats = {"g": rng.normal(size=(n, D_G)), "u": rng.normal(size=(n, D_U)),
             "i": rng.normal(size=(n, D_I))}
    users = rng.integers(0, N_USERS, size=n).astype(np.int32)
    items = rng.integers(0, N_ITEMS, size=n).astype(np.int32)
    users[::cold_every] = -1
    items[1::cold_every] = -1
    return feats, {"userId": users, "itemId": items}


def _assignments(pkg, P):
    return {"userId": pkg.entity_shard_assignment(N_USERS, P),
            "itemId": pkg.entity_shard_assignment(N_ITEMS, P)}


def _same_plan(got, want):
    for f in ("num_rows", "num_shards", "bucket", "down_shards", "degraded_rows"):
        assert getattr(got, f) == getattr(want, f), f
    for f in ("p_row", "p_shard", "p_slot", "fixed_mask", "counts"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)
    assert sorted(got.ents) == sorted(want.ents)
    for rk in want.ents:
        np.testing.assert_array_equal(got.ents[rk], want.ents[rk], err_msg=rk)


# -- routing -------------------------------------------------------------------


@pytest.mark.parametrize("P", [1, 2, 3, 4])
def test_route_batch_equals_jax(rng, P):
    """Cold rows, all-cold rows, rows whose user and item live on different
    shards, a missing key: every field, the routed arrays and the merge."""
    _, ents = _batch(rng, 64)
    ents["userId"][3] = ents["itemId"][3] = -1  # an all-cold row
    ents["userId"][7] = N_USERS + 5  # an id past the table scores cold
    for case in (ents, {"userId": ents["userId"]}):
        want = jsharding.route_batch(case, _assignments(jdata, P), 64, P)
        got = route_batch(case, _assignments(tdata, P), 64, P)
        _same_plan(got, want)
        feats = {"u": rng.normal(size=(64, D_U))}
        np.testing.assert_array_equal(got.scatter_feats(feats, np.float64)["u"],
                                      want.scatter_feats(feats, np.float64)["u"])
        for rk, routed in want.routed_entities().items():
            np.testing.assert_array_equal(got.routed_entities()[rk], routed)
        np.testing.assert_array_equal(got.routed_fixed_mask(np.float64),
                                      want.routed_fixed_mask(np.float64))
        partials = rng.normal(size=(P, want.bucket))
        np.testing.assert_array_equal(got.merge(partials), want.merge(partials))
    spans = route_batch(ents, _assignments(tdata, P), 64, P)
    assert (np.bincount(spans.p_row) > 1).any() == (P > 1)  # requests span shards


@pytest.mark.parametrize("P", [1, 2, 3, 4])
def test_route_batch_with_a_faulted_shard_equals_jax(rng, P):
    _, ents = _batch(rng, 40, cold_every=1000)
    victim = P - 1
    with jfaults.inject(jfaults.FaultSpec("serving.shard_route", "raise", nth=1, count=-1,
                                          key=str(victim))):
        want = jsharding.route_batch(ents, _assignments(jdata, P), 40, P)
    with tfaults.inject(tfaults.FaultSpec("serving.shard_route", "raise", nth=1, count=-1,
                                          key=str(victim))):
        got = route_batch(ents, _assignments(tdata, P), 40, P)
    _same_plan(got, want)
    assert got.down_shards == (victim,) and got.degraded_rows > 0


def test_shard_compact_table_equals_jax(rng):
    table = rng.normal(size=(10, 5)) * (rng.uniform(size=(10, 5)) < 0.5)
    cols, vals = jscoring._compact_table(table)
    for P in (1, 3, 4):
        want = jscoring.shard_compact_table(jscoring.CompactReTable(cols, vals),
                                            jdata.entity_shard_assignment(10, P))
        got = tscoring.shard_compact_table(tscoring.CompactReTable(cols, vals),
                                           tdata.entity_shard_assignment(10, P))
        np.testing.assert_array_equal(got.columns, np.asarray(want.columns))
        np.testing.assert_array_equal(got.values, np.asarray(want.values))


# -- sharded-checkpoint loaders ---------------------------------------------------


def _write_ckpt(tmp_path, rng, writer, n_users=21, d_u=4, ckpt_shards=3):
    table = rng.normal(size=(n_users, d_u)) * (rng.uniform(size=(n_users, d_u)) < 0.6)
    fixed = rng.normal(size=3)
    keys = [f"u{i:03d}" for i in range(n_users)]
    params = {"global": fixed, "per-user": table}
    directory = str(tmp_path / f"ckpt-{writer}")
    if writer == "jax":
        step_dir = jckpt.save_checkpoint_sharded(
            directory, step=5, params=params, rng_key=jax.random.PRNGKey(0),
            entity_keys={"per-user": keys}, num_shards=ckpt_shards)
    else:
        step_dir = tckpt.save_checkpoint_sharded(
            directory, 5, params, tckpt.jax_prng_key(0), entity_keys={"per-user": keys},
            num_shards=ckpt_shards)
    return step_dir, fixed, table, keys


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoint_loaders_equal_jax(rng, tmp_path, writer):
    step_dir, _, table, keys = _write_ckpt(tmp_path, rng, writer)
    blocks = list(iter_checkpoint_re_blocks(step_dir, "per-user"))
    jblocks = list(jsharding.iter_checkpoint_re_blocks(step_dir, "per-user"))
    assert len(blocks) == len(jblocks) == 3
    for (rows, block), (jrows, jblock) in zip(blocks, jblocks):
        np.testing.assert_array_equal(rows, jrows)
        np.testing.assert_array_equal(block, jblock)
    for serve in (2, 4):
        got, got_keys = load_sharded_re_table(step_dir, "per-user", serve)
        want, want_keys = jsharding.load_sharded_re_table(step_dir, "per-user", serve)
        assert got_keys == want_keys == keys
        np.testing.assert_array_equal(got.columns, want.columns)
        np.testing.assert_array_equal(got.values, want.values)
        np.testing.assert_array_equal(got.assignment.stored_to_global,
                                      want.assignment.stored_to_global)
        for q in range(serve):
            g, _ = load_sharded_re_table(step_dir, "per-user", serve, only_shard=q)
            w, _ = jsharding.load_sharded_re_table(step_dir, "per-user", serve, only_shard=q)
            np.testing.assert_array_equal(g.columns, w.columns)
            np.testing.assert_array_equal(g.values, w.values)
    with pytest.raises(ValueError, match="not entity-sharded"):
        load_sharded_re_table(step_dir, "global", 2)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_engine_from_sharded_checkpoint_equals_jax_unsharded(rng, tmp_path, writer):
    step_dir, fixed, table, keys = _write_ckpt(tmp_path, rng, writer)
    shards = {"global": "g", "per-user": "u"}
    res = {"global": None, "per-user": "userId"}
    n = 19
    feats = {"g": rng.normal(size=(n, 3)), "u": rng.normal(size=(n, 4))}
    ents = {"userId": rng.integers(-1, len(keys), size=n).astype(np.int32)}
    want = jengine.ScoringEngine({"global": fixed, "per-user": table}, shards, res,
                                 dtype=jnp.float64).score_arrays(feats, ents)
    for serve in (2, 3):
        eng = ShardedScoringEngine.from_sharded_checkpoint(step_dir, shards, res,
                                                           num_shards=serve, **CPU)
        assert eng.re_vocabs["userId"]["u007"] == 7
        _close(eng.score_arrays(feats, ents), want)


# -- the engine ----------------------------------------------------------------


@pytest.mark.parametrize("P", [1, 2, 3, 4])
def test_sharded_engine_equals_jax_unsharded(rng, P):
    jp, tp, shards, res = _model(rng)
    feats, ents = _batch(rng, 37)
    base = jengine.ScoringEngine(jp, shards, res, dtype=jnp.float64)
    want = base.score_arrays(feats, ents)
    offs = rng.normal(size=37)
    compact = tscoring.precompact_model(tp)
    for params in (tp, compact):
        eng = ShardedScoringEngine(params, shards, res, num_shards=P, **CPU)
        _close(eng.score_arrays(feats, ents), want)
        # offsets apply once per request, not once per placement
        _close(eng.score_arrays(feats, ents, offs), want + offs)
    # all-cold rows score the fixed effect alone
    cold = {k: np.full_like(v, -1) for k, v in ents.items()}
    _close(eng.score_arrays(feats, cold), base.score_arrays(feats, cold, fixed_only=True))
    _close(eng.score_arrays(feats, ents, fixed_only=True),
           base.score_arrays(feats, ents, fixed_only=True))


def test_blocks_sharing_a_device_score_as_one_group(rng):
    """Devices that repeat make one group (one gather and dot over their
    blocks); the split over devices does not change a score."""
    jp, tp, shards, res = _model(rng)
    feats, ents = _batch(rng, 29)
    want = jengine.ScoringEngine(jp, shards, res, dtype=jnp.float64).score_arrays(feats, ents)
    one = ShardedScoringEngine(tp, shards, res, num_shards=4, devices=["cpu"] * 4)
    assert len(one._groups) == 1 and one._groups[0][1].tolist() == [0, 1, 2, 3]
    _close(one.score_arrays(feats, ents), want)
    # the blocks of one device are rows [0, 4R) of the stored table, in order
    a = one.assignments["userId"]
    stored = tscoring.shard_compact_table(tscoring.precompact_model(tp)["per-user"], a)
    np.testing.assert_array_equal(one._group_params[0]["per-user"].columns.numpy(),
                                  stored.columns)
    with pytest.raises(ValueError, match="4 serving shards need 4 devices"):
        ShardedScoringEngine(tp, shards, res, num_shards=4, devices=["cpu"] * 3)


def test_ell_fixed_effect_equals_jax_offline(rng):
    """A fixed effect trained on an ELL shard: the engine featurizes it
    densely, and its scores equal the JAX offline scorer's on the ELL
    shard."""
    jp, tp, shards, res = _model(rng)
    feats, ents = _batch(rng, 24)
    g = feats["g"] * (rng.uniform(size=feats["g"].shape) < 0.5)
    feats["g"] = g
    k = max(int((g != 0).sum(axis=1).max()), 1)
    idx = np.full((24, k), D_G, np.int32)
    vals = np.zeros((24, k))
    for r in range(24):
        nz = np.flatnonzero(g[r])
        idx[r, :nz.size] = nz
        vals[r, :nz.size] = g[r, nz]
    ell = JSparseFeatures(indices=jnp.asarray(idx), values=jnp.asarray(vals), d=D_G)
    data = jdata.GameData.create({**feats, "g": ell}, np.zeros(24), entity_ids=ents)
    want = np.asarray(jscoring.score_game_data(jp, shards, res, data, dtype=jnp.float64))
    for P in (2, 4):
        _close(ShardedScoringEngine(tp, shards, res, num_shards=P, **CPU).score_arrays(
            feats, ents), want)


def test_faulted_shard_scores_its_entities_fixed_only(rng):
    jp, tp, shards, res = _model(rng)
    eng = ShardedScoringEngine(tp, shards, res, num_shards=4, **CPU)
    base = jengine.ScoringEngine(jp, shards, res, dtype=jnp.float64)
    feats, ents = _batch(rng, 32, cold_every=1000)
    exact = base.score_arrays(feats, ents)
    victim = 2
    u_hit = eng.assignments["userId"].owner_of_global(ents["userId"]) == victim
    i_hit = eng.assignments["itemId"].owner_of_global(ents["itemId"]) == victim
    with tfaults.inject(tfaults.FaultSpec("serving.shard_route", "raise", nth=1, count=-1,
                                          key=str(victim))):
        got = eng.score_arrays(feats, ents)
    # exactly the victim's entities lose their coordinates
    _close(got, base.score_arrays(feats, {"userId": np.where(u_hit, -1, ents["userId"]),
                                          "itemId": np.where(i_hit, -1, ents["itemId"])}))
    assert (u_hit | i_hit).any() and not (u_hit | i_hit).all()
    assert eng.stats.registry.counter("serving.shard.degraded_rows").value > 0
    _close(eng.score_arrays(feats, ents), exact)  # the next batch is whole


def test_no_build_after_warmup_and_resident_bytes_drop(rng):
    jp, tp, shards, res = _model(rng)
    eng = ShardedScoringEngine(tp, shards, res, num_shards=4, **CPU)
    eng.warmup(max_batch=64)
    warm, builds = eng.compile_count, bucket_builds()
    for n in (1, 3, 7, 8, 15, 16, 33, 64, 5, 40, 2, 63):
        feats, ents = _batch(rng, n, cold_every=3)
        eng.score_arrays(feats, ents)
    assert eng.compile_count == warm and bucket_builds() == builds
    snap = eng.stats.snapshot()
    assert snap["shards"] and snap["resident_re_bytes_per_process"] > 0
    full = ScoringEngine(tp, shards, res, **CPU).stats.registry.gauge(
        "serving.shard.resident_re_bytes_per_process").value
    prev = full
    for P in (2, 4, 8):
        cur = ShardedScoringEngine(tp, shards, res, num_shards=P, **CPU).stats.registry.gauge(
            "serving.shard.resident_re_bytes_per_process").value
        assert cur < prev and cur <= full / P * 1.5
        prev = cur


def test_cache_refusal_and_presort_key_equal_jax(rng):
    jp, tp, shards, res = _model(rng)
    with pytest.raises(ValueError) as want:
        jsharding.ShardedScoringEngine(jp, shards, res, num_shards=2, hbm_cache_entities=4)
    with pytest.raises(ValueError) as got:
        ShardedScoringEngine(tp, shards, res, num_shards=2, hbm_cache_entities=4, **CPU)
    assert str(got.value) == str(want.value)
    from photon_ml_tpu_torch.io.vocab import FeatureVocabulary, feature_key

    kw = dict(shards={"global": "g", "per-user": "u"},
              random_effects={"global": None, "per-user": "userId"},
              shard_vocabs={"g": FeatureVocabulary([feature_key("g0", ""), feature_key("g1", "")]),
                            "u": FeatureVocabulary([feature_key(f"u{j}", "") for j in range(3)])},
              re_vocabs={"userId": {f"user{i}": i for i in range(16)}})
    eng = ShardedScoringEngine({"global": rng.normal(size=2),
                                "per-user": rng.normal(size=(16, 3))}, num_shards=4, **kw, **CPU)
    order = (7, 0, 13, 2, 9, 4)
    reqs = [ScoreRequest(features={"u0": 1.0}, entities={"userId": f"user{i}"}) for i in order]
    a = jdata.entity_shard_assignment(16, 4)
    assert eng.shard_presort_key(reqs).tolist() == [
        int(a.owner_of_global(np.asarray([i]))[0]) for i in order]
    # the batcher groups a flushed batch by owner shard and keeps futures aligned
    seen = []

    def score_fn(requests):
        seen.append([r.entities["userId"] for r in requests])
        return eng.score(requests)

    batcher = MicroBatcher(score_fn, max_batch=len(reqs), max_wait_ms=50.0,
                           presort_fn=eng.shard_presort_key, auto_start=False)
    futs = [batcher.submit(r) for r in reqs]
    batcher.start()
    direct = {r.entities["userId"]: eng.score([r])[0] for r in reqs}
    for r, f in zip(reqs, futs):
        assert abs(f.result(timeout=30) - direct[r.entities["userId"]]) < 1e-12
    assert batcher.drain(timeout=5.0)
    owners = [int(a.owner_of_global(np.asarray([int(u[4:])]))[0]) for u in seen[0]]
    assert len(seen[0]) == len(reqs) and owners == sorted(owners)


# -- the registry and the CLI --------------------------------------------------


def test_sharded_registry_hot_reload_under_load_drops_nothing(tmp_path):
    root_a = _save_disk_model(str(tmp_path / "v1"), scale=1.0)
    root_b = _save_disk_model(str(tmp_path / "v2"), scale=3.0)
    reg = ModelRegistry(warmup_max_batch=16, serving_shards=2, **CPU)
    v1 = reg.load(root_a)
    assert isinstance(v1.engine, ShardedScoringEngine)
    probe = ScoreRequest(features={"uf0": 1.0, "uf2": 0.5}, entities={"userId": "u2"})
    s_a = reg.score([probe])[0]
    jprobe = jengine.ScoreRequest(features=probe.features, entities=probe.entities)
    j_a = jengine.ScoringEngine.from_model_dir(root_a, dtype=jnp.float64).score([jprobe])[0]
    j_b = jengine.ScoringEngine.from_model_dir(root_b, dtype=jnp.float64).score([jprobe])[0]
    assert abs(s_a - j_a) <= 1e-10 * max(1.0, abs(j_a)) and abs(j_a - j_b) > 1e-6
    batcher = MicroBatcher(reg.score, max_batch=16, max_wait_ms=0.5, stats=reg.stats)
    results = [[] for _ in range(4)]
    errors = []

    def client(ci):
        try:
            for _ in range(30):
                results[ci].append(batcher.submit(probe).result(timeout=30))
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    threads = [threading.Thread(target=client, args=(ci,)) for ci in range(4)]
    for t in threads:
        t.start()
    time.sleep(0.02)
    reg.load(root_b)  # the hot reload swaps the whole shard set
    for t in threads:
        t.join(60)
    assert batcher.drain()
    assert not errors, errors
    flat = [s for chunk in results for s in chunk]
    assert len(flat) == 120, "requests were dropped"
    for s in flat:
        assert min(abs(s - j_a), abs(s - j_b)) <= 1e-10 * max(1.0, abs(s))
    assert reg.version() == "v2" and v1.retired and v1.engine is None
    assert reg.health()["serving_shards"] == 2


def test_cli_serving_shards_answers_with_the_engine_scores(tmp_path):
    root = _save_disk_model(str(tmp_path / "m"), n_users=6)
    lines = [{"features": {"uf0": 1.0, "uf1": -0.5}, "entities": {"userId": f"u{i}"},
              "offset": 0.25 * i} for i in range(8)]
    lines.append({"features": {"uf2": 2.0}, "entities": {"userId": "nobody"}})
    proc = subprocess.run(
        [sys.executable, "-m", "photon_ml_tpu_torch.cli.serve", "--model-dir", root,
         "--device", "cpu", "--serving-shards", "2", "--max-wait-ms", "0.5"],
        input="".join(json.dumps(x) + "\n" for x in lines), capture_output=True, text=True,
        cwd=ROOT, env={**os.environ, "PYTHONPATH": ROOT}, timeout=120)
    assert proc.returncode == 0, proc.stderr
    replies = [json.loads(s) for s in proc.stdout.splitlines()]
    jeng = jengine.ScoringEngine.from_model_dir(root, dtype=jnp.float64)
    want = jeng.score([jengine.ScoreRequest(features=x["features"], entities=x["entities"],
                                            offset=x.get("offset", 0.0)) for x in lines])
    _close([r["score"] for r in replies], want)


def test_cli_refuses_the_cache_on_a_sharded_engine_as_jax(tmp_path, capsys):
    from photon_ml_tpu.cli import serve as jax_serve

    argv = ["--model-dir", "unused", "--serving-shards", "2", "--hbm-cache-entities", "4"]
    with pytest.raises(SystemExit) as exc:
        port_serve.main(argv)
    got = capsys.readouterr().err.splitlines()[-1]
    with pytest.raises(SystemExit) as jexc:
        jax_serve.main(argv)
    want = capsys.readouterr().err.splitlines()[-1]
    assert exc.value.code == jexc.value.code == 2
    assert got.split(": error: ")[1] == want.split(": error: ")[1]


def test_exports_equal_jax():
    from photon_ml_tpu import serving as jserving
    from photon_ml_tpu_torch import serving as tserving

    for name in ("RoutedBatch", "ShardedCompactTable", "ShardedScoringEngine",
                 "load_sharded_re_table", "route_batch"):
        assert name in jserving.__all__ and name in tserving.__all__
    assert tsharding.CACHE_REFUSAL.startswith("the tiered HBM/host cache")
