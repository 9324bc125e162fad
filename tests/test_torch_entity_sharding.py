"""The port's entity-sharded GAME against the JAX package's, on the CPU in
float64: the entity layout (``game.data``) equal to the JAX arrays exactly,
dense and ELL; one ``EntityShardedRandomEffectCoordinate`` update in gloo
worlds of 2 and 4 ranks (``torch_worlds.run_world``) equal within 1e-10 to
the JAX random-effect update of every lane on the same entity-partitioned
rows, with no collective in the update; the GAME driver with
``entity_shards`` 2 and 4 equal to the JAX unsharded driver, dense and with
an ELL fixed effect; the multi-process branch (2 ranks on 2 of 4
entity-partitioned part files each) equal to the JAX single-process driver
on all 4; and each refusal with the JAX package's message.

The JAX package's own entity-sharded coordinate and driver do not run with
the JAX of this machine (they pass ``check_rep`` to ``shard_map``, which it
no longer takes); their contract is equality with the unsharded path, which
is what these tests hold the port to."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_worlds import run_world

from photon_ml_tpu.cli import config as jconfig
from photon_ml_tpu.cli import game_train as jgame
from photon_ml_tpu.game import coordinates as jcoords
from photon_ml_tpu.game import data as jdata
from photon_ml_tpu.io.avro import write_avro_file
from photon_ml_tpu.io.checkpoint import shard_rows as jax_shard_rows
from photon_ml_tpu.io.schemas import TRAINING_EXAMPLE_SCHEMA
from photon_ml_tpu.models.training import OptimizerType as JOpt
from photon_ml_tpu.ops.sparse import from_dense as jax_from_dense
from photon_ml_tpu_torch.cli import config as tconfig
from photon_ml_tpu_torch.cli import game_train as tgame
from photon_ml_tpu_torch.game import data as tdata
from photon_ml_tpu_torch.io import checkpoint as tckpt
from photon_ml_tpu_torch.ops.sparse import from_dense, to_hybrid

from test_torch_game_train import D_G, D_U, N_USERS, _params, _records

N, DG, DU, E = 400, 6, 3, 23


def _args(seed=5):
    rng = np.random.default_rng(seed)
    xg = rng.normal(size=(N, DG))
    xg[rng.uniform(size=xg.shape) < 0.4] = 0.0
    xg[:, -1] = 1.0
    xu = rng.normal(size=(N, DU))
    xu[:, -1] = 1.0
    ents = (rng.zipf(1.4, N) - 1) % E
    ents[::13] = -1
    labels = (rng.uniform(size=N) < 0.35).astype(float)
    offsets = rng.normal(size=N) * 0.2
    weights = rng.uniform(0.5, 2.0, N)
    return ({"g": xg, "u": xu}, labels, offsets, weights, {"uid": ents}), rng


@pytest.mark.parametrize("shards", [1, 2, 3, 4, 8])
def test_assignment_equals_jax(shards):
    ja = jdata.entity_shard_assignment(E, shards)
    ta = tdata.entity_shard_assignment(E, shards)
    assert (ta.num_entities, ta.num_shards, ta.rows_per_shard) == (
        ja.num_entities, ja.num_shards, ja.rows_per_shard)
    np.testing.assert_array_equal(ta.stored_to_global, ja.stored_to_global)
    np.testing.assert_array_equal(ta.global_to_stored, ja.global_to_stored)
    ents = np.arange(E)
    np.testing.assert_array_equal(ta.owner_of_global(ents), ja.owner_of_global(ents))
    np.testing.assert_array_equal(ta.local_of_global(ents), ja.local_of_global(ents))
    keys = [f"user:{i}" for i in range(E)]
    assert ta.stored_entity_keys(keys) == ja.stored_entity_keys(keys)
    table = np.random.default_rng(shards).normal(size=(E, 3))
    stored = ta.table_from_global(table)
    np.testing.assert_array_equal(stored, ja.table_from_global(table))
    np.testing.assert_array_equal(ta.table_to_global(stored), ja.table_to_global(stored))
    np.testing.assert_array_equal(ta.table_to_global(torch.from_numpy(stored)).numpy(), table)
    with pytest.raises(ValueError, match="entity keys"):
        ta.stored_entity_keys(keys[:-1])


def test_shard_layout_is_the_checkpoint_rule():
    """Shard p's stored block holds exactly the rows ``shard_rows`` gives
    it, in the JAX package's checkpoint rule too."""
    from photon_ml_tpu_torch.io.checkpoint import shard_rows

    for e, p_count in ((17, 4), (16, 4), (5, 8)):
        a = tdata.entity_shard_assignment(e, p_count)
        for p in range(p_count):
            stored = a.stored_to_global[p * a.rows_per_shard:(p + 1) * a.rows_per_shard]
            got = [int(g) for g in stored if g < e]
            assert got == list(shard_rows(e, p, p_count)) == list(jax_shard_rows(e, p, p_count))


def test_contiguous_assignment_owns_blocks_in_rank_order():
    a = tdata.contiguous_entity_assignment([3, 0, 5])
    assert (a.num_entities, a.num_shards, a.rows_per_shard) == (8, 3, 5)
    np.testing.assert_array_equal(a.owner_of_global(np.arange(8)), [0, 0, 0, 2, 2, 2, 2, 2])
    np.testing.assert_array_equal(a.local_of_global(np.arange(8)), [0, 1, 2, 0, 1, 2, 3, 4])
    np.testing.assert_array_equal(a.table_to_global(a.table_from_global(np.arange(8.0))),
                                  np.arange(8.0))


def test_entity_meshes_and_rank_blocks_equal_jax_placement():
    """The entity and GAME meshes of a world of one, and a rank's block of
    an entity-major array and of a bucketed design (the placement of the
    JAX package's ``entity_sharding`` / ``shard_bucketed_design``: shard p
    of a 2-device 'entity' mesh)."""
    import jax

    from photon_ml_tpu.parallel import mesh as jmesh
    from photon_ml_tpu_torch.parallel import (
        entity_block,
        make_entity_mesh,
        make_game_mesh,
        shard_bucketed_design,
    )
    from photon_ml_tpu_torch.parallel.mesh import Mesh, row_axis

    one = make_entity_mesh()
    assert (one.axis_names, one.size, row_axis(one)) == (("entity",), 1, "entity")
    game = make_game_mesh(1, 1)
    assert (game.axis_names, row_axis(game)) == (("data", "entity"), "data")
    args, _ = _args()
    jd = jdata.GameData.create(*args)
    td = tdata.GameData.create(*args)
    jdesign = jmesh.shard_bucketed_design(
        jdata.build_bucketed_random_effect_design(jd, "uid", "u", E, num_buckets=2,
                                                  entity_multiple=2, dtype=jnp.float64),
        jmesh.make_entity_mesh(2, devices=jax.devices()[:2]))
    tdesign = tdata.build_bucketed_random_effect_design(td, "uid", "u", E, num_buckets=2,
                                                        entity_multiple=2, dtype=torch.float64)
    for p in range(2):
        # rank p of a 2-rank 'entity' mesh, as that rank sees it
        mesh = Mesh(("entity",), (2,), {"entity": None}, {"entity": p})
        mine = shard_bucketed_design(tdesign, mesh)
        for jb, tb, jei, tei in zip(jdesign.buckets, mine.buckets, jdesign.entity_index,
                                    mine.entity_index):
            shard = sorted(jb.features.addressable_shards, key=lambda a: a.device.id)[p]
            np.testing.assert_array_equal(tb.features.numpy(), np.asarray(shard.data))
            ei = sorted(jei.addressable_shards, key=lambda a: a.device.id)[p]
            np.testing.assert_array_equal(tei, np.asarray(ei.data))
        x = torch.arange(12.0).reshape(6, 2)
        np.testing.assert_array_equal(entity_block(x, mesh).numpy(), x[3 * p:3 * p + 3].numpy())
    with pytest.raises(ValueError, match="do not shard"):
        entity_block(torch.zeros(5, 2), mesh)


@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "ell"])
@pytest.mark.parametrize("shards", [2, 4])
def test_entity_partition_equals_jax(sparse, shards):
    args, _ = _args()
    feats = dict(args[0])
    jfeats, tfeats = dict(feats), dict(feats)
    if sparse:
        jfeats["g"] = jax_from_dense(feats["g"], dtype=jnp.float64)
        tfeats["g"] = from_dense(feats["g"], dtype=torch.float64)
    jd = jdata.GameData.create(jfeats, *args[1:])
    td = tdata.GameData.create(tfeats, *args[1:])
    ja = jdata.entity_shard_assignment(E, shards)
    ta = tdata.entity_shard_assignment(E, shards)
    jp, jpart = jdata.entity_partition_game_data(jd, "uid", ja)
    tp, tpart = tdata.entity_partition_game_data(td, "uid", ta)
    assert (tpart.num_shards, tpart.rows_per_shard) == (jpart.num_shards, jpart.rows_per_shard)
    np.testing.assert_array_equal(tpart.row_perm, jpart.row_perm)
    rp = tdata.entity_partition_rows(td.entity_ids["uid"], ta)
    np.testing.assert_array_equal(rp.row_perm,
                                  jdata.entity_partition_rows(jd.entity_ids["uid"], ja).row_perm)
    for col in ("labels", "offsets", "weights"):
        np.testing.assert_array_equal(getattr(tp, col), np.asarray(getattr(jp, col)))
    np.testing.assert_array_equal(tp.entity_ids["uid"], np.asarray(jp.entity_ids["uid"]))
    np.testing.assert_array_equal(tp.features["u"], np.asarray(jp.features["u"]))
    if sparse:
        np.testing.assert_array_equal(tp.features["g"].indices.numpy(),
                                      np.asarray(jp.features["g"].indices))
        np.testing.assert_array_equal(tp.features["g"].values.numpy(),
                                      np.asarray(jp.features["g"].values))
        assert tp.features["g"].d == jp.features["g"].d
    else:
        np.testing.assert_array_equal(tp.features["g"], np.asarray(jp.features["g"]))
    np.testing.assert_array_equal(tpart.restore(tp.labels), args[1])
    np.testing.assert_array_equal(tpart.apply(args[1]), tp.labels)


def test_entity_partition_refuses_other_structures():
    args, _ = _args()
    td = tdata.GameData.create(*args)
    hybrid = to_hybrid(from_dense(args[0]["g"], dtype=torch.float64), hot_columns=2)
    odd = tdata.GameData(features={"g": hybrid}, labels=td.labels, offsets=td.offsets,
                         weights=td.weights, entity_ids=td.entity_ids)
    with pytest.raises(ValueError, match="permutes dense or plain-ELL shards; got HybridFeatures"):
        tdata.entity_partition_game_data(odd, "uid", tdata.entity_shard_assignment(E, 2))


# -- the worlds -------------------------------------------------------------------

_RE_CONFIG = dict(shard="u", random_effect="uid", reg_weight=0.1, max_iters=40, tolerance=1e-8)


def _parts(tmp, rng, truth):
    """Four part files whose users are partitioned by parity: a 2-rank
    world's rank r reads parts r and r + 2 (``process_local_paths``), so
    that every user's rows are on one rank."""
    recs = _records(rng, 260, truth)
    paths = []
    for k in range(4):
        mine = [r for i, r in enumerate(recs)
                if (int(r["metadataMap"]["userId"][4:]) if r["metadataMap"] else i) % 2 == k % 2
                and (i // 2) % 2 == k // 2]
        paths.append(str(tmp / f"part-{k}.avro"))
        write_avro_file(paths[-1], TRAINING_EXAMPLE_SCHEMA, mine)
    return paths


@pytest.fixture(scope="module")
def game_inputs(tmp_path_factory):
    from photon_ml_tpu.io.vocab import FeatureVocabulary, feature_key

    rng = np.random.default_rng(20261018)
    tmp = tmp_path_factory.mktemp("torch_entity_sharding")
    truth = (rng.normal(size=D_G), rng.normal(size=(N_USERS, D_U)) * 1.5)
    train, validate = str(tmp / "train.avro"), str(tmp / "validate.avro")
    write_avro_file(train, TRAINING_EXAMPLE_SCHEMA, _records(rng, 260, truth))
    write_avro_file(validate, TRAINING_EXAMPLE_SCHEMA, _records(rng, 120, truth))
    shards = {}
    for shard, keys in (("gshard", [f"g{j}" for j in range(D_G)]),
                        ("ushard", [f"u{j}" for j in range(D_U)])):
        shards[shard] = str(tmp / f"{shard}.txt")
        FeatureVocabulary([feature_key(k, "") for k in keys], add_intercept=True).save(
            shards[shard])
    return {"train": train, "validate": validate, "shards": shards, "tmp": tmp,
            "parts": _parts(tmp, rng, truth)}


def _driver_params(inputs, out, sparse=False, **extra):
    return _params(inputs, out, ("gshard",) if sparse else (), **extra)


def _multi_params(inputs, out, **extra):
    p = _params(inputs, out, validate_input=[], **extra)
    p["train_input"] = list(inputs["parts"])
    p["coordinates"]["per-user"]["num_buckets"] = 1
    return p


def _multi_factored_params(inputs, out):
    p = _multi_params(inputs, out)
    p["coordinates"]["per-user"].update(latent_dim=2, num_inner_iterations=2,
                                        latent_reg_weight=0.5, reg_weights=[0.3])
    return p


def _re_spec(optimizer="TRON"):
    args, rng = _args(seed=4)
    return {"args": args, "num_entities": E, "optimizer": optimizer, "config": _RE_CONFIG,
            "reg": rng.uniform(0.1, 3.0, E), "table": rng.normal(size=(E, DU)) * 0.3,
            "partial": rng.normal(size=N) * 0.3}


@pytest.fixture(scope="module", params=[2, 4], ids=["2 ranks", "4 ranks"])
def world(request, game_inputs):
    """One gloo world of ``param`` ranks: the random-effect update, the
    driver with entity_shards (dense and ELL) and, at 2 ranks, the
    multi-process branch and its refusal of an entity on two ranks."""
    n = request.param
    runs = {"dense": _driver_params(game_inputs, f"es{n}-dense", entity_shards=n),
            "ell": _driver_params(game_inputs, f"es{n}-ell", sparse=True, entity_shards=n)}
    if n == 2:
        runs["multi"] = _multi_params(game_inputs, "multi")
        # with sharded checkpoints every pass: the factored gamma blocks
        # gathered to the host at each boundary
        runs["multi factored"] = {**_multi_factored_params(game_inputs, "multi-factored"),
                                  "sharded_ckpt": True, "checkpoint_every": 1}
        dup = _multi_params(game_inputs, f"multi-dup-{n}")
        dup["train_input"] = [game_inputs["parts"][0], game_inputs["parts"][0]]
    else:
        # four ranks on the four files: ranks 0 and 2 both hold even users
        dup = _multi_params(game_inputs, f"multi-dup-{n}")
    runs["refused duplicate"] = dup
    results = run_world(game_inputs["tmp"], n, "game_driver_world", re_update=_re_spec(),
                        runs=runs)
    return n, results


def test_random_effect_update_equals_jax_with_no_collective(world):
    """Each rank's update of its lanes, gathered, equals the JAX
    coordinate's update of all lanes on the same entity-partitioned rows
    (the JAX ``RandomEffectCoordinate``: its entity-sharded coordinate,
    whose contract is equality with it, needs ``shard_map(check_rep=)``,
    which the JAX on this machine no longer takes), within 1e-10, with
    the rescores, penalties and tracker summaries; the update issues no
    collective."""
    n, results = world
    spec = _re_spec()
    jd = jdata.GameData.create(*spec["args"])
    ja = jdata.entity_shard_assignment(E, n)
    jp, jpart = jdata.entity_partition_game_data(jd, "uid", ja)
    design = jdata.build_bucketed_random_effect_design(jp, "uid", "u", E, num_buckets=3,
                                                       dtype=jnp.float64)
    cfg = jcoords.CoordinateConfig(optimizer=JOpt["TRON"], **_RE_CONFIG)
    jc = jcoords.RandomEffectCoordinate(
        design, jnp.asarray(jp.features["u"]), jnp.asarray(jp.entity_ids["uid"]),
        jnp.asarray(jp.offsets), cfg, reg_weights=spec["reg"])
    jt, jsum, js = jc.update_and_score(jnp.asarray(spec["table"]),
                                       jnp.asarray(jpart.apply(spec["partial"])))
    order = np.argsort(jsum.entity_ids)
    ranks = [r["re_update"] for r in results]
    for r in ranks:
        assert r["collectives"] == {}
        np.testing.assert_array_equal(r["row_perm"], jpart.row_perm)
        np.testing.assert_allclose(r["table"], np.asarray(jt), rtol=0, atol=1e-10)
        # every rank's summary covers every entity
        mine = np.argsort(r["entity_ids"])
        np.testing.assert_array_equal(r["entity_ids"][mine], jsum.entity_ids[order])
        np.testing.assert_array_equal(r["reason"][mine], jsum.reason[order])
        np.testing.assert_array_equal(r["iterations"][mine], jsum.iterations[order])
        np.testing.assert_allclose(r["grad_norms"][mine], jsum.grad_norms[order], rtol=0,
                                   atol=1e-10)
    np.testing.assert_allclose(np.concatenate([r["scores"] for r in ranks]), np.asarray(js),
                               rtol=0, atol=1e-10)
    np.testing.assert_allclose(sum(r["reg"] for r in ranks), float(jc.reg_term(jt)),
                               rtol=1e-12)


def _same_sweep(got, ref, atol=1e-6):
    assert got["best_index"] == ref.best_index
    for g, r in zip(got["sweep"], ref.sweep):
        assert g["combo"] == r["combo"]
        assert g["coordinates"] == [(h.iteration, h.coordinate) for h in r["history"]]
        np.testing.assert_allclose(g["objectives"], [h.objective for h in r["history"]],
                                   rtol=1e-7)
        if r["validation_metric"] is not None:
            assert abs(g["validation_metric"] - r["validation_metric"]) <= atol
        for name, p in r["model"].params.items():
            np.testing.assert_allclose(g["params"][name], np.asarray(p), rtol=0, atol=atol,
                                       err_msg=name)


_JAX_RUNS = {}


def _jax_run(inputs, key, params):
    if key not in _JAX_RUNS:
        _JAX_RUNS[key] = jgame.run_game_training({**params, "quality_fingerprint": False})
    return _JAX_RUNS[key]


@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "ell-global"])
def test_entity_sharded_driver_equals_jax(world, game_inputs, sparse):
    """Every rank's run equals the JAX unsharded driver within 1e-6 in
    every table and the validation metric (the JAX driver's own
    entity_shards runs its coordinate through ``shard_map(check_rep=)``,
    which the JAX on this machine no longer takes; its contract is this
    equality); rank 0 alone writes, and every rank's tables are rank 0's
    bit for bit."""
    n, results = world
    tag = "ell" if sparse else "dense"
    plain = _jax_run(game_inputs, f"plain-{tag}", _driver_params(game_inputs, f"jax-{tag}",
                                                                 sparse))
    runs = [r[tag] for r in results]
    for rank, got in enumerate(runs):
        _same_sweep(got, plain)
        assert bool(got["output_dirs"]) == (rank == 0)
        for g, g0 in zip(got["sweep"], runs[0]["sweep"]):
            for name in g["params"]:
                np.testing.assert_array_equal(g["params"][name], g0["params"][name])
    # one objective all-reduce per update, none in the random-effect update
    colls = runs[0]["collectives"]
    updates = sum(len(s["objectives"]) for s in runs[0]["sweep"])
    assert colls["objective"]["count"] == updates


def test_multiprocess_branch_equals_single_process_jax(world, game_inputs):
    """At 2 ranks (each on the files of its users' parity) the branch
    equals the JAX single-process driver on all 4 files; an entity in two
    ranks' files is refused, at 2 ranks (one file twice) and at 4 (each
    parity on two ranks)."""
    n, results = world
    for r in results:
        assert "appear on more than one process" in r["refused duplicate"]
    if n != 2:
        return
    ref = _jax_run(game_inputs, "multi", _multi_params(game_inputs, "jax-multi"))
    jv = ref.entity_vocabs["userId"]
    runs = [r["multi"] for r in results]
    for got in runs:
        ev = got["entity_vocabs"]["userId"]
        assert sorted(ev) == sorted(jv)
        for g, r in zip(got["sweep"], ref.sweep):
            np.testing.assert_allclose(g["objectives"], [h.objective for h in r["history"]],
                                       rtol=1e-7)
            np.testing.assert_allclose(g["params"]["global"],
                                       np.asarray(r["model"].params["global"]), atol=1e-6)
            jt, gt = np.asarray(r["model"].params["per-user"]), g["params"]["per-user"]
            for key, i in jv.items():
                np.testing.assert_allclose(gt[ev[key]], jt[i], rtol=0, atol=1e-6)


def _game_params(**kw):
    return tconfig.load_params(_base_dict(**kw), tconfig.GameDriverParams)


def _base_dict(**kw):
    return {"train_input": ["x"], "output_dir": "o", "updating_sequence": ["g", "u"],
            "coordinates": {"g": {"shard": "s"},
                            "u": {"shard": "t", "random_effect": "userId", "num_buckets": 1}},
            **kw}


_MULTI_REFUSALS = {
    "validate_input": {"validate_input": ["v"]},
    "initial_model_dir": {"initial_model_dir": "m"},
    "sparse_shards": {"sparse_shards": ["s"]},
    "checkpoint without sharded_ckpt": {"checkpoint_every": 1},
    "hot_columns": {"sparse_shards": ["s"], "coordinates": {
        "g": {"shard": "s", "hot_columns": 2},
        "u": {"shard": "t", "random_effect": "userId", "num_buckets": 1}}},
    "num_buckets": {"coordinates": {"g": {"shard": "s"},
                                    "u": {"shard": "t", "random_effect": "userId"}}},
    "projector": {"coordinates": {"g": {"shard": "s"}, "u": {
        "shard": "t", "random_effect": "userId", "num_buckets": 1, "projector": "RANDOM=2"}}},
}


@pytest.mark.parametrize("case", list(_MULTI_REFUSALS))
def test_multiprocess_refusals_have_the_jax_message(case):
    raw = _base_dict(**_MULTI_REFUSALS[case])
    jp = jconfig.load_params(raw, jconfig.GameDriverParams)
    tp = tconfig.load_params(raw, tconfig.GameDriverParams)
    with pytest.raises(ValueError) as want:
        jgame._validate_multiprocess_params(jp)
    with pytest.raises(ValueError) as got:
        tgame._validate_multiprocess_params(tp)
    assert str(got.value) == str(want.value)


def test_multiprocess_factored_branch_equals_single_process_jax(world, game_inputs):
    """At 2 ranks a factored per-user effect (each rank its users' gamma
    rows, the shared projection's solve reduced over the ranks) equals the
    JAX single-process driver on all 4 files within 1e-10: the projection,
    gamma by entity key and the fixed effect; the projection's value and
    gradient are one all-reduce, and every rank's tables are rank 0's bit
    for bit."""
    n, results = world
    if n != 2:
        return
    ref = _jax_run(game_inputs, "multi factored",
                   _multi_factored_params(game_inputs, "jax-multi-factored"))
    jv = ref.entity_vocabs["userId"]
    runs = [r["multi factored"] for r in results]
    for got in runs:
        ev = got["entity_vocabs"]["userId"]
        assert sorted(ev) == sorted(jv)
        for g, r in zip(got["sweep"], ref.sweep):
            assert g["coordinates"] == [(h.iteration, h.coordinate) for h in r["history"]]
            np.testing.assert_allclose(g["objectives"], [h.objective for h in r["history"]],
                                       rtol=1e-12)
            jm = r["model"].params
            np.testing.assert_allclose(g["params"]["global"], np.asarray(jm["global"]),
                                       rtol=0, atol=1e-10)
            fact = g["params"]["per-user"]
            np.testing.assert_allclose(fact["projection"], np.asarray(jm["per-user"].projection),
                                       rtol=0, atol=1e-10)
            jg = np.asarray(jm["per-user"].gamma)
            assert np.abs(jg).max() > 1e-2 and np.abs(fact["projection"]).max() > 1e-2
            for key, i in jv.items():
                np.testing.assert_allclose(fact["gamma"][ev[key]], jg[i], rtol=0, atol=1e-10)
        for g, g0 in zip(got["sweep"], runs[0]["sweep"]):
            np.testing.assert_array_equal(g["params"]["per-user"]["gamma"],
                                          g0["params"]["per-user"]["gamma"])
    assert runs[0]["collectives"]["value_grad"]["count"] > 0
    # the last pass's sharded checkpoint holds every rank's gamma rows,
    # keyed by entity, and the run's projection
    ck = tckpt.latest_checkpoint(str(game_inputs["tmp"] / "multi-factored" / "checkpoints"
                                     / "combo-0"))
    assert ck.step == 3 and ck.shards == 2
    fact = ck.params["per-user"]
    keys = ck.entity_keys["per-user"]
    ev = runs[0]["entity_vocabs"]["userId"]
    want = runs[0]["sweep"][0]["params"]["per-user"]
    np.testing.assert_array_equal(fact.projection, want["projection"])
    for row, key in enumerate(keys):
        if key in ev:
            np.testing.assert_array_equal(fact.gamma[row], want["gamma"][ev[key]])
        else:
            assert key.startswith("__entity_pad__") and not fact.gamma[row].any()


def test_multiprocess_refuses_a_factored_effect_and_non_str_ids():
    """The factored half now checks that the branch admits a factored
    effect, as the JAX one does (its parity run is
    ``test_multiprocess_factored_branch_equals_single_process_jax``); the
    non-str ids are refused in the JAX words."""
    raw = _base_dict()
    raw["coordinates"]["u"]["latent_dim"] = 2
    jgame._validate_multiprocess_params(jconfig.load_params(raw, jconfig.GameDriverParams))
    tgame._validate_multiprocess_params(tconfig.load_params(raw, tconfig.GameDriverParams))
    with pytest.raises(ValueError) as want:
        jgame._ordered_entity_ids("userId", {7: 0})
    with pytest.raises(ValueError) as got:
        tgame._ordered_entity_ids("userId", {7: 0})
    assert str(got.value) == str(want.value)
    assert tgame._ordered_entity_ids("userId", {"b": 1, "a": 0}) == ["a", "b"]


@pytest.mark.parametrize("coords", [
    {"u": {"shard": "t", "random_effect": "userId", "latent_dim": 2}},
    {"u": {"shard": "t", "random_effect": "userId", "projector": "RANDOM=2"}},
    {"u": {"shard": "t", "random_effect": "userId"},
     "v": {"shard": "t", "random_effect": "adId"}},
    {},
], ids=["factored", "projected", "two random effects", "none"])
def test_entity_shards_needs_one_plain_random_effect(coords):
    raw = {"train_input": ["x"], "output_dir": "o", "entity_shards": 2,
           "coordinates": {"g": {"shard": "s"}, **coords}, "updating_sequence": ["g"]}
    with pytest.raises(ValueError) as want:
        jconfig.load_params(raw, jconfig.GameDriverParams).validate()
    with pytest.raises(ValueError) as got:
        tconfig.load_params(raw, tconfig.GameDriverParams).validate()
    assert str(got.value) == str(want.value)


def test_entity_shards_needs_a_world_of_its_size(game_inputs):
    with pytest.raises(ValueError, match="entity_shards=2 exceeds 1 visible devices"):
        tgame.run_game_training(_driver_params(game_inputs, "no-world", entity_shards=2),
                                device="cpu")
    assert not os.path.exists(str(game_inputs["tmp"] / "no-world"))
