"""The port's sharded checkpoints (``io/checkpoint.py``, the JAX package's
``photon_ml_tpu/io/checkpoint.py:391-1007``) and the host-loss recovery of
``CoordinateDescent.run`` and the GAME driver, on the CPU in float64:

- shard sets written by either package load in the other with equal
  arrays, entity keys, history and step, at any shard count; the quorum
  rules (a torn or missing shard falls back to the previous complete
  step), the shard-write fault's retry, the survivors' final save with no
  collective and its election, and ``reindex_entity_params`` against the
  JAX package's;
- the JAX package's ``TestHostLossRecoveryE2E`` on a tiny GAME built here
  (one process, two emulated peers): a lost peer leaves a final shard set
  and ``host-loss.json``, and a restart at a smaller width equals the
  uninterrupted run within 1e-10; a final save that fails still leaves
  the marker;
- the drill in a real world: the GAME CLI on 4 gloo ranks with
  ``sharded_ckpt`` and ``checkpoint_every`` 1, rank 3 silenced on the
  heartbeat store at pass 2: the survivors exit 43 after a complete final
  shard set (which the JAX package loads with equal arrays) and the marker;
  a 2-rank restart from it equals an uninterrupted 2-rank run within 1e-10
  (the 4 -> 2 shrunk resume).
"""

import json
import os

import numpy as np
import pytest
import torch
from torch_worlds import run_cli_world, run_world

from photon_ml_tpu.game.factored import FactoredParams as JFactoredParams
from photon_ml_tpu.io import checkpoint as jckpt
from photon_ml_tpu.io.avro import write_avro_file
from photon_ml_tpu.io.schemas import TRAINING_EXAMPLE_SCHEMA
from photon_ml_tpu_torch.core.tasks import TaskType
from photon_ml_tpu_torch.game import coordinates as tcoords
from photon_ml_tpu_torch.game import data as tdata
from photon_ml_tpu_torch.game import descent as tdescent
from photon_ml_tpu_torch.game.factored import FactoredParams
from photon_ml_tpu_torch.io import checkpoint as tckpt
from photon_ml_tpu_torch.models.training import OptimizerType
from photon_ml_tpu_torch.parallel.heartbeat import HeartbeatMonitor, InProcessHeartbeats
from photon_ml_tpu_torch.resilience import (
    HOST_LOSS_EXIT_CODE,
    HostLossDetected,
    read_host_loss_marker,
)
from photon_ml_tpu_torch.resilience.faults import FaultSpec, inject

from test_torch_game_train import D_G, D_U, N_USERS, _params, _records

_HIST = [{"iteration": 0, "coordinate": "fixed", "objective": 1.5, "seconds": 0.1,
          "solver_iterations": 3.0, "convergence_histogram": {"MAX_ITERATIONS": 1},
          "validation_metric": None, "event": None}]


def _keys(n, prefix="u"):
    return [f"{prefix}{i}" for i in range(n)]


def _params_of(rng, n_entities=7, d=3, factored=JFactoredParams):
    return {"fixed": rng.normal(size=5), "per-user": rng.normal(size=(n_entities, d)),
            "fact": factored(gamma=rng.normal(size=(n_entities, 2)),
                             projection=rng.normal(size=(2, d)))}


def _assert_same_params(a, b):
    assert sorted(a) == sorted(b)
    for name in a:
        pa, pb = a[name], b[name]
        if hasattr(pa, "gamma"):
            np.testing.assert_array_equal(np.asarray(pa.gamma), np.asarray(pb.gamma))
            np.testing.assert_array_equal(np.asarray(pa.projection), np.asarray(pb.projection))
        else:
            np.testing.assert_array_equal(np.asarray(pa), np.asarray(pb))


@pytest.mark.parametrize("num_shards", [1, 2, 3])
def test_shard_sets_load_across_packages(tmp_path, num_shards):
    rng = np.random.default_rng(num_shards)
    ekeys = {"per-user": _keys(7), "fact": _keys(7, "f")}
    state = torch.Generator().manual_seed(3).get_state().numpy()
    hist = [dict(_HIST[0], cg_iterations=5, entity_iterations=np.asarray([1, 2]))]
    # the port writes, the JAX package reads (and the port reads back)
    port_params = _params_of(rng, factored=FactoredParams)
    d = str(tmp_path / "port")
    tckpt.save_checkpoint_sharded(d, 3, port_params, tckpt.jax_prng_key(7), history=hist,
                                  frozen=["fact"], entity_keys=ekeys, num_shards=num_shards,
                                  generator_state=state)
    names = sorted(os.listdir(os.path.join(d, "step-3")))
    assert names == sorted(["manifest.json"] + [f"shard-{p}-of-{num_shards}.{x}"
                                                for p in range(num_shards)
                                                for x in ("npz", "json")])
    jck = jckpt.latest_checkpoint(d)
    assert (jck.step, jck.shards, jck.frozen, jck.history) == (3, num_shards, ["fact"], _HIST)
    assert jck.entity_keys == ekeys
    _assert_same_params(jck.params, port_params)
    tck = tckpt.latest_checkpoint(d)
    assert (tck.step, tck.shards, tck.entity_keys) == (3, num_shards, ekeys)
    _assert_same_params(tck.params, port_params)
    np.testing.assert_array_equal(tck.generator_state, state)
    assert tck.history[0]["cg_iterations"] == 5
    assert tck.history[0]["entity_iterations"] == [1, 2]
    # the JAX package writes, the port reads
    jax_params = _params_of(rng)
    d = str(tmp_path / "jax")
    jckpt.save_checkpoint_sharded(d, 4, jax_params, np.asarray([0, 9], np.uint32),
                                  history=_HIST, frozen=["per-user"], entity_keys=ekeys,
                                  num_shards=num_shards)
    tck = tckpt.latest_checkpoint(d)
    assert (tck.step, tck.shards, tck.frozen, tck.history) == (4, num_shards, ["per-user"], _HIST)
    assert tck.entity_keys == ekeys and tck.generator_state is None
    np.testing.assert_array_equal(tck.rng_key, [0, 9])
    _assert_same_params(tck.params, jax_params)
    # the manifests carry the same fields and per-shard digests
    with open(os.path.join(str(tmp_path / "port"), "step-3", "manifest.json")) as f:
        port_manifest = json.load(f)
    with open(os.path.join(d, "step-4", "manifest.json")) as f:
        jax_manifest = json.load(f)
    assert set(jax_manifest) <= set(port_manifest)
    assert port_manifest["param_sharding"] == jax_manifest["param_sharding"]
    for fname, digest in port_manifest["digests"].items():
        assert tckpt.sha256_file(os.path.join(str(tmp_path / "port"), "step-3", fname)) == digest


def test_quorum_torn_and_missing_shards_fall_back(tmp_path):
    rng = np.random.default_rng(5)
    d = str(tmp_path / "q")
    ekeys = {"per-user": _keys(7)}
    for step in (1, 2):
        tckpt.save_checkpoint_sharded(d, step, _params_of(rng, factored=FactoredParams),
                                      tckpt.jax_prng_key(0), entity_keys=ekeys, num_shards=3)
    # a torn shard: digest mismatch, the step before is restored
    with open(os.path.join(d, "step-2", "shard-1-of-3.npz"), "r+b") as f:
        f.seek(30)
        f.write(b"\x00" * 12)
    with pytest.raises(tckpt.CheckpointCorrupted, match="digest mismatch"):
        tckpt.verify_checkpoint(d, 2)
    assert tckpt.latest_checkpoint(d).step == 1
    # a missing shard: no quorum
    os.remove(os.path.join(d, "step-1", "shard-2-of-3.npz"))
    with pytest.raises(tckpt.CheckpointCorrupted, match="no quorum"):
        tckpt.verify_checkpoint(d, 1)
    assert tckpt.latest_checkpoint(d) is None
    # a whole-model step and a sharded one side by side
    tckpt.save_checkpoint(d, 3, {"fixed": np.ones(2)}, tckpt.jax_prng_key(0))
    tckpt.save_checkpoint_sharded(d, 4, {"fixed": np.ones(2) * 4}, tckpt.jax_prng_key(0),
                                  num_shards=2)
    assert tckpt.latest_checkpoint(d).step == 4
    assert tckpt.verify_checkpoint(d, 3).shards == 1
    # the shard-write fault retries the whole set
    with inject(FaultSpec("checkpoint.shard_write", "raise", nth=2)):
        tckpt.save_checkpoint_sharded(d, 5, {"fixed": np.ones(2) * 5}, tckpt.jax_prng_key(0),
                                      num_shards=2)
    np.testing.assert_array_equal(tckpt.latest_checkpoint(d).params["fixed"], np.ones(2) * 5)
    with pytest.raises(ValueError, match="must label every row"):
        tckpt.save_checkpoint_sharded(d, 6, {"per-user": np.ones((3, 2))}, [0, 0],
                                      entity_keys={"per-user": ["a"]})
    with pytest.raises(ValueError, match="reserved"):
        tckpt.save_checkpoint_sharded(d, 6, {"a#gamma": np.ones(1)}, [0, 0])


def test_final_save_publishes_alone_and_yields(tmp_path):
    """The survivors' save: a complete quorum step with no collective, an
    election by claim file, a published step reused, a stale claim pruned
    by the next save."""
    rng = np.random.default_rng(6)
    d = str(tmp_path / "f")
    params = _params_of(rng, factored=FactoredParams)
    ekeys = {"per-user": _keys(7)}
    out = tckpt.save_checkpoint_sharded_final(d, 2, params, tckpt.jax_prng_key(0),
                                              entity_keys=ekeys, num_shards=4, process_index=1)
    assert out.endswith("step-2")
    ck = jckpt.latest_checkpoint(d)
    assert ck.shards == 4 and ck.entity_keys == ekeys
    _assert_same_params(ck.params, params)
    # published already: returned as it is
    assert tckpt.save_checkpoint_sharded_final(d, 2, params, [0, 0], num_shards=4) == out
    # another survivor holds the claim: yield
    open(os.path.join(d, "step-3.publisher"), "w").close()
    assert tckpt.save_checkpoint_sharded_final(d, 3, params, [0, 0], num_shards=4) is None
    assert not os.path.exists(os.path.join(d, "step-3"))
    tckpt.save_checkpoint_sharded(d, 4, params, [0, 0], num_shards=2)
    assert not os.path.exists(os.path.join(d, "step-3.publisher"))


def test_reindex_equals_jax(tmp_path):
    rng = np.random.default_rng(7)
    old = _keys(6)
    d = str(tmp_path / "r")
    tckpt.save_checkpoint_sharded(d, 1, _params_of(rng, n_entities=6, factored=FactoredParams),
                                  [0, 0], entity_keys={"per-user": old, "fact": old},
                                  num_shards=2)
    tck, jck = tckpt.latest_checkpoint(d), jckpt.latest_checkpoint(d)
    for target in (old, old[::-1], ["u3", "new", "u0", "u5"]):
        ekeys = {"per-user": target, "fact": target}
        _assert_same_params(tckpt.reindex_entity_params(tck, ekeys),
                            jckpt.reindex_entity_params(jck, ekeys))
    same = tckpt.reindex_entity_params(tck, {"per-user": old})
    assert same["per-user"] is tck.params["per-user"]


def test_whole_model_writer_refuses_a_world(monkeypatch, tmp_path):
    from photon_ml_tpu_torch.parallel import mesh as mesh_mod

    monkeypatch.setattr(mesh_mod, "world", lambda: (2, 0))
    with pytest.raises(RuntimeError, match="save_checkpoint_sharded"):
        tckpt.save_checkpoint(str(tmp_path / "w"), 1, {"fixed": np.ones(2)}, [0, 0])


# -- host loss on a tiny GAME, one process -------------------------------------


def _tiny_game(rng):
    """The JAX package's ``resilience.drills._tiny_game``: a TRON fixed
    effect and a TRON per-user random effect on 32 rows of 4 users."""
    n_users, rows, d_g, d_u = 4, 8, 3, 2
    n = n_users * rows
    user = np.repeat(np.arange(n_users), rows)
    xg = rng.normal(size=(n, d_g))
    xu = rng.normal(size=(n, d_u))
    y = (rng.uniform(size=n) < 0.5).astype(float)
    data = tdata.GameData.create(features={"global": xg, "per_user": xu}, labels=y,
                                 entity_ids={"userId": user})
    common = dict(task=TaskType.LOGISTIC_REGRESSION, optimizer=OptimizerType.TRON,
                  max_iters=10, tolerance=1e-8)
    fixed = tcoords.FixedEffectCoordinate(
        data.fixed_effect_batch("global", torch.float64),
        tcoords.CoordinateConfig(shard="global", reg_weight=0.1, **common))
    design = tdata.build_random_effect_design(data, "userId", "per_user", n_users,
                                              dtype=torch.float64)
    random = tcoords.RandomEffectCoordinate(
        design, torch.from_numpy(xu), torch.from_numpy(user), torch.zeros(n, dtype=torch.float64),
        tcoords.CoordinateConfig(shard="per_user", reg_weight=1.0, random_effect="userId",
                                 **common))
    as_t = lambda a: torch.as_tensor(a, dtype=torch.float64)  # noqa: E731
    return tdescent.CoordinateDescent({"fixed": fixed, "per-user": random}, as_t(data.labels),
                                      as_t(data.offsets), as_t(data.weights),
                                      TaskType.LOGISTIC_REGRESSION)


def test_host_loss_final_shard_set_and_smaller_restart(tmp_path):
    ekeys = {"per-user": _keys(4, "user")}
    model_a, _ = _tiny_game(np.random.default_rng(41)).run(
        num_iterations=3, seed=3, checkpoint_dir=str(tmp_path / "a"), checkpoint_every=1,
        sharded_checkpoints=2, entity_keys=ekeys)
    mon = HeartbeatMonitor(interval_s=1e-4, miss_intervals=1.0,
                           transport=InProcessHeartbeats(2), process_index=0, process_count=2)
    ckdir = str(tmp_path / "b")
    with inject(FaultSpec("heartbeat.miss", "raise", nth=2, count=-1, key="1")):
        with pytest.raises(HostLossDetected):
            _tiny_game(np.random.default_rng(41)).run(
                num_iterations=3, seed=3, checkpoint_dir=ckdir, checkpoint_every=1,
                sharded_checkpoints=2, entity_keys=ekeys, heartbeat=mon)
    marker = read_host_loss_marker(ckdir)
    assert marker["peers"] == [1] and marker["exit_code"] == HOST_LOSS_EXIT_CODE
    ck = tckpt.latest_checkpoint(ckdir)
    assert ck is not None and ck.shards == 2 and ck.step == marker["step"] >= 1
    assert jckpt.latest_checkpoint(ckdir).shards == 2
    model_b, _ = _tiny_game(np.random.default_rng(41)).run(
        num_iterations=3, seed=3, checkpoint_dir=ckdir, checkpoint_every=1,
        sharded_checkpoints=1, entity_keys=ekeys, resume=True)
    for name in model_a.params:
        np.testing.assert_allclose(model_b.params[name].numpy(), model_a.params[name].numpy(),
                                   rtol=0, atol=1e-10, err_msg=name)


def test_marker_written_even_when_the_final_save_fails(tmp_path):
    mon = HeartbeatMonitor(interval_s=1e-4, miss_intervals=1.0,
                           transport=InProcessHeartbeats(2), process_index=0, process_count=2)
    ckdir = str(tmp_path / "c")
    with inject(FaultSpec("heartbeat.miss", "raise", nth=1, count=-1, key="1"),
                FaultSpec("checkpoint.shard_write", "raise", nth=1, count=-1)):
        with pytest.raises(HostLossDetected):
            _tiny_game(np.random.default_rng(7)).run(
                num_iterations=2, seed=1, checkpoint_dir=ckdir, checkpoint_every=10,
                sharded_checkpoints=2, entity_keys={"per-user": _keys(4, "user")}, heartbeat=mon)
    marker = read_host_loss_marker(ckdir)
    assert marker["peers"] == [1] and marker["final_checkpoint"] is False
    assert tckpt.latest_checkpoint(ckdir) is None


# -- the drill in a world --------------------------------------------------------


@pytest.fixture(scope="module")
def drill_setup(tmp_path_factory):
    """The drills' records, feature files and driver parameters."""
    from photon_ml_tpu.io.vocab import FeatureVocabulary, feature_key

    rng = np.random.default_rng(20261019)
    tmp = tmp_path_factory.mktemp("torch_sharded_drill")
    truth = (rng.normal(size=D_G), rng.normal(size=(N_USERS, D_U)) * 1.5)
    train = str(tmp / "train.avro")
    write_avro_file(train, TRAINING_EXAMPLE_SCHEMA, _records(rng, 260, truth))
    shards = {}
    for shard, keys in (("gshard", [f"g{j}" for j in range(D_G)]),
                        ("ushard", [f"u{j}" for j in range(D_U)])):
        shards[shard] = str(tmp / f"{shard}.txt")
        FeatureVocabulary([feature_key(k, "") for k in keys], add_intercept=True).save(
            shards[shard])
    inputs = {"train": train, "validate": None, "shards": shards, "tmp": tmp}

    def params(out, ranks, **kw):
        p = _params(inputs, out, validate_input=[], entity_shards=ranks, num_iterations=4,
                    checkpoint_every=1, sharded_ckpt=True, quality_fingerprint=False,
                    model_output_mode="BEST", **kw)
        p["coordinates"]["per-user"]["reg_weights"] = [0.1]
        return p

    return tmp, params


@pytest.fixture(scope="module")
def drill(drill_setup):
    """The 4-rank CLI drill, then the 2-rank restart and the uninterrupted
    2-rank run in one world."""
    tmp, params = drill_setup
    # rank 3 goes silent at its 4th update (pass 2's random effect), which
    # takes 6 s longer; a peer is lost past 3 beats of 1 s (at 0.02 s a
    # loaded machine's late beats read as lost peers at the first boundary)
    codes = run_cli_world(tmp, 4, params("drill", 4, heartbeat_s=1.0), victim=(3, 4))
    ckdir = str(tmp / "drill" / "checkpoints" / "combo-0")
    loaded = (tckpt.latest_checkpoint(ckdir), jckpt.latest_checkpoint(ckdir))
    marker = read_host_loss_marker(ckdir)
    runs = run_world(tmp, 2, "game_driver_world", runs={
        "restart": {**params("drill", 2), "resume": True, "overwrite": True},
        "straight": params("straight", 2)})
    return codes, loaded, marker, runs


def test_world_drill_exits_43_after_a_final_shard_set(drill):
    codes, (tck, jck), marker, _ = drill
    assert codes[:3] == [HOST_LOSS_EXIT_CODE] * 3
    assert marker["peers"] == [3] and marker["step"] == 2 and marker["final_checkpoint"]
    assert tck.step == jck.step == 2 and tck.shards == jck.shards == 4
    _assert_same_params(tck.params, jck.params)
    assert tck.entity_keys == jck.entity_keys
    assert len(tck.entity_keys["per-user"]) == tck.params["per-user"].shape[0]


def test_shrunk_restart_equals_the_uninterrupted_run(drill):
    *_, runs = drill
    for rank_runs in runs:
        got, want = rank_runs["restart"]["sweep"][0], rank_runs["straight"]["sweep"][0]
        assert got["coordinates"] == want["coordinates"]
        np.testing.assert_allclose(got["objectives"], want["objectives"], rtol=1e-12)
        for name in want["params"]:
            np.testing.assert_allclose(got["params"][name], want["params"][name], rtol=0,
                                       atol=1e-10, err_msg=name)


# -- a complete final set at a boundary that is not a cadence step -------------


@pytest.fixture(scope="module")
def noncadence_drill(drill_setup, drill):
    """The CLI on 2 gloo ranks with ``checkpoint_every`` 2, rank 1 silenced
    at its 2nd update (pass 1's random effect), so that rank 0 finds it lost
    at boundary 1, where no cadence save lands; then a 2-rank restart from
    what rank 0 left, to be held to the drill's uninterrupted 2-rank run."""
    tmp, params = drill_setup

    def every2(out, **kw):
        return {**params(out, 2, **kw), "checkpoint_every": 2}

    codes = run_cli_world(tmp, 2, every2("noncadence", heartbeat_s=1.0), victim=(1, 2))
    ckdir = str(tmp / "noncadence" / "checkpoints" / "combo-0")
    marker = read_host_loss_marker(ckdir)
    steps = sorted(d for d in os.listdir(ckdir) if d.startswith("step-"))
    step_dir = os.path.join(ckdir, steps[-1]) if steps else None
    listing = sorted(os.listdir(step_dir)) if step_dir else []
    loaded = (tckpt.latest_checkpoint(ckdir), jckpt.latest_checkpoint(ckdir))
    runs = run_world(tmp, 2, "game_driver_world", runs={
        "restart": {**every2("noncadence"), "resume": True, "overwrite": True}})
    return codes, marker, steps, listing, loaded, runs, drill[-1]


def test_noncadence_loss_leaves_a_complete_final_shard_set(noncadence_drill):
    codes, marker, steps, listing, (tck, jck), _, _ = noncadence_drill
    assert codes[0] == HOST_LOSS_EXIT_CODE
    # step 1 is no cadence step of checkpoint_every 2: the survivor wrote
    # it from its host copy of the boundary, every block included
    assert marker["peers"] == [1] and marker["step"] == 1
    assert marker["final_checkpoint"] is True
    assert steps == ["step-1"]
    assert listing == ["manifest.json"] + [f"shard-{p}-of-2.{ext}" for p in (0, 1)
                                           for ext in ("json", "npz")]
    assert tck.step == jck.step == 1 and tck.shards == jck.shards == 2
    _assert_same_params(tck.params, jck.params)
    assert tck.entity_keys == jck.entity_keys
    assert len(tck.entity_keys["per-user"]) == tck.params["per-user"].shape[0]


def test_noncadence_restart_equals_the_uninterrupted_run(noncadence_drill):
    *_, runs, straight = noncadence_drill
    for rank_runs, rank_straight in zip(runs, straight):
        got, want = rank_runs["restart"]["sweep"][0], rank_straight["straight"]["sweep"][0]
        assert got["coordinates"] == want["coordinates"]
        np.testing.assert_allclose(got["objectives"], want["objectives"], rtol=1e-12)
        for name in want["params"]:
            np.testing.assert_allclose(got["params"][name], want["params"][name], rtol=0,
                                       atol=1e-10, err_msg=name)
