"""The port's checkpoint store (``io/checkpoint.py``) and its checkpoint /
resume / preemption path through ``CoordinateDescent.run`` and the GAME
training driver, on the CPU in float64: the store round trip, pruning and
the fall-back past a torn step; a step written by either package loads in
the other (params, history, frozen set, step); a run stopped after a pass
and resumed is bit-identical to the uninterrupted one (down-sampling
draws, a projected and a factored coordinate included); and a real SIGTERM
to a training subprocess leaves ``preempted.json``, its checkpoint and no
model, from which ``resume`` ends bit-identical to an uninterrupted run."""

import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from photon_ml_tpu.game.factored import FactoredParams as JFactoredParams
from photon_ml_tpu.io import checkpoint as jckpt
from photon_ml_tpu_torch import interop
from photon_ml_tpu_torch.cli import game_train as tgame
from photon_ml_tpu_torch.core.tasks import TaskType
from photon_ml_tpu_torch.game import coordinates as tcoords
from photon_ml_tpu_torch.game import data as tdata
from photon_ml_tpu_torch.game import descent as tdescent
from photon_ml_tpu_torch.game import factored as tfactored
from photon_ml_tpu_torch.game import projected as tproj
from photon_ml_tpu_torch.game.factored import FactoredParams
from photon_ml_tpu_torch.io import checkpoint as tckpt
from photon_ml_tpu_torch.models.training import OptimizerType
from photon_ml_tpu_torch.resilience import PREEMPTED_MARKER, read_preempted_marker

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, E = 320, 10
_HIST = [{"iteration": 0, "coordinate": "fixed", "objective": 1.5, "seconds": 0.1,
          "solver_iterations": 3.0, "convergence_histogram": {"MAX_ITERATIONS": 1},
          "validation_metric": None, "event": None}]


def test_store_round_trip_prune_and_fall_back(tmp_path):
    rng = np.random.default_rng(1)
    params = {"fixed": rng.normal(size=5), "re": rng.normal(size=(3, 2)),
              "f": FactoredParams(gamma=rng.normal(size=(3, 2)),
                                  projection=rng.normal(size=(4, 2)))}
    hist = [dict(_HIST[0], cg_iterations=7, entity_iterations=np.asarray([1, 2, 3]))]
    state = torch.Generator().manual_seed(5).get_state().numpy()
    d = str(tmp_path / "ck")
    tckpt.save_checkpoint(d, 2, params, tckpt.jax_prng_key(42), hist, frozen=["re"],
                          generator_state=state)
    ck = tckpt.latest_checkpoint(d)
    assert ck.step == 2 and ck.frozen == ["re"]
    np.testing.assert_array_equal(ck.params["fixed"], params["fixed"])
    np.testing.assert_array_equal(ck.params["f"].projection, params["f"].projection)
    np.testing.assert_array_equal(ck.generator_state, state)
    np.testing.assert_array_equal(ck.rng_key, [0, 42])
    assert ck.history[0]["entity_iterations"] == [1, 2, 3]
    assert ck.history[0]["cg_iterations"] == 7
    for step in (3, 4, 5):
        tckpt.save_checkpoint(d, step, {"fixed": np.ones(2) * step}, tckpt.jax_prng_key(0))
    assert sorted(tckpt._list_steps(d)) == [4, 5]
    # a torn step (digest mismatch) falls back to the newest valid one
    with open(os.path.join(d, "step-5", "arrays.npz"), "r+b") as f:
        f.seek(40)
        f.write(b"\x00" * 16)
    with pytest.raises(tckpt.CheckpointCorrupted):
        tckpt.verify_checkpoint(d, 5)
    assert tckpt.latest_checkpoint(d).step == 4
    os.makedirs(os.path.join(d, "step-9.tmp"))
    tckpt.save_checkpoint(d, 6, {"fixed": np.ones(2)}, tckpt.jax_prng_key(0))
    assert not os.path.exists(os.path.join(d, "step-9.tmp"))
    assert tckpt.latest_checkpoint(str(tmp_path / "none")) is None
    with pytest.raises(ValueError, match="reserved"):
        tckpt.save_checkpoint(d, 7, {"a#gamma": np.ones(1)}, tckpt.jax_prng_key(0))


def test_checkpoints_load_across_packages(tmp_path):
    rng = np.random.default_rng(2)
    gamma, proj = rng.normal(size=(3, 2)), rng.normal(size=(4, 2))
    table = rng.normal(size=(3, 2))
    # the port writes, the JAX package reads
    d = str(tmp_path / "port")
    hist = [dict(_HIST[0], cg_iterations=4, entity_iterations=None)]
    tckpt.save_checkpoint(d, 3, {"re": table, "f": FactoredParams(gamma, proj)},
                          tckpt.jax_prng_key(7), hist, frozen=["f"],
                          generator_state=torch.Generator().get_state().numpy())
    ck = jckpt.latest_checkpoint(d)
    assert ck.step == 3 and ck.frozen == ["f"] and ck.history == _HIST
    np.testing.assert_array_equal(ck.params["re"], table)
    np.testing.assert_array_equal(ck.params["f"].gamma, gamma)
    np.testing.assert_array_equal(ck.rng_key, [0, 7])
    # the JAX package writes, the port reads (no generator state)
    d = str(tmp_path / "jax")
    jckpt.save_checkpoint(d, 4, {"re": table, "f": JFactoredParams(gamma, proj)},
                          np.asarray([0, 9], np.uint32), _HIST, frozen=["re"])
    ck = tckpt.latest_checkpoint(d)
    assert ck.step == 4 and ck.frozen == ["re"] and ck.history == _HIST
    assert ck.generator_state is None
    np.testing.assert_array_equal(ck.params["f"].projection, proj)
    same = interop.checkpoint_from_numpy(4, {"re": table, "f": JFactoredParams(gamma, proj)},
                                         _HIST, ["re"], [0, 9])
    np.testing.assert_array_equal(same.params["f"].gamma, ck.params["f"].gamma)
    assert same.history == ck.history and same.frozen == ck.frozen


def _coordinates():
    """A down-sampled dense fixed effect (its draws come from the run's
    generator), an INDEX_MAP-projected random effect with NEWTON and a
    factored one with OWL-QN."""
    rng = np.random.default_rng(3)
    xg = rng.normal(size=(N, 4))
    xg[:, -1] = 1.0
    xu = rng.normal(size=(N, 4))
    xu[:, -1] = 1.0
    ents = rng.integers(0, E, N)
    y = (rng.uniform(size=N) < 1 / (1 + np.exp(-xg @ rng.normal(size=4)))).astype(float)
    data = tdata.GameData.create({"g": xg, "u": xu}, y, rng.normal(size=N) * 0.1,
                                 np.ones(N), {"uid": ents})
    common = dict(task=TaskType.LOGISTIC_REGRESSION, max_iters=20, tolerance=1e-8)
    fe = tcoords.FixedEffectCoordinate(
        data.fixed_effect_batch("g", torch.float64, "cpu"),
        tcoords.CoordinateConfig(shard="g", reg_weight=0.5, down_sampling_rate=0.7, **common))
    design = tdata.build_bucketed_random_effect_design(data, "uid", "u", E, num_buckets=2,
                                                       dtype=torch.float64)
    rows = torch.from_numpy(xu)
    ents_t = torch.from_numpy(ents.astype(np.int64))
    off = torch.from_numpy(data.offsets)
    re_cfg = tcoords.CoordinateConfig(shard="u", random_effect="uid", reg_weight=1.0,
                                      optimizer=OptimizerType.NEWTON, **common)
    proj = tproj.ProjectedRandomEffectCoordinate(
        design, rows, ents_t, off, re_cfg,
        tproj.build_index_map_columns(data, "uid", "u", E), 4)
    fac = tfactored.FactoredRandomEffectCoordinate(
        design, rows, ents_t, off,
        tcoords.CoordinateConfig(shard="u", random_effect="uid", reg_weight=1.0,
                                 l1_ratio=0.5, optimizer=OptimizerType.LBFGS, **common),
        tfactored.FactoredConfig(latent_dim=2))
    cols = [torch.from_numpy(a) for a in (data.labels, data.offsets, data.weights)]
    return {"global": fe, "per-user": proj, "per-user-latent": fac}, cols


def _leaves(model):
    out = {}
    for n, p in model.params.items():
        if isinstance(p, FactoredParams):
            out[f"{n}#gamma"], out[f"{n}#projection"] = p.gamma.numpy(), p.projection.numpy()
        else:
            out[n] = p.numpy()
    return out


def _assert_bit_identical(a, b):
    (ma, ha), (mb, hb) = a, b
    la, lb = _leaves(ma), _leaves(mb)
    assert la.keys() == lb.keys()
    for k in la:
        np.testing.assert_array_equal(la[k], lb[k], err_msg=k)
    assert [h.objective for h in ha] == [h.objective for h in hb]
    assert [(h.iteration, h.coordinate, h.convergence_histogram) for h in ha] == [
        (h.iteration, h.coordinate, h.convergence_histogram) for h in hb]


def test_preempted_run_resumes_bit_identical(tmp_path):
    coords, cols = _coordinates()
    whole = tdescent.CoordinateDescent(coords, *cols, TaskType.LOGISTIC_REGRESSION).run(3, seed=9)
    d = str(tmp_path / "ck")
    passes = []

    def stop_after_one():
        passes.append(1)
        return len(passes) == 1

    coords, cols = _coordinates()
    first = tdescent.CoordinateDescent(coords, *cols, TaskType.LOGISTIC_REGRESSION).run(
        3, seed=9, checkpoint_dir=d, checkpoint_every=2, stop_check=stop_after_one)
    assert len(first[1]) == 3  # one pass of three updates
    assert read_preempted_marker(d)["step"] == 1
    assert tckpt.latest_checkpoint(d).step == 1  # the final checkpoint off the cadence
    coords, cols = _coordinates()
    resumed = tdescent.CoordinateDescent(coords, *cols, TaskType.LOGISTIC_REGRESSION).run(
        3, seed=9, checkpoint_dir=d, checkpoint_every=2, resume=True)
    _assert_bit_identical(resumed, whole)
    assert not os.path.exists(os.path.join(d, PREEMPTED_MARKER))
    assert tckpt.latest_checkpoint(d).step == 3
    # resuming a finished run returns its state; a longer checkpoint is refused
    coords, cols = _coordinates()
    again = tdescent.CoordinateDescent(coords, *cols, TaskType.LOGISTIC_REGRESSION).run(
        3, seed=9, checkpoint_dir=d, resume=True)
    _assert_bit_identical(again, whole)
    with pytest.raises(ValueError, match="exceeds num_iterations"):
        tdescent.CoordinateDescent(coords, *cols, TaskType.LOGISTIC_REGRESSION).run(
            2, seed=9, checkpoint_dir=d, resume=True)
    with pytest.raises(ValueError, match="lacks coordinates"):
        tdescent.CoordinateDescent({**coords, "extra": coords["global"]}, *cols,
                                   TaskType.LOGISTIC_REGRESSION).run(
            3, seed=9, checkpoint_dir=d, resume=True)


def _driver_params(tmp_path, out, **extra):
    from test_torch_game_train import _params

    inputs = {"train": str(tmp_path / "train.avro"), "validate": str(tmp_path / "validate.avro"),
              "shards": {s: str(tmp_path / f"{s}.txt") for s in ("gshard", "ushard")},
              "tmp": tmp_path}
    p = _params(inputs, out, num_iterations=6, checkpoint_every=1, **extra)
    p["coordinates"]["per-user"].update(projector="RANDOM=2", reg_weights=[1.0])
    return p


def _write_driver_inputs(tmp_path):
    from test_torch_game_train import D_G, D_U, N_USERS, _records
    from photon_ml_tpu.io.avro import write_avro_file
    from photon_ml_tpu.io.schemas import TRAINING_EXAMPLE_SCHEMA
    from photon_ml_tpu.io.vocab import FeatureVocabulary, feature_key

    rng = np.random.default_rng(41)
    truth = (rng.normal(size=D_G), rng.normal(size=(N_USERS, D_U)) * 1.5)
    write_avro_file(str(tmp_path / "train.avro"), TRAINING_EXAMPLE_SCHEMA,
                    _records(rng, 200, truth))
    write_avro_file(str(tmp_path / "validate.avro"), TRAINING_EXAMPLE_SCHEMA,
                    _records(rng, 80, truth))
    for shard, keys in (("gshard", [f"g{j}" for j in range(D_G)]),
                        ("ushard", [f"u{j}" for j in range(D_U)])):
        FeatureVocabulary([feature_key(k, "") for k in keys], add_intercept=True).save(
            str(tmp_path / f"{shard}.txt"))


# the subprocess: the driver's CLI with every fixed-effect update slowed by
# 0.3 s, so that a SIGTERM sent once the first checkpoint exists lands
# before the last pass
_SLOW_CLI = """
import sys, time
from photon_ml_tpu_torch.cli import game_train
from photon_ml_tpu_torch.game.coordinates import FixedEffectCoordinate
update = FixedEffectCoordinate.update_and_score
def slow(self, *a, **k):
    time.sleep(0.3)
    return update(self, *a, **k)
FixedEffectCoordinate.update_and_score = slow
game_train.main(["--config", sys.argv[1], "--device", "cpu"])
"""


def test_sigterm_then_resume_matches_uninterrupted(tmp_path):
    _write_driver_inputs(tmp_path)
    whole = tgame.run_game_training(_driver_params(tmp_path, "whole"), device="cpu")

    params = _driver_params(tmp_path, "killed")
    cfg = str(tmp_path / "killed.json")
    with open(cfg, "w") as f:
        json.dump(params, f)
    ckdir = os.path.join(params["output_dir"], "checkpoints", "combo-0")
    env = {**os.environ, "PYTHONPATH": os.pathsep.join([REPO, os.environ.get("PYTHONPATH", "")])}
    proc = subprocess.Popen([sys.executable, "-c", _SLOW_CLI, cfg], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    try:
        deadline = time.monotonic() + 120
        while not os.path.isdir(os.path.join(ckdir, "step-1")):
            assert proc.poll() is None, proc.stdout.read().decode()[-2000:]
            assert time.monotonic() < deadline, "no checkpoint within 120 s"
            time.sleep(0.05)
        proc.send_signal(signal.SIGTERM)
        out = proc.communicate(timeout=120)[0].decode()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, out[-2000:]
    marker = read_preempted_marker(ckdir)
    assert marker is not None and marker["signal"] == int(signal.SIGTERM)
    assert 1 <= marker["step"] < 6
    assert tckpt.latest_checkpoint(ckdir).step == marker["step"]
    assert not os.path.exists(os.path.join(params["output_dir"], "all"))

    resumed = tgame.run_game_training({**params, "resume": True}, device="cpu")
    assert read_preempted_marker(ckdir) is None
    for g, r in zip(resumed.sweep, whole.sweep):
        assert [h.objective for h in g["history"]] == [h.objective for h in r["history"]]
        for name, p in r["model"].params.items():
            np.testing.assert_array_equal(g["model"].params[name].numpy(), p.numpy())
    assert os.path.exists(os.path.join(resumed.output_dirs[0], "model-spec.json"))


def test_background_writer_retries_a_failed_write_at_join():
    """A write that fails on the writer thread runs again synchronously at
    the next join; only a second failure raises."""
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) == 1:
            raise OSError("disk went away")

    writer = tdescent._AsyncCheckpointWriter()
    writer.submit(flaky)
    writer.join()
    assert len(calls) == 2
    writer.join()  # nothing pending
    assert len(calls) == 2

    def broken():
        raise OSError("still gone")

    writer.submit(broken)
    with pytest.raises(OSError, match="still gone"):
        writer.join()
    assert writer._thread is None
