"""The port's coordinate descent against the JAX package's on the CPU in
float64: three passes over a fixed effect and a bucketed random effect
(the JAX package fused into one dispatch per pass and in its per-update
loop), the divergence guard's rollback, damped retry and freeze with a
coordinate that returns non-finite values, the caller's freeze, the
preemption poll, the warm start and the model bridge."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_ml_tpu.core.tasks import TaskType as JTask
from photon_ml_tpu.game import coordinates as jcoords
from photon_ml_tpu.game import data as jdata
from photon_ml_tpu.game import descent as jdescent
from photon_ml_tpu.models.training import OptimizerType as JOpt
from photon_ml_tpu_torch import interop
from photon_ml_tpu_torch.core.tasks import TaskType
from photon_ml_tpu_torch.game import coordinates as tcoords
from photon_ml_tpu_torch.game import data as tdata
from photon_ml_tpu_torch.game import descent as tdescent
from photon_ml_tpu_torch.models.training import OptimizerType
from photon_ml_tpu_torch.resilience import GracefulShutdown

N, D_G, D_U, E = 400, 5, 3, 20


def _data(seed=21):
    rng = np.random.default_rng(seed)
    xg = rng.normal(size=(N, D_G))
    xg[:, -1] = 1.0
    xu = rng.normal(size=(N, D_U))
    xu[:, -1] = 1.0
    ents = (rng.zipf(1.5, N) - 1) % E
    ents[::13] = -1
    w_u = rng.normal(size=(E, D_U)) * 1.5
    margin = xg @ rng.normal(size=D_G) + np.einsum("nd,nd->n", xu, w_u[np.maximum(ents, 0)])
    labels = (rng.uniform(size=N) < 1 / (1 + np.exp(-margin))).astype(float)
    offsets = rng.normal(size=N) * 0.2
    weights = rng.uniform(0.5, 2.0, N)
    args = ({"g": xg, "u": xu}, labels, offsets, weights, {"uid": ents})
    return jdata.GameData.create(*args), tdata.GameData.create(*args)


def _jax_descent(jd, fuse_passes, coord_types=None):
    common = dict(task=JTask.LOGISTIC_REGRESSION, optimizer=JOpt.TRON, max_iters=30,
                  tolerance=1e-7)
    fe = jcoords.FixedEffectCoordinate(
        jd.fixed_effect_batch("g", jnp.float64),
        jcoords.CoordinateConfig(shard="g", reg_weight=0.3, **common))
    des = jdata.build_bucketed_random_effect_design(jd, "uid", "u", E, num_buckets=2,
                                                    dtype=jnp.float64)
    re = jcoords.RandomEffectCoordinate(
        des, jnp.asarray(jd.features["u"]), jnp.asarray(jd.entity_ids["uid"]),
        jnp.asarray(jd.offsets), jcoords.CoordinateConfig(
            shard="u", random_effect="uid", reg_weight=0.1, **common))
    coords = {"global": fe, "per-user": re}
    if coord_types:
        coords = {n: coord_types.get(n, lambda c: c)(c) for n, c in coords.items()}
    return jdescent.CoordinateDescent(
        coords, jnp.asarray(jd.labels), jnp.asarray(jd.offsets), jnp.asarray(jd.weights),
        JTask.LOGISTIC_REGRESSION, fuse_passes=fuse_passes)


def _torch_descent(td, coord_types=None):
    common = dict(task=TaskType.LOGISTIC_REGRESSION, optimizer=OptimizerType.TRON,
                  max_iters=30, tolerance=1e-7)
    fe = tcoords.FixedEffectCoordinate(
        td.fixed_effect_batch("g", torch.float64),
        tcoords.CoordinateConfig(shard="g", reg_weight=0.3, **common))
    des = tdata.build_bucketed_random_effect_design(td, "uid", "u", E, num_buckets=2,
                                                    dtype=torch.float64)
    re = tcoords.RandomEffectCoordinate(
        des, torch.from_numpy(np.asarray(td.features["u"])),
        torch.from_numpy(td.entity_ids["uid"].astype(np.int64)),
        torch.from_numpy(td.offsets), tcoords.CoordinateConfig(
            shard="u", random_effect="uid", reg_weight=0.1, **common))
    coords = {"global": fe, "per-user": re}
    if coord_types:
        coords = {n: coord_types.get(n, lambda c: c)(c) for n, c in coords.items()}
    t = lambda a: torch.from_numpy(np.asarray(a, np.float64))  # noqa: E731
    return tdescent.CoordinateDescent(coords, t(td.labels), t(td.offsets), t(td.weights),
                                      TaskType.LOGISTIC_REGRESSION)


def _assert_same_run(got, ref, params_atol=1e-8):
    (gm, gh), (rm, rh) = got, ref
    assert [(h.iteration, h.coordinate, h.event) for h in gh] == [
        (h.iteration, h.coordinate, h.event) for h in rh]
    for a, b in zip(gh, rh):
        np.testing.assert_allclose(a.objective, b.objective, rtol=1e-10)
        assert a.convergence_histogram == b.convergence_histogram
        assert a.solver_iterations == b.solver_iterations
    for name, p in rm.params.items():
        np.testing.assert_allclose(gm.params[name].numpy(), np.asarray(p), rtol=0,
                                   atol=params_atol, err_msg=name)


@pytest.mark.parametrize("fuse_passes", [True, False], ids=["jax-fused", "jax-per-update"])
def test_three_passes_equal_jax(fuse_passes):
    jd, td = _data()
    ref = _jax_descent(jd, fuse_passes).run(3)
    got = _torch_descent(td).run(3)
    _assert_same_run(got, ref)
    assert all(h.seconds is not None for h in got[1])
    re_rec = [h for h in got[1] if h.coordinate == "per-user"]
    assert all(h.entity_iterations.size == sum(h.convergence_histogram.values())
               and np.mean(h.entity_iterations) == h.solver_iterations for h in re_rec)
    assert got[1][0].cg_iterations > 0


def test_validation_fn_and_warm_start_equal_jax():
    jd, td = _data(seed=5)
    rng = np.random.default_rng(3)
    warm = {"global": rng.normal(size=D_G) * 0.1, "per-user": rng.normal(size=(E, D_U)) * 0.2}
    jcd = _jax_descent(jd, True)
    tcd = _torch_descent(td)
    ref = jcd.run(2, initial_model=jdescent.GameModel({n: jnp.asarray(p) for n, p in
                                                       warm.items()}),
                  validation_fn=lambda m: float(jnp.sum(m.params["global"])))
    got = tcd.run(2, initial_model=interop.game_model_from_numpy(warm),
                  validation_fn=lambda m: float(torch.sum(m.params["global"])))
    _assert_same_run(got, ref)
    for a, b in zip(got[1], ref[1]):
        np.testing.assert_allclose(a.validation_metric, b.validation_metric, atol=1e-10)
    back = interop.game_model_to_numpy(got[0])
    for n, p in ref[0].params.items():
        np.testing.assert_allclose(back[n], np.asarray(p), atol=1e-8)
    np.testing.assert_allclose(tcd.total_scores(got[0]).numpy(),
                               np.asarray(jcd.total_scores(ref[0])), atol=1e-8)


def _poisoned(calls_to_poison):
    """Wrap a coordinate so its first ``calls_to_poison`` updates return
    NaN params and scores (the guard's drill)."""

    def wrap(coord):
        state = {"calls": 0}

        class Poisoned:
            config = coord.config

            def initial_params(self):
                return coord.initial_params()

            def score(self, p):
                return coord.score(p)

            def reg_term(self, p):
                return coord.reg_term(p)

            def update_and_score(self, p, partial, key=None):
                p2, r, s = coord.update_and_score(p, partial, key)
                state["calls"] += 1
                if state["calls"] <= calls_to_poison:
                    nan = (jnp if not torch.is_tensor(s) else torch).full_like(s, np.nan)
                    return (torch.full_like(p2, np.nan) if torch.is_tensor(p2)
                            else jnp.full_like(p2, np.nan)), r, nan
                return p2, r, s

        return Poisoned()

    return wrap


@pytest.mark.parametrize("poison,event", [(1, "recovered"), (100, "frozen")])
def test_divergence_guard_equals_jax(poison, event):
    jd, td = _data(seed=8)
    types = {"per-user": _poisoned(poison)}
    ref = _jax_descent(jd, True, types).run(3, divergence_guard=True)
    got = _torch_descent(td, types).run(3, divergence_guard=True)
    _assert_same_run(got, ref)
    events = [h.event for h in got[1] if h.coordinate == "per-user"]
    assert events[0] == event
    if event == "frozen":
        # frozen after its first update: no further per-user records, and
        # its table keeps its last finite state
        assert len(events) == 1
        assert bool(torch.all(got[0].params["per-user"] == 0.0))
    assert all(np.isfinite(h.objective) for h in got[1])


def test_unguarded_nan_spreads_and_freeze_seed_equals_jax():
    jd, td = _data(seed=9)
    types = {"per-user": _poisoned(1)}
    _, hist = _torch_descent(td, types).run(1)
    assert not np.isfinite(hist[-1].objective)
    ref = _jax_descent(jd, False).run(2, freeze=["per-user"])
    got = _torch_descent(td).run(2, freeze=["per-user"])
    _assert_same_run(got, ref)
    assert {h.coordinate for h in got[1]} == {"global"}
    with pytest.raises(ValueError, match="unknown"):
        _torch_descent(td).run(1, freeze=["nope"])
    with pytest.raises(ValueError, match="every coordinate"):
        _torch_descent(td).run(1, freeze=["global", "per-user"])


def test_stop_check_ends_the_run_at_a_pass_boundary():
    _, td = _data()
    stop = GracefulShutdown()
    calls = {"n": 0}

    def check():
        calls["n"] += 1
        if calls["n"] == 2:
            stop.request()
        return stop()

    _, hist = _torch_descent(td).run(5, stop_check=check)
    assert [h.iteration for h in hist] == [0, 0, 1, 1]
    hooked = []
    stop2 = GracefulShutdown()
    stop2.register_drain(lambda: hooked.append(1))
    stop2.register_drain(lambda: 1 / 0)
    stop2.request(15)
    stop2.request(15)
    assert stop2.requested and stop2.signum == 15 and hooked == [1]


def test_warm_start_params_equal_jax():
    jd, td = _data()
    jcd, tcd = _jax_descent(jd, True), _torch_descent(td)
    warm = {"global": np.arange(D_G, dtype=float)}
    ref = jdescent._warm_start_params(jcd.coordinates, ["global", "per-user"], warm)
    got = tdescent._warm_start_params(tcd.coordinates, ["global", "per-user"], warm)
    for n in ref:
        np.testing.assert_array_equal(got[n].numpy(), np.asarray(ref[n]))
    with pytest.raises(ValueError, match="mismatched shapes"):
        tdescent._warm_start_params(tcd.coordinates, ["per-user"],
                                    {"per-user": np.zeros((E + 1, D_U))})
    # run() starts through the same helper: a mapping warm-starts the
    # coordinates it names, a stale table is refused
    jm, jh = jcd.run(1, initial_model=jdescent.GameModel(params=dict(ref)))
    tm, th = tcd.run(1, initial_model=warm)
    _assert_same_run((tm, th), (jm, jh))
    with pytest.raises(ValueError, match="mismatched shapes"):
        tcd.run(1, initial_model={"per-user": np.zeros((E + 1, D_U))})
