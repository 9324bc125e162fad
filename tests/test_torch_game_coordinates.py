"""The port's GAME coordinates against the JAX package's, one update each,
on the CPU in float64: a fixed effect on a dense and on a padded-ELL
design (TRON, L-BFGS, OWL-QN, NEWTON), with down-sampling fed the JAX
package's own draws, and a bucketed random effect (TRON, L-BFGS), with the
rescores, the penalties and the tracker summaries."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_ml_tpu.core.tasks import TaskType as JTask
from photon_ml_tpu.game import coordinates as jcoords
from photon_ml_tpu.game import data as jdata
from photon_ml_tpu.models.training import OptimizerType as JOpt
from photon_ml_tpu.ops.sparse import from_dense as jax_from_dense
from photon_ml_tpu_torch.core.tasks import TaskType
from photon_ml_tpu_torch.game import coordinates as tcoords
from photon_ml_tpu_torch.game import data as tdata
from photon_ml_tpu_torch.models.training import OptimizerType
from photon_ml_tpu_torch.ops.sparse import from_dense

N, D_G, D_U, E = 500, 6, 3, 25


def _data(seed=11):
    rng = np.random.default_rng(seed)
    xg = rng.normal(size=(N, D_G))
    xg[rng.uniform(size=xg.shape) < 0.4] = 0.0
    xg[:, -1] = 1.0
    xu = rng.normal(size=(N, D_U))
    xu[:, -1] = 1.0
    ents = (rng.zipf(1.4, N) - 1) % E
    ents[::17] = -1
    labels = (rng.uniform(size=N) < 0.35).astype(float)
    offsets = rng.normal(size=N) * 0.2
    weights = rng.uniform(0.5, 2.0, N)
    args = ({"g": xg, "u": xu}, labels, offsets, weights, {"uid": ents})
    return jdata.GameData.create(*args), tdata.GameData.create(*args), rng


def _configs(optimizer="TRON", **kw):
    common = dict(max_iters=40, tolerance=1e-8, **kw)
    return (jcoords.CoordinateConfig(optimizer=JOpt[optimizer], **common),
            tcoords.CoordinateConfig(optimizer=OptimizerType[optimizer], **common))


# NEWTON takes dense designs only, in both packages
FIXED = [(sparse, opt, kw) for sparse in (False, True)
         for opt, kw in (("TRON", {}), ("LBFGS", {}), ("LBFGS", {"l1_ratio": 0.4}),
                         ("NEWTON", {}))
         if not (sparse and opt == "NEWTON")]


@pytest.mark.parametrize("sparse,optimizer,kw", FIXED, ids=[
    f"{'ell' if s else 'dense'}-{'owlqn' if kw else o.lower()}" for s, o, kw in FIXED])
def test_fixed_effect_update_equals_jax(sparse, optimizer, kw):
    jd, td, rng = _data()
    if sparse:
        jd.features["g"] = jax_from_dense(np.asarray(jd.features["g"]), dtype=jnp.float64)
        td.features["g"] = from_dense(np.asarray(td.features["g"]), dtype=torch.float64)
    jcfg, tcfg = _configs(optimizer, shard="g", reg_weight=0.7, **kw)
    jc = jcoords.FixedEffectCoordinate(jd.fixed_effect_batch("g", jnp.float64), jcfg)
    tc = tcoords.FixedEffectCoordinate(td.fixed_effect_batch("g", torch.float64), tcfg)
    w0 = rng.normal(size=D_G) * 0.1
    partial = rng.normal(size=N) * 0.3
    jw, jr, js = jc.update_and_score(jnp.asarray(w0), jnp.asarray(partial))
    tw, tr, ts = tc.update_and_score(torch.from_numpy(w0), torch.from_numpy(partial))
    assert (tr.reason, tr.iterations) == (int(jr.reason), int(jr.iterations))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=0, atol=1e-10)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=0, atol=1e-10)
    np.testing.assert_allclose(tc.score(tw).numpy(), np.asarray(jc.score(jw)), atol=1e-10)
    np.testing.assert_allclose(float(tc.reg_term(tw)), float(jc.reg_term(jw)), rtol=1e-12)
    assert tuple(tc.initial_params().shape) == (D_G,)


@pytest.mark.parametrize("binary", [True, False], ids=["binary", "uniform"])
def test_downsampled_fixed_effect_equals_jax_on_the_same_draws(binary, monkeypatch):
    """Both packages drop the same rows when the port is handed the JAX
    package's uniforms for the same key (the draws themselves come from
    different generators, by design)."""
    jd, td, rng = _data()
    task = "LOGISTIC_REGRESSION" if binary else "LINEAR_REGRESSION"
    if not binary:
        for d in (jd, td):
            d.labels[:] = rng.normal(size=N)
    jcfg, tcfg = _configs(shard="g", reg_weight=0.5, down_sampling_rate=0.4)
    jcfg = jcoords.CoordinateConfig(**{**jcfg.__dict__, "task": JTask[task]})
    tcfg = tcoords.CoordinateConfig(**{**tcfg.__dict__, "task": TaskType[task]})
    jc = jcoords.FixedEffectCoordinate(jd.fixed_effect_batch("g", jnp.float64), jcfg)
    tc = tcoords.FixedEffectCoordinate(td.fixed_effect_batch("g", torch.float64), tcfg)
    assert tc._ds_budget == jc._ds_budget and tc._ds_budget < N
    key = jax.random.PRNGKey(5)
    draws = np.array(jax.random.uniform(key, (N,)))
    monkeypatch.setattr(tcoords, "_uniform_draws", lambda gen, like: torch.from_numpy(draws))
    w0 = np.zeros(D_G)
    partial = rng.normal(size=N) * 0.3
    jw, jr, js = jc.update_and_score(jnp.asarray(w0), jnp.asarray(partial), key)
    tw, tr, ts = tc.update_and_score(torch.from_numpy(w0), torch.from_numpy(partial),
                                     torch.Generator())
    assert (tr.reason, tr.iterations) == (int(jr.reason), int(jr.iterations))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=0, atol=1e-10)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=0, atol=1e-10)
    with pytest.raises(ValueError, match="generator"):
        tc.update_and_score(torch.from_numpy(w0), torch.from_numpy(partial))


def test_downsample_weights_keep_positives_and_reweight():
    g = torch.Generator().manual_seed(0)
    weights = torch.ones(20000, dtype=torch.float64)
    labels = (torch.arange(20000) % 2).to(torch.float64)
    w = tcoords._binary_downsample_weights(g, weights, labels, 0.25)
    assert bool(torch.all(w[labels > 0] == 1.0))
    assert set(torch.unique(w[labels <= 0]).tolist()) == {0.0, 4.0}
    u = tcoords._uniform_downsample_weights(g, weights, labels, 0.25)
    assert abs(float(u.mean()) - 1.0) < 0.05


@pytest.mark.parametrize("optimizer", ["TRON", "LBFGS"])
def test_random_effect_update_equals_jax(optimizer):
    jd, td, rng = _data(seed=4)
    jdes = jdata.build_bucketed_random_effect_design(jd, "uid", "u", E, num_buckets=3,
                                                     dtype=jnp.float64, entity_multiple=4)
    tdes = tdata.build_bucketed_random_effect_design(td, "uid", "u", E, num_buckets=3,
                                                     dtype=torch.float64, entity_multiple=4)
    jcfg, tcfg = _configs(optimizer, shard="u", random_effect="uid", reg_weight=0.1)
    reg = rng.uniform(0.1, 3.0, E)
    rows = (np.asarray(jd.features["u"]), np.asarray(jd.entity_ids["uid"]),
            np.asarray(jd.offsets))
    jc = jcoords.RandomEffectCoordinate(jdes, *(jnp.asarray(a) for a in rows), jcfg,
                                        reg_weights=reg)
    tc = tcoords.RandomEffectCoordinate(
        tdes, torch.from_numpy(rows[0]), torch.from_numpy(rows[1].astype(np.int64)),
        torch.from_numpy(rows[2]), tcfg, reg_weights=reg)
    table = rng.normal(size=(E, D_U)) * 0.3
    partial = rng.normal(size=N) * 0.3
    jt, jsum, js = jc.update_and_score(jnp.asarray(table), jnp.asarray(partial))
    t_in = torch.from_numpy(table.copy())
    tt, tsum, ts = tc.update_and_score(t_in, torch.from_numpy(partial))
    np.testing.assert_array_equal(t_in.numpy(), table)  # the input is not modified
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), rtol=0, atol=1e-10)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=0, atol=1e-10)
    np.testing.assert_array_equal(tsum.reason, jsum.reason)
    np.testing.assert_array_equal(tsum.iterations, jsum.iterations)
    np.testing.assert_array_equal(tsum.entity_ids, jsum.entity_ids)
    np.testing.assert_allclose(tsum.grad_norms, jsum.grad_norms, rtol=0, atol=1e-10)
    assert (tsum.cg_iterations is None) == (optimizer != "TRON")
    np.testing.assert_allclose(tc.score(tt).numpy(), np.asarray(jc.score(jt)), atol=1e-10)
    np.testing.assert_allclose(float(tc.reg_term(tt)), float(jc.reg_term(jt)), rtol=1e-12)
    assert tc.initial_params().shape == tuple(jc.initial_params().shape)
    # unknown entities score 0
    assert bool(torch.all(ts[torch.from_numpy(rows[1] < 0)] == 0.0))


def test_single_design_and_config_checks():
    jd, td, rng = _data()
    tdes = tdata.build_random_effect_design(td, "uid", "u", E, dtype=torch.float64)
    _, tcfg = _configs(shard="u", random_effect="uid", reg_weight=1.0)
    rows = (torch.from_numpy(np.asarray(td.features["u"])),
            torch.from_numpy(td.entity_ids["uid"].astype(np.int64)),
            torch.from_numpy(td.offsets))
    tc = tcoords.RandomEffectCoordinate(tdes, *rows, tcfg)
    assert tc.design.num_buckets == 1 and tc.num_entities == E and tc.dim == D_U
    with pytest.raises(ValueError, match="reg_weights"):
        tcoords.RandomEffectCoordinate(tdes, *rows, tcfg, reg_weights=np.ones(3))
    with pytest.raises(ValueError, match="wrong coordinate"):
        tcoords.FixedEffectCoordinate(td.fixed_effect_batch("u", torch.float64), tcfg)
    _, fcfg = _configs(shard="g")
    with pytest.raises(ValueError, match="wrong coordinate"):
        tcoords.RandomEffectCoordinate(tdes, *rows, fcfg)
