"""The GLM solver options of the port on the CPU against the JAX package's,
on the same seeded objectives: OWL-QN (L1 and elastic net), the exact
Newton solver (with the Levenberg jitter retry), ``train_glm`` with
coefficient variances under TRON, L-BFGS with box constraints, OWL-QN and
NEWTON, the constraint file with every wildcard rule, and the bootstrap
replica solves given the same (R, n) weights.

Tolerances: float64; the same iteration count and convergence reason
exactly; coefficients and variances within 1e-8 x max(1, ||.||_inf);
tracker tapes within 1e-8 relative; Newton directions within 1e-10.
"""

import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import photon_ml_tpu.models.bootstrap as jax_bootstrap
from photon_ml_tpu.core.normalization import NormalizationType as JNormType
from photon_ml_tpu.core.types import LabeledBatch as JBatch
from photon_ml_tpu.io.constraints import load_constraint_bounds as j_load_bounds
from photon_ml_tpu.io.vocab import FeatureVocabulary as JVocab
from photon_ml_tpu.models.glm import TaskType as JTask
from photon_ml_tpu.models.training import GLMTrainingConfig as JTrainConfig
from photon_ml_tpu.models.training import OptimizerType as JOptimizer
from photon_ml_tpu.models.training import train_glm as j_train_glm
from photon_ml_tpu.ops import losses as jax_losses
from photon_ml_tpu.ops.objective import GLMObjective as JObjective
from photon_ml_tpu.ops.objective import RegularizationContext as JReg
from photon_ml_tpu.ops.sparse import from_dense as j_from_dense
from photon_ml_tpu.solvers import SolverConfig as JConfig
from photon_ml_tpu.solvers import lbfgs as jax_lbfgs
from photon_ml_tpu.solvers import newton as jax_newton
from photon_ml_tpu_torch.core.normalization import NormalizationType
from photon_ml_tpu_torch.core.tasks import TaskType
from photon_ml_tpu_torch.interop import (
    bounds_from_numpy,
    labeled_batch_from_numpy,
    sparse_from_numpy,
)
from photon_ml_tpu_torch.io.constraints import (
    constraint_bounds,
    load_constraint_bounds,
    parse_constraint_string,
)
from photon_ml_tpu_torch.io.vocab import FeatureVocabulary
from photon_ml_tpu_torch.models import bootstrap as port_bootstrap
from photon_ml_tpu_torch.models.training import (
    GLMTrainingConfig,
    OptimizerType,
    train_glm,
)
from photon_ml_tpu_torch.ops import losses as port_losses
from photon_ml_tpu_torch.ops.objective import GLMObjective, RegularizationContext
from photon_ml_tpu_torch.solvers import (
    NEWTON_DEFAULT_CONFIG,
    ConvergenceReason,
    SolverConfig,
    host_reads,
    minimize_newton,
    minimize_owlqn,
    reset_host_reads,
)
from photon_ml_tpu_torch.solvers import lbfgs as port_lbfgs
from photon_ml_tpu_torch.solvers import newton as port_newton

N, D = 160, 20


def _problem(rng, sparse, n=N, d=D):
    x = rng.standard_normal((n, d)) * (rng.uniform(size=(n, d)) < 0.4)
    x[:, d - 1] = 1.0  # the intercept column
    w_true = 0.6 * rng.standard_normal(d) * (rng.uniform(size=d) < 0.5)
    y = (rng.uniform(size=n) < 1 / (1 + np.exp(-(x @ w_true)))).astype(np.float64)
    off = 0.1 * rng.standard_normal(n)
    wts = rng.uniform(0.5, 2.0, size=n)
    mask = np.ones(n)
    mask[-5:] = 0.0
    if sparse:
        jf = j_from_dense(x, dtype=jnp.float64)
        pf = sparse_from_numpy(np.asarray(jf.indices), np.asarray(jf.values), jf.d)
    else:
        jf, pf = jnp.asarray(x), x
    jb = JBatch(jf, jnp.asarray(y), jnp.asarray(off), jnp.asarray(wts), jnp.asarray(mask))
    return x, jb, labeled_batch_from_numpy(pf, y, off, wts, mask)


def _close_w(got, ref, what="w"):
    ref = np.asarray(ref, np.float64)
    got = got.detach().cpu().numpy() if torch.is_tensor(got) else np.asarray(got)
    tol = 1e-8 * max(1.0, np.abs(ref).max())
    assert np.abs(got - ref).max() <= tol, (what, float(np.abs(got - ref).max()))


def _same_result(got, ref):
    assert got.iterations == int(ref.iterations)
    assert got.reason == int(ref.reason)
    _close_w(got.w, ref.w)
    for g, r in zip(got.masked_history(), ref.masked_history()):
        np.testing.assert_allclose(g, r, rtol=1e-8, atol=1e-12)


# -- OWL-QN --------------------------------------------------------------------


@pytest.mark.parametrize("l1,l2", [(2.0, 0.0), (1.0, 1.0), (12.0, 0.5)],
                         ids=["l1", "elastic_net", "sparse_solution"])
@pytest.mark.parametrize("sparse", [True, False], ids=["ell", "dense"])
def test_owlqn_matches_jax(rng, sparse, l1, l2):
    _, jb, pb = _problem(rng, sparse)
    jo = JObjective(loss=jax_losses.LOGISTIC_LOSS, l2_weight=l2)
    po = GLMObjective(loss=port_losses.LOGISTIC_LOSS, l2_weight=l2)
    cfg = dict(max_iters=80, tolerance=1e-9, num_corrections=6, track_models=True)
    ref = jax_lbfgs.minimize_owlqn(lambda w: jo.value_and_grad(w, jb), jnp.zeros(D), l1,
                                   JConfig(**cfg))
    reset_host_reads()
    got = minimize_owlqn(lambda w: po.value_and_grad(w, pb), torch.zeros(D, dtype=torch.float64),
                         l1, SolverConfig(**cfg))
    _same_result(got, ref)
    assert got.evals == int(ref.evals)
    _close_w(got.grad, ref.grad, "pseudo-gradient")
    n = got.iterations + 1
    for tape in ("step_tape", "eval_tape"):
        np.testing.assert_allclose(getattr(got, tape).numpy()[:n],
                                   np.asarray(getattr(ref, tape))[:n], rtol=1e-8, atol=1e-14)
    # the same coefficients are exactly zero
    assert np.array_equal(got.w.numpy() == 0.0, np.asarray(ref.w) == 0.0)
    # one read per trial point and per history push, plus the loop tests
    assert host_reads() == 1 + got.evals - 1 + 2 * got.iterations


def test_pseudo_gradient_matches_jax(rng):
    w = np.array([1.0, -2.0, 0.0, 0.0, 0.0, 3.0])
    g = np.array([0.5, 0.5, 2.0, -2.0, 0.3, -0.1])
    for l1 in (0.0, 1.0):
        ref = np.asarray(jax_lbfgs._pseudo_gradient(jnp.asarray(w), jnp.asarray(g), l1))
        got = port_lbfgs._pseudo_gradient(torch.from_numpy(w), torch.from_numpy(g), l1)
        assert got.tolist() == ref.tolist()


def test_owlqn_keeps_the_iterate_when_the_line_search_dies():
    # a smooth part whose value never drops along any direction: every trial
    # is rejected, the iterate stays, and the reason is OBJECTIVE_NOT_IMPROVING
    def vg(w):
        return (w * w).sum() * 0.0 + 1.0 + 1e3 * (w != 0).any().to(w.dtype), torch.ones_like(w)

    cfg = SolverConfig(max_iters=5, tolerance=1e-12, ls_max_evals=4)
    got = minimize_owlqn(vg, torch.zeros(3, dtype=torch.float64), 0.1, cfg)
    assert got.reason == ConvergenceReason.OBJECTIVE_NOT_IMPROVING
    assert got.w.tolist() == [0.0, 0.0, 0.0] and got.step_tape[1] == 0.0


# -- Newton --------------------------------------------------------------------


@pytest.mark.parametrize("l2", [0.0, 0.5])
def test_newton_matches_jax(rng, l2):
    _, jb, pb = _problem(rng, False)
    jo = JObjective(loss=jax_losses.LOGISTIC_LOSS, l2_weight=l2)
    po = GLMObjective(loss=port_losses.LOGISTIC_LOSS, l2_weight=l2)
    cfg = dict(max_iters=25, tolerance=1e-10)
    ref = jax_newton.minimize_newton(lambda w: jo.value_and_grad(w, jb),
                                     lambda w: jo.hessian_full(w, jb), jnp.zeros(D),
                                     JConfig(**cfg))
    got = minimize_newton(lambda w: po.value_and_grad(w, pb), lambda w: po.hessian_full(w, pb),
                          torch.zeros(D, dtype=torch.float64), SolverConfig(**cfg))
    _same_result(got, ref)
    assert got.evals == int(ref.evals)
    assert NEWTON_DEFAULT_CONFIG.max_iters == jax_newton.NEWTON_DEFAULT_CONFIG.max_iters


def _spd(rng, d):
    a = rng.standard_normal((d, d))
    return a @ a.T + 0.5 * np.eye(d)


@pytest.mark.parametrize("kind", ["positive_definite", "barely_indefinite", "zero_column",
                                  "indefinite_after_jitter"])
@pytest.mark.parametrize("d", [6, 40], ids=["unrolled", "blocked"])
def test_newton_direction_takes_the_jitter_retry_where_jax_does(rng, kind, d):
    h = _spd(rng, d)
    if kind == "barely_indefinite":  # the jitter makes it positive definite
        h = h - (np.linalg.eigvalsh(h)[0] + 1e-8) * np.eye(d)
    elif kind == "zero_column":
        h[:, 2] = 0.0
        h[2, :] = 0.0
    elif kind == "indefinite_after_jitter":  # both solves give NaN
        h[-1, -1] = -abs(h[-1, -1])
    g = rng.standard_normal(d)
    ref = np.asarray(jax_newton._newton_direction(jnp.asarray(h), jnp.asarray(g)))
    # JAX takes the jittered solve where the plain factorization gave NaNs
    jax_retried = not np.all(np.isfinite(np.asarray(
        jax_newton._small_cho_solve(jnp.asarray(h), -jnp.asarray(g))
        if d <= jax_newton._UNROLLED_CHO_MAX_DIM else
        __import__("jax").scipy.linalg.cho_solve(
            __import__("jax").scipy.linalg.cho_factor(jnp.asarray(h)), -jnp.asarray(g)))))
    got, retried = port_newton._newton_direction(torch.from_numpy(h), torch.from_numpy(g))
    assert retried == jax_retried == (kind != "positive_definite")
    assert np.array_equal(np.isnan(got.numpy()), np.isnan(ref))
    assert np.isnan(ref).all() == (kind == "indefinite_after_jitter")
    fin = np.isfinite(ref)
    np.testing.assert_allclose(got.numpy()[fin], ref[fin], rtol=1e-9,
                               atol=1e-9 * np.abs(ref[fin]).max(initial=1.0))


def test_newton_with_a_singular_hessian_matches_jax(rng):
    # a feature column of zeros and no L2: the first Hessian is singular
    x, _, _ = _problem(rng, False)
    x[:, 3] = 0.0
    y = (rng.uniform(size=N) < 0.5).astype(np.float64)
    ones = np.ones(N)
    jb = JBatch(jnp.asarray(x), jnp.asarray(y), jnp.zeros(N), jnp.asarray(ones), jnp.asarray(ones))
    pb = labeled_batch_from_numpy(x, y, np.zeros(N), ones, ones)
    jo = JObjective(loss=jax_losses.LOGISTIC_LOSS)
    po = GLMObjective(loss=port_losses.LOGISTIC_LOSS)
    cfg = dict(max_iters=10, tolerance=1e-9)
    ref = jax_newton.minimize_newton(lambda w: jo.value_and_grad(w, jb),
                                     lambda w: jo.hessian_full(w, jb), jnp.zeros(D),
                                     JConfig(**cfg))
    got = minimize_newton(lambda w: po.value_and_grad(w, pb), lambda w: po.hessian_full(w, pb),
                          torch.zeros(D, dtype=torch.float64), SolverConfig(**cfg))
    _same_result(got, ref)
    assert got.w[3] == 0.0


# -- train_glm with variances, bounds, OWL-QN and NEWTON -----------------------

TRAIN_CASES = {
    # name: (sparse, optimizer, reg_type, normalization, bounds)
    "tron_variances_sparse": (True, "TRON", "L2", "NONE", False),
    "tron_variances_scaled": (True, "TRON", "L2", "SCALE_WITH_STANDARD_DEVIATION", False),
    "lbfgs_variances_bounds": (True, "LBFGS", "L2", "NONE", True),
    "owlqn_elastic_net_variances": (True, "LBFGS", "ELASTIC_NET", "NONE", False),
    "owlqn_l1_dense": (False, "LBFGS", "L1", "NONE", False),
    "newton_dense_scaled": (False, "NEWTON", "L2", "SCALE_WITH_MAX_MAGNITUDE", False),
    "lbfgs_variances_standardized": (False, "LBFGS", "L2", "STANDARDIZATION", False),
}


@pytest.mark.parametrize("case", list(TRAIN_CASES))
def test_train_glm_matches_jax(rng, case):
    sparse, optimizer, reg_type, normalization, with_bounds = TRAIN_CASES[case]
    _, jb, pb = _problem(rng, sparse)
    lower = upper = None
    common = dict(reg_weights=(3.0, 0.5), max_iters=60, tolerance=1e-10,
                  compute_variances=True, intercept_index=D - 1)
    if with_bounds:
        lower = np.full(D, -1.0)
        upper = np.full(D, 1.0)
        lower[D - 1], upper[D - 1] = -np.inf, np.inf
        # the projected L-BFGS of both packages stops converging once a bound
        # binds (it runs to max_iters and rounding differences grow), so this
        # case takes one lambda and a tolerance it meets
        common.update(reg_weights=(3.0,), tolerance=1e-6)
    ref = j_train_glm(jb, JTrainConfig(
        task=JTask.LOGISTIC_REGRESSION, optimizer=JOptimizer[optimizer],
        regularization=JReg(reg_type, alpha=0.5), normalization=JNormType[normalization],
        lower_bounds=lower, upper_bounds=upper, path_mode="loop", **common))
    lb, ub = bounds_from_numpy(lower, upper)
    got = train_glm(pb, GLMTrainingConfig(
        task=TaskType.LOGISTIC_REGRESSION, optimizer=OptimizerType[optimizer],
        regularization=RegularizationContext(reg_type, alpha=0.5),
        normalization=NormalizationType[normalization],
        lower_bounds=lb, upper_bounds=ub, **common))
    for g, r in zip(got, ref):
        assert g.reg_weight == r.reg_weight
        assert g.result.iterations == int(r.result.iterations)
        assert g.result.reason == int(r.result.reason)
        _close_w(g.model.coefficients.means, r.model.coefficients.means, "means")
        _close_w(g.model.coefficients.variances, r.model.coefficients.variances, "variances")
        assert bool((g.model.coefficients.variances > 0).all())
    if with_bounds:
        w = got[0].model.coefficients.means.numpy()
        assert np.all(w >= lower) and np.all(w <= upper)
        assert np.any(w == upper) or np.any(w == lower)  # a bound binds
        assert got[0].result.reason != ConvergenceReason.MAX_ITERATIONS


def test_variances_are_the_inverse_hessian_diagonal(rng):
    _, _, pb = _problem(rng, True)
    cfg = GLMTrainingConfig(reg_weights=(2.0,), regularization=RegularizationContext("L2"),
                            compute_variances=True, tolerance=1e-10)
    (tm,) = train_glm(pb, cfg)
    obj = GLMObjective(loss=port_losses.LOGISTIC_LOSS, l2_weight=2.0)
    diag = obj.hessian_diagonal(tm.result.w, pb)
    assert torch.allclose(tm.model.coefficients.variances, 1.0 / diag, rtol=1e-14, atol=0)
    (plain,) = train_glm(pb, dataclasses.replace(cfg, compute_variances=False))
    assert plain.model.coefficients.variances is None


@pytest.mark.parametrize("kw,match", [
    (dict(optimizer=OptimizerType.TRON, regularization=RegularizationContext("L1")), "TRON"),
    (dict(optimizer=OptimizerType.NEWTON, regularization=RegularizationContext("L1")), "L2 only"),
    (dict(optimizer=OptimizerType.NEWTON, task=TaskType.SMOOTHED_HINGE_LOSS_LINEAR_SVM),
     "first-order"),
    (dict(optimizer=OptimizerType.NEWTON, lower_bounds=np.zeros(3)), "box constraints"),
    (dict(optimizer=OptimizerType.NEWTON, normalization=NormalizationType.STANDARDIZATION,
          intercept_index=2), "scale-only"),
    (dict(lower_bounds=np.zeros(3), normalization=NormalizationType.SCALE_WITH_MAX_MAGNITUDE),
     "normalization"),
])
def test_config_validation_mirrors_jax(kw, match):
    with pytest.raises(ValueError, match=match):
        GLMTrainingConfig(**kw).validate()
    jkw = {k: (JOptimizer[v.name] if isinstance(v, OptimizerType)
               else JTask[v.name] if isinstance(v, TaskType)
               else JNormType[v.name] if isinstance(v, NormalizationType)
               else JReg(v.reg_type, v.alpha) if isinstance(v, RegularizationContext)
               else v) for k, v in kw.items()}
    with pytest.raises(ValueError, match=match):
        JTrainConfig(**jkw).validate()


# -- constraint files ----------------------------------------------------------

CONSTRAINTS = [
    {"name": "*", "term": "*", "lowerBound": -5.0, "upperBound": 5.0},
    {"name": "age", "term": "*", "lowerBound": 0.0},
    {"name": "age", "term": "b", "upperBound": 0.5, "lowerBound": -0.5},
    {"name": "city", "term": "x", "upperBound": 1.0},
    {"name": "missing", "term": "q", "lowerBound": 1.0},
    {"name": "(INTERCEPT)", "term": "", "lowerBound": 1.0, "upperBound": 2.0},
]
KEYS = ["age\x01a", "age\x01b", "city\x01x", "city\x01y", "plain\x01"]


def test_constraint_file_matches_jax(tmp_path):
    path = tmp_path / "bounds.json"
    path.write_text(json.dumps(CONSTRAINTS))
    jl, ju = j_load_bounds(str(path), JVocab(KEYS, add_intercept=True))
    pl, pu = load_constraint_bounds(str(path), FeatureVocabulary(KEYS, add_intercept=True))
    assert pl.tolist() == jl.tolist() == [0.0, -0.5, -np.inf, -5.0, -5.0, -np.inf]
    assert pu.tolist() == ju.tolist() == [np.inf, 0.5, 1.0, 5.0, 5.0, np.inf]


def test_constraint_file_without_a_bound_is_none_and_bad_files_raise():
    vocab = FeatureVocabulary(KEYS, add_intercept=True)
    assert constraint_bounds([], vocab) == (None, None)
    assert constraint_bounds(parse_constraint_string('[{"name": "nope", "term": "z"}]'),
                             vocab) == (None, None)
    with pytest.raises(ValueError, match="wildcard"):
        parse_constraint_string('[{"name": "*", "term": "a"}]')
    with pytest.raises(ValueError, match="lowerBound > upperBound"):
        parse_constraint_string('[{"name": "a", "lowerBound": 2, "upperBound": 1}]')
    with pytest.raises(ValueError, match="array"):
        parse_constraint_string('{"name": "a"}')


# -- bootstrap replicas --------------------------------------------------------


@pytest.mark.parametrize("optimizer", ["TRON", "LBFGS"])
def test_bootstrap_replicas_match_jax_given_the_same_weights(rng, monkeypatch, optimizer):
    _, jb, pb = _problem(rng, True)
    _, jvb, pvb = _problem(rng, True)
    replicas = 4
    counts = rng.multinomial(N - 5, np.r_[np.ones(N - 5), np.zeros(5)] / (N - 5), size=replicas)
    weights_r = np.asarray(jb.weights * jb.mask) * counts
    monkeypatch.setattr(jax_bootstrap, "_resample_weights", lambda *a, **k: jnp.asarray(weights_r))
    common = dict(reg_weights=(1.5,), max_iters=50, tolerance=1e-10, intercept_index=D - 1)
    ref = jax_bootstrap.bootstrap_train_glm(
        jb, JTrainConfig(optimizer=JOptimizer[optimizer], regularization=JReg("L2"), **common),
        num_replicas=replicas, evaluation_batch=jvb)
    cfg = GLMTrainingConfig(optimizer=OptimizerType[optimizer],
                            regularization=RegularizationContext("L2"), **common)
    w = port_bootstrap.bootstrap_replicas(pb, cfg, weights_r)
    _close_w(w, ref.coefficients, "replicas")
    got = port_bootstrap.summarize_replicas(pb, cfg, w, evaluation_batch=pvb)
    for field in ("mean", "stddev", "min", "max", "lower", "upper"):
        _close_w(getattr(got.summary, field), getattr(ref.summary, field), field)
    assert set(got.metric_distributions) == set(ref.metric_distributions)
    for name, values in ref.metric_distributions.items():
        np.testing.assert_allclose(got.metric_distributions[name], values, rtol=0, atol=1e-8)


def test_bootstrap_draws_are_seeded_and_skip_padding(rng):
    _, _, pb = _problem(rng, True)
    w1 = port_bootstrap.resample_weights(torch.Generator().manual_seed(3), pb.weights,
                                         pb.mask, 5, 0.7)
    w2 = port_bootstrap.resample_weights(torch.Generator().manual_seed(3), pb.weights,
                                         pb.mask, 5, 0.7)
    assert torch.equal(w1, w2) and w1.shape == (5, N)
    assert not w1[:, -5:].any()  # masked rows are never drawn
    counts = w1 / pb.weights
    assert torch.allclose(counts.sum(1), torch.full((5,), float(round(0.7 * (N - 5))),
                                                    dtype=torch.float64))
    result = port_bootstrap.bootstrap_train_glm(
        pb, GLMTrainingConfig(reg_weights=(1.0,), tolerance=1e-8), num_replicas=3, seed=1)
    assert result.coefficients.shape == (3, D)
    assert np.all(result.summary.lower <= result.summary.upper)
