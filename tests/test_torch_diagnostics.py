"""The port's model diagnostics on the CPU against the JAX package's, on the
same inputs: Hosmer–Lemeshow, Kendall-tau independence, both feature
importances, the learning-curve fitting diagnostic (the same numpy-seeded
partitions, refit through each package's ``train_glm``), the bootstrap
diagnostic given the same replica weights, and the HTML report.

Tolerances: float64; statistics from the same numbers exactly (HL bins and
counts, tau pair counts); chi-square, tau and metrics within 1e-10 where
they are computed from the same inputs and within 1e-8 where they come
from the two packages' solves; the HTML rendered by either package's
renderer from the port's report is the same text.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import photon_ml_tpu.models.bootstrap as jax_bootstrap
from photon_ml_tpu.core.types import LabeledBatch as JBatch
from photon_ml_tpu.diagnostics import bootstrap_diag as j_boot
from photon_ml_tpu.diagnostics import fitting as j_fitting
from photon_ml_tpu.diagnostics import hl as j_hl
from photon_ml_tpu.diagnostics import html as j_html
from photon_ml_tpu.diagnostics import importance as j_importance
from photon_ml_tpu.diagnostics import independence as j_independence
from photon_ml_tpu.io.vocab import FeatureVocabulary as JVocab
from photon_ml_tpu.models.training import GLMTrainingConfig as JTrainConfig
from photon_ml_tpu.models.training import OptimizerType as JOptimizer
from photon_ml_tpu.ops.objective import RegularizationContext as JReg
from photon_ml_tpu.ops.sparse import from_dense as j_from_dense
from photon_ml_tpu.ops.stats import summarize_features as j_summarize
from photon_ml_tpu_torch.diagnostics import bootstrap_diag, fitting, hl, html, importance
from photon_ml_tpu_torch.diagnostics import independence
from photon_ml_tpu_torch.diagnostics.reports import (
    DiagnosticReport,
    ModelDiagnosticReport,
    SystemReport,
)
from photon_ml_tpu_torch.interop import labeled_batch_from_numpy, sparse_from_numpy
from photon_ml_tpu_torch.io.vocab import FeatureVocabulary
from photon_ml_tpu_torch.models import bootstrap as port_bootstrap
from photon_ml_tpu_torch.models.training import GLMTrainingConfig, OptimizerType
from photon_ml_tpu_torch.ops.objective import RegularizationContext
from photon_ml_tpu_torch.ops.stats import summarize_features


def _scores(rng, n):
    p = rng.uniform(0.02, 0.98, size=n)
    y = (rng.uniform(size=n) < p).astype(np.float64)
    w = rng.uniform(0.5, 2.0, size=n)
    w[::11] = 0.0
    return y, p, w


@pytest.mark.parametrize("n,dims", [(400, 6), (2000, 30), (50, 3)])
def test_hosmer_lemeshow_matches_jax(rng, n, dims):
    y, p, w = _scores(rng, n)
    ref = j_hl.hosmer_lemeshow(y, p, num_dimensions=dims, weights=w)
    got = hl.hosmer_lemeshow(torch.from_numpy(y), torch.from_numpy(p), num_dimensions=dims,
                             weights=torch.from_numpy(w))
    assert got.bins == tuple(hl.HistogramBin(b.lower, b.upper, b.observed_pos, b.observed_neg)
                             for b in ref.bins)
    assert got.degrees_of_freedom == ref.degrees_of_freedom
    assert got.binning_msg == ref.binning_msg and got.chi_square_msg == ref.chi_square_msg
    assert got.chi_square == pytest.approx(ref.chi_square, rel=1e-12, abs=1e-12)
    assert got.p_value == pytest.approx(ref.p_value, rel=1e-10, abs=1e-12)
    assert got.cutoffs == ref.cutoffs


@pytest.mark.parametrize("ties", [False, True])
def test_kendall_tau_matches_jax(rng, ties):
    a = rng.standard_normal(300)
    b = 0.3 * a + rng.standard_normal(300)
    if ties:
        a, b = np.round(a, 1), np.round(b, 1)
    ref = j_independence.kendall_tau(a, b)
    got = independence.kendall_tau(torch.from_numpy(a), b)
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)


def test_prediction_error_independence_samples_like_jax(rng):
    y, p, w = _scores(rng, 900)
    ref = j_independence.prediction_error_independence(y, p, weights=w, seed=5, max_sample=120)
    got = independence.prediction_error_independence(
        torch.from_numpy(y), torch.from_numpy(p), weights=torch.from_numpy(w), seed=5,
        max_sample=120)
    np.testing.assert_array_equal(got.predictions, ref.predictions)
    np.testing.assert_array_equal(got.errors, ref.errors)
    assert dataclasses.asdict(got.kendall_tau) == dataclasses.asdict(ref.kendall_tau)


N, D = 360, 8


def _design(rng, n=N, d=D, sparse=True):
    x = rng.standard_normal((n, d)) * (rng.uniform(size=(n, d)) < 0.6)
    x[:, d - 1] = 1.0
    w_true = 0.7 * rng.standard_normal(d)
    y = (rng.uniform(size=n) < 1 / (1 + np.exp(-(x @ w_true)))).astype(np.float64)
    off = 0.1 * rng.standard_normal(n)
    wts = rng.uniform(0.5, 2.0, size=n)
    mask = np.ones(n)
    mask[-6:] = 0.0
    if sparse:
        jf = j_from_dense(x, dtype=jnp.float64)
        pf = sparse_from_numpy(np.asarray(jf.indices), np.asarray(jf.values), jf.d)
    else:
        jf, pf = jnp.asarray(x), x
    jb = JBatch(jf, jnp.asarray(y), jnp.asarray(off), jnp.asarray(wts), jnp.asarray(mask))
    return jb, labeled_batch_from_numpy(pf, y, off, wts, mask)


KEYS = [f"f{i}\x01{'t' if i % 2 else ''}" for i in range(D - 1)]


@pytest.mark.parametrize("kind", ["EXPECTED_MAGNITUDE", "VARIANCE"])
@pytest.mark.parametrize("with_summary", [True, False])
def test_feature_importance_matches_jax(rng, kind, with_summary):
    jb, pb = _design(rng)
    coef = rng.standard_normal(D)
    js = j_summarize(jb) if with_summary else None
    ps = summarize_features(pb) if with_summary else None
    ref = j_importance.feature_importance(coef, JVocab(KEYS, add_intercept=True), js, kind)
    got = importance.feature_importance(torch.from_numpy(coef),
                                        FeatureVocabulary(KEYS, add_intercept=True), ps, kind)
    assert (got.importance_type, got.importance_description) == (
        ref.importance_type, ref.importance_description)
    assert [(f.name, f.term, f.index) for f in got.features] == [
        (f.name, f.term, f.index) for f in ref.features]
    for g, r in zip(got.features, ref.features):
        assert g.importance == pytest.approx(r.importance, rel=1e-12)
        assert g.coefficient == r.coefficient
    assert got.rank_to_importance == pytest.approx(ref.rank_to_importance, rel=1e-12)


def _configs(**kw):
    common = dict(reg_weights=(4.0, 0.5), max_iters=60, tolerance=1e-10,
                  intercept_index=D - 1)
    common.update(kw)
    return (
        JTrainConfig(optimizer=JOptimizer.TRON, regularization=JReg("L2"), path_mode="loop",
                     **common),
        GLMTrainingConfig(optimizer=OptimizerType.TRON,
                          regularization=RegularizationContext("L2"), **common),
    )


def test_fitting_diagnostic_matches_jax(rng):
    jb, pb = _design(rng)
    jcfg, pcfg = _configs()
    ref = j_fitting.fitting_diagnostic(jb, jcfg, seed=3)
    got = fitting.fitting_diagnostic(pb, pcfg, seed=3)
    assert set(got) == set(ref) == {4.0, 0.5}
    for lam in ref:
        assert set(got[lam].metrics) == set(ref[lam].metrics)
        for name, (portions, train, test) in ref[lam].metrics.items():
            gp, gtr, gte = got[lam].metrics[name]
            np.testing.assert_array_equal(gp, portions)
            np.testing.assert_allclose(gtr, train, rtol=0, atol=1e-8)
            np.testing.assert_allclose(gte, test, rtol=0, atol=1e-8)


def test_fitting_diagnostic_needs_enough_rows(rng):
    _, pb = _design(rng, n=40)
    assert fitting.fitting_diagnostic(pb, _configs()[1]) == {}


def _same_draws(monkeypatch, replicas_seed=11):
    """Both packages' bootstrap draws replaced by one numpy draw of the
    same shape, so their replica solves see the same weights."""
    def draws(base_weights, mask, num_replicas, portion):
        m = np.asarray(mask) > 0
        real = np.flatnonzero(m)
        count = max(1, int(round(real.size * portion)))
        rows = np.random.default_rng(replicas_seed).choice(real, (num_replicas, count))
        counts = np.stack([np.bincount(r, minlength=m.size) for r in rows])
        return np.asarray(base_weights) * counts

    monkeypatch.setattr(jax_bootstrap, "_resample_weights",
                        lambda key, b, m, r, portion=1.0: jnp.asarray(draws(b, m, r, portion)))
    monkeypatch.setattr(port_bootstrap, "resample_weights",
                        lambda g, b, m, r, portion=1.0: torch.from_numpy(
                            draws(b.numpy(), m.numpy(), r, portion)))


def test_bootstrap_diagnostic_matches_jax_given_the_same_draws(rng, monkeypatch):
    _same_draws(monkeypatch)
    jb, pb = _design(rng)
    jvb, pvb = _design(rng, n=120)
    jcfg, pcfg = _configs(reg_weights=(1.0,))
    coef = rng.standard_normal(D)
    ref = j_boot.bootstrap_diagnostic(jb, jcfg, coef, JVocab(KEYS, add_intercept=True),
                                      summary=j_summarize(jb), evaluation_batch=jvb,
                                      num_replicas=6)
    got = bootstrap_diag.bootstrap_diagnostic(pb, pcfg, coef, FeatureVocabulary(KEYS, True),
                                              summary=summarize_features(pb),
                                              evaluation_batch=pvb, num_replicas=6)
    assert (got.num_replicas, got.portion) == (ref.num_replicas, ref.portion)
    assert set(got.metric_distributions) == set(ref.metric_distributions)
    for k, v in ref.metric_distributions.items():
        np.testing.assert_allclose(got.metric_distributions[k], v, rtol=0, atol=1e-8)
    for gl, rl in ((got.important_features, ref.important_features),
                   (got.straddling_zero, ref.straddling_zero)):
        assert [f.index for f in gl] == [f.index for f in rl]
        for g, r in zip(gl, rl):
            np.testing.assert_allclose(
                [g.min, g.q1, g.median, g.q3, g.max], [r.min, r.q1, r.median, r.q3, r.max],
                rtol=0, atol=1e-8)


def test_html_report_renders_like_jax(rng):
    y, p, w = _scores(rng, 500)
    vocab = FeatureVocabulary(KEYS, add_intercept=True)
    coef = rng.standard_normal(D)
    model = ModelDiagnosticReport(
        model_description="LOGISTIC_REGRESSION @ lambda = 1",
        reg_weight=1.0,
        metrics={"AREA_UNDER_RECEIVER_OPERATOR_CHARACTERISTICS": 0.75},
        prediction_error_independence=independence.prediction_error_independence(y, p, w),
        hosmer_lemeshow=hl.hosmer_lemeshow(y, p, num_dimensions=D, weights=w),
        mean_impact_importance=importance.feature_importance(coef, vocab),
        variance_impact_importance=importance.feature_importance(coef, vocab, kind="VARIANCE"),
        fit_report=fitting.FittingReport(metrics={"AUC": (
            np.array([10.0, 20.0]), np.array([0.7, 0.72]), np.array([0.69, np.nan]))}),
    )
    report = DiagnosticReport(
        system=SystemReport(params={"task": "LOGISTIC_REGRESSION", "<b>": 1}, num_features=D,
                            summary_table={"mean": [0.5] * D}, feature_names=["a"] * D),
        models=[model],
    )
    got = html.render_html(report)
    assert got == j_html.render_html(report)
    assert got.startswith("<!DOCTYPE html>") and "&lt;b&gt;" in got and "<svg" in got
