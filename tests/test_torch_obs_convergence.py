"""The port's convergence-health layer (``photon_ml_tpu_torch.obs.
convergence``) and solver metrics against the JAX package's, on the CPU in
float64, on the same seeded problems: ``decode_result`` of TRON, L-BFGS,
OWL-QN and NEWTON solves from each package's ``train_glm``,
``fleet_summary`` of batched per-entity lanes, ``analyze_history``, the
``ConvergenceTracker`` report, ``note_solve`` / ``note_update`` into the
registry, and ``design_passes`` / ``record_solver_metrics``.

Tolerances: the same iterations, reason, order and counts exactly;
histories and tapes within 1e-10 relative (1e-12 absolute); the rate
estimate, a geometric mean of ratios of the last gradient norms (at
rounding noise at the end of a NEWTON or TRON solve), within 1e-6
relative.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_ml_tpu import obs as jax_obs
from photon_ml_tpu.core.types import LabeledBatch as JBatch
from photon_ml_tpu.models.glm import TaskType as JTask
from photon_ml_tpu.models.training import GLMTrainingConfig as JTrainConfig
from photon_ml_tpu.models.training import OptimizerType as JOptimizer
from photon_ml_tpu.models.training import train_glm as j_train_glm
from photon_ml_tpu.ops.objective import RegularizationContext as JReg
from photon_ml_tpu.ops.sparse import from_dense as j_from_dense
from photon_ml_tpu.solvers import common as jax_common
from photon_ml_tpu_torch import obs
from photon_ml_tpu_torch.core.tasks import TaskType
from photon_ml_tpu_torch.interop import labeled_batch_from_numpy, sparse_from_numpy
from photon_ml_tpu_torch.models.training import GLMTrainingConfig, OptimizerType, train_glm
from photon_ml_tpu_torch.ops.objective import RegularizationContext
from photon_ml_tpu_torch.solvers import common as port_common
from photon_ml_tpu_torch.solvers.batched import final_grad_norm as batched_final_grad_norm
from torch_obs_hygiene import clean_obs  # noqa: F401
from torch_obs_parity import assert_same_report

pytestmark = [pytest.mark.obs, pytest.mark.convergence, pytest.mark.usefixtures("clean_obs")]

N, D = 180, 16


def _batches(sparse, seed=20261018):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((N, D)) * (rng.uniform(size=(N, D)) < 0.5)
    x[:, D - 1] = 1.0
    w_true = 0.7 * rng.standard_normal(D)
    y = (rng.uniform(size=N) < 1 / (1 + np.exp(-(x @ w_true)))).astype(np.float64)
    off = 0.1 * rng.standard_normal(N)
    wts = rng.uniform(0.5, 2.0, size=N)
    mask = np.ones(N)
    if sparse:
        jf = j_from_dense(x, dtype=jnp.float64)
        pf = sparse_from_numpy(np.asarray(jf.indices), np.asarray(jf.values), jf.d)
    else:
        jf, pf = jnp.asarray(x), x
    jb = JBatch(jf, jnp.asarray(y), jnp.asarray(off), jnp.asarray(wts), jnp.asarray(mask))
    return jb, labeled_batch_from_numpy(pf, y, off, wts, mask)


# (optimizer, regularization, sparse design)
SOLVERS = {
    "tron": ("TRON", "L2", True),
    "lbfgs": ("LBFGS", "L2", True),
    "owlqn": ("LBFGS", "L1", False),
    "newton": ("NEWTON", "L2", False),
}


def _solve_both(kind):
    optimizer, reg, sparse = SOLVERS[kind]
    jb, pb = _batches(sparse)
    common = dict(reg_weights=(4.0, 0.5), max_iters=60, tolerance=1e-7)
    jcfg = JTrainConfig(task=JTask.LOGISTIC_REGRESSION, optimizer=JOptimizer[optimizer],
                        regularization=JReg(reg), **common)
    pcfg = GLMTrainingConfig(task=TaskType.LOGISTIC_REGRESSION,
                             optimizer=OptimizerType[optimizer],
                             regularization=RegularizationContext(reg), **common)
    return j_train_glm(jb, jcfg), train_glm(pb, pcfg)


@pytest.mark.parametrize("kind", sorted(SOLVERS))
def test_decode_result_matches_jax(kind):
    """Each solver's report: the same iterations, reason, order, plateau
    and oscillation counts, the histories and the solver's tapes (TRON's
    radius and CG steps, the others' step sizes and evaluations)."""
    jax_models, port_models = _solve_both(kind)
    for jm, pm in zip(jax_models, port_models):
        want = jax_obs.decode_result(jm.result, optimizer=kind).to_dict()
        got = obs.decode_result(pm.result, optimizer=kind).to_dict()
        assert got["iterations"] == want["iterations"] > 0
        assert got["reason"] == want["reason"]
        assert sorted(got["tapes"]) == sorted(want["tapes"]) != []
        assert_same_report(got, want, kind)


@pytest.mark.parametrize("kind", sorted(SOLVERS))
def test_solver_metrics_match_jax(kind):
    """``design_passes`` and each solver's ``record_solve_metrics``: the
    JAX counters (``solver.<prefix>.*`` and ``solver.iterations``)."""
    from photon_ml_tpu.models import training as jtraining
    from photon_ml_tpu_torch.models import training as ptraining

    optimizer, reg, _ = SOLVERS[kind]
    jax_models, port_models = _solve_both(kind)
    jreg, preg = jax_obs.MetricsRegistry(), obs.MetricsRegistry()
    prev_j, prev_p = jax_obs.set_registry(jreg), obs.set_registry(preg)
    try:
        for jm, pm in zip(jax_models, port_models):
            assert port_common.design_passes(pm.result) == jax_common.design_passes(jm.result)
            jtraining._record_solve_metrics(
                JTrainConfig(optimizer=JOptimizer[optimizer], regularization=JReg(reg)),
                jm.result)
            ptraining._record_solve_metrics(
                GLMTrainingConfig(optimizer=OptimizerType[optimizer],
                                  regularization=RegularizationContext(reg)),
                pm.result)
            assert float(port_common.final_grad_norm(pm.result)) == pytest.approx(
                float(jax_common.final_grad_norm(jm.result)), rel=1e-10)
    finally:
        jax_obs.set_registry(prev_j)
        obs.set_registry(prev_p)
    # (reading the JAX results may compile, which an installed compile
    # listener counts in the same registry: xla.compiles is not compared)
    want = {k: v for k, v in jreg.snapshot()["counters"].items() if k.startswith("solver.")}
    assert preg.snapshot()["counters"] == want
    assert any(k.endswith(".iterations") for k in want)


def _lanes(seed=7, e=40):
    """Per-entity (reason, iterations, final grad norm, entity ids) of a
    batched update: some lanes at MAX_ITERATIONS, one non-finite norm."""
    rng = np.random.default_rng(seed)
    reasons = rng.choice([1, 2, 3, 4], size=e, p=[0.3, 0.4, 0.2, 0.1]).astype(np.int32)
    iters = rng.integers(1, 12, size=e).astype(np.int32)
    gn = np.exp(rng.normal(-6, 2, size=e))
    gn[5] = np.inf
    ids = rng.permutation(3 * e)[:e]
    return reasons, iters, gn, ids


def test_fleet_summary_matches_jax_on_batched_lanes():
    """A batched result's lanes: the port's ``BatchedSolverResult``
    through ``final_grad_norm`` and ``fleet_summary`` equal the JAX
    summary of the same lanes (histogram, reason counts, worst-k)."""
    from photon_ml_tpu_torch.solvers.batched import BatchedSolverResult

    reasons, iters, gn, ids = _lanes()
    slots = 13
    tape = np.full((reasons.size, slots), np.inf)
    tape[np.arange(reasons.size), np.minimum(iters, slots - 1)] = gn
    res = BatchedSolverResult(
        w=torch.zeros((reasons.size, 2), dtype=torch.float64),
        value=torch.zeros(reasons.size, dtype=torch.float64),
        grad=torch.zeros((reasons.size, 2), dtype=torch.float64),
        iterations=torch.as_tensor(iters), reason=torch.as_tensor(reasons),
        values=torch.as_tensor(tape), grad_norms=torch.as_tensor(tape))
    port_gn = batched_final_grad_norm(res).numpy()
    np.testing.assert_array_equal(port_gn, gn)
    for worst_k in (1, 5, 60):
        want = jax_obs.fleet_summary(reasons, iters, gn, ids, coordinate="per-user",
                                     iteration=3, worst_k=worst_k).to_dict()
        got = obs.fleet_summary(res.reason.numpy(), res.iterations.numpy(), port_gn, ids,
                                coordinate="per-user", iteration=3,
                                worst_k=worst_k).to_dict()
        assert got == want


@pytest.mark.parametrize("case", ["converging", "plateau", "oscillating", "short", "nonfinite"])
def test_analyze_history_matches_jax(case):
    rng = np.random.default_rng(3)
    if case == "converging":
        g = 10.0 ** -np.arange(0, 9, 0.7)
        v = 5.0 + np.cumsum(-g)
    elif case == "plateau":
        v = np.concatenate([np.linspace(10, 2, 6), np.full(5, 2.0)])
        g = np.concatenate([np.geomspace(1, 1e-2, 6), np.full(5, 1e-2)])
    elif case == "oscillating":
        v = 3.0 + 0.5 * np.sin(np.arange(12)) * np.exp(-0.1 * np.arange(12))
        g = np.abs(rng.normal(size=12))
    elif case == "short":
        v, g = np.array([1.0]), np.array([0.5])
    else:
        v = np.array([3.0, np.nan, 2.0, 1.5, np.inf, 1.2])
        g = np.array([1.0, 0.5, np.inf, 0.1, 0.05, 0.0])
    assert obs.convergence.analyze_history(v, g) == jax_obs.convergence.analyze_history(v, g)


def test_tracker_report_and_registry_match_jax(tmp_path):
    """The same solves and updates noted into each package's tracker and
    registry: equal reports (the dumped JSON) and equal metrics."""
    import json

    jax_models, port_models = _solve_both("tron")
    reasons, iters, gn, ids = _lanes()
    docs, snaps = [], []
    for pkg, models in (("jax", jax_models), ("port", port_models)):
        o = jax_obs if pkg == "jax" else obs
        reg = o.MetricsRegistry()
        prev = o.set_registry(reg)
        tracker = o.install_convergence_tracker(last_n=3, worst_k=4)
        try:
            assert o.convergence.tracking_enabled()
            for m in models:
                o.convergence.note_solve(o.decode_result(m.result, optimizer="tron"),
                                         label=f"lambda={m.reg_weight:g}")
            for it in range(3):
                o.convergence.note_update("per-user", it, reasons, iters + it, gn * (it + 1),
                                          ids)
                o.convergence.note_update("global", it, [2], [it + 4], [1e-7], None)
            path = tracker.dump(str(tmp_path / f"{pkg}.json"))
        finally:
            o.uninstall_convergence_tracker()
            o.set_registry(prev)
        assert o.convergence_tracker() is None
        with open(path) as f:
            docs.append(json.load(f))
        snaps.append(reg.snapshot())
    assert_same_report(docs[1], docs[0], "convergence-report")
    assert snaps[1]["counters"] == snaps[0]["counters"]
    assert set(snaps[1]["gauges"]) == set(snaps[0]["gauges"])
    for k, v in snaps[0]["gauges"].items():
        assert snaps[1]["gauges"][k] == pytest.approx(v, rel=1e-10), k
