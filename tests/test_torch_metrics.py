"""The port's ``ops.metrics.evaluate`` and ``ops.losses`` against the JAX
package's on the same seeded inputs, with weighted ties and zero-weight
rows, at rtol 1e-12 (summation order only)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_ml_tpu.core.tasks import TaskType as JTaskType
from photon_ml_tpu.ops import losses as jlosses
from photon_ml_tpu.ops import metrics as jmetrics
from photon_ml_tpu_torch.core.tasks import TaskType
from photon_ml_tpu_torch.ops import losses as tlosses
from photon_ml_tpu_torch.ops import metrics as tmetrics

TASKS = [t.name for t in TaskType]


def _data(rng, task, n=400):
    # coarse scores -> many tied groups; some zero weights (padding)
    margins = np.round(rng.standard_normal(n) * 2.0, 1)
    weights = rng.uniform(0.2, 3.0, n)
    weights[rng.uniform(size=n) < 0.1] = 0.0
    if task in ("LOGISTIC_REGRESSION", "SMOOTHED_HINGE_LOSS_LINEAR_SVM"):
        labels = (rng.uniform(size=n) < 1 / (1 + np.exp(-margins))).astype(float)
    elif task == "POISSON_REGRESSION":
        labels = rng.poisson(np.exp(np.clip(margins, -3, 2))).astype(float)
    else:
        labels = margins + rng.standard_normal(n)
    return labels, margins, weights


@pytest.mark.parametrize("num_params", [None, 7])
@pytest.mark.parametrize("task", TASKS)
def test_evaluate_matches_jax(rng, task, num_params):
    labels, margins, weights = _data(rng, task)
    ref = jmetrics.evaluate(
        JTaskType[task], jnp.asarray(labels), jnp.asarray(margins),
        jnp.asarray(weights), num_effective_params=num_params,
    )
    got = tmetrics.evaluate(
        TaskType[task], torch.from_numpy(labels), torch.from_numpy(margins),
        torch.from_numpy(weights), num_effective_params=num_params,
    )
    assert set(got) == set(ref)
    for name in ref:
        np.testing.assert_allclose(got[name], ref[name], rtol=1e-12, err_msg=name)


@pytest.mark.parametrize(
    "fn",
    ["area_under_roc_curve", "average_precision", "peak_f1",
     "mean_squared_error", "root_mean_squared_error", "mean_absolute_error"],
)
def test_each_metric_matches_jax(rng, fn):
    labels, margins, weights = _data(rng, "LOGISTIC_REGRESSION", n=257)
    ref = float(getattr(jmetrics, fn)(
        jnp.asarray(labels), jnp.asarray(margins), jnp.asarray(weights)))
    got = float(getattr(tmetrics, fn)(
        torch.from_numpy(labels), torch.from_numpy(margins),
        torch.from_numpy(weights)))
    np.testing.assert_allclose(got, ref, rtol=1e-12)


def test_auc_all_tied_and_one_class():
    y = torch.tensor([0.0, 1.0, 1.0, 0.0], dtype=torch.float64)
    s = torch.zeros(4, dtype=torch.float64)
    w = torch.ones(4, dtype=torch.float64)
    assert float(tmetrics.area_under_roc_curve(y, s, w)) == 0.5
    assert float(tmetrics.area_under_roc_curve(torch.ones(4, dtype=torch.float64), s, w)) == 0.5
    assert float(jmetrics.area_under_roc_curve(
        jnp.asarray(y.numpy()), jnp.asarray(s.numpy()), jnp.asarray(w.numpy()))) == 0.5


@pytest.mark.parametrize("task", TASKS)
def test_losses_match_jax(rng, task):
    z = np.concatenate([rng.standard_normal(60) * 3, [-40.0, 0.0, 0.5, 1.0, 40.0]])
    y = (rng.uniform(size=z.size) < 0.5).astype(float)
    jl = jlosses.loss_for_task(task)
    tl = tlosses.loss_for_task(TaskType[task])
    for part in ("value", "d1", "d2"):
        ref = np.asarray(getattr(jl, part)(jnp.asarray(z), jnp.asarray(y)))
        got = getattr(tl, part)(torch.from_numpy(z), torch.from_numpy(y)).numpy()
        np.testing.assert_allclose(got, ref, rtol=1e-12, atol=1e-300, err_msg=part)
    np.testing.assert_allclose(
        tl.mean(torch.from_numpy(z)).numpy(), np.asarray(jl.mean(jnp.asarray(z))),
        rtol=1e-12,
    )
    assert tl.twice_differentiable == jl.twice_differentiable


def test_loss_for_unknown_task_raises():
    with pytest.raises(ValueError, match="unknown task type"):
        tlosses.loss_for_task("NOPE")
