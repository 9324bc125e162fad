"""The port's batched per-entity solvers (``solvers/batched.py``) against
``jax.vmap`` of the JAX package's solve and against the port's own
unbatched solve, lane by lane, on the CPU in float64: about 64 entities
with ragged row counts (padded rows carry mask 0 and weight 0), one entity
with no rows, and per-entity float32 reg weights (0.1 among them)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_ml_tpu.core.tasks import TaskType as JTask
from photon_ml_tpu.game.coordinates import CoordinateConfig as JConfig
from photon_ml_tpu.game.coordinates import _make_solve as jax_make_solve
from photon_ml_tpu.models.training import OptimizerType as JOpt
from photon_ml_tpu.solvers.common import final_grad_norm as jax_final_grad_norm
from photon_ml_tpu_torch.core.tasks import TaskType
from photon_ml_tpu_torch.core.types import LabeledBatch
from photon_ml_tpu_torch.game.coordinates import (
    CoordinateConfig,
    _make_batched_solve,
    _make_solve,
)
from photon_ml_tpu_torch.game.data import RandomEffectDesign
from photon_ml_tpu_torch.models.training import OptimizerType
from photon_ml_tpu_torch.solvers import host_reads, reset_host_reads
from photon_ml_tpu_torch.solvers.batched import final_grad_norm

E, R, D = 64, 14, 5


def _problem(seed, task="LOGISTIC_REGRESSION"):
    rng = np.random.default_rng(seed)
    counts = rng.integers(1, R + 1, E)
    counts[9] = 0  # an entity with no rows: converged at its start
    mask = (np.arange(R)[None, :] < counts[:, None]).astype(float)
    x = rng.normal(size=(E, R, D)) * mask[:, :, None]
    x[:, :, -1] = mask  # intercept
    if task == "LOGISTIC_REGRESSION":
        y = (rng.uniform(size=(E, R)) < 0.4).astype(float) * mask
    else:
        y = rng.normal(size=(E, R)) * mask
    w = rng.uniform(0.5, 2.0, (E, R)) * mask
    off = rng.normal(size=(E, R)) * 0.3 * mask
    lam = rng.choice([0.1, 0.7, 1.0, 3.0, 10.0], E).astype(np.float32)
    w0 = rng.normal(size=(E, D)) * 0.2
    w0[9] = 0.0  # its gradient is 0
    return x, y, w, mask, off, lam, w0


def _torch(a):
    return torch.from_numpy(np.array(a))


CASES = [("TRON", "LOGISTIC_REGRESSION"), ("LBFGS", "LOGISTIC_REGRESSION"),
         ("TRON", "LINEAR_REGRESSION"), ("LBFGS", "POISSON_REGRESSION")]


@pytest.mark.parametrize("optimizer,task", CASES, ids=[f"{o}-{t}" for o, t in CASES])
def test_batched_solve_equals_vmap_and_unbatched(optimizer, task):
    x, y, w, mask, off, lam, w0 = _problem(3, task)
    common = dict(max_iters=30, tolerance=1e-7, track_states=True)
    tcfg = CoordinateConfig(shard="u", random_effect="uid", task=TaskType[task],
                            optimizer=OptimizerType[optimizer], **common)
    jcfg = JConfig(shard="u", random_effect="uid", task=JTask[task],
                   optimizer=JOpt[optimizer], **common)
    design = RandomEffectDesign(_torch(x), _torch(y), _torch(w), _torch(mask),
                                torch.zeros((E, R), dtype=torch.int32))
    reset_host_reads()
    got = _make_batched_solve(tcfg)(_torch(w0), _torch(lam), design, _torch(off))
    reads = host_reads()
    ref = jax_make_solve(jcfg, batched=True)(
        jnp.asarray(w0), jnp.asarray(lam), jnp.asarray(x), jnp.asarray(y), jnp.asarray(off),
        jnp.asarray(w), jnp.asarray(mask))

    np.testing.assert_array_equal(got.reason.numpy(), np.asarray(ref.reason))
    np.testing.assert_array_equal(got.iterations.numpy(), np.asarray(ref.iterations))
    np.testing.assert_allclose(got.w.numpy(), np.asarray(ref.w), rtol=0, atol=1e-10)
    np.testing.assert_allclose(got.value.numpy(), np.asarray(ref.value), rtol=1e-12,
                               atol=1e-20)
    np.testing.assert_allclose(final_grad_norm(got).numpy(),
                               np.asarray(jax_final_grad_norm(ref)), rtol=0, atol=1e-10)
    if optimizer == "TRON":
        np.testing.assert_array_equal(got.cg_iterations.numpy(),
                                      np.asarray(ref.cg_iterations))
        # one host read per outer step and per CG step, never per lane
        assert reads <= int(got.iterations.max()) * (1 + 20 + 1) + 1
    else:
        np.testing.assert_array_equal(got.evals.numpy(), np.asarray(ref.evals))
    assert int(got.iterations[9]) == 0

    solve_one = _make_solve(tcfg)
    for e in range(E):
        batch = LabeledBatch(_torch(x[e]), _torch(y[e]), _torch(off[e]), _torch(w[e]),
                             _torch(mask[e]))
        one = solve_one(_torch(w0[e]), float(np.float64(lam[e])), batch)
        assert (one.reason, one.iterations) == (int(got.reason[e]), int(got.iterations[e]))
        np.testing.assert_allclose(one.w.numpy(), got.w[e].numpy(), rtol=0, atol=1e-10)
        if optimizer == "TRON":
            assert one.cg_iterations == int(got.cg_iterations[e])
        else:
            assert one.evals == int(got.evals[e])


def test_untracked_tapes_hold_the_last_state():
    x, y, w, mask, off, lam, w0 = _problem(4)
    design = RandomEffectDesign(_torch(x), _torch(y), _torch(w), _torch(mask),
                                torch.zeros((E, R), dtype=torch.int32))
    cfg = CoordinateConfig(shard="u", random_effect="uid", max_iters=20, tolerance=1e-8)
    got = _make_batched_solve(cfg)(_torch(w0), _torch(lam), design, _torch(off))
    assert got.values.shape == (E, 1)
    np.testing.assert_allclose(final_grad_norm(got).numpy(),
                               torch.linalg.norm(got.grad, dim=-1).numpy(), rtol=1e-12)
    tracked = _make_batched_solve(dataclasses.replace(cfg, track_states=True))(
        _torch(w0), _torch(lam), design, _torch(off))
    np.testing.assert_array_equal(tracked.w.numpy(), got.w.numpy())


@pytest.mark.parametrize("change", [{"l1_ratio": 0.5}, {"optimizer": OptimizerType.NEWTON}],
                         ids=["owlqn", "newton"])
def test_batched_owlqn_and_newton_are_not_ported(change):
    cfg = dataclasses.replace(CoordinateConfig(shard="u", random_effect="uid"), **change)
    with pytest.raises(NotImplementedError, match="'GAME training'"):
        _make_batched_solve(cfg)


def test_first_order_loss_refuses_tron():
    cfg = CoordinateConfig(shard="u", random_effect="uid",
                           task=TaskType.SMOOTHED_HINGE_LOSS_LINEAR_SVM)
    with pytest.raises(ValueError, match="first-order only"):
        _make_batched_solve(cfg)


def test_lane_codes_equal_one_solve_codes():
    """``check_convergence`` over (E,) lanes with per-lane iteration counts
    gives each lane the code of the one-solve call."""
    from photon_ml_tpu_torch.solvers.common import check_convergence

    prev = torch.tensor([10.0, 10.0, 10.0, 10.0, 10.0], dtype=torch.float64)
    cur = torch.tensor([9.0, 10.0 - 1e-9, 9.0, 10.0, 9.0], dtype=torch.float64)
    gn = torch.tensor([1.0, 1.0, 1e-9, 1e-9, 1.0], dtype=torch.float64)
    its = torch.tensor([3, 3, 3, 3, 10], dtype=torch.int32)
    v0, g0 = torch.tensor(20.0, dtype=torch.float64), torch.tensor(5.0, dtype=torch.float64)
    lanes = check_convergence(prev, cur, gn, v0, g0, its, 10, 1e-7)
    assert lanes.shape == (5,) and lanes.dtype == torch.int32
    one = [int(check_convergence(prev[i], cur[i], gn[i], v0, g0, int(its[i]), 10, 1e-7))
           for i in range(5)]
    assert lanes.tolist() == one
    assert len(set(one)) == 4
