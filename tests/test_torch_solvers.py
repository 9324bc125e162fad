"""The port's solvers on the CPU against the JAX package's, on the same
seeded objectives (the port's ``GLMObjective`` and the JAX package's over
the same batch): TRON on the value/grad/curvature route and L-BFGS with
the strong-Wolfe line search, over dense and padded-ELL designs, with and
without box constraints; the Gram-form two-loop recursion, the line
search and the convergence codes on their own.

Tolerances: float64; the same iteration count, convergence reason, CG
iterations (TRON) and evaluations (L-BFGS) exactly; coefficients within
1e-8 x max(1, ||w||_inf); tracker tapes within 1e-8 relative; the
two-loop direction and line-search step within 1e-12.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_ml_tpu.core.types import LabeledBatch as JBatch
from photon_ml_tpu.ops import losses as jax_losses
from photon_ml_tpu.ops.objective import GLMObjective as JObjective
from photon_ml_tpu.ops.sparse import from_dense as j_from_dense
from photon_ml_tpu.solvers import SolverConfig as JConfig
from photon_ml_tpu.solvers import lbfgs as jax_lbfgs
from photon_ml_tpu.solvers import linesearch as jax_ls
from photon_ml_tpu.solvers import minimize_lbfgs as j_lbfgs
from photon_ml_tpu.solvers import minimize_tron as j_tron
from photon_ml_tpu.solvers.common import check_convergence as j_check
from photon_ml_tpu_torch.interop import (
    labeled_batch_from_numpy,
    solver_config_from_numpy,
    sparse_from_numpy,
)
from photon_ml_tpu_torch.ops import losses as port_losses
from photon_ml_tpu_torch.ops.objective import GLMObjective
from photon_ml_tpu_torch.solvers import (
    ConvergenceReason,
    SolverConfig,
    host_reads,
    minimize_lbfgs,
    minimize_tron,
    project_to_hypercube,
    reset_host_reads,
)
from photon_ml_tpu_torch.solvers import lbfgs as port_lbfgs
from photon_ml_tpu_torch.solvers import linesearch as port_ls
from photon_ml_tpu_torch.solvers.common import check_convergence

N, D = 150, 24


def _problem(rng, sparse, loss="logistic"):
    x = rng.standard_normal((N, D)) * (rng.uniform(size=(N, D)) < 0.4)
    x[:, D - 1] = 1.0
    w_true = 0.5 * rng.standard_normal(D)
    z = x @ w_true
    if loss == "logistic":
        y = (rng.uniform(size=N) < 1 / (1 + np.exp(-z))).astype(np.float64)
    else:
        y = z + 0.2 * rng.standard_normal(N)
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


def _objectives(jb, pb, l2, loss="logistic"):
    jl = {"logistic": jax_losses.LOGISTIC_LOSS, "squared": jax_losses.SQUARED_LOSS}[loss]
    pl_ = {"logistic": port_losses.LOGISTIC_LOSS, "squared": port_losses.SQUARED_LOSS}[loss]
    return JObjective(loss=jl, l2_weight=l2), GLMObjective(loss=pl_, l2_weight=l2)


def _same_result(got, ref):
    assert got.iterations == int(ref.iterations)
    assert got.reason == int(ref.reason)
    w_ref = np.asarray(ref.w)
    tol = 1e-8 * max(1.0, np.abs(w_ref).max())
    assert np.abs(got.w.numpy() - w_ref).max() <= tol
    for g, r in zip(got.masked_history(), ref.masked_history()):
        np.testing.assert_allclose(g, r, rtol=1e-8, atol=1e-12)


@pytest.mark.parametrize("l2", [0.1, 3.0])
@pytest.mark.parametrize("sparse", [True, False], ids=["ell", "dense"])
def test_tron_matches_jax(rng, sparse, l2):
    jb, pb = _problem(rng, sparse)
    jo, po = _objectives(jb, pb, l2)
    cfg = dict(max_iters=30, tolerance=1e-9)
    ref = j_tron(
        lambda w: jo.value_and_grad(w, jb), lambda w, v: jo.hessian_vector(w, v, jb),
        jnp.zeros(D), JConfig(**cfg),
        hvp_at_fn=lambda c, v: jo.hessian_vector_at(c, v, jb),
        vgc_fn=lambda w: jo.value_grad_curvature(w, jb),
    )
    reset_host_reads()
    got = minimize_tron(
        lambda w: po.value_and_grad(w, pb), lambda w, v: po.hessian_vector(w, v, pb),
        torch.zeros(D, dtype=torch.float64), SolverConfig(**cfg),
        hvp_at_fn=lambda c, v: po.hessian_vector_at(c, v, pb),
        vgc_fn=lambda w: po.value_grad_curvature(w, pb),
    )
    _same_result(got, ref)
    assert got.cg_iterations == int(ref.cg_iterations)
    for tape in ("radius_tape", "cg_tape"):
        n = got.iterations + 1
        np.testing.assert_allclose(getattr(got, tape).numpy()[:n],
                                   np.asarray(getattr(ref, tape))[:n], rtol=1e-8)
    # one read per outer iteration and at most two per CG step, plus the
    # initial tests
    assert got.iterations <= host_reads() <= 1 + got.iterations * 2 + 2 * got.cg_iterations


def test_tron_without_the_curvature_route_matches_jax(rng):
    jb, pb = _problem(rng, True)
    jo, po = _objectives(jb, pb, 1.0)
    cfg = dict(max_iters=15, tolerance=1e-8)
    ref = j_tron(lambda w: jo.value_and_grad(w, jb),
                 lambda w, v: jo.hessian_vector(w, v, jb), jnp.zeros(D), JConfig(**cfg))
    got = minimize_tron(lambda w: po.value_and_grad(w, pb),
                        lambda w, v: po.hessian_vector(w, v, pb),
                        torch.zeros(D, dtype=torch.float64), SolverConfig(**cfg))
    _same_result(got, ref)
    assert got.cg_iterations == int(ref.cg_iterations)


@pytest.mark.parametrize("loss", ["logistic", "squared"])
@pytest.mark.parametrize("sparse", [True, False], ids=["ell", "dense"])
def test_lbfgs_matches_jax(rng, sparse, loss):
    jb, pb = _problem(rng, sparse, loss)
    jo, po = _objectives(jb, pb, 0.5, loss)
    cfg = dict(max_iters=60, tolerance=1e-10, num_corrections=5)
    ref = j_lbfgs(lambda w: jo.value_and_grad(w, jb), jnp.zeros(D), JConfig(**cfg))
    got = minimize_lbfgs(lambda w: po.value_and_grad(w, pb),
                         torch.zeros(D, dtype=torch.float64), SolverConfig(**cfg))
    _same_result(got, ref)
    assert got.evals == int(ref.evals)
    n = got.iterations + 1
    for tape in ("step_tape", "eval_tape"):
        np.testing.assert_allclose(getattr(got, tape).numpy()[:n],
                                   np.asarray(getattr(ref, tape))[:n], rtol=1e-8, atol=1e-14)


def test_lbfgs_with_box_constraints_matches_jax(rng):
    jb, pb = _problem(rng, True)
    jo, po = _objectives(jb, pb, 0.2)
    lower = np.full(D, -0.3)
    upper = np.full(D, 0.25)
    upper[0] = np.inf
    cfg = dict(max_iters=40, tolerance=1e-9, track_models=True)
    ref = j_lbfgs(lambda w: jo.value_and_grad(w, jb), jnp.zeros(D),
                  JConfig(lower_bounds=jnp.asarray(lower), upper_bounds=jnp.asarray(upper), **cfg))
    got = minimize_lbfgs(lambda w: po.value_and_grad(w, pb),
                         torch.zeros(D, dtype=torch.float64),
                         solver_config_from_numpy(lower, upper, **cfg))
    _same_result(got, ref)
    assert got.evals == int(ref.evals)
    assert np.all(got.w.numpy() <= upper + 1e-15) and np.all(got.w.numpy() >= lower - 1e-15)
    assert got.w_history.shape == (41, D)


@pytest.mark.parametrize("count,head", [(0, 0), (3, 3), (5, 0), (5, 2), (4, 1)])
def test_two_loop_matches_jax(rng, count, head):
    m, d = 5, 12
    s = rng.standard_normal((m, d))
    y = s + 0.1 * rng.standard_normal((m, d))
    rho = 1.0 / np.einsum("ij,ij->i", s, y)
    valid = np.zeros(m, bool)
    for i in range(count):
        valid[(head - 1 - i) % m] = True
    s[~valid], y[~valid], rho[~valid] = 0.0, 0.0, 0.0
    g = rng.standard_normal(d)
    jh = jax_lbfgs._History(jnp.asarray(s), jnp.asarray(y), jnp.asarray(rho),
                            jnp.int32(count), jnp.int32(head))
    ph = port_lbfgs._History(torch.from_numpy(s), torch.from_numpy(y),
                             torch.from_numpy(rho), count, head)
    ref = np.asarray(jax_lbfgs._two_loop(jh, jnp.asarray(g)))
    got = port_lbfgs._two_loop(ph, torch.from_numpy(g)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-12, atol=1e-12)
    seq = np.asarray(jax_lbfgs._two_loop_sequential(jh, jnp.asarray(g)))
    np.testing.assert_allclose(got, seq, rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("alpha0", [1e-3, 1.0, 30.0])
@pytest.mark.parametrize("shape", ["quadratic", "quartic"])
def test_strong_wolfe_matches_jax(alpha0, shape):
    # phi along a fixed direction of a 2-d objective
    def make(lib, t):
        a = t.asarray([3.0, -1.5]) if lib == "jax" else t.tensor([3.0, -1.5], dtype=torch.float64)
        direction = -a

        def f(x):
            if shape == "quadratic":
                return 0.5 * (x * x).sum() * 4.0, 4.0 * x
            return (x ** 4).sum() + (x * x).sum(), 4.0 * x ** 3 + 2.0 * x

        def phi(alpha):
            v, g = f(a + alpha * direction)
            return v, (g * direction).sum(), g

        v0, g0 = f(a)
        return phi, v0, (g0 * direction).sum(), g0

    jphi, jv0, jd0, jg0 = make("jax", jnp)
    pphi, pv0, pd0, pg0 = make("torch", torch)
    ref = jax_ls.strong_wolfe(jphi, jv0, jd0, jnp.asarray(alpha0), g0=jg0)
    got = port_ls.strong_wolfe(pphi, pv0, pd0, torch.tensor(alpha0, dtype=torch.float64), g0=pg0)
    for g, r in zip(got[:3], ref[:3]):
        np.testing.assert_allclose(np.asarray(g), np.asarray(r), rtol=1e-12, atol=1e-15)
    assert bool(got[3]) == bool(ref[3]) and got[4] == int(ref[4])


def test_cubic_min_matches_jax():
    args = [(0.0, 1.0, -2.0, 1.0, 0.5, 1.0), (0.0, 1.0, -1.0, 2.0, 3.0, 4.0),
            (1.0, 0.0, 1.0, 0.0, 1.0, 1.0), (0.5, 1.0, -1.0, 0.2, 2.0, -3.0)]
    for a in args:
        ref = float(jax_ls._cubic_min(*(jnp.asarray(v) for v in a)))
        got = float(port_ls._cubic_min(*(torch.tensor(v, dtype=torch.float64) for v in a)))
        assert got == pytest.approx(ref, rel=1e-14, abs=1e-15)


@pytest.mark.parametrize("it", [3, 10])
def test_check_convergence_codes_match_jax(it):
    cases = [(10.0, 9.0, 1.0), (10.0, 10.0 - 1e-9, 1.0), (10.0, 9.0, 1e-9),
             (10.0, 10.0, 1e-9)]
    for prev, cur, gn in cases:
        ref = int(j_check(jnp.asarray(prev), jnp.asarray(cur), jnp.asarray(gn),
                          jnp.asarray(20.0), jnp.asarray(5.0), jnp.int32(it), 10, 1e-7))
        got = int(check_convergence(*(torch.tensor(v, dtype=torch.float64)
                                      for v in (prev, cur, gn, 20.0, 5.0)), it, 10, 1e-7))
        assert got == ref
    assert ConvergenceReason(got).name in ConvergenceReason.__members__


def test_projection_clips_to_the_box():
    w = torch.tensor([-2.0, 0.5, 3.0], dtype=torch.float64)
    lo = torch.tensor([-1.0, -1.0, -1.0], dtype=torch.float64)
    hi = torch.tensor([1.0, 1.0, float("inf")], dtype=torch.float64)
    assert project_to_hypercube(w, lo, hi).tolist() == [-1.0, 0.5, 3.0]
    assert project_to_hypercube(w, None, None) is w


def test_a_zero_gradient_start_is_converged():
    got = minimize_lbfgs(lambda w: ((w * w).sum(), 2 * w), torch.zeros(3, dtype=torch.float64))
    assert got.iterations == 0 and got.reason == ConvergenceReason.GRADIENT_CONVERGED
    got = minimize_tron(lambda w: ((w * w).sum(), 2 * w), lambda w, v: 2 * v,
                        torch.zeros(3, dtype=torch.float64))
    assert got.iterations == 0 and got.cg_iterations == 0
