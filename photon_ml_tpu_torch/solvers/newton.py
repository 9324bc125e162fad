"""Exact Newton (IRLS) with Cholesky solves, for small-d dense designs
(counterpart of ``photon_ml_tpu/solvers/newton.py``).

Each iteration forms the explicit (d, d) Hessian X^T diag(c) X + l2 I (one
design pass), solves H p = -g by Cholesky and backtracks on the Armijo
condition (``SolverConfig.ls_c1`` / ``ls_max_evals``). When the Cholesky
meets a matrix that is not positive definite (possible only with l2 = 0 on
degenerate data) it retries once with a Levenberg jitter
1e-6 (1 + trace(H) / d) on the diagonal. The JAX package detects that case
by NaNs in the solution of its unrolled factorization; here
``torch.linalg.cholesky_ex`` reports it in ``info``. Convergence follows
``AbstractOptimizer.scala:52-62`` like the other solvers.

Host reads per iteration: the Cholesky's ``info``, one per line-search
evaluation, and the loop test.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch

from photon_ml_tpu_torch.solvers.common import (
    ConvergenceReason,
    SolverConfig,
    SolverResult,
    check_convergence,
    host_read,
    model_buffer,
    record,
    tape_buffer,
    tracker_buffers,
)
from photon_ml_tpu_torch.solvers.lbfgs import _dead_search_reason

ValueAndGrad = Callable[[torch.Tensor], Tuple[torch.Tensor, torch.Tensor]]
HessianFull = Callable[[torch.Tensor], torch.Tensor]

NEWTON_DEFAULT_CONFIG = SolverConfig(max_iters=25, tolerance=1e-7)


def _cholesky_step(h: torch.Tensor, grad: torch.Tensor):
    """(p with H p = -grad, the factorization's ``info``), for one (d, d)
    matrix or a batch of them; p is NaN where ``info`` is not 0 (H not
    positive definite), as the JAX package's factorization gives."""
    factor, info = torch.linalg.cholesky_ex(h)
    p = torch.cholesky_solve(-grad[..., None], factor)[..., 0]
    return torch.where((info == 0)[..., None], p, torch.full_like(p, float("nan"))), info


def _jittered(h: torch.Tensor) -> torch.Tensor:
    """H + 1e-6 (1 + trace(H) / d) I: the Levenberg retry of a matrix that
    is not positive definite, per matrix of a batch."""
    d = h.shape[-1]
    jitter = 1e-6 * (1.0 + torch.diagonal(h, dim1=-2, dim2=-1).sum(-1) / d)
    eye = torch.eye(d, dtype=h.dtype, device=h.device)
    return h + jitter[..., None, None] * eye


def _scaled_steepest(grad: torch.Tensor, direction: torch.Tensor) -> torch.Tensor:
    """The fallback for a direction that is not a descent direction
    (possible after the jitter): steepest descent scaled to the Newton
    step's length, per row of a batch."""
    ratio = (torch.linalg.norm(direction, dim=-1, keepdim=True)
             / torch.clamp(torch.linalg.norm(grad, dim=-1, keepdim=True), min=1e-30))
    return -grad * ratio


def _newton_direction(h: torch.Tensor, grad: torch.Tensor) -> Tuple[torch.Tensor, bool]:
    """(p with H p = -grad, whether the jitter retry ran). One host read:
    the factorization's ``info`` (0 when H is positive definite). When the
    jittered matrix is not positive definite either, p is NaN."""
    p, info = _cholesky_step(h, grad)
    if host_read(info) == 0:
        return p, False
    return _cholesky_step(_jittered(h), grad)[0], True


def minimize_newton(
    value_and_grad_fn: ValueAndGrad,
    hessian_fn: HessianFull,
    w0: torch.Tensor,
    config: SolverConfig = NEWTON_DEFAULT_CONFIG,
) -> SolverResult:
    """Minimize a twice-differentiable objective by damped exact Newton."""
    w = w0
    value, grad = value_and_grad_fn(w)
    gnorm0 = torch.linalg.norm(grad)
    values, grad_norms = tracker_buffers(config.max_iters, value, config.track_states)
    record(values, 0, value)
    record(grad_norms, 0, gnorm0)
    w_history = model_buffer(config.max_iters, w, config.track_models)
    step_tape = tape_buffer(config.max_iters, value, config.track_states)
    eval_tape = tape_buffer(config.max_iters, value, config.track_states)
    record(step_tape, 0, 0.0)
    record(eval_tape, 0, 1.0)

    value_initial, grad_norm_initial = value, gnorm0
    evals = 1
    it = 0
    reason = int(
        ConvergenceReason.GRADIENT_CONVERGED
        if host_read(gnorm0 == 0.0)
        else ConvergenceReason.NOT_CONVERGED
    )
    while reason == ConvergenceReason.NOT_CONVERGED:
        direction, _ = _newton_direction(hessian_fn(w), grad)
        dphi0 = torch.dot(grad, direction)
        # not a descent direction (possible after the jitter): steepest
        # descent scaled to the Newton step's length
        bad = dphi0 >= 0.0
        direction = torch.where(bad, _scaled_steepest(grad, direction), direction)
        dphi0 = torch.where(bad, torch.dot(grad, direction), dphi0)

        alpha = 1.0
        v_new, g_new = value_and_grad_fn(w + direction)
        ls_ok = host_read(v_new <= value + config.ls_c1 * dphi0)
        ls_evals = 1
        if not ls_ok:
            alpha = 0.5
        while not ls_ok and ls_evals < config.ls_max_evals:
            v_new, g_new = value_and_grad_fn(w + alpha * direction)
            ls_ok = host_read(v_new <= value + config.ls_c1 * alpha * dphi0)
            ls_evals += 1
            if not ls_ok:
                alpha = alpha * 0.5
        if ls_ok:
            w_new = w + alpha * direction
        else:
            # an exhausted line search keeps the previous iterate
            w_new, v_new, g_new = w, value, grad

        it += 1
        gnorm = torch.linalg.norm(g_new)
        code = check_convergence(
            value, v_new, gnorm, value_initial, grad_norm_initial, it,
            config.max_iters, config.tolerance,
        )
        if not ls_ok:
            code = _dead_search_reason(code, torch.zeros_like(code, dtype=torch.bool))
        record(values, it, v_new)
        record(grad_norms, it, gnorm)
        record(w_history, it, w_new)
        record(step_tape, it, alpha if ls_ok else 0.0)
        record(eval_tape, it, float(ls_evals))
        w, value, grad = w_new, v_new, g_new
        evals += ls_evals
        reason = host_read(code)

    return SolverResult(
        w=w,
        value=value,
        grad=grad,
        iterations=it,
        reason=reason,
        values=values,
        grad_norms=grad_norms,
        w_history=w_history if config.track_models else None,
        evals=evals,
        step_tape=step_tape,
        eval_tape=eval_tape,
    )
