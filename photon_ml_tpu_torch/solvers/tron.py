"""TRON: trust-region Newton with truncated conjugate gradient (counterpart
of ``photon_ml_tpu/solvers/tron.py``; the reference's
``optimization/TRON.scala:82-320``, itself LIBLINEAR's tron.cpp, whose
constants are kept):

  - acceptance thresholds (eta0, eta1, eta2) = (1e-4, .25, .75)
  - radius update factors (sigma1, sigma2, sigma3) = (.25, .5, 4)
  - inner CG: <= 20 iterations, tolerance 0.1 * ||g||
  - <= 5 consecutive improvement failures, then give up

The inner CG runs over Hessian-vector products (one fused
``fused_hessian_vector`` pass each on ELL designs). Host reads per outer
iteration: the loop test (the convergence reason), one per CG step (its
boundary test) and one per CG step that stays inside the region (its
residual test), plus one for the initial residual test.

TRON is L2-only, as in the reference; callers enforce it.
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
    vdot,
    vdots,
    vnorm,
    vnorm_and_dots,
)

ValueAndGrad = Callable[[torch.Tensor], Tuple[torch.Tensor, torch.Tensor]]
Hvp = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]

_ETA0, _ETA1, _ETA2 = 1e-4, 0.25, 0.75
_SIGMA1, _SIGMA2, _SIGMA3 = 0.25, 0.5, 4.0

TRON_DEFAULT_CONFIG = SolverConfig(max_iters=15, tolerance=1e-5)


def _to_sphere(sp, ss, pp, delta):
    """tau >= 0 with ||step + tau p|| = delta, from sp = step.p,
    ss = step.step and pp = p.p: the CG step clipped to the trust-region
    boundary (``TRON.scala:283-300``). Elementwise, so one solve's scalars
    or the batched solver's lanes."""
    rad = torch.sqrt(torch.clamp(sp * sp + pp * (delta * delta - ss), min=0.0))
    return torch.where(
        sp >= 0.0,
        (delta * delta - ss) / torch.clamp(sp + rad, min=1e-30),
        (rad - sp) / torch.clamp(pp, min=1e-30),
    )


def _new_radius(delta, snorm, gs, value, v_try, actred, prered):
    """The radius after a trial step (``TRON.scala:136-224``, LIBLINEAR's
    alpha logic), from the radius the step was taken in (already tightened
    to the step length on the first iteration). Elementwise."""
    denom = v_try - value - gs
    alpha_c = torch.where(
        denom <= 0.0, torch.full_like(denom, _SIGMA3),
        torch.clamp(-0.5 * (gs / denom), min=_SIGMA1),
    )
    alpha_snorm = alpha_c * snorm
    return torch.where(
        actred < _ETA0 * prered,
        torch.minimum(torch.maximum(alpha_snorm, _SIGMA1 * snorm), _SIGMA2 * delta),
        torch.where(
            actred < _ETA1 * prered,
            torch.maximum(_SIGMA1 * delta, torch.minimum(alpha_snorm, _SIGMA2 * delta)),
            torch.where(
                actred < _ETA2 * prered,
                torch.maximum(_SIGMA1 * delta, torch.minimum(alpha_snorm, _SIGMA3 * delta)),
                torch.maximum(delta, torch.minimum(alpha_snorm, _SIGMA3 * delta)),
            ),
        ),
    )


def _step_reason(code, accept, failures, max_failures: int):
    """TRON's own rules over ``check_convergence``'s code: function-value
    convergence counts only on accepted steps (a rejected step has
    |dv| = 0 by construction), and ``max_failures`` rejected steps in a
    row stop the solve as not improving. Elementwise."""
    not_converged = torch.full_like(code, int(ConvergenceReason.NOT_CONVERGED))
    code = torch.where(
        (~accept) & (code == ConvergenceReason.FUNCTION_VALUES_CONVERGED),
        not_converged, code,
    )
    return torch.where(
        (failures >= max_failures) & (code == ConvergenceReason.NOT_CONVERGED),
        torch.full_like(code, int(ConvergenceReason.OBJECTIVE_NOT_IMPROVING)),
        code,
    )


def _truncated_cg(
    hvp: Callable[[torch.Tensor], torch.Tensor],
    grad: torch.Tensor,
    delta: torch.Tensor,
    max_cg: int,
    cg_tol_factor: float,
):
    """Solve H s ~= -grad with ||s|| <= delta (``TRON.scala:252-319``).

    Returns (s, r, iterations). Exits on residual < cg_tol_factor *
    ||grad||, on reaching the trust-region boundary (the step clipped to
    the sphere), or on max_cg."""
    gnorm = vnorm(grad)
    cg_tol = cg_tol_factor * gnorm
    step = torch.zeros_like(grad)
    r = -grad
    p = -grad
    rtr = vdot(grad, grad)
    i = 0
    done = host_read(gnorm <= cg_tol)
    while not done and i < max_cg:
        hp = hvp(p)
        php = vdot(p, hp)
        # non-positive curvature should not happen for a convex GLM + L2;
        # guard the division and treat it as a boundary hit
        alpha = rtr / torch.where(php > 0.0, php, torch.full_like(php, 1e-30))
        step_try = step + alpha * p
        r_new = r - alpha * hp
        # the step's norm and the next residual's square in one reduction
        step_norm, rtr_new = vnorm_and_dots(step_try, (r_new, r_new))
        outside = (step_norm > delta) | (php <= 0.0)
        i += 1
        if host_read(outside):
            # back to the sphere
            tau = _to_sphere(*vdots((step, p), (step, step), (p, p)), delta)
            step = step + tau * p
            r = r - tau * hp
            done = True
        else:
            beta = rtr_new / torch.clamp(rtr, min=1e-30)
            step = step_try
            r = r_new
            p = r_new + beta * p
            rtr = rtr_new
            done = host_read(torch.sqrt(rtr_new) <= cg_tol)
    return step, r, i


def minimize_tron(
    value_and_grad_fn: ValueAndGrad,
    hvp_fn: Hvp,
    w0: torch.Tensor,
    config: SolverConfig = TRON_DEFAULT_CONFIG,
    hvp_at_fn=None,
    vgc_fn=None,
) -> SolverResult:
    """Minimize a twice-differentiable objective by trust-region Newton-CG.

    ``vgc_fn(w) -> (value, grad, carry)`` with ``hvp_at_fn(carry, v) -> Hv``
    is the route the training driver takes: the acceptance evaluation at
    the trial point already computes the margins, so on acceptance the
    next iteration's CG carry (the curvature weights) is free. Without
    them every CG step goes through ``hvp_fn(w, v)``."""
    use_vgc = vgc_fn is not None and hvp_at_fn is not None
    if use_vgc:
        value, grad, curv = vgc_fn(w0)
    else:
        value, grad = value_and_grad_fn(w0)
        curv = None
    w = w0
    gnorm0 = vnorm(grad)
    values, grad_norms = tracker_buffers(config.max_iters, value, config.track_states)
    record(values, 0, value)
    record(grad_norms, 0, gnorm0)
    w_history = model_buffer(config.max_iters, w0, config.track_models)
    # slot 0 = the initial radius / no CG work before the first step
    radius_tape = tape_buffer(config.max_iters, value, config.track_states)
    cg_tape = tape_buffer(config.max_iters, value, config.track_states)
    record(radius_tape, 0, gnorm0)
    record(cg_tape, 0, 0.0)

    delta = gnorm0  # initial radius = ||g0|| (LIBLINEAR, TRON.scala:117)
    failures = torch.zeros((), dtype=torch.int32, device=value.device)
    value_initial, grad_norm_initial = value, gnorm0
    cg_total = 0
    it = 0
    reason = int(
        ConvergenceReason.GRADIENT_CONVERGED
        if host_read(gnorm0 == 0.0)
        else ConvergenceReason.NOT_CONVERGED
    )
    while reason == ConvergenceReason.NOT_CONVERGED:
        if use_vgc:
            hvp_local = lambda v, c=curv: hvp_at_fn(c, v)  # noqa: E731
        else:
            hvp_local = lambda v, w=w: hvp_fn(w, v)  # noqa: E731
        step, r, cg_iters = _truncated_cg(
            hvp_local, grad, delta, config.tron_max_cg, config.tron_cg_tol
        )
        snorm = vnorm(step)
        gs = vdot(grad, step)
        prered = -0.5 * (gs - vdot(step, r))

        w_try = w + step
        if use_vgc:
            v_try, g_try, c_try = vgc_fn(w_try)
        else:
            v_try, g_try = value_and_grad_fn(w_try)
            c_try = None
        actred = value - v_try

        # the first iteration tightens the radius to the actual step length
        if it == 0:
            delta = torch.minimum(delta, snorm)
        delta = _new_radius(delta, snorm, gs, value, v_try, actred, prered)

        accept = actred > _ETA0 * prered
        w_new = torch.where(accept, w_try, w)
        v_new = torch.where(accept, v_try, value)
        g_new = torch.where(accept, g_try, grad)
        if use_vgc:
            curv = torch.where(accept, c_try, curv)
        failures = torch.where(accept, torch.zeros_like(failures), failures + 1)

        it += 1
        gnorm = vnorm(g_new)
        code = _step_reason(
            check_convergence(value, v_new, gnorm, value_initial, grad_norm_initial, it,
                              config.max_iters, config.tolerance),
            accept, failures, config.tron_max_failures,
        )
        record(values, it, v_new)
        record(grad_norms, it, gnorm)
        record(w_history, it, w_new)
        record(radius_tape, it, delta)
        record(cg_tape, it, float(cg_iters))
        w, value, grad = w_new, v_new, g_new
        cg_total += cg_iters
        reason = host_read(code)

    return SolverResult(
        w=w,
        value=value,
        grad=grad,
        iterations=it,
        reason=reason,
        values=values,
        grad_norms=grad_norms,
        cg_iterations=cg_total,
        w_history=w_history if config.track_models else None,
        radius_tape=radius_tape,
        cg_tape=cg_tape,
    )


def record_solve_metrics(result: SolverResult, registry=None) -> None:
    """TRON counters into the obs registry: ``solver.tron.iterations``
    (outer trust-region steps) and ``solver.tron.cg_iterations`` (inner
    CG == Hessian-vector products) (JAX ``solvers/tron.py:348``). Host
    ints; callers gate on observability being enabled."""
    from photon_ml_tpu_torch.solvers.common import record_solver_metrics

    record_solver_metrics("tron", result, registry)
