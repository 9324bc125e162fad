"""L-BFGS with the two-loop recursion in Gram form, and OWL-QN for L1
objectives (counterpart of ``photon_ml_tpu/solvers/lbfgs.py``; the
reference's ``optimization/LBFGS.scala:41-133`` over breeze's LBFGS and
OWLQN).

The limited-memory history is a ring buffer of (m, d) tensors whose
fill count and head are host ints; the direction is the Gram-form two-loop
recursion; the line search is :func:`strong_wolfe` (L-BFGS) or the
orthant-projected backtracking of Andrew & Gao 2007 (OWL-QN).

Host reads per iteration: the loop test (the convergence reason), the
curvature test of the history push, and one per line-search evaluation.

Defaults (maxIter 80, tol 1e-7, 10 corrections) per
``optimization/LBFGS.scala:129-133``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Tuple

import torch

from photon_ml_tpu_torch.solvers.common import (
    ConvergenceReason,
    SolverConfig,
    SolverResult,
    check_convergence,
    host_read,
    model_buffer,
    project_to_hypercube,
    record,
    tape_buffer,
    tracker_buffers,
)
from photon_ml_tpu_torch.solvers.linesearch import strong_wolfe

ValueAndGrad = Callable[[torch.Tensor], Tuple[torch.Tensor, torch.Tensor]]


@dataclasses.dataclass
class _History:
    """Ring buffer of (s, y) correction pairs; head = next write slot."""

    s: torch.Tensor  # (m, d)
    y: torch.Tensor  # (m, d)
    rho: torch.Tensor  # (m,) 1 / (s . y)
    count: int = 0  # valid pairs (<= m)
    head: int = 0


def _empty_history(m: int, w: torch.Tensor) -> _History:
    d = w.shape[-1]
    z = dict(dtype=w.dtype, device=w.device)
    return _History(s=torch.zeros((m, d), **z), y=torch.zeros((m, d), **z),
                    rho=torch.zeros((m,), **z))


def _curvature_ok(sy: torch.Tensor, yy: torch.Tensor) -> torch.Tensor:
    """Whether a pair with curvature s.y and y.y enters the history: s.y
    positive against y.y (the safeguard that replaces breeze's handling).
    Elementwise, so one solve's or the batched solver's lanes."""
    return sy > 1e-10 * torch.clamp(yy, min=1e-30)


def _first_step(direction_norm: torch.Tensor) -> torch.Tensor:
    """The first iteration's trial step: unit-ish length, like breeze's
    initial heuristic. Elementwise."""
    return torch.clamp(1.0 / torch.clamp(direction_norm, min=1e-30), max=1.0)


def _dead_search_reason(code: torch.Tensor, ls_ok: torch.Tensor) -> torch.Tensor:
    """A dead line search means no further progress; it also leaves w
    unchanged, so the |df| = 0 test would fire spuriously — replace that
    (and NOT_CONVERGED), never GRADIENT_CONVERGED nor MAX_ITERATIONS,
    which the reference checks first. Elementwise."""
    return torch.where(
        (~ls_ok)
        & (code != ConvergenceReason.GRADIENT_CONVERGED)
        & (code != ConvergenceReason.MAX_ITERATIONS),
        torch.full_like(code, int(ConvergenceReason.OBJECTIVE_NOT_IMPROVING)),
        code,
    )


def _push_history(h: _History, s: torch.Tensor, y: torch.Tensor) -> _History:
    """Append a correction pair in place; skip it when its curvature fails
    :func:`_curvature_ok`. One host read."""
    sy = torch.dot(s, y)
    if host_read(_curvature_ok(sy, torch.dot(y, y))):
        i = h.head
        h.s[i] = s
        h.y[i] = y
        h.rho[i] = 1.0 / sy
        h.count = min(h.count + 1, h.s.shape[0])
        h.head = (h.head + 1) % h.s.shape[0]
    return h


def _two_loop(h: _History, grad: torch.Tensor) -> torch.Tensor:
    """Two-loop recursion in Gram form: the alpha/beta recurrence with
    every (d,)-vector contraction batched into (m, d) products. Expanding
    the recursion:

        alpha_i = rho_i (s_i.g - sum_{l newer} alpha_l s_i.y_l)
        q       = g - Y^T alpha
        beta_i  = rho_i (gamma y_i.q + sum_{l older} (alpha_l - beta_l) y_i.s_l)
        r       = gamma q + S^T (alpha - beta)

    The ring positions are host ints, so the masks are built on the host;
    invalid slots keep rho = 0 and mask to zero, as in the JAX package."""
    m = h.s.shape[0]
    dev = grad.device
    order_b = [(h.head - 1 - i) % m for i in range(m)]  # newest -> oldest
    step_of = [0] * m
    for i, j in enumerate(order_b):
        step_of[j] = i
    step_of_t = torch.tensor(step_of, device=dev)
    valid_slot = torch.tensor([step_of[j] < h.count for j in range(m)], device=dev)

    G = h.s @ h.y.T  # (m, m): G[a, b] = s_a . y_b
    sg = h.s @ grad
    zero = torch.zeros((), dtype=grad.dtype, device=dev)
    alphas = torch.zeros((m,), dtype=grad.dtype, device=dev)
    for i in range(m):
        j = order_b[i]
        cross = torch.sum(torch.where(step_of_t < i, alphas * G[j, :], zero))
        alphas[j] = h.rho[j] * (sg[j] - cross) if i < h.count else zero
    q = grad - h.y.T @ alphas

    newest = (h.head - 1) % m
    if h.count > 0:
        gamma = G[newest, newest] / torch.clamp(
            torch.dot(h.y[newest], h.y[newest]), min=1e-30
        )
    else:
        gamma = torch.ones((), dtype=grad.dtype, device=dev)
    yq = h.y @ q
    # forward order: oldest -> newest among valid; y_j . s_l = G[l, j]
    order_f = [(h.head - h.count + i) % m for i in range(m)]
    fstep_of = [0] * m
    for i, j in enumerate(order_f):
        fstep_of[j] = i
    fstep_of_t = torch.tensor(fstep_of, device=dev)
    betas = torch.zeros((m,), dtype=grad.dtype, device=dev)
    for i in range(m):
        j = order_f[i]
        coeff = torch.where((fstep_of_t < i) & valid_slot, alphas - betas, zero)
        cross = torch.sum(coeff * G[:, j])
        betas[j] = h.rho[j] * (gamma * yq[j] + cross) if i < h.count else zero
    coeff = torch.where(valid_slot, alphas - betas, zero)
    return gamma * q + h.s.T @ coeff


def minimize_lbfgs(
    value_and_grad_fn: ValueAndGrad,
    w0: torch.Tensor,
    config: SolverConfig = SolverConfig(),
) -> SolverResult:
    """Minimize a smooth objective: one strong-Wolfe line search per
    iteration, each evaluation a full value+grad pass (the reference's
    cost model, ``LBFGS.scala:68-97``)."""
    m = config.num_corrections
    lower, upper = config.lower_bounds, config.upper_bounds
    has_bounds = lower is not None or upper is not None

    w = project_to_hypercube(w0, lower, upper)
    value, grad = value_and_grad_fn(w)
    values, grad_norms = tracker_buffers(config.max_iters, value, config.track_states)
    gnorm0 = torch.linalg.norm(grad)
    record(values, 0, value)
    record(grad_norms, 0, gnorm0)
    w_history = model_buffer(config.max_iters, w, config.track_models)
    # slot 0: no step yet, one evaluation (the initial value/grad pass)
    step_tape = tape_buffer(config.max_iters, value, config.track_states)
    eval_tape = tape_buffer(config.max_iters, value, config.track_states)
    record(step_tape, 0, 0.0)
    record(eval_tape, 0, 1.0)

    hist = _empty_history(m, w)
    value_initial, grad_norm_initial = value, gnorm0
    evals = 1
    it = 0
    reason = int(
        ConvergenceReason.GRADIENT_CONVERGED
        if host_read(gnorm0 == 0.0)
        else ConvergenceReason.NOT_CONVERGED
    )
    while reason == ConvergenceReason.NOT_CONVERGED:
        direction = -_two_loop(hist, grad)
        dphi0 = torch.dot(grad, direction)
        # not a descent direction (stale curvature): restart on -grad
        bad = dphi0 >= 0.0
        direction = torch.where(bad, -grad, direction)
        dphi0 = torch.where(bad, -torch.dot(grad, grad), dphi0)

        def phi(alpha, w=w, direction=direction):
            val, g = value_and_grad_fn(w + alpha * direction)
            return val, torch.dot(g, direction), g

        if hist.count == 0:
            alpha_init = _first_step(torch.linalg.norm(direction))
        else:
            alpha_init = torch.ones((), dtype=value.dtype, device=value.device)
        alpha, v_ls, g_ls, ls_ok, ls_evals = strong_wolfe(
            phi, value, dphi0, alpha_init, g0=grad,
            c1=config.ls_c1, c2=config.ls_c2, max_evals=config.ls_max_evals,
        )

        w_new = w + alpha * direction
        if has_bounds:
            # the projection moves the point off the search ray, so the
            # line-search gradient no longer applies: re-evaluate
            w_new = project_to_hypercube(w_new, lower, upper)
            v_new, g_new = value_and_grad_fn(w_new)
            iter_evals = ls_evals + 1
        else:
            # the accepted point IS the last line-search point
            v_new, g_new = v_ls, g_ls
            iter_evals = ls_evals
        hist = _push_history(hist, w_new - w, g_new - grad)

        it += 1
        gnorm = torch.linalg.norm(g_new)
        code = check_convergence(
            value, v_new, gnorm, value_initial, grad_norm_initial, it,
            config.max_iters, config.tolerance,
        )
        code = _dead_search_reason(code, ls_ok)
        record(values, it, v_new)
        record(grad_norms, it, gnorm)
        record(w_history, it, w_new)
        record(step_tape, it, alpha)
        record(eval_tape, it, float(iter_evals))
        w, value, grad = w_new, v_new, g_new
        evals += iter_evals
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


# -- OWL-QN (Orthant-Wise Limited-memory Quasi-Newton), for L1 objectives -----


def _pseudo_gradient(w: torch.Tensor, g: torch.Tensor, l1) -> torch.Tensor:
    """Pseudo-gradient of f(w) + l1 ||w||_1 (Andrew & Gao 2007, eq. 4)."""
    right = g + l1  # the derivative approaching w = 0 from the right
    left = g - l1  # from the left
    zero = torch.zeros_like(g)
    pg_zero = torch.where(left > 0.0, left, torch.where(right < 0.0, right, zero))
    return torch.where(w > 0.0, right, torch.where(w < 0.0, left, pg_zero))


def minimize_owlqn(
    value_and_grad_fn: ValueAndGrad,
    w0: torch.Tensor,
    l1_weight,
    config: SolverConfig = SolverConfig(),
) -> SolverResult:
    """Minimize f(w) + l1 ||w||_1. ``value_and_grad_fn`` is the SMOOTH part
    only; the L1 term goes through the pseudo-gradient and the orthant
    projection, as breeze's OWLQN (selected when the objective carries an
    ``L1RegularizationTerm``, ``optimization/LBFGS.scala:56-66``). History
    pairs use smooth gradients; the line search is projected backtracking,
    one host read per trial point. Box constraints are not applied, as in
    the JAX package."""
    m = config.num_corrections
    l1 = float(l1_weight)

    w = w0
    value, grad = value_and_grad_fn(w)
    full = value + l1 * w.abs().sum()
    pgnorm0 = torch.linalg.norm(_pseudo_gradient(w, grad, l1))
    values, grad_norms = tracker_buffers(config.max_iters, value, config.track_states)
    record(values, 0, full)
    record(grad_norms, 0, pgnorm0)
    w_history = model_buffer(config.max_iters, w, config.track_models)
    step_tape = tape_buffer(config.max_iters, value, config.track_states)
    eval_tape = tape_buffer(config.max_iters, value, config.track_states)
    record(step_tape, 0, 0.0)
    record(eval_tape, 0, 1.0)

    hist = _empty_history(m, w)
    value_initial, grad_norm_initial = full, pgnorm0
    evals = 1
    it = 0
    reason = int(
        ConvergenceReason.GRADIENT_CONVERGED
        if host_read(pgnorm0 == 0.0)
        else ConvergenceReason.NOT_CONVERGED
    )
    while reason == ConvergenceReason.NOT_CONVERGED:
        pg = _pseudo_gradient(w, grad, l1)
        direction = -_two_loop(hist, pg)
        # sign alignment: drop components that disagree with -pg; fall back
        # to steepest pseudo-descent when that leaves nothing
        direction = torch.where(direction * pg < 0.0, direction, torch.zeros_like(direction))
        degenerate = torch.dot(direction, direction) == 0.0
        direction = torch.where(degenerate, -pg, direction)
        # the orthant of the projected step: sign(w), or sign(-pg) at w = 0
        xi = torch.where(w != 0.0, torch.sign(w), torch.sign(-pg))

        def trial(alpha, w=w, direction=direction, xi=xi, pg=pg, full=full):
            wt = w + alpha * direction
            wt = torch.where(wt * xi > 0.0, wt, torch.zeros_like(wt))
            vt, gt = value_and_grad_fn(wt)
            ft = vt + l1 * wt.abs().sum()
            accepted = host_read(ft <= full + config.ls_c1 * torch.dot(pg, wt - w))
            return wt, vt, ft, gt, accepted

        if hist.count == 0:
            alpha = 1.0 / torch.clamp(torch.linalg.norm(direction), min=1e-30)
        else:
            alpha = torch.ones((), dtype=value.dtype, device=value.device)
        # backtracking with the Armijo-like acceptance of Andrew & Gao:
        # F(w') <= F(w) + c1 pg . (w' - w)
        w_new, v_new, f_new, g_new, ls_ok = trial(alpha)
        ls_evals = 1
        if not ls_ok:
            alpha = alpha * 0.5
        while not ls_ok and ls_evals < config.ls_max_evals:
            w_new, v_new, f_new, g_new, ls_ok = trial(alpha)
            ls_evals += 1
            if not ls_ok:
                alpha = alpha * 0.5
        if not ls_ok:
            # an exhausted line search keeps the previous iterate: a rejected
            # trial point is never committed
            w_new, v_new, f_new, g_new = w, value, full, grad
        hist = _push_history(hist, w_new - w, g_new - grad)

        it += 1
        pgnorm = torch.linalg.norm(_pseudo_gradient(w_new, g_new, l1))
        code = check_convergence(
            full, f_new, pgnorm, value_initial, grad_norm_initial, it,
            config.max_iters, config.tolerance,
        )
        if not ls_ok:
            code = _dead_search_reason(code, torch.zeros_like(code, dtype=torch.bool))
        record(values, it, f_new)
        record(grad_norms, it, pgnorm)
        record(w_history, it, w_new)
        # a dead line search commits no step: the tape says 0
        record(step_tape, it, alpha if ls_ok else 0.0)
        record(eval_tape, it, float(ls_evals))
        w, value, full, grad = w_new, v_new, f_new, g_new
        evals += ls_evals
        reason = host_read(code)

    return SolverResult(
        w=w,
        value=full,
        grad=_pseudo_gradient(w, grad, l1),
        iterations=it,
        reason=reason,
        values=values,
        grad_norms=grad_norms,
        w_history=w_history if config.track_models else None,
        evals=evals,
        step_tape=step_tape,
        eval_tape=eval_tape,
    )
