"""Batched per-entity solvers: TRON and L-BFGS over E independent
problems at once, the counterpart of ``jax.vmap`` over the JAX package's
solvers (``photon_ml_tpu/game/coordinates.py:135``; the reference's
millions of per-entity solves, ``RandomEffectCoordinate.scala:36-214``).

The state of every lane is a row of an (E, ...) tensor, and the loops keep
``vmap``'s semantics over ``lax.while_loop``:

  - every lane runs its own solve: trust-region radius, failure count,
    CG boundary step, line-search stage and L-BFGS history are per lane;
  - a lane that has stopped keeps its state (each update is a select);
  - the outer loop, each inner CG loop and each line search run until
    every lane has stopped.

So each lane's result, reason, iteration count and final gradient norm
are those of an unbatched solve of that lane. A lane whose outer loop has
stopped takes no CG step or line-search trial (its result would be thrown
away), so the inner loops wait only for the lanes still running.

Host reads: each loop test is ONE read for all lanes (``any`` over the
lanes), never one per lane — per outer iteration one for the outer test
and one per CG step or line-search trial plus one.

The rules that act on each lane alone are the unbatched solvers' own
functions, elementwise: ``common.check_convergence``; TRON's boundary step,
radius update and stopping rules (``tron._to_sphere``, ``_new_radius``,
``_step_reason``); L-BFGS's history safeguard, first step and dead-search
rule (``lbfgs._curvature_ok``, ``_first_step``, ``_dead_search_reason``);
the line search's cubic step (``linesearch._cubic_min``). What stays in
two forms is the loops' control: the unbatched solvers branch on host
reads where the lanes select (ROADMAP.md queue C).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import torch

from photon_ml_tpu_torch.solvers.common import (
    ConvergenceReason,
    SolverConfig,
    check_convergence,
    host_read,
)
from photon_ml_tpu_torch.solvers.lbfgs import (
    _curvature_ok,
    _dead_search_reason,
    _first_step,
)
from photon_ml_tpu_torch.solvers.linesearch import _BRACKET, _DONE, _FAIL, _ZOOM, _cubic_min
from photon_ml_tpu_torch.solvers.tron import _ETA0, _new_radius, _step_reason, _to_sphere

_NOT = int(ConvergenceReason.NOT_CONVERGED)
_GRAD = int(ConvergenceReason.GRADIENT_CONVERGED)


@dataclasses.dataclass(frozen=True)
class BatchedSolverResult:
    """Per-lane results, each an (E, ...) tensor on the solve's device.
    ``values``/``grad_norms`` are (E, max_iters+1) tracker tapes (one slot
    holding the latest state when tracking is off); entries past a lane's
    ``iterations`` are +inf."""

    w: torch.Tensor  # (E, d)
    value: torch.Tensor  # (E,)
    grad: torch.Tensor  # (E, d)
    iterations: torch.Tensor  # (E,) int32
    reason: torch.Tensor  # (E,) int32 ConvergenceReason codes
    values: torch.Tensor
    grad_norms: torch.Tensor
    cg_iterations: Optional[torch.Tensor] = None  # (E,) TRON
    evals: Optional[torch.Tensor] = None  # (E,) L-BFGS


def final_grad_norm(result: BatchedSolverResult) -> torch.Tensor:
    """||grad|| at each lane's last written tracker slot (valid with
    tracking on or off), as ``solvers/common.final_grad_norm``."""
    gn = result.grad_norms
    idx = torch.clamp(result.iterations.long(), max=gn.shape[-1] - 1)
    return torch.gather(gn, -1, idx[:, None])[:, 0]


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.sum(a * b, dim=-1)


def _col(x: torch.Tensor) -> torch.Tensor:
    return x[:, None]


def _codes(value: int, like: torch.Tensor) -> torch.Tensor:
    return torch.full(like.shape[:1], value, dtype=torch.int32, device=like.device)


class _Tapes:
    """The (E, slots) value and gradient-norm tapes, written per lane at
    min(iteration, last slot)."""

    def __init__(self, max_iters: int, value: torch.Tensor, gnorm: torch.Tensor,
                 track: bool):
        slots = max_iters + 1 if track else 1
        shape = (value.shape[0], slots)
        self.values = torch.full(shape, float("inf"), dtype=value.dtype, device=value.device)
        self.grad_norms = torch.full_like(self.values, float("inf"))
        self.values[:, 0] = value
        self.grad_norms[:, 0] = gnorm

    def record(self, lanes: torch.Tensor, iteration: torch.Tensor, value, gnorm) -> None:
        slot = torch.clamp(iteration.long(), max=self.values.shape[1] - 1)
        hit = torch.nn.functional.one_hot(slot, self.values.shape[1]).bool() & _col(lanes)
        self.values = torch.where(hit, _col(value), self.values)
        self.grad_norms = torch.where(hit, _col(gnorm), self.grad_norms)


# -- TRON ---------------------------------------------------------------------


def _truncated_cg(hvp, grad, delta, running, max_cg: int, cg_tol_factor: float):
    """Per lane, solve H s ~= -grad with ||s|| <= delta
    (``TRON.scala:252-319``): each lane exits on its residual test, on
    reaching the boundary or on max_cg. Lanes not ``running`` take no step.
    Returns (s, r, iterations per lane)."""
    gnorm = torch.linalg.norm(grad, dim=-1)
    cg_tol = cg_tol_factor * gnorm
    step = torch.zeros_like(grad)
    r = -grad
    p = -grad
    rtr = _dot(grad, grad)
    i = torch.zeros_like(running, dtype=torch.int32)
    done = (gnorm <= cg_tol) | ~running
    tiny = torch.full_like(rtr, 1e-30)
    while True:
        live = ~done & (i < max_cg)
        if not host_read(torch.any(live)):
            break
        hp = hvp(p)
        php = _dot(p, hp)
        alpha = rtr / torch.where(php > 0.0, php, tiny)
        step_try = step + _col(alpha) * p
        outside = (torch.linalg.norm(step_try, dim=-1) > delta) | (php <= 0.0)
        # back to the sphere
        tau = _to_sphere(_dot(step, p), _dot(step, step), _dot(p, p), delta)
        # inside the region: the CG update
        r_new = r - _col(alpha) * hp
        rtr_new = _dot(r_new, r_new)
        beta = rtr_new / torch.clamp(rtr, min=1e-30)
        inner = live & ~outside
        edge = live & outside
        step = torch.where(_col(edge), step + _col(tau) * p,
                           torch.where(_col(inner), step_try, step))
        r = torch.where(_col(edge), r - _col(tau) * hp, torch.where(_col(inner), r_new, r))
        p = torch.where(_col(inner), r_new + _col(beta) * p, p)
        rtr = torch.where(inner, rtr_new, rtr)
        done = torch.where(live, outside | (torch.sqrt(rtr_new) <= cg_tol), done)
        i = i + live.to(torch.int32)
    return step, r, i


def minimize_tron_batched(
    vgc_fn: Callable[[torch.Tensor], Tuple[torch.Tensor, torch.Tensor, torch.Tensor]],
    hvp_at_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    w0: torch.Tensor,
    config: SolverConfig,
) -> BatchedSolverResult:
    """E trust-region Newton-CG solves (``solvers/tron.minimize_tron``'s
    vgc route, lane by lane). ``vgc_fn(W) -> (values (E,), grads (E, d),
    curvature carry)`` and ``hvp_at_fn(carry, V) -> (E, d)``; the carry's
    leading axis is the lanes'."""
    value, grad, curv = vgc_fn(w0)
    w = w0
    gnorm0 = torch.linalg.norm(grad, dim=-1)
    tapes = _Tapes(config.max_iters, value, gnorm0, config.track_states)
    delta = gnorm0  # initial radius = ||g0|| (LIBLINEAR, TRON.scala:117)
    failures = torch.zeros_like(value, dtype=torch.int32)
    it = torch.zeros_like(failures)
    cg_total = torch.zeros_like(failures)
    value_initial, grad_norm_initial = value, gnorm0
    reason = torch.where(gnorm0 == 0.0, _codes(_GRAD, value), _codes(_NOT, value))
    while True:
        active = reason == _NOT
        if not host_read(torch.any(active)):
            break
        step, r, cg_iters = _truncated_cg(
            lambda v, c=curv: hvp_at_fn(c, v), grad, delta, active,
            config.tron_max_cg, config.tron_cg_tol,
        )
        snorm = torch.linalg.norm(step, dim=-1)
        gs = _dot(grad, step)
        prered = -0.5 * (gs - _dot(step, r))
        w_try = w + step
        v_try, g_try, c_try = vgc_fn(w_try)
        actred = value - v_try

        # the first iteration tightens the radius to the actual step length
        d0 = torch.where(it == 0, torch.minimum(delta, snorm), delta)
        d_new = _new_radius(d0, snorm, gs, value, v_try, actred, prered)

        accept = actred > _ETA0 * prered
        w_new = torch.where(_col(accept), w_try, w)
        v_new = torch.where(accept, v_try, value)
        g_new = torch.where(_col(accept), g_try, grad)
        c_new = torch.where(_col(accept), c_try, curv)
        f_new = torch.where(accept, torch.zeros_like(failures), failures + 1)
        it_new = it + 1
        gnorm = torch.linalg.norm(g_new, dim=-1)
        code = _step_reason(
            check_convergence(value, v_new, gnorm, value_initial, grad_norm_initial,
                              it_new, config.max_iters, config.tolerance),
            accept, f_new, config.tron_max_failures,
        )

        # only the running lanes take the new state
        tapes.record(active, it_new, v_new, gnorm)
        w = torch.where(_col(active), w_new, w)
        value = torch.where(active, v_new, value)
        grad = torch.where(_col(active), g_new, grad)
        curv = torch.where(_col(active), c_new, curv)
        delta = torch.where(active, d_new, delta)
        failures = torch.where(active, f_new, failures)
        cg_total = torch.where(active, cg_total + cg_iters, cg_total)
        it = torch.where(active, it_new, it)
        reason = torch.where(active, code, reason)

    return BatchedSolverResult(
        w=w, value=value, grad=grad, iterations=it, reason=reason,
        values=tapes.values, grad_norms=tapes.grad_norms, cg_iterations=cg_total,
    )


# -- L-BFGS -------------------------------------------------------------------


@dataclasses.dataclass
class _History:
    """Per-lane ring buffers of (s, y) pairs; head = next write slot."""

    s: torch.Tensor  # (E, m, d)
    y: torch.Tensor  # (E, m, d)
    rho: torch.Tensor  # (E, m)
    count: torch.Tensor  # (E,) int64
    head: torch.Tensor  # (E,) int64


def _push_history(h: _History, s, y, lanes) -> _History:
    """Append a pair in each lane of ``lanes`` whose curvature s.y is
    positive; the other lanes keep their history."""
    m = h.s.shape[1]
    sy = _dot(s, y)
    ok = lanes & _curvature_ok(sy, _dot(y, y))
    hit = torch.nn.functional.one_hot(h.head, m).bool() & _col(ok)  # (E, m)
    return _History(
        s=torch.where(hit[:, :, None], s[:, None, :], h.s),
        y=torch.where(hit[:, :, None], y[:, None, :], h.y),
        rho=torch.where(hit, _col(1.0 / sy), h.rho),
        count=torch.where(ok, torch.clamp(h.count + 1, max=m), h.count),
        head=torch.where(ok, (h.head + 1) % m, h.head),
    )


def _inverse_positions(order: torch.Tensor) -> torch.Tensor:
    """(E, m) slot-at-step -> step-of-slot."""
    pos = torch.arange(order.shape[1], device=order.device).expand_as(order)
    return torch.empty_like(order).scatter_(1, order, pos)


def _two_loop(h: _History, grad: torch.Tensor) -> torch.Tensor:
    """The Gram-form two-loop recursion of ``solvers/lbfgs._two_loop``
    with each lane's own ring position and fill count."""
    m = h.s.shape[1]
    pos = torch.arange(m, device=grad.device)
    rows = torch.arange(grad.shape[0], device=grad.device)
    order_b = (_col(h.head) - 1 - pos) % m  # (E, m): newest -> oldest
    step_of = _inverse_positions(order_b)
    valid = pos < _col(h.count)  # by backward step
    valid_slot = torch.gather(valid, 1, step_of)  # by ring slot

    G = h.s @ h.y.transpose(1, 2)  # (E, m, m): G[e, a, b] = s_a . y_b
    sg = torch.einsum("emd,ed->em", h.s, grad)
    zero = torch.zeros((), dtype=grad.dtype, device=grad.device)
    alphas = torch.zeros_like(h.rho)
    for i in range(m):
        j = order_b[:, i]
        cross = torch.sum(torch.where(step_of < i, alphas * G[rows, j, :], zero), dim=-1)
        alpha = torch.where(valid[:, i], h.rho[rows, j] * (sg[rows, j] - cross), zero)
        alphas = alphas.scatter(1, j[:, None], alpha[:, None])
    q = grad - torch.einsum("emd,em->ed", h.y, alphas)

    newest = (h.head - 1) % m
    y_new = h.y[rows, newest]
    gamma = torch.where(
        h.count > 0,
        G[rows, newest, newest] / torch.clamp(_dot(y_new, y_new), min=1e-30),
        torch.ones_like(h.rho[:, 0]),
    )
    yq = torch.einsum("emd,ed->em", h.y, q)
    # forward order: oldest -> newest among valid; y_j . s_l = G[l, j]
    order_f = (_col(h.head - h.count) + pos) % m
    fstep_of = _inverse_positions(order_f)
    betas = torch.zeros_like(h.rho)
    for i in range(m):
        j = order_f[:, i]
        coeff = torch.where((fstep_of < i) & valid_slot, alphas - betas, zero)
        cross = torch.sum(coeff * G[rows, :, j], dim=-1)
        beta = torch.where(valid[:, i], h.rho[rows, j] * (gamma * yq[rows, j] + cross), zero)
        betas = betas.scatter(1, j[:, None], beta[:, None])
    coeff = torch.where(valid_slot, alphas - betas, zero)
    return _col(gamma) * q + torch.einsum("emd,em->ed", h.s, coeff)


def _strong_wolfe(phi_fn, phi0, dphi0, alpha_init, g0, running, c1: float, c2: float,
                  max_evals: int, alpha_max: float = 1e10):
    """``solvers/linesearch.strong_wolfe`` per lane: each lane brackets and
    zooms on its own stage; lanes not ``running`` take no trial. One
    ``phi_fn`` evaluation (all lanes) per trip. Returns (alpha, phi(alpha),
    grad(alpha), ok, evaluations per lane)."""
    zero = torch.zeros_like(phi0)
    st = {
        "stage": torch.full_like(phi0, _BRACKET, dtype=torch.int32),
        "a": alpha_init, "a_prev": zero, "phi_prev": phi0, "dphi_prev": dphi0,
        "a_lo": zero, "phi_lo": phi0, "dphi_lo": dphi0,
        "a_hi": zero, "phi_hi": phi0, "dphi_hi": dphi0,
        "a_star": zero, "phi_star": phi0,
        "g_prev": g0, "g_lo": g0, "g_star": g0,
    }
    i = torch.zeros_like(st["stage"])

    def armijo_ok(a, phi):
        return phi <= phi0 + c1 * a * dphi0

    def curvature_ok(dphi):
        return torch.abs(dphi) <= -c2 * dphi0

    def pick(cond, a, b):
        return torch.where(_col(cond) if a.dim() == 2 else cond, a, b)

    while True:
        live = running & (st["stage"] < _DONE) & (i < max_evals)
        if not host_read(torch.any(live)):
            break
        s = st
        phi_a, dphi_a, g_a = phi_fn(s["a"])

        # bracketing
        fail = ~armijo_ok(s["a"], phi_a) | ((phi_a >= s["phi_prev"]) & (i > 0))
        curv = curvature_ok(dphi_a)
        pos_slope = dphi_a >= 0.0
        to_zoom_pf = fail  # -> zoom(prev, a)
        accept = ~fail & curv
        to_zoom_ap = ~fail & ~curv & pos_slope  # -> zoom(a, prev)
        extend = ~fail & ~curv & ~pos_slope
        b_stage = torch.where(accept, _DONE, torch.where(to_zoom_pf | to_zoom_ap, _ZOOM,
                                                         _BRACKET)).to(torch.int32)
        b = {}
        for key, val_pf, val_ap in (("a_lo", s["a_prev"], s["a"]),
                                    ("phi_lo", s["phi_prev"], phi_a),
                                    ("dphi_lo", s["dphi_prev"], dphi_a),
                                    ("a_hi", s["a"], s["a_prev"]),
                                    ("phi_hi", phi_a, s["phi_prev"]),
                                    ("dphi_hi", dphi_a, s["dphi_prev"]),
                                    ("g_lo", s["g_prev"], g_a)):
            b[key] = pick(to_zoom_pf, val_pf, pick(to_zoom_ap, val_ap, s[key]))
        doubled = torch.clamp(2.0 * s["a"], max=alpha_max)
        next_a = torch.where(
            b_stage == _ZOOM,
            _cubic_min(b["a_lo"], b["phi_lo"], b["dphi_lo"], b["a_hi"], b["phi_hi"],
                       b["dphi_hi"]),
            doubled,
        )
        b.update(
            stage=b_stage,
            a=torch.where(extend, doubled, next_a),
            a_prev=torch.where(extend, s["a"], s["a_prev"]),
            phi_prev=torch.where(extend, phi_a, s["phi_prev"]),
            dphi_prev=torch.where(extend, dphi_a, s["dphi_prev"]),
            a_star=torch.where(accept, s["a"], s["a_star"]),
            phi_star=torch.where(accept, phi_a, s["phi_star"]),
            g_prev=pick(extend, g_a, s["g_prev"]),
            g_star=pick(accept, g_a, s["g_star"]),
        )

        # zoom
        aj = s["a"]
        shrink_hi = ~armijo_ok(aj, phi_a) | (phi_a >= s["phi_lo"])
        z_accept = ~shrink_hi & curvature_ok(dphi_a)
        # hi <- lo when the new lo's slope points away from hi
        flip = ~shrink_hi & ~z_accept & (dphi_a * (s["a_hi"] - s["a_lo"]) >= 0.0)
        z = {
            "a_hi": torch.where(shrink_hi, aj, torch.where(flip, s["a_lo"], s["a_hi"])),
            "phi_hi": torch.where(shrink_hi, phi_a, torch.where(flip, s["phi_lo"], s["phi_hi"])),
            "dphi_hi": torch.where(shrink_hi, dphi_a,
                                   torch.where(flip, s["dphi_lo"], s["dphi_hi"])),
            "a_lo": torch.where(shrink_hi, s["a_lo"], aj),
            "phi_lo": torch.where(shrink_hi, s["phi_lo"], phi_a),
            "dphi_lo": torch.where(shrink_hi, s["dphi_lo"], dphi_a),
        }
        # a degenerate interval stops with the best (lo) point
        tiny = torch.abs(z["a_hi"] - z["a_lo"]) <= 1e-12 * torch.clamp(
            torch.abs(z["a_hi"]), min=1.0)
        z.update(
            stage=torch.where(z_accept, _DONE, torch.where(tiny, _FAIL, _ZOOM)).to(torch.int32),
            a=_cubic_min(z["a_lo"], z["phi_lo"], z["dphi_lo"], z["a_hi"], z["phi_hi"],
                         z["dphi_hi"]),
            a_star=torch.where(z_accept, aj, s["a_star"]),
            phi_star=torch.where(z_accept, phi_a, s["phi_star"]),
            g_lo=pick(shrink_hi, s["g_lo"], g_a),
            g_star=pick(z_accept, g_a, s["g_star"]),
        )

        in_bracket = s["stage"] == _BRACKET
        st = {
            key: pick(live, pick(in_bracket, b.get(key, s[key]), z.get(key, s[key])), s[key])
            for key in s
        }
        i = i + live.to(torch.int32)

    accepted = st["stage"] == _DONE
    # fall back to the zoom interval's lo point: by invariant it satisfies
    # Armijo whenever the zoom stage was entered
    fallback_ok = armijo_ok(st["a_lo"], st["phi_lo"]) & (st["a_lo"] > 0.0)
    alpha = torch.where(accepted, st["a_star"], torch.where(fallback_ok, st["a_lo"], zero))
    phi = torch.where(accepted, st["phi_star"], torch.where(fallback_ok, st["phi_lo"], phi0))
    grad = pick(accepted, st["g_star"], pick(fallback_ok, st["g_lo"], g0))
    return alpha, phi, grad, accepted | fallback_ok, i


def minimize_lbfgs_batched(
    value_and_grad_fn: Callable[[torch.Tensor], Tuple[torch.Tensor, torch.Tensor]],
    w0: torch.Tensor,
    config: SolverConfig,
) -> BatchedSolverResult:
    """E L-BFGS solves (``solvers/lbfgs.minimize_lbfgs``, lane by lane):
    ``value_and_grad_fn(W) -> (values (E,), grads (E, d))``. Box
    constraints are not taken (no GAME coordinate sets them)."""
    if config.lower_bounds is not None or config.upper_bounds is not None:
        raise ValueError("the batched L-BFGS takes no box constraints")
    m = config.num_corrections
    e, d = w0.shape
    w = w0
    value, grad = value_and_grad_fn(w)
    gnorm0 = torch.linalg.norm(grad, dim=-1)
    tapes = _Tapes(config.max_iters, value, gnorm0, config.track_states)
    z = dict(dtype=w.dtype, device=w.device)
    lanes0 = torch.zeros(e, dtype=torch.int64, device=w.device)
    hist = _History(s=torch.zeros((e, m, d), **z), y=torch.zeros((e, m, d), **z),
                    rho=torch.zeros((e, m), **z), count=lanes0, head=lanes0)
    value_initial, grad_norm_initial = value, gnorm0
    evals = torch.ones_like(value, dtype=torch.int32)
    it = torch.zeros_like(evals)
    reason = torch.where(gnorm0 == 0.0, _codes(_GRAD, value), _codes(_NOT, value))
    while True:
        active = reason == _NOT
        if not host_read(torch.any(active)):
            break
        direction = -_two_loop(hist, grad)
        dphi0 = _dot(grad, direction)
        # not a descent direction (stale curvature): restart on -grad
        bad = dphi0 >= 0.0
        direction = torch.where(_col(bad), -grad, direction)
        dphi0 = torch.where(bad, -_dot(grad, grad), dphi0)

        def phi(alpha, w=w, direction=direction):
            val, g = value_and_grad_fn(w + _col(alpha) * direction)
            return val, _dot(g, direction), g

        alpha_init = torch.where(hist.count == 0,
                                 _first_step(torch.linalg.norm(direction, dim=-1)),
                                 torch.ones_like(value))
        alpha, v_new, g_new, ls_ok, ls_evals = _strong_wolfe(
            phi, value, dphi0, alpha_init, grad, active,
            c1=config.ls_c1, c2=config.ls_c2, max_evals=config.ls_max_evals,
        )
        # the accepted point IS the last line-search point
        w_new = w + _col(alpha) * direction
        hist = _push_history(hist, w_new - w, g_new - grad, active)

        it_new = it + 1
        gnorm = torch.linalg.norm(g_new, dim=-1)
        code = _dead_search_reason(
            check_convergence(value, v_new, gnorm, value_initial, grad_norm_initial,
                              it_new, config.max_iters, config.tolerance),
            ls_ok,
        )
        tapes.record(active, it_new, v_new, gnorm)
        w = torch.where(_col(active), w_new, w)
        value = torch.where(active, v_new, value)
        grad = torch.where(_col(active), g_new, grad)
        evals = torch.where(active, evals + ls_evals, evals)
        it = torch.where(active, it_new, it)
        reason = torch.where(active, code, reason)

    return BatchedSolverResult(
        w=w, value=value, grad=grad, iterations=it, reason=reason,
        values=tapes.values, grad_norms=tapes.grad_norms, evals=evals,
    )
