"""Strong-Wolfe line search as a bracket/zoom stage machine (counterpart of
``photon_ml_tpu/solvers/linesearch.py``; the reference delegates to
breeze's StrongWolfeLineSearch inside ``optimization/LBFGS.scala:56-98``).

Nocedal & Wright, Alg. 3.5/3.6, with exactly ONE objective evaluation per
trip — the evaluation is the expensive part (a full value+grad pass), so
the evaluation budget is the cost model. The state is the JAX package's,
step for step: 0-dim tensors on the solve's device updated by
``torch.where``, and (d,) gradients carried so the caller reuses the
accepted point's gradient. The stage (0 = bracketing, 1 = zoom,
2 = accepted, 3 = failed) is read to the host once per trip: it drives the
loop and the bracket/zoom branch.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Tuple

import torch

from photon_ml_tpu_torch.solvers.common import host_read

_BRACKET = 0
_ZOOM = 1
_DONE = 2
_FAIL = 3


class _LSState(NamedTuple):
    stage: torch.Tensor
    # candidate to evaluate next
    a: torch.Tensor
    # previous bracketing point
    a_prev: torch.Tensor
    phi_prev: torch.Tensor
    dphi_prev: torch.Tensor
    # zoom interval
    a_lo: torch.Tensor
    phi_lo: torch.Tensor
    dphi_lo: torch.Tensor
    a_hi: torch.Tensor
    phi_hi: torch.Tensor
    dphi_hi: torch.Tensor
    # accepted point
    a_star: torch.Tensor
    phi_star: torch.Tensor
    # gradient vectors at prev / lo / star
    g_prev: torch.Tensor
    g_lo: torch.Tensor
    g_star: torch.Tensor


_where = torch.where


def _cubic_min(a_lo, phi_lo, dphi_lo, a_hi, phi_hi, dphi_hi):
    """Minimizer of the cubic through (a_lo, phi_lo, dphi_lo), (a_hi,
    phi_hi, dphi_hi); safeguarded to the interior of the interval, with a
    bisection fallback."""
    d1 = dphi_lo + dphi_hi - 3.0 * (phi_lo - phi_hi) / (a_lo - a_hi)
    rad = d1 * d1 - dphi_lo * dphi_hi
    sqrt_rad = torch.sqrt(torch.clamp(rad, min=0.0))
    d2 = torch.sign(a_hi - a_lo) * sqrt_rad
    denom = dphi_hi - dphi_lo + 2.0 * d2
    cand = a_hi - (a_hi - a_lo) * (dphi_hi + d2 - d1) / denom
    lo = torch.minimum(a_lo, a_hi)
    hi = torch.maximum(a_lo, a_hi)
    width = hi - lo
    inside = (cand > lo + 0.1 * width) & (cand < hi - 0.1 * width)
    ok = (rad >= 0.0) & (torch.abs(denom) > 1e-20) & torch.isfinite(cand) & inside
    return _where(ok, cand, 0.5 * (a_lo + a_hi))


def strong_wolfe(
    phi_fn: Callable[[torch.Tensor], Tuple[torch.Tensor, torch.Tensor, torch.Tensor]],
    phi0: torch.Tensor,
    dphi0: torch.Tensor,
    alpha_init: torch.Tensor,
    g0: torch.Tensor,
    c1: float = 1e-4,
    c2: float = 0.9,
    max_evals: int = 20,
    alpha_max: float = 1e10,
):
    """Find alpha with phi(a) <= phi0 + c1*a*dphi0 and |phi'(a)| <= c2*|dphi0|.

    ``phi_fn(alpha) -> (phi, dphi, grad)`` along the fixed direction,
    ``grad`` the full gradient at the trial point; ``g0`` the gradient at
    alpha = 0. Returns (alpha, phi(alpha), grad(alpha), ok, evals): ``ok``
    a 0-dim bool tensor, ``evals`` a host int. On failure ok is False and
    alpha is the best Armijo point seen (possibly 0.0, with grad = g0)."""
    dtype, device = phi0.dtype, phi0.device
    zero = torch.zeros((), dtype=dtype, device=device)

    def scalar(x):
        return torch.as_tensor(x, dtype=dtype, device=device)

    def stage_of(code):
        return torch.tensor(code, dtype=torch.int32, device=device)

    s = _LSState(
        stage=stage_of(_BRACKET),
        a=scalar(alpha_init),
        a_prev=zero,
        phi_prev=phi0,
        dphi_prev=dphi0,
        a_lo=zero,
        phi_lo=phi0,
        dphi_lo=dphi0,
        a_hi=zero,
        phi_hi=phi0,
        dphi_hi=dphi0,
        a_star=zero,
        phi_star=phi0,
        g_prev=g0,
        g_lo=g0,
        g_star=g0,
    )

    def armijo_ok(a, phi):
        return phi <= phi0 + c1 * a * dphi0

    def curvature_ok(dphi):
        return torch.abs(dphi) <= -c2 * dphi0

    def bracket_step(s: _LSState, i: int, phi_a, dphi_a, g_a) -> _LSState:
        hit_armijo_fail = ~armijo_ok(s.a, phi_a)
        if i > 0:
            hit_armijo_fail = hit_armijo_fail | (phi_a >= s.phi_prev)
        hit_curv = curvature_ok(dphi_a)
        hit_pos_slope = dphi_a >= 0.0

        to_zoom_pf = hit_armijo_fail  # -> zoom(prev, a)
        accept = (~hit_armijo_fail) & hit_curv
        to_zoom_ap = (~hit_armijo_fail) & (~hit_curv) & hit_pos_slope  # -> zoom(a, prev)
        extend = (~hit_armijo_fail) & (~hit_curv) & (~hit_pos_slope)

        stage = _where(
            accept, stage_of(_DONE),
            _where(to_zoom_pf | to_zoom_ap, stage_of(_ZOOM), stage_of(_BRACKET)),
        )
        a_lo = _where(to_zoom_pf, s.a_prev, _where(to_zoom_ap, s.a, s.a_lo))
        phi_lo = _where(to_zoom_pf, s.phi_prev, _where(to_zoom_ap, phi_a, s.phi_lo))
        dphi_lo = _where(to_zoom_pf, s.dphi_prev, _where(to_zoom_ap, dphi_a, s.dphi_lo))
        a_hi = _where(to_zoom_pf, s.a, _where(to_zoom_ap, s.a_prev, s.a_hi))
        phi_hi = _where(to_zoom_pf, phi_a, _where(to_zoom_ap, s.phi_prev, s.phi_hi))
        dphi_hi = _where(to_zoom_pf, dphi_a, _where(to_zoom_ap, s.dphi_prev, s.dphi_hi))

        doubled = torch.clamp(2.0 * s.a, max=alpha_max)
        next_a = _where(
            stage == _ZOOM,
            _cubic_min(a_lo, phi_lo, dphi_lo, a_hi, phi_hi, dphi_hi),
            doubled,
        )
        g_lo = _where(to_zoom_pf, s.g_prev, _where(to_zoom_ap, g_a, s.g_lo))
        return s._replace(
            stage=stage,
            a=_where(extend, doubled, next_a),
            a_prev=_where(extend, s.a, s.a_prev),
            phi_prev=_where(extend, phi_a, s.phi_prev),
            dphi_prev=_where(extend, dphi_a, s.dphi_prev),
            a_lo=a_lo,
            phi_lo=phi_lo,
            dphi_lo=dphi_lo,
            a_hi=a_hi,
            phi_hi=phi_hi,
            dphi_hi=dphi_hi,
            a_star=_where(accept, s.a, s.a_star),
            phi_star=_where(accept, phi_a, s.phi_star),
            g_prev=_where(extend, g_a, s.g_prev),
            g_lo=g_lo,
            g_star=_where(accept, g_a, s.g_star),
        )

    def zoom_step(s: _LSState, phi_j, dphi_j, g_a) -> _LSState:
        aj = s.a
        shrink_hi = (~armijo_ok(aj, phi_j)) | (phi_j >= s.phi_lo)
        accept = (~shrink_hi) & curvature_ok(dphi_j)
        # hi <- lo when the new lo's slope points away from hi
        flip = (~shrink_hi) & (~accept) & (dphi_j * (s.a_hi - s.a_lo) >= 0.0)

        a_hi = _where(shrink_hi, aj, _where(flip, s.a_lo, s.a_hi))
        phi_hi = _where(shrink_hi, phi_j, _where(flip, s.phi_lo, s.phi_hi))
        dphi_hi = _where(shrink_hi, dphi_j, _where(flip, s.dphi_lo, s.dphi_hi))
        a_lo = _where(shrink_hi, s.a_lo, aj)
        phi_lo = _where(shrink_hi, s.phi_lo, phi_j)
        dphi_lo = _where(shrink_hi, s.dphi_lo, dphi_j)

        # degenerate interval => stop with the best (lo) point
        tiny = torch.abs(a_hi - a_lo) <= 1e-12 * torch.clamp(torch.abs(a_hi), min=1.0)
        stage = _where(
            accept, stage_of(_DONE), _where(tiny, stage_of(_FAIL), stage_of(_ZOOM))
        )
        return s._replace(
            stage=stage,
            a=_cubic_min(a_lo, phi_lo, dphi_lo, a_hi, phi_hi, dphi_hi),
            a_lo=a_lo,
            phi_lo=phi_lo,
            dphi_lo=dphi_lo,
            a_hi=a_hi,
            phi_hi=phi_hi,
            dphi_hi=dphi_hi,
            a_star=_where(accept, aj, s.a_star),
            phi_star=_where(accept, phi_j, s.phi_star),
            g_lo=_where(shrink_hi, s.g_lo, g_a),
            g_star=_where(accept, g_a, s.g_star),
        )

    stage = _BRACKET
    i = 0
    while stage < _DONE and i < max_evals:
        phi_a, dphi_a, g_a = phi_fn(s.a)
        if stage == _BRACKET:
            s = bracket_step(s, i, phi_a, dphi_a, g_a)
        else:
            s = zoom_step(s, phi_a, dphi_a, g_a)
        i += 1
        stage = host_read(s.stage)

    accepted = s.stage == _DONE
    # fall back to the zoom interval's lo point: by invariant it satisfies
    # Armijo whenever the zoom stage was entered
    fallback_ok = armijo_ok(s.a_lo, s.phi_lo) & (s.a_lo > 0.0)
    alpha = _where(accepted, s.a_star, _where(fallback_ok, s.a_lo, zero))
    phi = _where(accepted, s.phi_star, _where(fallback_ok, s.phi_lo, phi0))
    grad = _where(accepted, s.g_star, _where(fallback_ok, s.g_lo, g0))
    return alpha, phi, grad, accepted | fallback_ok, i
