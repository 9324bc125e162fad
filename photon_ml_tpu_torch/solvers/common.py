"""Shared solver machinery: convergence semantics, configs, results
(counterpart of ``photon_ml_tpu/solvers/common.py``).

Convergence follows ``optimization/AbstractOptimizer.scala:49-63``,
relative to the initial state:

  - FUNCTION_VALUES_CONVERGED:  |f_prev - f_cur| <= tol * |f_initial|
  - GRADIENT_CONVERGED:         ||g_cur|| <= tol * ||g_initial||
  - MAX_ITERATIONS
  - OBJECTIVE_NOT_IMPROVING (TRON's improvement-failure budget,
    ``optimization/TRON.scala:136-224``; a dead L-BFGS line search)

The JAX package runs each solver as one ``lax.while_loop`` on the device.
Here the loops are Python loops over tensors on the batch's device: every
loop test or branch on a value the device computed reads it back to the
host. :func:`host_read` does each such read and counts it, so a run can
report its host syncs per iteration (``host_reads``).
"""

from __future__ import annotations

import dataclasses
import enum
import threading
from typing import Optional

import numpy as np
import torch


class ConvergenceReason(enum.IntEnum):
    """Mirrors ``optimization/ConvergenceReason.scala``."""

    NOT_CONVERGED = 0
    MAX_ITERATIONS = 1
    FUNCTION_VALUES_CONVERGED = 2
    GRADIENT_CONVERGED = 3
    OBJECTIVE_NOT_IMPROVING = 4


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """Solver knobs. Defaults follow the reference: L-BFGS maxIter 80 /
    tol 1e-7 / 10 corrections (``optimization/LBFGS.scala:129-133``);
    TRON's inner CG and failure budget (``optimization/TRON.scala:230-237``).
    """

    max_iters: int = 80
    tolerance: float = 1e-7
    num_corrections: int = 10
    # line search
    ls_max_evals: int = 20
    ls_c1: float = 1e-4
    ls_c2: float = 0.9
    # TRON inner CG (``TRON.scala:252-319``)
    tron_max_cg: int = 20
    tron_cg_tol: float = 0.1
    tron_max_failures: int = 5
    # box constraints (``optimization/OptimizationUtils.scala``): (d,)
    # tensors or None, applied by clipping after each step
    lower_bounds: Optional[torch.Tensor] = None
    upper_bounds: Optional[torch.Tensor] = None
    # (value, |grad|) per iteration (``OptimizationStatesTracker.scala``)
    track_states: bool = True
    # coefficients per iteration (``supervised/model/ModelTracker.scala``)
    track_models: bool = False


@dataclasses.dataclass(frozen=True)
class SolverResult:
    """What a solve returns. Tensors stay on the solve's device; the loop
    counters are host ints (the Python loops count them).

    ``values``/``grad_norms`` are (max_iters+1,) tracker buffers; entries
    past ``iterations`` are unwritten (+inf) — read them through
    :meth:`masked_history`."""

    w: torch.Tensor
    value: torch.Tensor
    grad: torch.Tensor
    iterations: int
    reason: int  # ConvergenceReason code
    values: torch.Tensor
    grad_norms: torch.Tensor
    # TRON: total inner CG iterations == Hessian-vector products
    cg_iterations: Optional[int] = None
    # L-BFGS: total value/grad evaluations == design passes
    evals: Optional[int] = None
    # (max_iters+1, d) coefficients when track_models
    w_history: Optional[torch.Tensor] = None
    # tapes (track_states; one slot otherwise): TRON radius after each
    # step (slot 0 = the initial radius) and CG iterations per step;
    # L-BFGS accepted step size (slot 0 = 0) and evaluations per step
    # (slot 0 = the initial pass)
    radius_tape: Optional[torch.Tensor] = None
    cg_tape: Optional[torch.Tensor] = None
    step_tape: Optional[torch.Tensor] = None
    eval_tape: Optional[torch.Tensor] = None

    def masked_history(self):
        """Host-side tracker buffers truncated to ``iterations + 1``
        entries: ``(values, grad_norms)``, plus ``w_history`` when it was
        tracked."""
        out = [
            mask_tape(self.values, self.iterations),
            mask_tape(self.grad_norms, self.iterations),
        ]
        if self.w_history is not None:
            out.append(mask_tape(self.w_history, self.iterations, axis=-2))
        return tuple(out)


def mask_tape(tape: torch.Tensor, iterations: int, axis: int = -1) -> np.ndarray:
    """The tracker-buffer contract on the host: truncate along ``axis`` to
    ``iterations + 1`` entries (all of a one-slot untracked buffer)."""
    arr = tape.detach().cpu().numpy()
    axis = axis % arr.ndim
    n = min(int(iterations), arr.shape[axis] - 1) + 1
    sl = [slice(None)] * arr.ndim
    sl[axis] = slice(0, n)
    return arr[tuple(sl)]


# -- host reads ---------------------------------------------------------------

_reads_lock = threading.Lock()
_host_reads = 0


def host_read(t: torch.Tensor):
    """A device scalar (or small tensor) as a Python value, counted: on a
    CUDA tensor each call waits for the card."""
    global _host_reads
    with _reads_lock:
        _host_reads += 1
    return t.item() if t.dim() == 0 else t.tolist()


def host_reads() -> int:
    with _reads_lock:
        return _host_reads


def reset_host_reads() -> None:
    global _host_reads
    with _reads_lock:
        _host_reads = 0


# -- shared steps -------------------------------------------------------------


def project_to_hypercube(
    w: torch.Tensor,
    lower: Optional[torch.Tensor],
    upper: Optional[torch.Tensor],
) -> torch.Tensor:
    """``OptimizationUtils.projectCoefficientsToHypercube`` as a clip."""
    if lower is None and upper is None:
        return w
    if lower is not None:
        w = torch.maximum(w, lower.to(w))
    if upper is not None:
        w = torch.minimum(w, upper.to(w))
    return w


def _code(reason: ConvergenceReason, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(int(reason), dtype=torch.int32, device=like.device)


def check_convergence(
    value_prev: torch.Tensor,
    value_cur: torch.Tensor,
    grad_norm_cur: torch.Tensor,
    value_initial: torch.Tensor,
    grad_norm_initial: torch.Tensor,
    iteration,
    max_iters: int,
    tolerance: float,
) -> torch.Tensor:
    """The ConvergenceReason code as an int32 tensor (0 = keep going),
    computed on the device, of the values' shape: a 0-dim code for one
    solve with a host int ``iteration``, or one code per lane for the
    batched solvers' (E,) values and iteration counts. Order follows
    ``AbstractOptimizer.convergenceReason:49-63``: max iterations, then
    function values, then gradient."""
    batched = torch.is_tensor(iteration)
    if not batched and iteration >= max_iters:
        return _code(ConvergenceReason.MAX_ITERATIONS, value_cur)
    reason = torch.where(
        grad_norm_cur <= tolerance * grad_norm_initial,
        _code(ConvergenceReason.GRADIENT_CONVERGED, value_cur),
        _code(ConvergenceReason.NOT_CONVERGED, value_cur),
    )
    func_conv = torch.abs(value_prev - value_cur) <= tolerance * torch.abs(value_initial)
    reason = torch.where(
        func_conv, _code(ConvergenceReason.FUNCTION_VALUES_CONVERGED, value_cur), reason
    )
    if batched:
        reason = torch.where(
            iteration >= max_iters, _code(ConvergenceReason.MAX_ITERATIONS, value_cur), reason
        )
    return reason


def tracker_buffers(max_iters: int, like: torch.Tensor, track: bool = True):
    """Per-iteration (value, ||grad||) buffers filled with +inf; one slot
    (holding the latest state) when tracking is off."""
    return tape_buffer(max_iters, like, track), tape_buffer(max_iters, like, track)


def tape_buffer(max_iters: int, like: torch.Tensor, track: bool = True) -> torch.Tensor:
    """One per-iteration tape, +inf where unwritten; one slot when off."""
    size = max_iters + 1 if track else 1
    return torch.full((size,), float("inf"), dtype=like.dtype, device=like.device)


def record(tape: torch.Tensor, i: int, value) -> None:
    """tape[min(i, last)] = value, in place (no host sync)."""
    tape[min(i, tape.shape[0] - 1)] = value


def model_buffer(max_iters: int, w0: torch.Tensor, track: bool) -> torch.Tensor:
    """(max_iters+1, d) coefficient buffer (ModelTracker), row 0 = w0; one
    slot when tracking is off."""
    size = max_iters + 1 if track else 1
    buf = torch.zeros((size,) + tuple(w0.shape), dtype=w0.dtype, device=w0.device)
    buf[0] = w0
    return buf
