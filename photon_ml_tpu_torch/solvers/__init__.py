"""Solvers (counterpart of ``photon_ml_tpu/solvers``): L-BFGS, OWL-QN,
TRON and the exact Newton solver as Python loops over tensors on the
batch's device; ``batched`` holds TRON and L-BFGS over many per-entity
problems at once (the JAX package's ``jax.vmap`` of them)."""

from photon_ml_tpu_torch.solvers.common import (
    ConvergenceReason,
    SolverConfig,
    SolverResult,
    host_reads,
    mask_tape,
    project_to_hypercube,
    reset_host_reads,
)
from photon_ml_tpu_torch.solvers.lbfgs import minimize_lbfgs, minimize_owlqn
from photon_ml_tpu_torch.solvers.newton import NEWTON_DEFAULT_CONFIG, minimize_newton
from photon_ml_tpu_torch.solvers.tron import minimize_tron

__all__ = [
    "ConvergenceReason",
    "SolverConfig",
    "SolverResult",
    "host_reads",
    "mask_tape",
    "project_to_hypercube",
    "reset_host_reads",
    "minimize_lbfgs",
    "minimize_owlqn",
    "minimize_newton",
    "minimize_tron",
    "NEWTON_DEFAULT_CONFIG",
]
