"""Solvers (counterpart of ``photon_ml_tpu/solvers``): L-BFGS and TRON as
Python loops over tensors on the batch's device. OWL-QN and the exact
Newton solver are not ported yet (ROADMAP.md, queue A)."""

from photon_ml_tpu_torch.solvers.common import (
    ConvergenceReason,
    SolverConfig,
    SolverResult,
    host_reads,
    mask_tape,
    project_to_hypercube,
    reset_host_reads,
)
from photon_ml_tpu_torch.solvers.lbfgs import minimize_lbfgs
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
    "minimize_tron",
]
