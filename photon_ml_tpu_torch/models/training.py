"""GLM training over the regularization path with warm starts (counterpart
of ``photon_ml_tpu/models/training.py``; the reference's
``GeneralizedLinearAlgorithm.scala:37,181-251`` and
``ModelTraining.scala:32-141``):

  - regularization weights are trained in DESCENDING order
    (``ModelTraining.scala:124``), each solve warm-started from the
    previous solution (``GeneralizedLinearAlgorithm.scala:226-235``);
  - the model is optimized in normalized space through the whitening
    algebra folded into the objective, then mapped back to raw feature
    space (``GeneralizedLinearAlgorithm.scala:111-113``);
  - L2 goes into the objective; TRON is L2-only (``Params.scala:156-173``).

The path is a Python loop over one per-lambda solve: the JAX package's
``path_mode="loop"``, which its tests hold equal to its default ``"scan"``.
The port takes either value and runs the loop.
"""

from __future__ import annotations

import dataclasses
import enum
import time
from typing import Optional, Sequence, Tuple

import torch

from photon_ml_tpu_torch.core.normalization import (
    NormalizationContext,
    NormalizationType,
    build_normalization_context,
    no_normalization,
)
from photon_ml_tpu_torch.core.tasks import TaskType
from photon_ml_tpu_torch.core.types import Coefficients, LabeledBatch
from photon_ml_tpu_torch.models.glm import GeneralizedLinearModel
from photon_ml_tpu_torch.ops.losses import loss_for_task
from photon_ml_tpu_torch.ops.objective import GLMObjective, RegularizationContext
from photon_ml_tpu_torch.ops.sparse import is_sparse
from photon_ml_tpu_torch.ops.stats import summarize_features
from photon_ml_tpu_torch.solvers import (
    SolverConfig,
    SolverResult,
    minimize_lbfgs,
    minimize_tron,
)


class OptimizerType(enum.Enum):
    """``optimization/OptimizerType.scala`` plus the JAX package's exact
    Newton solver, which the port does not run yet."""

    LBFGS = "LBFGS"
    TRON = "TRON"
    NEWTON = "NEWTON"


def not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to photon_ml_tpu_torch yet (ROADMAP.md, queue "
        f"A: {item!r}); run it with photon_ml_tpu"
    )


@dataclasses.dataclass(frozen=True)
class GLMTrainingConfig:
    """The knobs of one training run (``Params.scala:36-183``). Box
    constraints are not taken yet (ROADMAP.md, queue A: 'GLM solver
    options'); the solvers take them through ``SolverConfig``."""

    task: TaskType = TaskType.LOGISTIC_REGRESSION
    optimizer: OptimizerType = OptimizerType.LBFGS
    reg_weights: Tuple[float, ...] = (0.0,)
    regularization: RegularizationContext = RegularizationContext()
    normalization: NormalizationType = NormalizationType.NONE
    max_iters: int = 80
    tolerance: float = 1e-7
    num_corrections: int = 10
    intercept_index: Optional[int] = None
    compute_variances: bool = False
    track_states: bool = True
    # per-iteration coefficients (ModelTracker) for validate-per-iteration
    track_models: bool = False
    # "scan" | "loop": both run the per-lambda loop here
    path_mode: str = "scan"

    def __post_init__(self):
        object.__setattr__(
            self, "reg_weights", tuple(float(v) for v in self.reg_weights)
        )

    def validate(self) -> None:
        """The reference's cross-flag validation matrix
        (``Params.scala:156-173``, ``OptimizationProblem.scala:155-161``),
        then the parts the port does not run yet."""
        if self.path_mode not in ("scan", "loop"):
            raise ValueError(
                f"path_mode must be 'scan' or 'loop', got {self.path_mode!r}"
            )
        has_l1 = self.regularization.reg_type in ("L1", "ELASTIC_NET")
        if self.optimizer == OptimizerType.TRON and has_l1:
            raise ValueError(
                "TRON does not support L1 regularization "
                "(reference Params.scala:158-161)"
            )
        if (
            self.optimizer == OptimizerType.TRON
            and not loss_for_task(self.task).twice_differentiable
        ):
            raise ValueError(
                f"{self.task} is first-order only; use LBFGS "
                "(reference SmoothedHingeLossFunction.scala:24-60)"
            )
        if (
            self.normalization == NormalizationType.STANDARDIZATION
            and self.intercept_index is None
        ):
            raise ValueError(
                "standardization requires an intercept term "
                "(reference Params.scala:166-169)"
            )
        if self.optimizer == OptimizerType.NEWTON:
            raise not_ported("the NEWTON optimizer", "GLM solver options")
        if has_l1:
            raise not_ported(
                f"{self.regularization.reg_type} regularization (OWL-QN)",
                "GLM solver options",
            )
        if self.compute_variances:
            raise not_ported("compute_variances", "Variances")

    def solver_config(self) -> SolverConfig:
        return SolverConfig(
            max_iters=self.max_iters,
            tolerance=self.tolerance,
            num_corrections=self.num_corrections,
            track_states=self.track_states,
            track_models=self.track_models,
        )


@dataclasses.dataclass(frozen=True)
class TrainedModel:
    """(lambda, model, solver result); ``seconds`` is the solve's wall
    clock, which ends in a host read of the convergence reason."""

    reg_weight: float
    model: GeneralizedLinearModel
    result: SolverResult
    seconds: float = 0.0


def _solver_step_fn(config: GLMTrainingConfig):
    """``solve(w0, reg_weight, batch, norm) -> SolverResult``: the one
    per-lambda solve."""
    loss = loss_for_task(config.task)
    reg = config.regularization
    scfg = config.solver_config()
    use_tron = config.optimizer == OptimizerType.TRON

    def solve(w0, reg_weight, batch: LabeledBatch, norm: NormalizationContext):
        obj = GLMObjective(
            loss=loss, normalization=norm, l2_weight=reg_weight * reg.l2_weight(1.0)
        )

        def vg(w):
            return obj.value_and_grad(w, batch)

        if use_tron:
            return minimize_tron(
                vg,
                lambda w, v: obj.hessian_vector(w, v, batch),
                w0,
                scfg,
                hvp_at_fn=lambda c, v: obj.hessian_vector_at(c, v, batch),
                vgc_fn=lambda w: obj.value_grad_curvature(w, batch),
            )
        return minimize_lbfgs(vg, w0, scfg)

    return solve


def solve_dtype(batch: LabeledBatch) -> torch.dtype:
    """Solver-state dtype: at least float32 (a bf16-stored design still
    accumulates and steps in float32)."""
    x = batch.features
    stored = x.values.dtype if is_sparse(x) else x.dtype
    return torch.promote_types(stored, torch.float32)


def prepare_normalization(
    config: GLMTrainingConfig, batch: LabeledBatch
) -> NormalizationContext:
    """Feature summary pass -> whitening context (``Driver.scala:229-253``)."""
    if config.normalization == NormalizationType.NONE:
        return no_normalization()
    return build_normalization_context(
        config.normalization, summarize_features(batch), config.intercept_index
    )


def train_glm(
    batch: LabeledBatch,
    config: GLMTrainingConfig,
    initial_coefficients: Optional[Coefficients] = None,
    normalization: Optional[NormalizationContext] = None,
) -> Sequence[TrainedModel]:
    """Train one model per regularization weight, descending, warm-started,
    on the batch's device.

    Returns the models in the ORIGINAL order of ``reg_weights``
    (``ModelTraining.scala:130-140``). Coefficients come back in raw
    feature space; ``initial_coefficients`` are raw-space too and are
    mapped into normalized space before solving."""
    config.validate()
    norm = normalization if normalization is not None else prepare_normalization(config, batch)
    dtype = solve_dtype(batch)
    device = batch.labels.device
    d = batch.features.shape[-1]
    if initial_coefficients is not None:
        w = norm.inverse_transform_model_coefficients(
            initial_coefficients, config.intercept_index
        ).means.to(device=device, dtype=dtype)
    else:
        w = torch.zeros((d,), dtype=dtype, device=device)

    solve = _solver_step_fn(config)
    by_lambda = {}
    for lam in sorted(config.reg_weights, reverse=True):
        t0 = time.perf_counter()
        result = solve(w, lam, batch, norm)
        seconds = time.perf_counter() - t0
        w = result.w  # warm start for the next (smaller) lambda
        if config.track_models and result.w_history is not None:
            # snapshots leave the solver in normalized space
            hist = torch.stack([
                norm.transform_model_coefficients(
                    Coefficients(means=row), config.intercept_index
                ).means
                for row in result.w_history
            ])
            result = dataclasses.replace(result, w_history=hist)
        coef = norm.transform_model_coefficients(
            Coefficients(means=result.w), config.intercept_index
        )
        model = GeneralizedLinearModel(coefficients=coef, task=config.task)
        by_lambda[lam] = TrainedModel(
            reg_weight=lam, model=model, result=result, seconds=seconds
        )
    return [by_lambda[lam] for lam in config.reg_weights]
