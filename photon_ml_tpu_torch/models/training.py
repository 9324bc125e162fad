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
  - L2 goes into the objective, L1 selects OWL-QN, TRON is L2-only (the
    validation matrix of ``Params.scala:156-173``);
  - with ``compute_variances`` each solution gets per-coefficient variances
    1 / diag(H) at its own lambda, mapped to raw space with the means.

The path is a Python loop over one per-lambda solve: the JAX package's
``path_mode="loop"``, which its tests hold equal to its default ``"scan"``.
The port takes either value and runs the loop. ``train_glm_streamed`` is
the same path out of core, over a host-resident chunked design
(``io.pipeline.StreamedDesign``).

Observability follows the JAX package's default path: one
``glm.solve_path`` span around the path and one ``glm.solve`` span per
lambda. Where the JAX package retro-stamps each lambda's span with a
share of its one dispatch, here each span is the solve's own window.
Under a tracer (or an installed convergence tracker) each solve also
records its ``solver.*`` counters, its convergence report
(``obs.convergence``) and, under a tracer, the cost book's attribution
over the window, which then ends in a device sync; an untraced run reads
nothing more from the device.

Under an active mesh (``parallel.mesh.set_mesh``) ``train_glm`` takes this
rank's shard: the objective sums its data partials over 'data', and when
the mesh splits the coefficient axis the batch is this rank's column block
and so is every solver vector; each solution is then gathered over
'feature' (the blocked coefficient space, identical on every rank) before
it is mapped back to raw feature space. ``parallel.distributed`` places
the shards.
"""

from __future__ import annotations

import dataclasses
import enum
import time
from typing import Optional, Sequence, Tuple

import torch

from photon_ml_tpu_torch import obs

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
from photon_ml_tpu_torch.ops.sparse import values_dtype
from photon_ml_tpu_torch.ops.stats import summarize_features
from photon_ml_tpu_torch.parallel.mesh import (
    FEATURE_AXIS,
    active_mesh,
    all_gather,
    feature_sharded,
    row_axis,
    whole_vectors,
)
from photon_ml_tpu_torch.solvers import (
    SolverConfig,
    SolverResult,
    minimize_lbfgs,
    minimize_newton,
    minimize_owlqn,
    minimize_tron,
)

# Variance guard for 1 / Hessian-diagonal, mirroring the epsilon in
# ``optimization/game/OptimizationProblem.scala:89-116`` (MathConst.EPSILON).
_VARIANCE_EPSILON = 1e-12


class OptimizerType(enum.Enum):
    """``optimization/OptimizerType.scala`` plus the JAX package's exact
    Newton solver (dense designs, scale-only normalization, L2 only)."""

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
    constraints are (d,) bounds (a tensor, an array or a sequence; +-inf
    where a side is open), kept as float64 tensors on the CPU and moved to
    the batch's device by each solve."""

    task: TaskType = TaskType.LOGISTIC_REGRESSION
    optimizer: OptimizerType = OptimizerType.LBFGS
    reg_weights: Tuple[float, ...] = (0.0,)
    regularization: RegularizationContext = RegularizationContext()
    normalization: NormalizationType = NormalizationType.NONE
    max_iters: int = 80
    tolerance: float = 1e-7
    num_corrections: int = 10
    intercept_index: Optional[int] = None
    lower_bounds: Optional[torch.Tensor] = None
    upper_bounds: Optional[torch.Tensor] = None
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
        for name in ("lower_bounds", "upper_bounds"):
            v = getattr(self, name)
            if v is not None:
                object.__setattr__(
                    self, name, torch.as_tensor(v, dtype=torch.float64, device="cpu")
                )

    def validate(self) -> None:
        """The reference's cross-flag validation matrix
        (``Params.scala:156-173``, ``OptimizationProblem.scala:155-161``)."""
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
        has_constraints = (
            self.lower_bounds is not None or self.upper_bounds is not None
        )
        if has_constraints and self.normalization != NormalizationType.NONE:
            raise ValueError(
                "box constraints cannot be combined with normalization "
                "(reference Params.scala:162-165)"
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
            if has_l1:
                raise ValueError("NEWTON supports L2 only (use OWL-QN for L1)")
            if not loss_for_task(self.task).twice_differentiable:
                raise ValueError(f"{self.task} is first-order only; use LBFGS")
            if has_constraints:
                raise ValueError(
                    "NEWTON does not support box constraints; use LBFGS"
                )
            if self.normalization == NormalizationType.STANDARDIZATION:
                raise ValueError(
                    "NEWTON supports scale-only normalization (no whiten "
                    "shifts); use SCALE_WITH_* or NONE"
                )

    def solver_config(self) -> SolverConfig:
        return SolverConfig(
            max_iters=self.max_iters,
            tolerance=self.tolerance,
            num_corrections=self.num_corrections,
            lower_bounds=self.lower_bounds,
            upper_bounds=self.upper_bounds,
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
    per-lambda solve. L1 and elastic net run OWL-QN whatever the optimizer
    (``LBFGS.scala:56-66``); otherwise TRON, NEWTON or L-BFGS."""
    loss = loss_for_task(config.task)
    reg = config.regularization
    scfg = config.solver_config()
    use_owlqn = reg.reg_type in ("L1", "ELASTIC_NET")
    use_tron = config.optimizer == OptimizerType.TRON
    use_newton = config.optimizer == OptimizerType.NEWTON

    def solve(w0, reg_weight, batch: LabeledBatch, norm: NormalizationContext):
        obj = GLMObjective(
            loss=loss, normalization=norm, l2_weight=reg_weight * reg.l2_weight(1.0),
            axis_name=row_axis(),
        )
        cfg = scfg
        if cfg.lower_bounds is not None or cfg.upper_bounds is not None:
            # the bounds go to the solve's device and dtype once
            cfg = dataclasses.replace(cfg, **{
                name: None if b is None else b.to(w0)
                for name, b in (("lower_bounds", cfg.lower_bounds),
                                ("upper_bounds", cfg.upper_bounds))
            })

        def vg(w):
            return obj.value_and_grad(w, batch)

        if use_owlqn:
            return minimize_owlqn(vg, w0, reg_weight * reg.l1_weight(1.0), cfg)
        if use_tron:
            return minimize_tron(
                vg,
                lambda w, v: obj.hessian_vector(w, v, batch),
                w0,
                cfg,
                hvp_at_fn=lambda c, v: obj.hessian_vector_at(c, v, batch),
                vgc_fn=lambda w: obj.value_grad_curvature(w, batch),
            )
        if use_newton:
            return minimize_newton(vg, lambda w: obj.hessian_full(w, batch), w0, cfg)
        return minimize_lbfgs(vg, w0, cfg)

    return solve


def _variances_fn(config: GLMTrainingConfig):
    """``variances(w, reg_weight, batch, norm)``: the per-coefficient
    variance estimate 1 / diag(H) at ``reg_weight``'s L2, in the solve's
    (normalized) space. ELL designs: one ``fused_hessian_diagonal``."""
    loss = loss_for_task(config.task)
    reg = config.regularization

    def variances(w, reg_weight, batch: LabeledBatch, norm: NormalizationContext):
        obj = GLMObjective(
            loss=loss, normalization=norm, l2_weight=reg_weight * reg.l2_weight(1.0),
            axis_name=row_axis(),
        )
        return 1.0 / torch.clamp(obj.hessian_diagonal(w, batch), min=_VARIANCE_EPSILON)

    return variances


def _record_solve_metrics(config: GLMTrainingConfig, result: SolverResult) -> None:
    """A completed solve's counters under its solver's prefix (JAX
    ``models/training.py:397``): OWL-QN for L1 and elastic net, else the
    configured optimizer."""
    if config.regularization.reg_type in ("L1", "ELASTIC_NET"):
        from photon_ml_tpu_torch.solvers.lbfgs import record_solve_metrics

        record_solve_metrics(result, owlqn=True)
    elif config.optimizer == OptimizerType.TRON:
        from photon_ml_tpu_torch.solvers.tron import record_solve_metrics

        record_solve_metrics(result)
    elif config.optimizer == OptimizerType.LBFGS:
        from photon_ml_tpu_torch.solvers.lbfgs import record_solve_metrics

        record_solve_metrics(result)
    else:
        from photon_ml_tpu_torch.solvers.common import record_solver_metrics

        record_solver_metrics(config.optimizer.name.lower(), result)


def _observe_solve(config: GLMTrainingConfig, sp, tracer, ts0: float, t0: float, lam: float,
                   result: SolverResult, features=None, device=None, dtype=None,
                   streamed: bool = False) -> float:
    """The observed half of one solve (JAX ``models/training.py:745-845``),
    run only under a tracer or an installed convergence tracker: the
    span's device sync (a tracer's only), the solver counters, the cost
    book's attribution of ``design_passes`` passes over ``features`` in
    the window (the pass's record exists once the solve's first pass has
    run), the convergence report and its counter track. Returns the
    design passes."""
    from photon_ml_tpu_torch.solvers.common import design_passes

    sp.sync(result.w)
    seconds = time.perf_counter() - t0
    _record_solve_metrics(config, result)
    passes = design_passes(result)
    if features is not None:
        obs.annotate_span(sp, obs.cost.pass_record(features, dtype), seconds=seconds,
                          passes=passes, device=device, dtype=dtype)
    report = obs.decode_result(result, optimizer=config.optimizer.name.lower())
    obs.convergence.note_solve(
        report, label=f"lambda={float(lam):g}" + (" (streamed)" if streamed else ""))
    sp.set(convergence_reason=report.reason, convergence_order=report.order)
    if streamed:
        sp.set(sweep_s=round(seconds, 4))
    elif tracer is not None:
        obs.convergence.emit_tape_counters(report, tracer, ts0, seconds * 1e6)
    return passes


def _observed() -> bool:
    """Whether a solve records its observations: an active tracer or an
    installed convergence tracker (JAX's gate)."""
    return obs.get_tracer() is not None or obs.convergence.tracking_enabled()


def _block_range(batch: LabeledBatch) -> Tuple[int, int]:
    """[lo, hi) of this rank's columns in the blocked coefficient space."""
    d_local = batch.features.shape[-1]
    lo = active_mesh().index(FEATURE_AXIS) * d_local
    return lo, lo + d_local


def _gathered(v: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """Every rank's block of a coefficient-space vector (or of each row of
    an (iterations, d) tape) over 'feature', in block order."""
    if v is None:
        return None
    g = all_gather(v, FEATURE_AXIS, "gather")
    if v.dim() == 1:
        return g.reshape(-1)
    return g.permute(1, 0, 2).reshape(v.shape[0], -1)


def solve_dtype(batch: LabeledBatch) -> torch.dtype:
    """Solver-state dtype: at least float32 (a bf16-stored design still
    accumulates and steps in float32)."""
    return torch.promote_types(values_dtype(batch.features), torch.float32)


def prepare_normalization(
    config: GLMTrainingConfig, batch: LabeledBatch
) -> NormalizationContext:
    """Feature summary pass -> whitening context (``Driver.scala:229-253``).
    On a feature-sharded solve: this rank's block of it, the intercept
    (a position in the blocked space) in whichever block holds it."""
    if config.normalization == NormalizationType.NONE:
        return no_normalization()
    icpt, elsewhere = config.intercept_index, False
    if feature_sharded() and icpt is not None:
        lo, hi = _block_range(batch)
        icpt, elsewhere = (icpt - lo, False) if lo <= icpt < hi else (None, True)
    return build_normalization_context(
        config.normalization, summarize_features(batch), icpt, intercept_elsewhere=elsewhere
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
    sharded = feature_sharded()
    # the raw-space map back runs on whole vectors: on a feature-sharded
    # solve, the blocks gathered over 'feature'
    out_norm = norm
    if sharded:
        out_norm = NormalizationContext(factors=_gathered(norm.factors),
                                        shifts=_gathered(norm.shifts))
    if initial_coefficients is not None:
        with whole_vectors():
            w = out_norm.inverse_transform_model_coefficients(
                initial_coefficients, config.intercept_index
            ).means.to(device=device, dtype=dtype)
        if sharded:
            lo, hi = _block_range(batch)
            w = w[lo:hi].contiguous()
    else:
        w = torch.zeros((d,), dtype=dtype, device=device)

    solve = _solver_step_fn(config)
    variances = _variances_fn(config) if config.compute_variances else None
    by_lambda = {}
    lams = sorted(config.reg_weights, reverse=True)
    path_t0, path_passes = time.perf_counter(), 0.0
    path_span = obs.span("glm.solve_path", cat="solver", optimizer=config.optimizer.name,
                         path_len=len(lams))
    with path_span:
        for lam in lams:
            with obs.span("glm.solve", cat="solver", optimizer=config.optimizer.name,
                          reg_weight=float(lam), path=True) as sp:
                tracer = obs.get_tracer()
                ts0 = tracer.now_us() if tracer is not None else 0.0
                t0 = time.perf_counter()
                result = solve(w, lam, batch, norm)
                seconds = time.perf_counter() - t0
                if _observed():
                    path_passes += _observe_solve(config, sp, tracer, ts0, t0, lam, result,
                                                  batch.features, device, dtype)
            w, by_lambda[lam] = _finish_solve(config, result, lam, seconds, batch, norm,
                                              out_norm, variances, sharded)
        if _observed():
            obs.annotate_span(path_span, obs.cost.pass_record(batch.features, dtype),
                              seconds=time.perf_counter() - path_t0, passes=path_passes,
                              device=device, dtype=dtype)
    return [by_lambda[lam] for lam in config.reg_weights]


def _finish_solve(config, result, lam, seconds, batch, norm, out_norm, variances, sharded):
    """(the warm start of the next lambda, this lambda's TrainedModel):
    the variances, the gathered blocks of a feature-sharded solve, and the
    map back to raw feature space."""
    w = result.w  # warm start for the next (smaller) lambda
    var = None if variances is None else variances(result.w, lam, batch, norm)
    if sharded:
        result = dataclasses.replace(result, w=_gathered(result.w),
                                     grad=_gathered(result.grad),
                                     w_history=_gathered(result.w_history))
        var = _gathered(var)
    with whole_vectors():
        if config.track_models and result.w_history is not None:
            # snapshots leave the solver in normalized space
            hist = torch.stack([
                out_norm.transform_model_coefficients(
                    Coefficients(means=row), config.intercept_index
                ).means
                for row in result.w_history
            ])
            result = dataclasses.replace(result, w_history=hist)
        coef = out_norm.transform_model_coefficients(
            Coefficients(means=result.w, variances=var), config.intercept_index
        )
    model = GeneralizedLinearModel(coefficients=coef, task=config.task)
    return w, TrainedModel(reg_weight=lam, model=model, result=result, seconds=seconds)


def train_glm_streamed(
    design,
    config: GLMTrainingConfig,
    initial_coefficients: Optional[Coefficients] = None,
    stats=None,
) -> Sequence[TrainedModel]:
    """Out-of-core :func:`train_glm`: every objective evaluation streams the
    host-resident chunks of a :class:`photon_ml_tpu_torch.io.pipeline.
    StreamedDesign` to its device through the per-chunk dense passes
    (``io.pipeline.StreamingObjective``), so TRON, L-BFGS and OWL-QN see
    the exact full-dataset objective, and the models equal the in-core
    path's up to the reassociation at the chunk boundaries.

    The contract of :func:`train_glm` (the descending warm-started lambda
    path, models in config order, variances from the streamed Hessian
    diagonal), with the JAX package's refusals: ``normalization`` other
    than NONE (the summary would need its own streaming pass) and NEWTON
    (its explicit Hessian needs the in-core design). ``stats`` (a
    ``PipelineStats``) collects every sweep's copy and pass times (the
    device's, on the card), each lambda's by the time its model is made."""
    from photon_ml_tpu_torch.io.pipeline import StreamingObjective

    config.validate()
    if config.normalization != NormalizationType.NONE:
        raise ValueError(
            "train_glm_streamed supports normalization=NONE only (the "
            "whitening summary needs its own streaming pass)"
        )
    if config.optimizer == OptimizerType.NEWTON:
        raise ValueError(
            "NEWTON materializes the explicit Hessian from the in-core "
            "design; use TRON or LBFGS for out-of-core training"
        )
    loss = loss_for_task(config.task)
    reg = config.regularization
    scfg = config.solver_config()
    if scfg.lower_bounds is not None or scfg.upper_bounds is not None:
        scfg = dataclasses.replace(scfg, **{
            name: None if b is None else b.to(device=design.device, dtype=design.dtype)
            for name, b in (("lower_bounds", scfg.lower_bounds),
                            ("upper_bounds", scfg.upper_bounds))
        })
    use_owlqn = reg.reg_type in ("L1", "ELASTIC_NET")
    use_tron = config.optimizer == OptimizerType.TRON
    if initial_coefficients is not None:
        w = initial_coefficients.means.to(device=design.device, dtype=design.dtype)
    else:
        w = torch.zeros((design.d,), dtype=design.dtype, device=design.device)

    by_lambda = {}
    for lam in sorted(config.reg_weights, reverse=True):
        sobj = StreamingObjective(design, loss, l2_weight=lam * reg.l2_weight(1.0),
                                  stats=stats)
        with obs.span("glm.solve", cat="solver", optimizer=config.optimizer.name,
                      reg_weight=float(lam), streamed=True, chunks=design.num_chunks) as sp:
            tracer = obs.get_tracer()
            ts0 = tracer.now_us() if tracer is not None else 0.0
            t0 = time.perf_counter()
            if use_owlqn:
                result = minimize_owlqn(sobj.value_and_grad, w, lam * reg.l1_weight(1.0), scfg)
            elif use_tron:
                result = minimize_tron(sobj.value_and_grad, sobj.hessian_vector, w, scfg)
            else:
                result = minimize_lbfgs(sobj.value_and_grad, w, scfg)
            seconds = time.perf_counter() - t0
            if _observed():
                _observe_solve(config, sp, tracer, ts0, t0, lam, result, streamed=True)
        w = result.w  # warm start for the next (smaller) lambda
        var = None
        if config.compute_variances:
            var = 1.0 / torch.clamp(sobj.hessian_diagonal(result.w), min=_VARIANCE_EPSILON)
        sobj.flush_timing()
        # normalization is NONE: the solved space is the raw feature space
        model = GeneralizedLinearModel(
            coefficients=Coefficients(means=result.w, variances=var), task=config.task)
        by_lambda[lam] = TrainedModel(reg_weight=lam, model=model, result=result,
                                      seconds=seconds)
    return [by_lambda[lam] for lam in config.reg_weights]
