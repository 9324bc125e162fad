"""GAME coordinates: fixed-effect and random-effect update/score units
(counterpart of ``photon_ml_tpu/game/coordinates.py``; the reference's
``algorithm/Coordinate.scala:28-55`` and its concrete types). A coordinate
owns its training design on its device and exposes:

  update_and_score(params, partial_scores, generator) -> (params', result, scores)
      solve the coordinate's subproblem with the OTHER coordinates' scores
      added to the offsets (``algorithm/Coordinate.scala:45-48``),
      warm-starting from the current parameters, then rescore its rows
  score(params) -> (n,) margins for the coordinate's own rows

``FixedEffectCoordinate`` (``FixedEffectCoordinate.scala:33-179``): one
GLM solve through the port's solvers; on an ELL shard every TRON
evaluation is one ``fused_vgc`` launch, every CG step one ``fused_hvp``
and the rescore one ``ell_matvec``. With ``hot_columns`` the shard is a
hybrid design inside the coordinate (``hybridize_batch``): each pass runs
``ell_matvec`` and the column-sorted reduce per cold segment and a plain
product on the slab, and the hybrid's row permutation stays private —
partial scores come in and rescores go out in the global row order
through two ``index_select`` calls on the device. Optional down-sampling
is a weight transform (``sampler/*DownSampler.scala``), its draws from a
``torch.Generator`` (another stream than ``jax.random``'s).

``RandomEffectCoordinate`` (``RandomEffectCoordinate.scala:36-214``): per
bucket ONE batched solve over the padded (entities, rows, dim) design
(:mod:`photon_ml_tpu_torch.solvers.batched`, the counterpart of
``jax.vmap``), plain tensor products on the card. Per-entity convergence
reasons come back as an (E,) array for the tracker histogram
(``RandomEffectOptimizationTracker.scala:33-110``).

Not ported: the entity-sharded coordinate and the fused-state hooks of
the JAX package's one-dispatch passes and grid sweeps.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from photon_ml_tpu_torch.core.tasks import TaskType
from photon_ml_tpu_torch.core.types import LabeledBatch
from photon_ml_tpu_torch.game.data import BucketedRandomEffectDesign, RandomEffectDesign
from photon_ml_tpu_torch.models.training import OptimizerType, solve_dtype
from photon_ml_tpu_torch.ops.losses import PointwiseLoss, loss_for_task
from photon_ml_tpu_torch.ops.objective import GLMObjective
from photon_ml_tpu_torch.ops.sparse import is_sparse, is_structured, matvec, to_hybrid
from photon_ml_tpu_torch.solvers import (
    SolverConfig,
    minimize_lbfgs,
    minimize_newton,
    minimize_owlqn,
    minimize_tron,
)
from photon_ml_tpu_torch.solvers.batched import (
    BatchedSolverResult,
    final_grad_norm,
    minimize_lbfgs_batched,
    minimize_newton_batched,
    minimize_owlqn_batched,
    minimize_tron_batched,
)
from photon_ml_tpu_torch.utils.device import to_numpy


@dataclasses.dataclass(frozen=True)
class CoordinateConfig:
    """Per-coordinate optimization knobs — the typed analog of the
    reference's GLMOptimizationConfiguration mini-DSL
    (``optimization/game/GLMOptimizationConfiguration.scala:32-80``);
    defaults per ``GLMOptimizationConfiguration.scala:33-38``."""

    shard: str
    task: TaskType = TaskType.LOGISTIC_REGRESSION
    optimizer: OptimizerType = OptimizerType.TRON
    reg_weight: float = 50.0
    l1_ratio: float = 0.0  # > 0 selects OWL-QN (elastic-net alpha)
    max_iters: int = 20
    tolerance: float = 1e-5
    # fixed-effect only: None = no down-sampling; else the keep rate in (0, 1)
    down_sampling_rate: Optional[float] = None
    # random-effect only
    random_effect: Optional[str] = None
    active_cap: Optional[int] = None
    # per-iteration solver tapes; off by default (per-entity solves would
    # carry (entities, max_iters+1) tapes)
    track_states: bool = False

    def solver_config(self) -> SolverConfig:
        return SolverConfig(
            max_iters=self.max_iters,
            tolerance=self.tolerance,
            track_states=self.track_states,
        )


def _checked_loss(config: CoordinateConfig) -> PointwiseLoss:
    loss = loss_for_task(config.task)
    if (
        config.optimizer in (OptimizerType.TRON, OptimizerType.NEWTON)
        and not loss.twice_differentiable
    ):
        # the GLM driver's validate() never runs for GAME coordinates, so
        # the second-order requirement is enforced here, at build time
        raise ValueError(
            f"{config.task} is first-order only; {config.optimizer.name} "
            "needs a twice-differentiable loss (use LBFGS)"
        )
    return loss


def _make_solve(config: CoordinateConfig):
    """``solve(w0, reg_weight, batch) -> SolverResult`` for one subproblem
    (the JAX package's unbatched ``solve_one``)."""
    loss = _checked_loss(config)
    scfg = config.solver_config()

    def solve(w0, reg_weight: float, batch: LabeledBatch):
        l1 = reg_weight * config.l1_ratio
        l2 = reg_weight * (1.0 - config.l1_ratio)
        obj = GLMObjective(loss=loss, l2_weight=l2)

        def vg(w):
            return obj.value_and_grad(w, batch)

        if config.l1_ratio > 0.0:
            return minimize_owlqn(vg, w0, l1, scfg)
        if config.optimizer == OptimizerType.TRON:
            return minimize_tron(
                vg, lambda w, v: obj.hessian_vector(w, v, batch), w0, scfg,
                hvp_at_fn=lambda c, v: obj.hessian_vector_at(c, v, batch),
                vgc_fn=lambda w: obj.value_grad_curvature(w, batch),
            )
        if config.optimizer == OptimizerType.NEWTON:
            return minimize_newton(vg, lambda w: obj.hessian_full(w, batch), w0, scfg)
        return minimize_lbfgs(vg, w0, scfg)

    return solve


@dataclasses.dataclass(frozen=True)
class _BatchedObjective:
    """The dense GLM objective of E per-entity problems at once, each
    lane with its own L2 weight: value, gradient and curvature weights
    from one margins pass, and the Hessian-vector product at fixed
    curvature weights (``ops/objective.GLMObjective`` lane by lane)."""

    loss: PointwiseLoss
    features: torch.Tensor  # (E, R, d)
    labels: torch.Tensor  # (E, R)
    offsets: torch.Tensor  # (E, R)
    ew: torch.Tensor  # (E, R) weights * mask
    l2: torch.Tensor  # (E,)

    def _margins(self, w):
        return torch.einsum("erd,ed->er", self.features, w)

    def _backproject(self, a):
        return torch.einsum("erd,er->ed", self.features, a)

    def value_grad_curvature(self, w):
        z = self._margins(w) + self.offsets
        val = torch.sum(self.ew * self.loss.value(z, self.labels), dim=-1)
        grad = self._backproject(self.ew * self.loss.d1(z, self.labels))
        c = self.ew * self.loss.d2(z, self.labels)
        val = val + 0.5 * self.l2 * torch.sum(w * w, dim=-1)
        return val, grad + self.l2[:, None] * w, c

    def value_and_grad(self, w):
        return self.value_grad_curvature(w)[:2]

    def hessian_vector_at(self, c, v):
        return self._backproject(c * self._margins(v)) + self.l2[:, None] * v

    def hessian_full(self, w):
        """(E, d, d): X_e^T diag(c_e) X_e + l2_e I, for the exact Newton
        solver (``GLMObjective.hessian_full`` lane by lane)."""
        c = self.ew * self.loss.d2(self._margins(w) + self.offsets, self.labels)
        x = self.features.to(c.dtype)
        h = x.transpose(1, 2) @ (c[:, :, None] * x)
        eye = torch.eye(w.shape[-1], dtype=h.dtype, device=h.device)
        return h + self.l2[:, None, None] * eye


def _make_batched_solve(config: CoordinateConfig):
    """``solve(W0, lams, design, offsets) -> BatchedSolverResult``: the
    JAX package's ``jax.vmap(solve_one)`` over the lanes of one bucket,
    each lane with its own reg weight, through the batched OWL-QN
    (``l1_ratio > 0``), TRON, NEWTON or L-BFGS. A plain random effect's
    weights are float32, as there (``coordinates.py:633-639``), and the
    L1 and L2 terms are formed in the weights' type before they meet the
    solve's dtype."""
    loss = _checked_loss(config)
    scfg = config.solver_config()

    def solve(w0, lams, design: RandomEffectDesign, offsets):
        l2 = (lams * (1.0 - config.l1_ratio)).to(w0.dtype)
        obj = _BatchedObjective(
            loss=loss, features=design.features, labels=design.labels,
            offsets=offsets, ew=design.weights * design.mask, l2=l2,
        )
        if config.l1_ratio > 0.0:
            return minimize_owlqn_batched(obj.value_and_grad, w0, lams * config.l1_ratio, scfg)
        if config.optimizer == OptimizerType.TRON:
            return minimize_tron_batched(
                obj.value_grad_curvature, obj.hessian_vector_at, w0, scfg
            )
        if config.optimizer == OptimizerType.NEWTON:
            return minimize_newton_batched(obj.value_and_grad, obj.hessian_full, w0, scfg)
        return minimize_lbfgs_batched(obj.value_and_grad, w0, scfg)

    return solve


def _downsample_budget(labels: np.ndarray, mask: np.ndarray, rate: float,
                       binary: bool) -> int:
    """Static row budget of the gathered down-sampled batch: the expected
    keep count + 6 standard deviations of the Bernoulli draw."""
    real = mask > 0
    n = int(real.sum())
    if binary:
        pos = int(((labels > 0) & real).sum())
        neg = n - pos
        mean = pos + rate * neg
        var = rate * (1.0 - rate) * neg
    else:
        mean = rate * n
        var = rate * (1.0 - rate) * n
    return min(n, int(np.ceil(mean + 6.0 * np.sqrt(max(var, 1.0)))) + 1)


def _uniform_draws(generator: torch.Generator, like: torch.Tensor) -> torch.Tensor:
    """(n,) uniforms from the host generator, on ``like``'s device, so the
    card and the CPU draw the same rows."""
    return torch.rand(like.shape, generator=generator, dtype=torch.float64).to(like)


def _binary_downsample_weights(generator, weights, labels, rate: float):
    """Keep positives; keep negatives w.p. rate with weight / rate
    (``sampler/BinaryClassificationDownSampler.scala:36-66``); dropped
    rows get weight 0."""
    keep = _uniform_draws(generator, weights) < rate
    neg = labels <= 0.0
    w = torch.where(neg & keep, weights / rate, weights)
    return torch.where(neg & ~keep, torch.zeros_like(w), w)


def _uniform_downsample_weights(generator, weights, labels, rate: float):
    """Uniform Bernoulli down-sampling with reweighting
    (``sampler/DefaultDownSampler.scala:30``)."""
    keep = _uniform_draws(generator, weights) < rate
    return torch.where(keep, weights / rate, torch.zeros_like(weights))


class FixedEffectCoordinate:
    """Global GLM coordinate over a LabeledBatch on its device (dense,
    padded-ELL, or with ``hot_columns`` a hybrid whose row permutation is
    private to the coordinate)."""

    @staticmethod
    def hybridize_batch(batch: LabeledBatch, hot_columns: int):
        """(permuted hybrid batch, row_perm, inv_perm): the split on the
        host (``to_hybrid``), exposed so that a grid sweep builds it once
        per coordinate (it depends on the data and ``hot_columns``, never
        on the reg weight). The permutations are int64 on the batch's
        device."""
        if not is_sparse(batch.features):
            raise ValueError("hot_columns requires a padded-ELL (sparse) shard")
        hf = to_hybrid(batch.features, hot_columns=hot_columns)
        perm = hf.row_perm.long()
        batch = dataclasses.replace(
            batch,
            features=hf,
            labels=batch.labels.index_select(0, perm),
            offsets=batch.offsets.index_select(0, perm),
            weights=batch.weights.index_select(0, perm),
            mask=batch.mask.index_select(0, perm),
        )
        return batch, perm, torch.argsort(perm)

    def __init__(self, batch: LabeledBatch, config: CoordinateConfig,
                 hot_columns: int = 0, hybrid_pack=None):
        if config.random_effect is not None:
            raise ValueError("config names a random effect; wrong coordinate")
        self._row_perm = self._inv_perm = None
        if hybrid_pack is not None:
            batch, self._row_perm, self._inv_perm = hybrid_pack
        elif hot_columns:
            batch, self._row_perm, self._inv_perm = self.hybridize_batch(batch, hot_columns)
        self.batch = batch
        self.config = config
        self._solve = _make_solve(config)
        rate = config.down_sampling_rate
        self._downsample = (
            None if rate is None
            else _binary_downsample_weights if config.task.is_classifier
            else _uniform_downsample_weights
        )
        # down-sampling SAVES work on a dense design: the kept rows are
        # gathered into a smaller batch sized for the expected keep count
        # plus a 6-sigma margin. An ELL or hybrid design keeps its rows with
        # zero weights; on a hybrid the draws follow its stored row order,
        # as the JAX package's do.
        self._ds_budget = None
        if self._downsample is not None and not is_structured(batch.features):
            self._ds_budget = _downsample_budget(
                to_numpy(batch.labels), to_numpy(batch.mask), rate,
                binary=config.task.is_classifier,
            )

    @property
    def dim(self) -> int:
        return self.batch.features.shape[-1]

    def initial_params(self) -> torch.Tensor:
        return torch.zeros((self.dim,), dtype=solve_dtype(self.batch),
                           device=self.batch.labels.device)

    def update(self, w, partial_scores, generator=None):
        params, result, _ = self.update_and_score(w, partial_scores, generator)
        return params, result

    def update_and_score(self, w: torch.Tensor, partial_scores: torch.Tensor,
                         generator: Optional[torch.Generator] = None):
        """(w', SolverResult, full-batch rescore), the partial scores and
        the rescore in the global row order."""
        b = self.batch
        if self._row_perm is not None:
            # a hybrid batch lives in its stored order
            partial_scores = partial_scores.index_select(0, self._row_perm)
        offsets = b.offsets + partial_scores
        weights = b.weights
        reg = self.config.reg_weight
        if self._downsample is not None:
            if generator is None:
                raise ValueError(
                    "down-sampling needs a generator per update; a fixed default "
                    "would drop the SAME rows every pass"
                )
            weights = self._downsample(generator, b.weights * b.mask, b.labels,
                                       self.config.down_sampling_rate)
            if self._ds_budget is not None:
                kept = weights > 0.0
                # stable partition: the kept rows first
                idx = torch.argsort((~kept).to(torch.int8), stable=True)[: self._ds_budget]
                valid = kept[idx]
                zero = torch.zeros_like(weights[idx])
                sub = LabeledBatch(
                    features=b.features[idx], labels=b.labels[idx], offsets=offsets[idx],
                    weights=torch.where(valid, weights[idx], zero),
                    mask=torch.where(valid, b.mask[idx], zero),
                )
                result = self._solve(w, reg, sub)
                return result.w, result, self.score(result.w)
        batch = dataclasses.replace(b, offsets=offsets, weights=weights)
        result = self._solve(w, reg, batch)
        return result.w, result, self.score(result.w)

    def reg_term(self, params: torch.Tensor) -> torch.Tensor:
        lam = torch.as_tensor(self.config.reg_weight, dtype=params.dtype,
                              device=params.device)
        l2 = lam * (1.0 - self.config.l1_ratio)
        l1 = lam * self.config.l1_ratio
        return 0.5 * l2 * torch.dot(params, params) + l1 * torch.sum(torch.abs(params))

    def score(self, w: torch.Tensor) -> torch.Tensor:
        """Broadcast-dot scoring (``FixedEffectCoordinate.scala:171-178``),
        without the dataset offset (scores sum across coordinates), in the
        global row order."""
        z = matvec(self.batch.features, w)
        return z if self._inv_perm is None else z.index_select(0, self._inv_perm)


@dataclasses.dataclass
class RandomEffectUpdateSummary:
    """Per-entity tracker view of one (possibly multi-bucket) update,
    concatenated over buckets with padding lanes removed
    (``RandomEffectOptimizationTracker.scala:33-110``). Holds device
    tensors until a field is first read."""

    # [(reason (E_b,), iterations (E_b,), grad_norm (E_b,), valid mask,
    #   entity_index (E_b,), cg_iterations (E_b,) or None), ...]
    pending: list

    def _materialize(self):
        if self.pending is not None:
            def cat(i):
                return np.concatenate([to_numpy(p[i])[p[3]] for p in self.pending])

            self._reason = cat(0)
            self._iterations = cat(1)
            self._grad_norms = cat(2)
            self._entity_ids = cat(4)
            self._cg_iterations = (
                None if any(p[5] is None for p in self.pending) else cat(5)
            )
            self.pending = None

    @property
    def reason(self) -> np.ndarray:  # (E_active,) int32
        self._materialize()
        return self._reason

    @property
    def iterations(self) -> np.ndarray:  # (E_active,) int32
        self._materialize()
        return self._iterations

    @property
    def grad_norms(self) -> np.ndarray:  # (E_active,) final ||grad||
        self._materialize()
        return self._grad_norms

    @property
    def entity_ids(self) -> np.ndarray:  # (E_active,) table rows
        self._materialize()
        return self._entity_ids

    @property
    def cg_iterations(self) -> Optional[np.ndarray]:  # TRON's CG steps per entity
        self._materialize()
        return self._cg_iterations


def _score_rows_by_entity(table, feats, ents):
    """Per-row scoring with the -1 = unknown-entity -> score-0 convention
    (``model/RandomEffectModel.scala:117-146``)."""
    safe = ents.clamp(min=0)
    per_row = torch.einsum("nd,nd->n", feats, table[safe])
    return torch.where(ents >= 0, per_row, torch.zeros_like(per_row))


class RandomEffectCoordinate:
    """Per-entity batched coordinate: the padded active design plus the
    full-row (features, entity index) for scoring. Scoring covers ALL rows
    — active and passive — through the coefficient table
    (``RandomEffectCoordinate.scala:116-170``). Takes a single
    :class:`RandomEffectDesign` (one bucket whose lanes ARE the table rows)
    or a :class:`BucketedRandomEffectDesign`."""

    def __init__(
        self,
        design,  # RandomEffectDesign | BucketedRandomEffectDesign
        row_features: torch.Tensor,  # (n, d) full scoring view
        row_entities: torch.Tensor,  # (n,) -1 = unknown entity
        full_offsets_base: torch.Tensor,  # (n,) data offsets
        config: CoordinateConfig,
        reg_weights=None,  # (E,) per-entity lambdas
    ):
        if config.random_effect is None:
            raise ValueError("config lacks random_effect; wrong coordinate")
        if isinstance(design, RandomEffectDesign):
            design = BucketedRandomEffectDesign(
                buckets=[design],
                entity_index=[np.arange(design.num_entities, dtype=np.int32)],
                num_entities=design.num_entities,
            )
        self.design = design
        self.row_features = row_features
        self.row_entities = row_entities
        self.full_offsets_base = full_offsets_base
        self.config = config
        device = row_features.device
        e = design.num_entities
        # (E,) per-entity regularization weights, float32 as in the JAX
        # package (``RandomEffectOptimizationProblem.scala:41-110``)
        if reg_weights is None:
            reg_weights = torch.full((e,), config.reg_weight, dtype=torch.float32,
                                     device=device)
        else:
            reg_weights = torch.as_tensor(reg_weights, dtype=torch.float32, device=device)
            if tuple(reg_weights.shape) != (e,):
                raise ValueError(f"reg_weights must be ({e},), got {tuple(reg_weights.shape)}")
        self.reg_weights = reg_weights
        self._solve = _make_batched_solve(config)
        self._valid_lanes = [np.asarray(ei) < e for ei in design.entity_index]
        # per bucket: the lanes' table rows (sentinels clamped for the
        # gathers) and the real lanes, whose solutions are scattered back
        self._lanes: List[Tuple[torch.Tensor, Optional[torch.Tensor]]] = []
        for ei, valid in zip(design.entity_index, self._valid_lanes):
            rows = torch.as_tensor(np.asarray(ei, np.int64), device=device)
            real = None if valid.all() else torch.as_tensor(np.flatnonzero(valid), device=device)
            self._lanes.append((rows.clamp(max=e - 1), real))

    @property
    def num_entities(self) -> int:
        return self.design.num_entities

    @property
    def dim(self) -> int:
        return self.design.dim

    def initial_params(self) -> torch.Tensor:
        feats = self.design.buckets[0].features
        return torch.zeros(
            (self.num_entities, self.dim),
            dtype=torch.promote_types(feats.dtype, torch.float32),
            device=feats.device,
        )

    def update(self, table, partial_scores, generator=None):
        table, summary, _ = self.update_and_score(table, partial_scores, generator)
        return table, summary

    def update_and_score(self, table: torch.Tensor, partial_scores: torch.Tensor,
                         generator=None):
        """All bucket solves + the full-row rescore; ``table`` is not
        modified (the new table is returned)."""
        full_offsets = self.full_offsets_base + partial_scores
        trackers = []
        for (rows, real), bucket in zip(self._lanes, self.design.buckets):
            offsets = bucket.gather_offsets(full_offsets)
            result: BatchedSolverResult = self._solve(
                table[rows], self.reg_weights[rows], bucket, offsets
            )
            w = result.w
            if real is not None:
                rows, w = rows[real], w[real]
            table = table.index_copy(0, rows, w)
            trackers.append((result.reason, result.iterations, final_grad_norm(result),
                             result.cg_iterations))
        scores = _score_rows_by_entity(table, self.row_features, self.row_entities)
        return table, self.wrap_tracker(trackers), scores

    def wrap_tracker(self, trackers) -> RandomEffectUpdateSummary:
        return RandomEffectUpdateSummary(pending=[
            (reason, iters, gnorm, valid, np.asarray(ei), cg)
            for (reason, iters, gnorm, cg), valid, ei in zip(
                trackers, self._valid_lanes, self.design.entity_index
            )
        ])

    def score(self, table: torch.Tensor) -> torch.Tensor:
        return _score_rows_by_entity(table, self.row_features, self.row_entities)

    def reg_term(self, table: torch.Tensor) -> torch.Tensor:
        """Penalty with the PER-ENTITY weights the batched solves
        minimized (``RandomEffectOptimizationProblem.getRegularizationTermValue``)."""
        lam = self.reg_weights.to(table.dtype)
        l2 = lam * (1.0 - self.config.l1_ratio)
        l1 = lam * self.config.l1_ratio
        sq = torch.sum(table * table, dim=-1)
        ab = torch.sum(torch.abs(table), dim=-1)
        return torch.sum(0.5 * l2 * sq + l1 * ab)
