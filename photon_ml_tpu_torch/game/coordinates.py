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

The grid surface (``fused_state_for_reg`` / ``with_fused_state``, the
JAX package's names): a coordinate's state for one reg weight, whose
pieces that do not depend on the weight are the same tensor objects on
every call, and a copy of the coordinate on such a state. The combo grid
and the lambda path (``game/descent.run_grid``, ``run_lambda_path``) run
on it, combo by combo over the coordinates' one design.

``EntityShardedRandomEffectCoordinate`` (``coordinates.py:790``): the
random effect over a world of ranks, each holding its entities' block of
the table (stored shard-major) and their rows (the entity-partitioned row
order): each rank solves its own lanes and rescores its own rows, and the
update issues no collective. Under an active mesh the fixed effect's
objective sums its row partials over the rows' axis
(``parallel.mesh.row_axis``).
"""

from __future__ import annotations

import copy as copy_module
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
from photon_ml_tpu_torch.parallel.mesh import ENTITY_AXIS, entity_block, row_axis
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
        # under a mesh the batch is this rank's rows: the row partials sum
        # over the rows' axis
        obj = GLMObjective(loss=loss, l2_weight=l2, axis_name=row_axis())

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
        # the reg weight the solves and the penalty read: the config's, or
        # a grid combo's on a copy made by with_fused_state
        self._reg_weight = config.reg_weight
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
        reg = self._reg_weight
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

    def fused_state_for_reg(self, reg_weight):
        """The coordinate's state for one reg weight (JAX
        ``coordinates.py:378``): the batch, the hybrid's row permutations
        and the weight, a float64 scalar on the host. Same-object contract:
        every piece that does not depend on ``reg_weight`` is the same
        tensor object on every call, so a grid reads it once for all its
        combos."""
        return (self.batch, self._row_perm, self._inv_perm,
                torch.tensor(float(reg_weight), dtype=torch.float64))

    def with_fused_state(self, state):
        """A copy of the coordinate on ``state`` (``fused_state_for_reg``)."""
        c = copy_module.copy(self)
        c.batch, c._row_perm, c._inv_perm, lam = state
        c._reg_weight = float(lam)
        return c

    def reg_term(self, params: torch.Tensor) -> torch.Tensor:
        lam = torch.as_tensor(self._reg_weight, dtype=params.dtype, device=params.device)
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
    # an entity-sharded coordinate's: every rank's fields joined in rank
    # order at the first read (a host exchange every rank makes at the same
    # point of the run), so that each rank's record covers every entity
    gathered: bool = False

    def _materialize(self):
        if self.pending is not None:
            def cat(i):
                return np.concatenate([to_numpy(p[i])[p[3]] for p in self.pending])

            fields = [cat(0), cat(1), cat(2), cat(4),
                      None if any(p[5] is None for p in self.pending) else cat(5)]
            if self.gathered:
                from photon_ml_tpu_torch.parallel.multihost import allgather_objects

                ranks = allgather_objects(fields)
                fields = [None if any(r[k] is None for r in ranks)
                          else np.concatenate([r[k] for r in ranks]) for k in range(5)]
            (self._reason, self._iterations, self._grad_norms, self._entity_ids,
             self._cg_iterations) = fields
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
        self._uniform_reg = reg_weights is None
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

    def fused_state_for_reg(self, reg_weight):
        """The coordinate's state with every entity's reg weight set to
        ``reg_weight`` (JAX ``coordinates.py:730``): the (E,) float32
        weights, then the offsets, the design's buckets, the scoring rows
        and their entities. The grid replaces the coordinate's shared
        weight, so a coordinate built with custom per-entity weights
        refuses. Same-object contract: only the weights are made anew."""
        if not self._uniform_reg:
            raise ValueError(
                "grid sweeps replace the coordinate's shared reg weight; "
                "this RandomEffectCoordinate carries CUSTOM per-entity "
                "reg_weights — run its combos sequentially instead"
            )
        return (
            torch.full((self.design.num_entities,), reg_weight, dtype=torch.float32,
                       device=self.row_features.device),
            self.full_offsets_base,
            tuple(self.design.buckets),
            self.row_features,
            self.row_entities,
        )

    def with_fused_state(self, state):
        """A copy of the coordinate on ``state`` (``fused_state_for_reg``)."""
        c = copy_module.copy(self)
        c.reg_weights, c.full_offsets_base, buckets, c.row_features, c.row_entities = state
        c.design = dataclasses.replace(self.design, buckets=list(buckets))
        return c

    def reg_term(self, table: torch.Tensor) -> torch.Tensor:
        """Penalty with the PER-ENTITY weights the batched solves
        minimized (``RandomEffectOptimizationProblem.getRegularizationTermValue``)."""
        lam = self.reg_weights.to(table.dtype)
        l2 = lam * (1.0 - self.config.l1_ratio)
        l1 = lam * self.config.l1_ratio
        sq = torch.sum(table * table, dim=-1)
        ab = torch.sum(torch.abs(table), dim=-1)
        return torch.sum(0.5 * l2 * sq + l1 * ab)



def _regroup_lanes(eidx: np.ndarray, assignment, n_shards: int):
    """Lanes of one bucket regrouped by owner shard (JAX
    ``coordinates.py:889-960``): shard p's lanes contiguous, padded to the
    largest shard's count ``l_b``; sentinel lanes (entity index at or past
    ``num_entities``) balance onto shard 0's padding. Returns (order,
    lane_of, l_b, new_stored): the old lanes ``order`` go to the new lanes
    ``lane_of``; ``new_stored`` is each new lane's stored table row
    (``padded_rows`` = sentinel)."""
    e_global = assignment.num_entities
    eidx = np.asarray(eidx, np.int64)
    g2s = assignment.global_to_stored
    stored = np.where(eidx < e_global, g2s[np.minimum(eidx, e_global)], assignment.padded_rows)
    owner = assignment.shard_of_stored(np.minimum(stored, assignment.padded_rows - 1))
    owner = np.where(stored < assignment.padded_rows, owner, 0)
    counts = np.bincount(owner, minlength=n_shards)
    l_b = max(int(counts.max()), 1)
    order = np.argsort(owner, kind="stable")
    starts = np.concatenate([[0], np.cumsum(counts)])[:-1]
    slot = np.arange(eidx.size) - starts[owner[order]]
    lane_of = owner[order] * l_b + slot
    new_stored = np.full(n_shards * l_b, assignment.padded_rows, np.int64)
    new_stored[lane_of] = stored[order]
    return order, lane_of, l_b, new_stored


class EntityShardedRandomEffectCoordinate:
    """The random effect over a world of ranks, each holding its entities
    (``photon_ml_tpu/game/coordinates.py:790``). Rank p (``mesh.flat_index()``)
    keeps:

    - its block of the table, rows ``[p * B, (p + 1) * B)`` of the stored
      (shard-major, padded) layout of ``assignment`` — the coordinate's
      params are this block, ``(B, d)``;
    - its rows, block p of the entity-partitioned row order of
      ``partition`` (every entity's rows on its owner);
    - per bucket, shard p's lanes of the lanes regrouped by owner, with
      table and offset indices local to the block (sentinel lanes masked,
      their solutions dropped), and its block of the per-entity
      ``reg_weights``, stored shard-major.

    An update solves the rank's lanes (``solvers/batched.py``) and rescores
    its rows: it issues no collective. Its penalty (:meth:`reg_term`) is the
    rank's partial; ``sharded_params`` tells the descent to sum it over the
    ranks with the loss. :meth:`stored_table` gathers the blocks (a
    collective) and :meth:`global_table` puts them in global entity order.
    The grid surface (``fused_state_for_reg`` / ``with_fused_state``) is
    :class:`RandomEffectCoordinate`'s."""

    sharded_params = True

    def __init__(
        self,
        design,  # BucketedRandomEffectDesign on the PERMUTED rows, GLOBAL ids
        row_features,  # (n_pad, d) permuted
        row_entities,  # (n_pad,) permuted GLOBAL ids, -1 unknown
        full_offsets_base,  # (n_pad,) permuted
        config: CoordinateConfig,
        mesh,
        assignment,  # game.data.EntityShardAssignment
        partition,  # game.data.EntityRowPartition
        reg_weights=None,  # (E,) GLOBAL order
        device=None,
    ):
        if config.random_effect is None:
            raise ValueError("config lacks random_effect; wrong coordinate")
        if isinstance(design, RandomEffectDesign):
            design = BucketedRandomEffectDesign(
                buckets=[design],
                entity_index=[np.arange(design.num_entities, dtype=np.int32)],
                num_entities=design.num_entities,
            )
        n_shards = mesh.size
        if assignment.num_shards != n_shards:
            raise ValueError(f"assignment built for {assignment.num_shards} shards, mesh "
                             f"'{ENTITY_AXIS}' axis has {n_shards}")
        if partition.num_shards != n_shards:
            raise ValueError(f"row partition built for {partition.num_shards} shards, mesh "
                             f"'{ENTITY_AXIS}' axis has {n_shards}")
        if design.num_entities != assignment.num_entities:
            raise ValueError(f"design covers {design.num_entities} entities, assignment "
                             f"{assignment.num_entities}")
        n_pad = partition.padded_rows
        if int(np.shape(row_entities)[0]) != n_pad:
            raise ValueError(f"row arrays must be in the partitioned row space ({n_pad} rows), "
                             f"got {np.shape(row_entities)[0]}")
        p = mesh.flat_index()
        b_rows, r_rows = assignment.rows_per_shard, partition.rows_per_shard
        buckets, locals_, valid, lane_entities = [], [], [], []
        for bucket, eidx in zip(design.buckets, design.entity_index):
            order, lane_of, l_b, new_stored = _regroup_lanes(eidx, assignment, n_shards)
            mine = slice(p * l_b, (p + 1) * l_b)
            stored = new_stored[mine]
            real = stored < assignment.padded_rows
            locals_.append(np.where(real, stored - p * b_rows, b_rows))
            valid.append(real)
            glob = np.full(l_b, assignment.num_entities, np.int64)
            glob[real] = assignment.stored_to_global[stored[real]]
            lane_entities.append(glob)
            # the old lanes that land in this rank's slice, in lane order
            pick = (lane_of >= p * l_b) & (lane_of < (p + 1) * l_b)
            src = torch.as_tensor(order[pick])
            dst = torch.as_tensor(lane_of[pick] - p * l_b)

            def regroup(x, fill=0.0):
                x = torch.as_tensor(x).cpu()
                out = torch.full((l_b,) + tuple(x.shape[1:]), fill, dtype=x.dtype)
                out[dst] = x[src]
                return out

            ri = regroup(bucket.row_index, fill=-1).long()
            ri = torch.where(ri >= 0, ri - p * r_rows, torch.full_like(ri, -1))
            buckets.append(RandomEffectDesign(
                features=regroup(bucket.features), labels=regroup(bucket.labels),
                weights=regroup(bucket.weights), mask=regroup(bucket.mask),
                row_index=ri.to(torch.int32)))
        re_ids = np.asarray(torch.as_tensor(row_entities).cpu(), np.int64)[p * r_rows:(p + 1) * r_rows]
        known = re_ids >= 0
        ents_local = np.full(re_ids.shape, -1, np.int64)
        ents_local[known] = assignment.global_to_stored[re_ids[known]] - p * b_rows
        rows = slice(p * r_rows, (p + 1) * r_rows)
        self._setup(config, mesh, assignment, buckets, locals_, valid, lane_entities,
                    torch.as_tensor(row_features)[rows], ents_local,
                    torch.as_tensor(full_offsets_base)[rows], reg_weights, device)

    @classmethod
    def from_local(cls, design, row_features, row_entities, full_offsets_base,
                   config: CoordinateConfig, mesh, assignment, reg_weights=None, device=None):
        """The coordinate from this rank's own rows (the multi-process
        branch, where each rank ingests its own part files and owns the
        entities of its rows): ``design`` built on the rank's rows with
        GLOBAL entity indices (``parallel.multihost.make_global_re_design``),
        ``row_entities`` the rows' global indices (-1 unknown), every entity
        of them in this rank's block of ``assignment``."""
        if config.random_effect is None:
            raise ValueError("config lacks random_effect; wrong coordinate")
        e_global = assignment.num_entities
        b_rows = assignment.rows_per_shard
        base = mesh.flat_index() * b_rows

        def local_rows(g):
            g = np.asarray(g, np.int64)
            real = (g >= 0) & (g < e_global)
            loc = np.full(g.shape, -1, np.int64)
            loc[real] = assignment.global_to_stored[g[real]] - base
            if ((loc[real] < 0) | (loc[real] >= b_rows)).any():
                raise ValueError("an entity of this rank's rows is owned by another rank: "
                                 "the input splits must be entity-partitioned")
            return loc, real

        locals_, valid, lane_entities = [], [], []
        for eidx in design.entity_index:
            loc, real = local_rows(eidx)
            locals_.append(np.where(real, loc, b_rows))
            valid.append(real)
            lane_entities.append(np.where(real, np.asarray(eidx, np.int64), e_global))
        ents_local, _ = local_rows(np.asarray(torch.as_tensor(row_entities).cpu()))
        c = cls.__new__(cls)
        c._setup(config, mesh, assignment, [b.to("cpu") for b in design.buckets], locals_,
                 valid, lane_entities, torch.as_tensor(row_features), ents_local,
                 torch.as_tensor(full_offsets_base), reg_weights, device)
        return c

    def _setup(self, config, mesh, assignment, buckets, locals_, valid, lane_entities,
               row_features, ents_local, offsets, reg_weights, device):
        device = row_features.device if device is None else torch.device(device)
        self.config = config
        self.mesh = mesh
        self.assignment = assignment
        self.design = BucketedRandomEffectDesign(
            buckets=[b.to(device) for b in buckets],
            entity_index=[np.asarray(g, np.int64) for g in lane_entities],
            num_entities=assignment.num_entities)
        b_rows = assignment.rows_per_shard
        lo = mesh.flat_index() * b_rows
        # per-entity reg weights, stored shard-major, float32 as in the JAX
        # package (pad rows keep the config weight: their solutions drop)
        self._uniform_reg = reg_weights is None
        if reg_weights is None:
            reg_block = np.full((b_rows,), config.reg_weight, np.float32)
        else:
            reg_weights = np.asarray(reg_weights, np.float32)
            if reg_weights.shape != (assignment.num_entities,):
                raise ValueError(f"reg_weights must be ({assignment.num_entities},), got "
                                 f"{reg_weights.shape}")
            reg_block = assignment.table_from_global(reg_weights)[lo:lo + b_rows]
        self.reg_weights = torch.as_tensor(reg_block, device=device)
        self._valid_lanes = [np.asarray(v, bool) for v in valid]
        self._lanes: List[Tuple[torch.Tensor, Optional[torch.Tensor]]] = []
        for loc, v in zip(locals_, self._valid_lanes):
            rows = torch.as_tensor(np.asarray(loc, np.int64), device=device)
            real = None if v.all() else torch.as_tensor(np.flatnonzero(v), device=device)
            self._lanes.append((rows.clamp(max=b_rows - 1), real))
        self.row_features = row_features.to(device)
        self.row_entities_local = torch.as_tensor(ents_local, dtype=torch.int64, device=device)
        self.full_offsets_base = offsets.to(device)
        self._solve = _make_batched_solve(config)

    @property
    def num_entities(self) -> int:
        return self.assignment.num_entities

    @property
    def dim(self) -> int:
        return self.design.dim

    def initial_params(self) -> torch.Tensor:
        """Zeros for this rank's block of the stored table."""
        feats = self.design.buckets[0].features
        return torch.zeros((self.assignment.rows_per_shard, self.dim),
                           dtype=torch.promote_types(feats.dtype, torch.float32),
                           device=feats.device)

    def local_params(self, stored_table) -> torch.Tensor:
        """This rank's block of a stored (shard-major, padded) table — a
        checkpoint's or a warm start's — in the block's dtype and device; a
        table already of the block's shape is taken as the block."""
        want = self.initial_params()
        t = torch.as_tensor(np.asarray(stored_table) if not torch.is_tensor(stored_table)
                            else stored_table)
        if t.shape[0] != want.shape[0]:
            t = entity_block(t, self.mesh)
        return t.to(want)

    def stored_table(self, table: torch.Tensor) -> torch.Tensor:
        """Every rank's block gathered into the stored table (a collective
        over the mesh)."""
        from photon_ml_tpu_torch.parallel.multihost import reshard_replicated

        axis = self.mesh.axis_names[0] if len(self.mesh.axis_names) == 1 else ENTITY_AXIS
        return reshard_replicated(table, self.mesh, axis)

    def stored_table_host(self, table: torch.Tensor) -> np.ndarray:
        """:meth:`stored_table` on the host, gathered in pieces of at most
        one block on the card (a collective over the mesh): what a
        checkpoint and the pass boundary's host copy read."""
        from photon_ml_tpu_torch.parallel.multihost import gather_rows_to_host

        axis = self.mesh.axis_names[0] if len(self.mesh.axis_names) == 1 else ENTITY_AXIS
        return gather_rows_to_host(table, self.mesh, axis)

    def global_table(self, table: torch.Tensor) -> torch.Tensor:
        """The table in global entity order (``coordinates.py:1063``), the
        same on every rank."""
        return self.assignment.table_to_global(self.stored_table(table))

    def update(self, table, partial_scores, generator=None):
        table, summary, _ = self.update_and_score(table, partial_scores, generator)
        return table, summary

    def update_and_score(self, table: torch.Tensor, partial_scores: torch.Tensor,
                         generator=None):
        """This rank's lanes solved from its block, scattered back into it,
        and its rows rescored: no collective."""
        full_offsets = self.full_offsets_base + partial_scores
        trackers = []
        for (rows, real), bucket in zip(self._lanes, self.design.buckets):
            offsets = bucket.gather_offsets(full_offsets)
            result: BatchedSolverResult = self._solve(
                table[rows], self.reg_weights[rows], bucket, offsets)
            w = result.w
            if real is not None:
                rows, w = rows[real], w[real]
            table = table.index_copy(0, rows, w)
            trackers.append((result.reason, result.iterations, final_grad_norm(result),
                             result.cg_iterations))
        scores = _score_rows_by_entity(table, self.row_features, self.row_entities_local)
        return table, self.wrap_tracker(trackers), scores

    def wrap_tracker(self, trackers) -> RandomEffectUpdateSummary:
        return RandomEffectUpdateSummary(pending=[
            (reason, iters, gnorm, valid, ents, cg)
            for (reason, iters, gnorm, cg), valid, ents in zip(
                trackers, self._valid_lanes, self.design.entity_index)
        ], gathered=self.mesh.size > 1)

    def score(self, table: torch.Tensor) -> torch.Tensor:
        return _score_rows_by_entity(table, self.row_features, self.row_entities_local)

    def with_config(self, config: CoordinateConfig) -> "EntityShardedRandomEffectCoordinate":
        """A copy on another config (a grid combo's): the lanes, rows and
        card tensors are shared; uniform reg weights take the config's."""
        c = copy_module.copy(self)
        c.config = config
        if self._uniform_reg:
            c.reg_weights = torch.full_like(self.reg_weights, config.reg_weight)
        c._solve = _make_batched_solve(config)
        return c

    def fused_state_for_reg(self, reg_weight):
        """:meth:`RandomEffectCoordinate.fused_state_for_reg` on this rank's
        block (JAX ``coordinates.py:1103``)."""
        if not self._uniform_reg:
            raise ValueError(
                "grid sweeps replace the coordinate's shared reg weight; "
                "this RandomEffectCoordinate carries CUSTOM per-entity "
                "reg_weights — run its combos sequentially instead"
            )
        return (
            torch.full((self.assignment.rows_per_shard,), reg_weight, dtype=torch.float32,
                       device=self.row_features.device),
            self.full_offsets_base,
            tuple(self.design.buckets),
            self.row_features,
            self.row_entities_local,
        )

    def with_fused_state(self, state):
        c = copy_module.copy(self)
        (c.reg_weights, c.full_offsets_base, buckets, c.row_features,
         c.row_entities_local) = state
        c.design = dataclasses.replace(self.design, buckets=list(buckets))
        return c

    def reg_term(self, table: torch.Tensor) -> torch.Tensor:
        """This rank's partial of the per-entity penalty (pad rows are zero,
        so their weight is inert)."""
        lam = self.reg_weights.to(table.dtype)
        l2 = lam * (1.0 - self.config.l1_ratio)
        l1 = lam * self.config.l1_ratio
        sq = torch.sum(table * table, dim=-1)
        ab = torch.sum(torch.abs(table), dim=-1)
        return torch.sum(0.5 * l2 * sq + l1 * ab)
