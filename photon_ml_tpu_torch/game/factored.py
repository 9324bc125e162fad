"""Factored random effects and matrix-factorization scoring (counterpart of
``photon_ml_tpu/game/factored.py``; the reference's
``algorithm/FactoredRandomEffectCoordinate.scala:37-267``): when entities
are too many or their data too thin for full per-entity coefficient
vectors, the random effect factors as w_e = B gamma_e, with a shared
projection B (d x k) and per-entity latent coefficients gamma_e (k,).
Training alternates (``num_inner_iterations`` times):

  (a) project the active design through the current B and solve the
      per-entity latent GLMs (one batched solve per bucket in k dims,
      :mod:`photon_ml_tpu_torch.solvers.batched`);
  (b) re-fit B as ONE GLM whose virtual features are the Kronecker
      products x (x) gamma_e (``kroneckerProductFeaturesAndCoefficients``
      :251-266), never materialized: margins, gradient and Hessian-vector
      products contract X, gamma and B by ``torch.einsum``, bucket by
      bucket in the JAX package's order, through the port's unbatched
      TRON, L-BFGS or OWL-QN.

The einsums are plain tensor products on the card, as the JAX package
computes them outside any Pallas kernel. ``MatrixFactorizationModel``
(``model/MatrixFactorizationModel.scala:30-134``) is the inference-side
pairing: two latent tables scored by a gathered dot product.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from photon_ml_tpu_torch.game.coordinates import (
    CoordinateConfig,
    EntityShardedRandomEffectCoordinate,
    _make_batched_solve,
    final_grad_norm,
)
from photon_ml_tpu_torch.game.data import BucketedRandomEffectDesign, RandomEffectDesign
from photon_ml_tpu_torch.models.training import OptimizerType
from photon_ml_tpu_torch.ops.losses import loss_for_task
from photon_ml_tpu_torch.solvers import minimize_lbfgs, minimize_owlqn, minimize_tron


@dataclasses.dataclass(frozen=True)
class FactoredParams:
    """(per-entity latent table, shared projection)."""

    gamma: torch.Tensor  # (E, k)
    projection: torch.Tensor  # (d, k)


def is_factored_params(x) -> bool:
    """THE predicate for factored parameter containers: persistence,
    checkpoints and scoring dispatch on it."""
    return isinstance(x, FactoredParams)


@dataclasses.dataclass(frozen=True)
class FactoredConfig:
    """``MFOptimizationConfiguration.scala:24-46`` ("numInnerIter,latentDim")
    plus the two sub-configs (random-effect and latent-matrix)."""

    latent_dim: int
    num_inner_iterations: int = 1
    random_effect_config: Optional[CoordinateConfig] = None
    latent_factor_config: Optional[CoordinateConfig] = None

    def __post_init__(self):
        if self.latent_dim < 1:
            raise ValueError(f"latent_dim must be >= 1, got {self.latent_dim}")
        if self.num_inner_iterations < 1:
            raise ValueError(
                f"num_inner_iterations must be >= 1, got {self.num_inner_iterations}"
            )


def _make_latent_solve(config: CoordinateConfig, reduce=None):
    """``solve(B0, gammas, bucket_offsets, buckets) -> SolverResult`` for
    the shared projection B. The objective treats vec(B) as the
    coefficient vector of a GLM on the virtual Kronecker features
    x (x) gamma, contracted lazily:

      margin_er = einsum('erd,dk->erk', X_b, B) . gamma_b + offsets
      grad_dk   = einsum('erd,erk->dk', X_b, c gamma_b) + lambda B
      (Hv)_dk   = the same contraction with c2 * dmargin(V)

    ``reduce(tensor, label)`` (a world): the buckets' data terms are this
    rank's partials, summed over the ranks by it (the value with the
    gradient in one reduction, each Hessian-vector product in another)
    before the penalty is added once; every rank then takes the same
    solver steps on the same B."""
    loss = loss_for_task(config.task)
    scfg = config.solver_config()
    use_tron = config.optimizer == OptimizerType.TRON
    lam = config.reg_weight * (1.0 - config.l1_ratio)
    l1 = config.reg_weight * config.l1_ratio

    def solve(b0, gammas, bucket_offsets, buckets):
        d, k = b0.shape

        def margins(B, bucket, gamma_b, offsets):
            xb = torch.einsum("erd,dk->erk", bucket.features, B)
            return torch.einsum("erk,ek->er", xb, gamma_b) + offsets

        def data_value_and_grad(B, val, grad):
            for bucket, gamma_b, offsets in zip(buckets, gammas, bucket_offsets):
                w = bucket.weights * bucket.mask
                z = margins(B, bucket, gamma_b, offsets)
                val = val + torch.sum(w * loss.value(z, bucket.labels))
                cg = torch.einsum("er,ek->erk", w * loss.d1(z, bucket.labels), gamma_b)
                grad = grad + torch.einsum("erd,erk->dk", bucket.features, cg)
            return val, grad

        def data_hvp(B, V, out):
            for bucket, gamma_b, offsets in zip(buckets, gammas, bucket_offsets):
                w = bucket.weights * bucket.mask
                z = margins(B, bucket, gamma_b, offsets)
                dz = margins(V, bucket, gamma_b, torch.zeros_like(offsets))
                c2 = w * loss.d2(z, bucket.labels) * dz
                cg = torch.einsum("er,ek->erk", c2, gamma_b)
                out = out + torch.einsum("erd,erk->dk", bucket.features, cg)
            return out

        def value_and_grad(vec_b):
            B = vec_b.reshape(d, k)
            if reduce is None:
                val, grad = data_value_and_grad(B, 0.5 * lam * torch.sum(B * B), lam * B)
                return val, grad.reshape(-1)
            val, grad = data_value_and_grad(B, B.new_zeros(()), torch.zeros_like(B))
            both = reduce(torch.cat([val.reshape(1), grad.reshape(-1)]), "value_grad")
            return 0.5 * lam * torch.sum(B * B) + both[0], (lam * B).reshape(-1) + both[1:]

        def hvp(vec_b, vec_v):
            B = vec_b.reshape(d, k)
            V = vec_v.reshape(d, k)
            if reduce is None:
                return data_hvp(B, V, lam * V).reshape(-1)
            return (lam * V).reshape(-1) + reduce(data_hvp(B, V, torch.zeros_like(V)).reshape(-1),
                                                  "hvp")

        if config.l1_ratio > 0.0:
            return minimize_owlqn(value_and_grad, b0.reshape(-1), l1, scfg)
        if use_tron:
            return minimize_tron(value_and_grad, hvp, b0.reshape(-1), scfg)
        return minimize_lbfgs(value_and_grad, b0.reshape(-1), scfg)

    return solve


def _score_factored_rows(params: FactoredParams, feats: torch.Tensor,
                         ents: torch.Tensor) -> torch.Tensor:
    latent = feats @ params.projection  # (n, k)
    per_row = torch.einsum("nk,nk->n", latent, params.gamma[ents.clamp(min=0)])
    return torch.where(ents >= 0, per_row, torch.zeros_like(per_row))


class FactoredRandomEffectCoordinate:
    """A coordinate over FactoredParams: ``update_and_score(params,
    partial_scores, generator)`` / ``score(params)``. Takes a
    :class:`RandomEffectDesign` (one bucket whose lanes ARE the table rows)
    or a :class:`BucketedRandomEffectDesign` on the coordinate's device."""

    def __init__(
        self,
        design,  # RandomEffectDesign | BucketedRandomEffectDesign
        row_features: torch.Tensor,
        row_entities: torch.Tensor,
        full_offsets_base: torch.Tensor,
        re_config: CoordinateConfig,
        factored: FactoredConfig,
        seed: int = 0,
    ):
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
        self.config = re_config
        self.factored = factored
        self._seed = seed
        self._latent_cfg = factored.latent_factor_config or re_config
        self._re_solve = _make_batched_solve(dataclasses.replace(re_config, random_effect=None))
        self._latent_solve = _make_latent_solve(
            dataclasses.replace(self._latent_cfg, random_effect=None))
        e = design.num_entities
        device = row_features.device
        # per bucket: the lanes' gamma rows (sentinels clamped for the
        # gathers) and the real lanes, whose solutions are written back
        self._lanes = []
        for ei in design.entity_index:
            ei = np.asarray(ei, np.int64)
            rows = torch.as_tensor(ei, device=device)
            real = None if (ei < e).all() else torch.as_tensor(np.flatnonzero(ei < e),
                                                                 device=device)
            self._lanes.append((rows.clamp(max=e - 1), real))

    @property
    def num_entities(self) -> int:
        return self.design.num_entities

    @property
    def dim(self) -> int:
        """The original feature dimension of the underlying design."""
        return self.design.dim

    def initial_params(self) -> FactoredParams:
        """gamma zeros; B Gaussian N(0, 1/d) from numpy ``default_rng(seed)``
        as in the JAX package (the reference's random projection init)."""
        d = self.design.dim
        k = self.factored.latent_dim
        rng = np.random.default_rng(self._seed)
        b = rng.normal(0.0, 1.0 / np.sqrt(d), size=(d, k))
        feats = self.design.buckets[0].features
        dtype = torch.promote_types(feats.dtype, torch.float32)
        return FactoredParams(
            gamma=torch.zeros((self.num_entities, k), dtype=dtype, device=feats.device),
            projection=torch.as_tensor(b, dtype=dtype, device=feats.device),
        )

    def update_and_score(self, params: FactoredParams, partial_scores: torch.Tensor,
                         generator=None) -> Tuple[FactoredParams, object, torch.Tensor]:
        """The alternating gamma / B loop, then the full-row rescore. The
        update's result is the last bucket's batched solve, as in the JAX
        package."""
        design = self.design
        full_offsets = self.full_offsets_base + partial_scores
        bucket_offsets = [b.gather_offsets(full_offsets) for b in design.buckets]
        gamma, b = params.gamma, params.projection
        lam_re = torch.full((design.num_entities,), self.config.reg_weight,
                            dtype=gamma.dtype, device=gamma.device)
        result = None
        for _ in range(self.factored.num_inner_iterations):
            # (a) latent-space per-entity solves, bucket by bucket
            for (rows, real), bucket, offsets in zip(self._lanes, design.buckets,
                                                     bucket_offsets):
                latent = dataclasses.replace(
                    bucket, features=torch.einsum("erd,dk->erk", bucket.features, b))
                result = self._re_solve(gamma[rows], lam_re[rows], latent, offsets)
                w, lanes = result.w, rows
                if real is not None:
                    lanes, w = rows[real], w[real]
                gamma = gamma.index_copy(0, lanes, w)
            # (b) the shared projection over ALL buckets
            gammas = [gamma[rows] for rows, _ in self._lanes]
            latent_result = self._latent_solve(b, gammas, bucket_offsets, design.buckets)
            b = latent_result.w.reshape(b.shape)
        params = FactoredParams(gamma=gamma, projection=b)
        return params, result, self.score(params)

    def score(self, params: FactoredParams) -> torch.Tensor:
        return _score_factored_rows(params, self.row_features, self.row_entities)

    def reg_term(self, params: FactoredParams) -> torch.Tensor:
        """gamma is penalized under the random-effect config, B under the
        latent-factor config: what the two inner solves minimize."""
        from photon_ml_tpu_torch.game.descent import _config_reg_term

        return (_config_reg_term(self.config, params.gamma)
                + _config_reg_term(self._latent_cfg, params.projection))

    def to_full_table(self, params: FactoredParams) -> torch.Tensor:
        """w_e = B gamma_e materialized: (E, d)
        (``RandomEffectModelInProjectedSpace.toRandomEffectModel``)."""
        return params.gamma @ params.projection.T


class EntityShardedFactoredRandomEffectCoordinate:
    """The factored random effect over a world of ranks, each holding its
    entities (the multi-process GAME branch; the JAX package replicates a
    global gamma there, ``photon_ml_tpu/cli/game_train.py:91-96,338-372``).
    Rank p keeps the gamma rows of its entity block, with the lanes, rows
    and layout of ``block`` (an :class:`EntityShardedRandomEffectCoordinate`
    built the same way, whose table the gamma block replaces), and a copy of
    the shared projection B:

    - each entity's latent solve is local (step (a) on the rank's lanes);
    - B's solve (step (b)) sums its value, gradient and Hessian-vector
      products over the ranks through the counted ``parallel.mesh``
      all-reduce (``value_grad`` and ``hvp``), so every rank takes the same
      steps to the same B;
    - :meth:`reg_term` is this rank's partial: its gamma rows' penalty, and
      B's penalty on rank 0 alone, so that the descent's sum over the ranks
      counts it once (``sharded_params``).

    The params are ``FactoredParams(gamma=(B_rows, k) block, projection)``;
    :meth:`stored_table_host` and :meth:`global_table` gather the gamma
    blocks (a collective)."""

    sharded_params = True

    def __init__(self, block: EntityShardedRandomEffectCoordinate, re_config: CoordinateConfig,
                 factored: FactoredConfig, seed: int = 0):
        from photon_ml_tpu_torch.parallel.mesh import ENTITY_AXIS, all_reduce

        self.block = block
        self.mesh = block.mesh
        self.assignment = block.assignment
        self.design = block.design
        self.config = re_config
        self.factored = factored
        self._seed = seed
        self._latent_cfg = factored.latent_factor_config or re_config
        axis = self.mesh.axis_names[0] if len(self.mesh.axis_names) == 1 else ENTITY_AXIS
        self._re_solve = _make_batched_solve(dataclasses.replace(re_config, random_effect=None))
        self._latent_solve = _make_latent_solve(
            dataclasses.replace(self._latent_cfg, random_effect=None),
            reduce=lambda t, label: all_reduce(t, axis, label, mesh=self.mesh))

    def initial_params(self) -> FactoredParams:
        """gamma zeros for this rank's block; B as
        :meth:`FactoredRandomEffectCoordinate.initial_params` draws it (the
        same on every rank)."""
        d, k = self.design.dim, self.factored.latent_dim
        rng = np.random.default_rng(self._seed)
        b = rng.normal(0.0, 1.0 / np.sqrt(d), size=(d, k))
        feats = self.design.buckets[0].features
        dtype = torch.promote_types(feats.dtype, torch.float32)
        return FactoredParams(
            gamma=torch.zeros((self.assignment.rows_per_shard, k), dtype=dtype,
                              device=feats.device),
            projection=torch.as_tensor(b, dtype=dtype, device=feats.device),
        )

    def local_params(self, stored) -> FactoredParams:
        """This rank's gamma block of a stored (shard-major) FactoredParams,
        a checkpoint's or a warm start's."""
        want = self.initial_params()
        gamma = self.block.local_params(stored.gamma).to(want.gamma)
        projection = stored.projection
        projection = (projection if torch.is_tensor(projection)
                      else torch.from_numpy(np.array(projection))).to(want.projection)
        return FactoredParams(gamma=gamma, projection=projection)

    def stored_table_host(self, params: FactoredParams) -> FactoredParams:
        from photon_ml_tpu_torch.utils.device import to_numpy

        return FactoredParams(gamma=self.block.stored_table_host(params.gamma),
                              projection=to_numpy(params.projection))

    def global_table(self, params: FactoredParams) -> FactoredParams:
        """gamma in global entity order (a collective), the same on every
        rank, with B."""
        return FactoredParams(gamma=self.block.global_table(params.gamma),
                              projection=params.projection)

    def update_and_score(self, params: FactoredParams, partial_scores: torch.Tensor,
                         generator=None):
        """The alternating gamma / B loop on this rank's block and rows,
        then its rows rescored. The update's result is the last bucket's
        per-entity solve, joined over the ranks at its first read."""
        block = self.block
        full_offsets = block.full_offsets_base + partial_scores
        buckets = block.design.buckets
        bucket_offsets = [b.gather_offsets(full_offsets) for b in buckets]
        gamma, b = params.gamma, params.projection
        lam_re = torch.full((self.assignment.rows_per_shard,), self.config.reg_weight,
                            dtype=gamma.dtype, device=gamma.device)
        trackers = []
        for _ in range(self.factored.num_inner_iterations):
            trackers = []
            for (rows, real), bucket, offsets in zip(block._lanes, buckets, bucket_offsets):
                latent = dataclasses.replace(
                    bucket, features=torch.einsum("erd,dk->erk", bucket.features, b))
                result = self._re_solve(gamma[rows], lam_re[rows], latent, offsets)
                w, lanes = result.w, rows
                if real is not None:
                    lanes, w = rows[real], w[real]
                gamma = gamma.index_copy(0, lanes, w)
                trackers.append((result.reason, result.iterations, final_grad_norm(result),
                                 result.cg_iterations))
            gammas = [gamma[rows] for rows, _ in block._lanes]
            latent_result = self._latent_solve(b, gammas, bucket_offsets, buckets)
            b = latent_result.w.reshape(b.shape)
        params = FactoredParams(gamma=gamma, projection=b)
        summary = block.wrap_tracker(trackers)
        summary.pending = summary.pending[-1:]
        return params, summary, self.score(params)

    def score(self, params: FactoredParams) -> torch.Tensor:
        return _score_factored_rows(params, self.block.row_features,
                                    self.block.row_entities_local)

    def reg_term(self, params: FactoredParams) -> torch.Tensor:
        """This rank's partial: its gamma rows under the random-effect
        config, plus B under the latent-factor config on rank 0 only."""
        from photon_ml_tpu_torch.game.descent import _config_reg_term

        part = _config_reg_term(self.config, params.gamma)
        if self.mesh.flat_index() == 0:
            part = part + _config_reg_term(self._latent_cfg, params.projection)
        return part


class MatrixFactorizationModel:
    """Two latent tables; score(row, col) = rowFactors[row] . colFactors[col],
    a missing side (-1) scoring 0 (``MatrixFactorizationModel.scala``)."""

    def __init__(self, row_factors: torch.Tensor, col_factors: torch.Tensor):
        if row_factors.shape[1] != col_factors.shape[1]:
            raise ValueError("row/col latent dims differ")
        self.row_factors = row_factors
        self.col_factors = col_factors

    @property
    def latent_dim(self) -> int:
        return self.row_factors.shape[1]

    def score(self, row_ids: torch.Tensor, col_ids: torch.Tensor) -> torch.Tensor:
        rows = torch.as_tensor(row_ids, device=self.row_factors.device).long()
        cols = torch.as_tensor(col_ids, device=self.col_factors.device).long()
        s = torch.einsum("nk,nk->n", self.row_factors[rows.clamp(min=0)],
                         self.col_factors[cols.clamp(min=0)])
        return torch.where((rows >= 0) & (cols >= 0), s, torch.zeros_like(s))

    @staticmethod
    def random(num_rows: int, num_cols: int, latent_dim: int, seed: int = 0,
               dtype: torch.dtype = torch.float32, device="cpu") -> "MatrixFactorizationModel":
        rng = np.random.default_rng(seed)
        return MatrixFactorizationModel(
            torch.as_tensor(rng.normal(size=(num_rows, latent_dim)), dtype=dtype, device=device),
            torch.as_tensor(rng.normal(size=(num_cols, latent_dim)), dtype=dtype, device=device),
        )
