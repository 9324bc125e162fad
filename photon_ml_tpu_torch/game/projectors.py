"""Per-entity dimensionality reduction (counterpart of
``photon_ml_tpu/game/projectors.py``; the reference's ``projector/``).

Three projector types (``projector/ProjectorType.scala:20-30``):

  IDENTITY   — no-op.
  RANDOM=k   — a shared Gaussian projection matrix, N(0, 1/k) for projected
               dimension k, with an optional intercept passthrough column
               (``projector/ProjectionMatrix.scala:96-126``). The matrix is
               drawn with numpy ``default_rng(seed)``, as in the JAX
               package, so both packages project with the same bits.
  INDEX_MAP  — per-entity compaction onto the union of feature indices
               active in that entity's data
               (``projector/IndexMapProjector.scala:44``,
               ``projector/IndexMapProjectorRDD.scala:113-120``).

A projection is a matrix product (RANDOM) or a gather (INDEX_MAP) applied
to the padded (entities, rows, dim) design once at build time;
coefficients go back to the original space by the transpose operation
(``model/RandomEffectModelInProjectedSpace.scala:31-97``). Plain tensor
operations: the JAX package computes them outside any Pallas kernel.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from photon_ml_tpu_torch.game.data import RandomEffectDesign
from photon_ml_tpu_torch.utils.device import to_numpy


@dataclasses.dataclass(frozen=True)
class RandomProjection:
    """A shared Gaussian projection (``ProjectionMatrix.scala:33-127``).

    matrix: (d, k) with entries N(0, 1/k); with an intercept index, that
    original dimension maps to a dedicated passthrough output column."""

    matrix: torch.Tensor  # (d, k)

    @property
    def projected_dim(self) -> int:
        return self.matrix.shape[1]

    def project_features(self, features: torch.Tensor) -> torch.Tensor:
        """(..., d) -> (..., k)."""
        return features @ self.matrix

    def project_coefficients_back(self, coef: torch.Tensor) -> torch.Tensor:
        """(..., k) -> (..., d): w_orig = P w_proj, so that
        x_orig . w_orig == (P^T x_orig) . w_proj."""
        return coef @ self.matrix.T


def build_random_projection(
    original_dim: int,
    projected_dim: int,
    seed: int = 0,
    intercept_index: Optional[int] = None,
    dtype: torch.dtype = torch.float32,
    device="cpu",
) -> RandomProjection:
    rng = np.random.default_rng(seed)
    k = projected_dim
    m = rng.normal(0.0, 1.0 / np.sqrt(k), size=(original_dim, k))
    if intercept_index is not None:
        # intercept passthrough: its own exclusive output column
        m = np.concatenate([m, np.zeros((original_dim, 1))], axis=1)
        m[intercept_index, :] = 0.0
        m[intercept_index, -1] = 1.0
    return RandomProjection(matrix=torch.as_tensor(m, dtype=dtype, device=device))


def _gather_columns(features: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """features (..., d) at each row's columns ``cols`` (..., k), -1
    columns reading 0."""
    gathered = torch.gather(features, -1, cols.clamp(min=0).long())
    return torch.where(cols >= 0, gathered, torch.zeros_like(gathered))


@dataclasses.dataclass(frozen=True)
class IndexMapProjection:
    """Per-entity feature-index compaction.

    columns: (E, k) int — for each entity, the original feature indices
    kept (padded with -1); k = the largest active-feature count."""

    columns: torch.Tensor

    @property
    def projected_dim(self) -> int:
        return self.columns.shape[1]

    def project_design(self, design: RandomEffectDesign) -> RandomEffectDesign:
        """(E, R, d) -> (E, R, k) by a per-entity column gather."""
        e, r, _ = design.features.shape
        cols = self.columns[:, None, :].expand(e, r, self.projected_dim)
        return dataclasses.replace(design, features=_gather_columns(design.features, cols))

    def project_coefficients_back(self, table: torch.Tensor, original_dim: int) -> torch.Tensor:
        """(E, k) -> (E, d): scatter back to the original indices."""
        vals = torch.where(self.columns >= 0, table, torch.zeros_like(table))
        out = torch.zeros((table.shape[0], original_dim), dtype=table.dtype,
                          device=table.device)
        return out.scatter_add_(1, self.columns.clamp(min=0).long(), vals)

    def project_row_features(self, features: torch.Tensor,
                             entities: torch.Tensor) -> torch.Tensor:
        """(n, d) rows -> (n, k) in each row's OWN entity's projected space
        (entity -1 rows give zeros; they score 0 anyway)."""
        cols = self.columns[entities.clamp(min=0).long()]
        gathered = _gather_columns(features, cols)
        keep = (entities >= 0)[:, None]
        return torch.where(keep, gathered, torch.zeros_like(gathered))


def columns_from_active_pairs(
    ent: np.ndarray, col: np.ndarray, d: int, num_entities: int
) -> np.ndarray:
    """(entity, feature) occurrence pairs -> the (num_entities, k)
    per-entity sorted active-column table padded with -1, k the largest
    active-column count. O(nnz): the shared kernel of both INDEX_MAP
    builders."""
    pairs = np.unique(ent.astype(np.int64) * d + col.astype(np.int64))
    pair_ent = pairs // d
    pair_col = pairs % d
    _, starts, counts = np.unique(pair_ent, return_index=True, return_counts=True)
    k = max(int(counts.max()) if counts.size else 1, 1)
    cols = np.full((num_entities, k), -1, np.int64)
    slot = np.arange(pairs.size) - np.repeat(starts, counts)
    cols[pair_ent, slot] = pair_col
    return cols


def build_index_map_projection(design: RandomEffectDesign) -> IndexMapProjection:
    """Union of active feature indices per entity
    (``IndexMapProjectorRDD.scala:113-120``): a feature is kept for an
    entity iff it is nonzero in any of that entity's active rows. The
    design-tensor variant of ``projected.build_index_map_columns``; both
    share :func:`columns_from_active_pairs`. Built on the host, placed on
    the design's device."""
    feats = to_numpy(design.features)
    mask = to_numpy(design.mask)
    e, _, d = feats.shape
    ent, row, col = np.nonzero(feats)
    keep = mask[ent, row] > 0
    cols = columns_from_active_pairs(ent[keep], col[keep], d, e)
    return IndexMapProjection(
        columns=torch.as_tensor(cols, dtype=torch.int64, device=design.features.device))
