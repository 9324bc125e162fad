"""Random-effect training in a projected space (counterpart of
``photon_ml_tpu/game/projected.py``; the reference's
``algorithm/RandomEffectCoordinateInProjectedSpace.scala:26-120`` and
``model/RandomEffectModelInProjectedSpace.scala:31-97``): the coordinate
solves every per-entity subproblem in a reduced k-dimensional space (the
shared Gaussian RANDOM projection or the per-entity INDEX_MAP compaction),
and the table goes back to the original feature space before validation
and persistence, so saved models never know a projection existed.

The projection is applied ONCE to the padded bucketed design at build time
(a matrix product or a per-entity gather), the port's
:class:`RandomEffectCoordinate` runs unchanged on the projected tensors,
and back-projection of the (E, k) table is one matrix product or scatter.
The INDEX_MAP columns and a wide sparse shard's projected rows are built
on the host once per run (numpy, in the JAX package's order, so duplicate
slots sum the same), then placed on the coordinate's device.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import numpy as np
import torch

from photon_ml_tpu_torch.game.coordinates import CoordinateConfig, RandomEffectCoordinate
from photon_ml_tpu_torch.game.data import (
    BucketedRandomEffectDesign,
    GameData,
    RandomEffectDesign,
    build_bucketed_random_effect_design,
)
from photon_ml_tpu_torch.game.projectors import (
    IndexMapProjection,
    RandomProjection,
    _gather_columns,
    columns_from_active_pairs,
)
from photon_ml_tpu_torch.ops.sparse import is_sparse
from photon_ml_tpu_torch.utils.device import to_numpy


def parse_projector_spec(spec: str) -> Tuple[str, Optional[int]]:
    """"IDENTITY" | "INDEX_MAP" | "RANDOM=<k>" -> (kind, k)
    (``projector/ProjectorType.scala:20-30``)."""
    s = spec.strip().upper()
    if s == "IDENTITY":
        return "IDENTITY", None
    if s == "INDEX_MAP":
        return "INDEX_MAP", None
    if s.startswith("RANDOM="):
        k = int(s.split("=", 1)[1])
        if k <= 0:
            raise ValueError(f"RANDOM projected dim must be positive: {spec}")
        return "RANDOM", k
    raise ValueError(
        f"unknown projector {spec!r}; expected IDENTITY, INDEX_MAP, or RANDOM=<k>"
    )


def build_index_map_columns(data: GameData, random_effect: str, shard: str,
                            num_entities: int, device="cpu") -> IndexMapProjection:
    """Per-entity union of ACTIVE feature indices over all of the entity's
    rows (``IndexMapProjectorRDD.scala:113-120``), indexed by global entity
    id. O(nnz) on the host: never a dense (E, d) presence matrix. Takes a
    dense or padded-ELL shard; the columns land on ``device``."""
    x = data.features[shard]
    eids = to_numpy(data.entity_ids[random_effect])
    if is_sparse(x):
        ind = to_numpy(x.indices)
        d = x.d
        keep = (ind < d) & (eids[:, None] >= 0)
        rows = np.broadcast_to(np.arange(ind.shape[0])[:, None], ind.shape)[keep]
        ent = eids[rows]
        feat_cols = ind[keep]
    else:
        x = to_numpy(x)
        d = x.shape[1]
        rows, feat_cols = np.nonzero(x)
        ent = eids[rows]
        known = ent >= 0
        ent, feat_cols = ent[known], feat_cols[known]
    cols = columns_from_active_pairs(ent, feat_cols, d, num_entities)
    return IndexMapProjection(columns=torch.as_tensor(cols, dtype=torch.int64, device=device))


def project_sparse_rows(sf, entities: np.ndarray, projection: IndexMapProjection,
                        dtype=np.float32) -> np.ndarray:
    """Padded-ELL rows projected into each row's OWN entity's compact
    column space: (n, nnz) ELL -> dense (n, k). Entries whose (entity,
    column) pair is outside the entity's active union are dropped (score
    0), the reference's projected-space scoring. On the host, once per
    run; duplicate slots sum through ``np.add.at`` in the JAX package's
    order."""
    if not is_sparse(sf):
        raise ValueError("project_sparse_rows takes a SparseFeatures shard")
    cols_np = to_numpy(projection.columns)
    e_count, k = cols_np.shape
    d = sf.d
    valid = cols_np >= 0
    ent_of = np.broadcast_to(np.arange(e_count)[:, None], cols_np.shape)[valid]
    slot_of = np.broadcast_to(np.arange(k)[None, :], cols_np.shape)[valid]
    pair = ent_of.astype(np.int64) * d + cols_np[valid]
    order = np.argsort(pair, kind="stable")
    pair = pair[order]
    slot_sorted = slot_of[order]

    ind = to_numpy(sf.indices)
    val = to_numpy(sf.values)
    n = ind.shape[0]
    ents = np.asarray(entities).astype(np.int64)
    entry_ok = (ind < d) & (ents[:, None] >= 0)
    rows_e = np.broadcast_to(np.arange(n)[:, None], ind.shape)[entry_ok]
    epair = ents[rows_e] * d + ind[entry_ok].astype(np.int64)
    evals = val[entry_ok]
    loc = np.searchsorted(pair, epair)
    loc = np.clip(loc, 0, max(pair.size - 1, 0))
    hit = pair[loc] == epair if pair.size else np.zeros(epair.shape, bool)
    out = np.zeros((n, k), dtype)
    np.add.at(out, (rows_e[hit], slot_sorted[loc[hit]]), evals[hit])
    return out


def _project_design_bucket(projector, bucket: RandomEffectDesign,
                           entity_index: np.ndarray, num_entities: int) -> RandomEffectDesign:
    if isinstance(projector, RandomProjection):
        return dataclasses.replace(bucket, features=projector.project_features(bucket.features))
    # INDEX_MAP: this bucket's per-lane column tables; sentinel lanes take
    # the last entity's columns (the JAX package's mode="clip"), their
    # mask is 0 so nothing of them enters a solve
    lanes = torch.as_tensor(np.asarray(entity_index, np.int64),
                            device=projector.columns.device).clamp(0, num_entities - 1)
    cols = projector.columns[lanes]  # (E_b, k)
    e, r, _ = bucket.features.shape
    cols = cols[:, None, :].expand(e, r, cols.shape[-1])
    return dataclasses.replace(bucket, features=_gather_columns(bucket.features, cols))


def project_design_and_rows(design: BucketedRandomEffectDesign, row_features: torch.Tensor,
                            row_entities: torch.Tensor, projector):
    """The combo-invariant work of a projected coordinate: every bucket's
    design and the full row view, projected ONCE. Cacheable across a
    reg-weight grid (a projection depends on the data, never on
    lambda)."""
    projected = BucketedRandomEffectDesign(
        buckets=[_project_design_bucket(projector, b, ei, design.num_entities)
                 for b, ei in zip(design.buckets, design.entity_index)],
        entity_index=design.entity_index,
        num_entities=design.num_entities,
    )
    if isinstance(projector, RandomProjection):
        proj_rows = projector.project_features(row_features)
    else:
        proj_rows = projector.project_row_features(row_features, row_entities)
    return projected, proj_rows


class ProjectedRandomEffectCoordinate:
    """A RandomEffectCoordinate whose solves happen in a projected space:
    ``initial_params`` / ``update_and_score`` / ``score`` / ``reg_term``
    act on the PROJECTED (E, k) table, and :meth:`back_project` maps a
    trained table to the original d-space for validation and persistence
    (``RandomEffectModelInProjectedSpace.toRandomEffectModel``)."""

    def __init__(
        self,
        design,  # RandomEffectDesign | BucketedRandomEffectDesign
        row_features: torch.Tensor,  # (n, d) ORIGINAL-space scoring view
        row_entities: torch.Tensor,
        full_offsets_base: torch.Tensor,
        config: CoordinateConfig,
        projector: Union[RandomProjection, IndexMapProjection],
        original_dim: int,
        reg_weights=None,
        prebuilt=None,  # (projected design, projected rows), reused across a grid
    ):
        if isinstance(design, RandomEffectDesign):
            design = BucketedRandomEffectDesign(
                buckets=[design],
                entity_index=[np.arange(design.num_entities, dtype=np.int32)],
                num_entities=design.num_entities,
            )
        self.projector = projector
        self.original_dim = original_dim
        if prebuilt is not None:
            projected, proj_rows = prebuilt
        else:
            projected, proj_rows = project_design_and_rows(
                design, row_features, row_entities, projector)
        self.inner = RandomEffectCoordinate(
            design=projected, row_features=proj_rows, row_entities=row_entities,
            full_offsets_base=full_offsets_base, config=config, reg_weights=reg_weights,
        )

    @classmethod
    def from_sparse_shard(
        cls,
        data: GameData,  # with a SparseFeatures shard
        random_effect: str,
        shard: str,
        num_entities: int,
        config: CoordinateConfig,
        num_buckets: int = 4,
        active_cap: Optional[int] = None,
        entity_multiple: int = 1,
        seed: int = 0,
        dtype: torch.dtype = torch.float32,
        reg_weights=None,
        feature_ratio: Optional[float] = None,
        min_support: int = 0,
        device="cpu",
    ) -> "ProjectedRandomEffectCoordinate":
        """A wide-sparse random effect: an INDEX_MAP-projected coordinate
        built STRAIGHT from a padded-ELL shard, never materializing the
        (E, rows, d) original-space design (the regime of
        ``RandomEffectCoordinateInProjectedSpace.scala:26-120``, where d is
        huge and each entity touches few columns). On the host, once per
        run: the per-entity active-column union, every row projected into
        its own entity's compact space (dense (n, k)), and the standard
        bucketed builder on that dense view; then the tensors go to
        ``device``."""
        projector = build_index_map_columns(data, random_effect, shard, num_entities,
                                            device=device)
        entities = to_numpy(data.entity_ids[random_effect])
        proj_rows_np = project_sparse_rows(
            data.features[shard], entities, projector,
            dtype=torch.empty((), dtype=dtype).numpy().dtype,
        )
        proj_data = dataclasses.replace(data, features={**data.features, shard: proj_rows_np})
        design = build_bucketed_random_effect_design(
            proj_data, random_effect, shard, num_entities, num_buckets=num_buckets,
            active_cap=active_cap, entity_multiple=entity_multiple, seed=seed, dtype=dtype,
            feature_ratio=feature_ratio, min_support=min_support, device=device,
        )
        proj_rows = torch.as_tensor(proj_rows_np, dtype=dtype, device=device)
        return cls(
            design=design,
            row_features=proj_rows,
            row_entities=torch.as_tensor(entities, dtype=torch.int64, device=device),
            full_offsets_base=torch.as_tensor(to_numpy(data.offsets), dtype=dtype,
                                              device=device),
            config=config,
            projector=projector,
            original_dim=data.features[shard].d,
            reg_weights=reg_weights,
            prebuilt=(design, proj_rows),
        )

    def with_config(self, config: CoordinateConfig) -> "ProjectedRandomEffectCoordinate":
        """The same projected design and rows under another solver config
        (the grid's reuse hook). A UNIFORM per-entity reg-weight vector is
        rebuilt from the new config's weight; a CUSTOM one is carried
        through unchanged."""
        old = to_numpy(self.inner.reg_weights)
        uniform = np.allclose(old, self.inner.config.reg_weight)
        return ProjectedRandomEffectCoordinate(
            design=self.inner.design,
            row_features=self.inner.row_features,
            row_entities=self.inner.row_entities,
            full_offsets_base=self.inner.full_offsets_base,
            config=config,
            projector=self.projector,
            original_dim=self.original_dim,
            reg_weights=None if uniform else self.inner.reg_weights,
            prebuilt=(self.inner.design, self.inner.row_features),
        )

    @property
    def config(self) -> CoordinateConfig:
        """The L2 penalty applies to the projected table: what the inner
        solves minimized."""
        return self.inner.config

    @property
    def num_entities(self) -> int:
        return self.inner.num_entities

    @property
    def dim(self) -> int:
        """The projected dimension (the solve space)."""
        return self.inner.dim

    def initial_params(self) -> torch.Tensor:
        return self.inner.initial_params()

    def update_and_score(self, table, partial_scores, generator=None):
        return self.inner.update_and_score(table, partial_scores, generator)

    def reg_term(self, table: torch.Tensor) -> torch.Tensor:
        return self.inner.reg_term(table)

    def score(self, table: torch.Tensor) -> torch.Tensor:
        return self.inner.score(table)

    def back_project(self, table: torch.Tensor) -> torch.Tensor:
        """(E, k) projected table -> (E, d) original-space coefficients
        (``RandomEffectModelInProjectedSpace.scala:31-97``)."""
        if isinstance(self.projector, RandomProjection):
            return self.projector.project_coefficients_back(table)
        return self.projector.project_coefficients_back(table, self.original_dim)
