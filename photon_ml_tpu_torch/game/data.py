"""GAME data layer: the scored dataset as struct-of-arrays
(counterpart of ``photon_ml_tpu/game/data.py``; the reference's
``data/GameDatum.scala:32``).

A GAME dataset here is:

  - feature shards: dict shard_id -> dense (n, d_shard) numpy matrix, or a
    padded-ELL ``ops.sparse.SparseFeatures`` for wide shards;
  - response/offset/weight columns (n,);
  - entity columns: dict random_effect_id -> (n,) int32 entity indices
    (index -1 = entity unseen at vocabulary build; scores 0 like the
    reference's missing-entity cogroup).

Everything stays on the host: the scorer and the trainer place each
coordinate's inputs on its device. Random-effect training data is bucketed
ONCE into padded (num_entities, rows_cap, d) tensors
(:class:`RandomEffectDesign`, built on the host, then placed), the analog
of ``RandomEffectDataSet``'s groupByKey + reservoir capping; rows beyond
the cap stay out of the active tensors but are still scored through the
coefficient table (``RandomEffectDataSet.scala:319-358``).

The entity-sharded layout (``EntityShardAssignment``,
``entity_partition_game_data``) is host numpy, deterministic and the same
on every rank: entity ownership is the sharded checkpoint writer's
round-robin rule (``io.checkpoint.shard_rows``), the table is stored
shard-major, and the batch rows are regrouped by their entity's owner.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional

import numpy as np
import torch

from photon_ml_tpu_torch.core.types import LabeledBatch
from photon_ml_tpu_torch.ops.sparse import is_hybrid, is_structured
from photon_ml_tpu_torch.utils.device import to_numpy


@dataclasses.dataclass
class GameData:
    """Host-side container for a scored dataset (plain arrays; device
    placement happens per coordinate)."""

    features: Dict[str, object]  # shard -> (n, d_shard) array or SparseFeatures
    labels: np.ndarray  # (n,)
    offsets: np.ndarray  # (n,)
    weights: np.ndarray  # (n,)
    entity_ids: Dict[str, np.ndarray]  # re_name -> (n,) int32, -1 = unknown

    @property
    def num_rows(self) -> int:
        return self.labels.shape[0]

    @staticmethod
    def create(
        features: Mapping[str, object],
        labels,
        offsets=None,
        weights=None,
        entity_ids: Optional[Mapping[str, np.ndarray]] = None,
    ) -> "GameData":
        labels = np.asarray(labels, np.float64)
        n = labels.shape[0]
        for name, v in {**features, **(entity_ids or {})}.items():
            if is_hybrid(v):
                # hybrid rows are permuted relative to every other column;
                # GAME joins shards/entities/scores BY ROW
                raise ValueError(
                    f"shard {name!r} is a HybridFeatures container; GAME "
                    "shards must be dense or plain ELL (row-aligned)"
                )
            rows = v.shape[0] if is_structured(v) else np.shape(v)[0]
            if rows != n:
                raise ValueError(
                    f"column {name!r} has {rows} rows, labels have {n}"
                )
        return GameData(
            features={
                k: (v if is_structured(v) else np.asarray(v))
                for k, v in features.items()
            },
            labels=labels,
            offsets=(
                np.zeros(n) if offsets is None else np.asarray(offsets, np.float64)
            ),
            weights=(
                np.ones(n) if weights is None else np.asarray(weights, np.float64)
            ),
            entity_ids={
                k: np.asarray(v, np.int32)
                for k, v in (entity_ids or {}).items()
            },
        )

    def fixed_effect_batch(
        self, shard: str, dtype: torch.dtype = torch.float32, device="cpu"
    ) -> LabeledBatch:
        """(n, d) LabeledBatch on ``device`` for a fixed-effect coordinate
        (``data/FixedEffectDataSet.scala:31``)."""
        return LabeledBatch.create(
            self.features[shard],
            self.labels,
            offsets=self.offsets,
            weights=self.weights,
            dtype=dtype,
            device=device,
        )


def build_entity_vocabulary(raw_ids: np.ndarray):
    """Map raw entity keys -> dense [0, E) indices in ``np.unique`` order
    (a saved table's row order follows it). Returns (vocab dict, (n,) int32
    index column)."""
    uniq = np.unique(raw_ids)
    vocab = {k: i for i, k in enumerate(uniq.tolist())}
    idx = np.asarray([vocab[k] for k in raw_ids.tolist()], np.int32)
    return vocab, idx


def apply_entity_vocabulary(vocab: dict, raw_ids: np.ndarray) -> np.ndarray:
    """Index new data against an existing vocabulary; unknown -> -1
    (scores 0, ``model/RandomEffectModel.scala:117-146``)."""
    return np.asarray([vocab.get(k, -1) for k in raw_ids.tolist()], np.int32)


@dataclasses.dataclass
class RandomEffectDesign:
    """Padded per-entity active training tensors for one random effect.

    features: (E, R, d)   labels/weights/mask: (E, R)
    row_index: (E, R) int32 — the global row each active slot came from
    (-1 pad), used to gather per-row residual offsets each coordinate pass
    without re-bucketing.
    """

    features: torch.Tensor
    labels: torch.Tensor
    weights: torch.Tensor
    mask: torch.Tensor
    row_index: torch.Tensor

    @property
    def num_entities(self) -> int:
        return self.features.shape[0]

    @property
    def rows_per_entity(self) -> int:
        return self.features.shape[1]

    @property
    def dim(self) -> int:
        return self.features.shape[2]

    def to(self, device) -> "RandomEffectDesign":
        return RandomEffectDesign(
            *(getattr(self, f.name).to(device) for f in dataclasses.fields(self))
        )

    def gather_offsets(self, full_offsets: torch.Tensor) -> torch.Tensor:
        """(n,) -> (E, R): route each row's current residual offset to its
        active slot (``data/RandomEffectDataSet.scala:58-75``'s per-pass
        join, here one gather)."""
        safe = self.row_index.clamp(min=0).long()
        return full_offsets[safe] * self.mask


def _grouped_rows(eids: np.ndarray, seed: int):
    """Vectorized per-entity grouping with a uniform random shuffle inside
    each entity (the reservoir-sample analog), drawn from
    ``np.random.default_rng(seed)`` as in the JAX package, so the rows come
    out the same.

    Returns (order, sorted_ids, slot, uniq, counts): ``order`` are row
    indices sorted by (entity, random), ``slot`` is each row's position
    within its entity, ``uniq``/``counts`` the entities present and their
    row counts."""
    rng = np.random.default_rng(seed)
    rand = rng.uniform(size=eids.shape[0])
    order = np.lexsort((rand, eids))
    sorted_ids = eids[order]
    valid = sorted_ids >= 0
    order, sorted_ids = order[valid], sorted_ids[valid]
    uniq, starts, counts = np.unique(sorted_ids, return_index=True, return_counts=True)
    slot = np.arange(order.size) - np.repeat(starts, counts)
    return order, sorted_ids, slot, uniq, counts


def _fill_design(
    data: GameData,
    shard: str,
    rows: np.ndarray,
    ent_rows: np.ndarray,
    slot_rows: np.ndarray,
    rescale_rows: np.ndarray,
    shape_e: int,
    cap: int,
    dtype: torch.dtype,
) -> RandomEffectDesign:
    """Scatter kept rows into padded (shape_e, cap, d) tensors on the CPU."""
    x = np.asarray(data.features[shard])
    d = x.shape[1]
    feats = np.zeros((shape_e, cap, d), np.float64)
    labels = np.zeros((shape_e, cap), np.float64)
    weights = np.zeros((shape_e, cap), np.float64)
    mask = np.zeros((shape_e, cap), np.float64)
    row_index = np.full((shape_e, cap), -1, np.int64)
    feats[ent_rows, slot_rows] = x[rows]
    labels[ent_rows, slot_rows] = data.labels[rows]
    weights[ent_rows, slot_rows] = data.weights[rows] * rescale_rows
    mask[ent_rows, slot_rows] = 1.0
    row_index[ent_rows, slot_rows] = rows
    return RandomEffectDesign(
        features=torch.from_numpy(feats).to(dtype),
        labels=torch.from_numpy(labels).to(dtype),
        weights=torch.from_numpy(weights).to(dtype),
        mask=torch.from_numpy(mask).to(dtype),
        row_index=torch.from_numpy(row_index).to(torch.int32),
    )


def pearson_correlation_scores(
    features: np.ndarray, labels: np.ndarray, mask: np.ndarray
) -> np.ndarray:
    """(E, R, d) design -> (E, d) per-entity Pearson |correlation| basis
    (``LocalDataSet.computePearsonCorrelationScore``,
    ``LocalDataSet.scala:198-259``): per entity, corr(feature_j, label)
    over its active rows; a present feature with ~zero variance is the
    intercept — the FIRST such scores 1.0, later ones 0.0; features absent
    from the entity's rows score -inf (never selected)."""
    m = mask > 0
    x = np.where(m[:, :, None], features, 0.0)
    y = np.where(m, labels, 0.0)
    n = m.sum(axis=1).astype(np.float64)[:, None]  # (E, 1)
    s1 = x.sum(axis=1)
    s2 = (x * x).sum(axis=1)
    sxy = (x * y[:, :, None]).sum(axis=1)
    ly = y.sum(axis=1)[:, None]
    lyy = (y * y).sum(axis=1)[:, None]
    numerator = n * sxy - s1 * ly
    feat_var = np.abs(n * s2 - s1 * s1)
    std = np.sqrt(feat_var)
    label_var = np.maximum(n * lyy - ly * ly, 0.0)
    denominator = std * np.sqrt(label_var)
    # constant labels: the correlation is undefined — force 0. Thresholds
    # are relative to the moment magnitudes (cancellation at large n)
    label_const = label_var < 1e-9 * np.maximum(n * lyy, 1.0)
    score = np.where(label_const, 0.0, numerator / (denominator + 1e-12))

    present = s2 > 0.0
    constant = present & (feat_var < 1e-9 * np.maximum(n * s2, 1.0))
    # the first constant (intercept-like) feature per entity scores 1.0
    first_const = constant & (np.cumsum(constant, axis=1) == 1)
    score = np.where(constant, 0.0, score)
    score = np.where(first_const, 1.0, score)
    return np.where(present, np.abs(score), -np.inf)


def filter_features_by_support(
    design: RandomEffectDesign, min_support: int
) -> RandomEffectDesign:
    """Per-entity support filter (``LocalDataSet.filterFeaturesBySupport``,
    ``LocalDataSet.scala:80-109``): a feature survives for an entity iff it
    is nonzero in at least ``min_support`` of that entity's active rows;
    dropped columns are zeroed so their coefficients solve to exactly 0.
    Stored zeros count as absent, as in the JAX package."""
    if min_support <= 0:
        return design
    feats = to_numpy(design.features)
    mask = to_numpy(design.mask) > 0
    support = ((feats != 0.0) & mask[:, :, None]).sum(axis=1)  # (E, d)
    keep = support >= min_support
    return dataclasses.replace(
        design,
        features=torch.from_numpy(np.where(keep[:, None, :], feats, 0.0)).to(
            design.features
        ),
    )


def select_features_by_pearson(
    design: RandomEffectDesign, ratio: float
) -> RandomEffectDesign:
    """Per-entity feature selection: keep the top ceil(ratio * n_e)
    features by |Pearson corr|, zeroing the rest in the design so their
    coefficients solve to exactly 0
    (``RandomEffectDataSet.featureSelectionOnActiveData``,
    ``RandomEffectDataSet.scala:360-380``)."""
    if ratio <= 0:
        raise ValueError(f"feature ratio must be positive, got {ratio}")
    feats = to_numpy(design.features, np.float64)
    mask = to_numpy(design.mask)
    score = pearson_correlation_scores(feats, to_numpy(design.labels, np.float64), mask)
    d = feats.shape[2]
    n_e = (mask > 0).sum(axis=1)
    k_e = np.minimum(np.ceil(ratio * n_e).astype(np.int64), d)
    rank = np.argsort(np.argsort(-score, axis=1, kind="stable"), axis=1)
    keep = rank < k_e[:, None]  # (E, d)
    return dataclasses.replace(
        design,
        features=torch.from_numpy(np.where(keep[:, None, :], feats, 0.0)).to(
            design.features
        ),
    )


def _dense_entity_ids(data: GameData, random_effect: str, shard: str) -> np.ndarray:
    if is_structured(data.features[shard]):
        raise ValueError(
            f"random effect {random_effect!r}: per-entity designs gather "
            f"dense rows; shard {shard!r} is sparse (sparse shards serve "
            "fixed-effect coordinates only)"
        )
    return np.asarray(data.entity_ids[random_effect])


def build_random_effect_design(
    data: GameData,
    random_effect: str,
    shard: str,
    num_entities: int,
    active_cap: Optional[int] = None,
    seed: int = 0,
    dtype: torch.dtype = torch.float32,
    feature_ratio: Optional[float] = None,
    min_support: int = 0,
    device="cpu",
) -> RandomEffectDesign:
    """Group rows by entity into padded tensors (on the host, once per run;
    then placed on ``device``), with the semantics of
    ``RandomEffectDataSet.buildWithConfiguration``:

      - at most ``active_cap`` active rows per entity, chosen uniformly at
        random (the reference's reservoir sample, :247-308);
      - sampled rows get weight * count/cap so each entity's total active
        weight is preserved (:299-302);
      - rows of entities with index -1 (unknown) are dropped;
      - ``num_entities`` fixes the leading axis = the coefficient-table size.
    """
    eids = _dense_entity_ids(data, random_effect, shard)
    if active_cap is not None and active_cap <= 0:
        raise ValueError(f"active_cap must be positive, got {active_cap}")
    order, sorted_ids, slot, uniq, counts = _grouped_rows(eids, seed)

    max_count = int(counts.max()) if counts.size else 1
    cap = min(max_count, active_cap) if active_cap is not None else max_count

    cap_of = np.minimum(counts, cap)
    keep = slot < np.repeat(cap_of, counts)
    rescale = np.repeat(np.where(counts > cap, counts / cap, 1.0), counts)
    design = _fill_design(
        data, shard, order[keep], sorted_ids[keep], slot[keep], rescale[keep],
        num_entities, cap, dtype,
    )
    # the support filter first, the Pearson ranking second (LocalDataSet's
    # order: the cheap count-based cut precedes the ranking)
    design = filter_features_by_support(design, min_support)
    if feature_ratio is not None:
        design = select_features_by_pearson(design, feature_ratio)
    return design.to(device)


@dataclasses.dataclass
class BucketedRandomEffectDesign:
    """Size-bucketed padded designs for one random effect: entities grouped
    by row count into a few buckets, each padded only to ITS max count
    (the analog of ``data/RandomEffectIdPartitioner.scala:65-99``'s
    load-balanced placement).

    buckets[b] tensors have shape (E_b, R_b, d); entity_index[b] maps bucket
    lane -> row of the global (num_entities, d) coefficient table. Lanes
    padded to ``entity_multiple`` carry the sentinel ``num_entities``, which
    gathers clamp and scatters drop."""

    buckets: List[RandomEffectDesign]
    entity_index: List[np.ndarray]  # (E_b,) int32 each
    num_entities: int

    @property
    def num_buckets(self) -> int:
        return len(self.buckets)

    @property
    def dim(self) -> int:
        return self.buckets[0].dim

    @property
    def active_slots(self) -> int:
        """Total padded (entity, row) slots across buckets."""
        return sum(b.num_entities * b.rows_per_entity for b in self.buckets)


def _split_minimizing_padding(sorted_counts: np.ndarray, max_buckets: int):
    """Optimal contiguous split of ascending per-entity row counts into at
    most ``max_buckets`` groups minimizing the padded slots
    sum_b |entities_b| * max_count_b (exact DP over the distinct counts).
    Returns [(lo, hi)) index ranges into sorted_counts."""
    if sorted_counts.size == 0:
        return []
    values, nums = np.unique(sorted_counts, return_counts=True)
    m = values.size
    k = min(max_buckets, m)
    prefix = np.concatenate([[0], np.cumsum(nums)])
    dp = np.full(m + 1, float("inf"))
    dp[0] = 0.0
    choice = np.zeros((k, m + 1), np.int64)
    for layer in range(k):
        nxt = np.full(m + 1, float("inf"))
        for j in range(1, m + 1):
            # bucket = distinct values [i, j) with cap values[j-1]
            costs = dp[:j] + (prefix[j] - prefix[:j]) * values[j - 1]
            i = int(np.argmin(costs))
            nxt[j] = costs[i]
            choice[layer, j] = i
        dp = nxt
    bounds = []
    j = m
    layer = k - 1
    while j > 0:
        i = int(choice[layer, j])
        bounds.append((int(prefix[i]), int(prefix[j])))
        j = i
        layer -= 1
    return bounds[::-1]


def build_bucketed_random_effect_design(
    data: GameData,
    random_effect: str,
    shard: str,
    num_entities: int,
    num_buckets: int = 4,
    active_cap: Optional[int] = None,
    entity_multiple: int = 1,
    seed: int = 0,
    dtype: torch.dtype = torch.float32,
    feature_ratio: Optional[float] = None,
    min_support: int = 0,
    device="cpu",
) -> BucketedRandomEffectDesign:
    """Like :func:`build_random_effect_design` with per-size-class row
    caps: entities with data are sorted by row count and split into
    ``num_buckets`` contiguous groups; each bucket's row cap is its own max
    count (still bounded by ``active_cap``, with the same weight-preserving
    rescale). ``entity_multiple`` pads each bucket's entity axis up to a
    multiple."""
    eids = _dense_entity_ids(data, random_effect, shard)
    if active_cap is not None and active_cap <= 0:
        raise ValueError(f"active_cap must be positive, got {active_cap}")
    if entity_multiple <= 0:
        raise ValueError(f"entity_multiple must be positive, got {entity_multiple}")
    order, sorted_ids, slot, uniq, counts = _grouped_rows(eids, seed)

    if uniq.size == 0:
        # no rows with a known entity: one all-masked bucket, so that
        # initial_params and update keep working
        empty_idx = np.asarray([], np.int64)
        return BucketedRandomEffectDesign(
            buckets=[
                _fill_design(
                    data, shard, empty_idx, empty_idx, empty_idx,
                    np.asarray([]), entity_multiple, 1, dtype,
                ).to(device)
            ],
            entity_index=[np.full(entity_multiple, num_entities, np.int32)],
            num_entities=num_entities,
        )

    by_count = np.argsort(counts, kind="stable")
    splits = _split_minimizing_padding(counts[by_count], num_buckets)
    splits = [by_count[lo:hi] for lo, hi in splits]

    cap_of_entity = np.zeros(num_entities, np.int64)
    bucket_of_entity = np.full(num_entities, -1, np.int64)
    local_of_entity = np.zeros(num_entities, np.int64)
    bucket_caps = []
    bucket_entities = []
    for b, split in enumerate(splits):
        ents = uniq[split]
        cmax = int(counts[split].max())
        cap_b = min(cmax, active_cap) if active_cap is not None else cmax
        bucket_caps.append(cap_b)
        bucket_entities.append(ents)
        cap_of_entity[ents] = np.minimum(counts[split], cap_b)
        bucket_of_entity[ents] = b
        local_of_entity[ents] = np.arange(ents.size)

    keep = slot < cap_of_entity[sorted_ids]
    full_count = np.zeros(num_entities, np.int64)
    full_count[uniq] = counts
    rescale_of_entity = np.where(
        full_count > cap_of_entity,
        full_count / np.maximum(cap_of_entity, 1),
        1.0,
    )

    rows = order[keep]
    ents = sorted_ids[keep]
    slots = slot[keep]

    buckets = []
    entity_index = []
    for b, (cap_b, ents_b) in enumerate(zip(bucket_caps, bucket_entities)):
        sel = bucket_of_entity[ents] == b
        e_pad = -(-ents_b.size // entity_multiple) * entity_multiple
        bucket = _fill_design(
            data, shard, rows[sel], local_of_entity[ents[sel]], slots[sel],
            rescale_of_entity[ents[sel]], e_pad, cap_b, dtype,
        )
        bucket = filter_features_by_support(bucket, min_support)
        if feature_ratio is not None:
            bucket = select_features_by_pearson(bucket, feature_ratio)
        buckets.append(bucket.to(device))
        idx = np.full(e_pad, num_entities, np.int64)
        idx[: ents_b.size] = ents_b
        entity_index.append(np.asarray(idx, np.int32))

    return BucketedRandomEffectDesign(
        buckets=buckets, entity_index=entity_index, num_entities=num_entities
    )


# -- the entity-sharded layout --------------------------------------------------


@dataclasses.dataclass(frozen=True)
class EntityShardAssignment:
    """Entity -> shard ownership for entity-sharded GAME descent
    (``photon_ml_tpu/game/data.py:558``). Ownership is the sharded
    checkpoint writer's round-robin rule (``io.checkpoint.shard_rows``:
    shard p owns rows ``p::P`` of the global entity order), so the
    device layout and the checkpoint shards come from one rule and a
    restore at any width re-keys rows by entity.

    The table is stored SHARD-MAJOR: shard p's entities contiguous, each
    shard padded to ``rows_per_shard``, so rank p's block of the stored
    table is rows ``[p * rows_per_shard, (p + 1) * rows_per_shard)``.

    stored_to_global: (padded_rows,) int64 stored row -> global entity
                      (``num_entities`` = the pad sentinel).
    global_to_stored: (num_entities + 1,) int64 inverse; the last slot maps
                      the global sentinel to the stored sentinel
                      ``padded_rows``.
    """

    num_entities: int
    num_shards: int
    rows_per_shard: int
    stored_to_global: np.ndarray
    global_to_stored: np.ndarray

    @property
    def padded_rows(self) -> int:
        return self.num_shards * self.rows_per_shard

    def shard_of_stored(self, stored: np.ndarray) -> np.ndarray:
        return np.minimum(np.asarray(stored, np.int64) // self.rows_per_shard,
                          self.num_shards - 1)

    def owner_of_global(self, entities: np.ndarray) -> np.ndarray:
        """Owning shard of each global entity index in [0, num_entities)."""
        return self.shard_of_stored(self.global_to_stored[np.asarray(entities, np.int64)])

    def local_of_global(self, entities: np.ndarray) -> np.ndarray:
        """Row of each global entity index within its owner's block."""
        stored = self.global_to_stored[np.asarray(entities, np.int64)]
        return stored - self.shard_of_stored(stored) * self.rows_per_shard

    def stored_entity_keys(self, global_keys) -> list:
        """The global entity-key list in the STORED (shard-major) order,
        pad rows keyed uniquely so that a checkpoint's re-keying never
        aliases them onto real entities."""
        keys = list(global_keys)
        if len(keys) != self.num_entities:
            raise ValueError(f"{len(keys)} entity keys for {self.num_entities} entities")
        return [str(keys[g]) if g < self.num_entities else f"__entity_pad__:{i}"
                for i, g in enumerate(self.stored_to_global)]

    def table_to_global(self, stored_table):
        """Stored (shard-major, padded) table -> global entity order (numpy
        or a tensor, kept as given)."""
        idx = self.global_to_stored[: self.num_entities]
        if torch.is_tensor(stored_table):
            return stored_table.index_select(
                0, torch.as_tensor(idx, device=stored_table.device))
        return np.asarray(stored_table)[idx]

    def table_from_global(self, global_table: np.ndarray) -> np.ndarray:
        """Global entity order -> the stored layout; pad rows zero."""
        global_table = np.asarray(global_table)
        out = np.zeros((self.padded_rows,) + global_table.shape[1:], global_table.dtype)
        real = self.stored_to_global < self.num_entities
        out[real] = global_table[self.stored_to_global[real]]
        return out


def _assignment_from_blocks(num_entities: int, blocks) -> EntityShardAssignment:
    """An assignment whose shard p owns the global entities ``blocks[p]``
    (in that order), each shard padded to the largest block."""
    num_shards = len(blocks)
    per_shard = max(max((len(b) for b in blocks), default=0), 1)
    padded = per_shard * num_shards
    stored_to_global = np.full(padded, num_entities, np.int64)
    for p, rows in enumerate(blocks):
        rows = np.asarray(rows, np.int64)
        stored_to_global[p * per_shard: p * per_shard + rows.size] = rows
    global_to_stored = np.full(num_entities + 1, padded, np.int64)
    real = stored_to_global < num_entities
    global_to_stored[stored_to_global[real]] = np.flatnonzero(real)
    return EntityShardAssignment(num_entities=num_entities, num_shards=num_shards,
                                 rows_per_shard=per_shard, stored_to_global=stored_to_global,
                                 global_to_stored=global_to_stored)


def entity_shard_assignment(num_entities: int, num_shards: int) -> EntityShardAssignment:
    """The round-robin entity -> shard assignment (``photon_ml_tpu/game/
    data.py:647``; the rule of ``io.checkpoint.shard_rows``)."""
    from photon_ml_tpu_torch.io.checkpoint import shard_rows

    if num_shards < 1:
        raise ValueError(f"num_shards must be >= 1, got {num_shards}")
    return _assignment_from_blocks(
        num_entities, [list(shard_rows(num_entities, p, num_shards)) for p in range(num_shards)])


def contiguous_entity_assignment(counts) -> EntityShardAssignment:
    """Shard p owns the contiguous global entities ``[base_p, base_p +
    counts[p])``, ``base_p`` the sum of the counts before it: the layout of
    the multi-process GAME branch, where every rank indexes its own
    entities and the global vocabulary is their concatenation in rank
    order (``parallel.multihost.global_entity_space``)."""
    counts = [int(c) for c in counts]
    bases = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
    return _assignment_from_blocks(int(bases[-1]), [np.arange(bases[p], bases[p + 1])
                                                    for p in range(len(counts))])


@dataclasses.dataclass(frozen=True)
class EntityRowPartition:
    """The row permutation that groups batch rows by their entity's owner
    shard (``photon_ml_tpu/game/data.py:679``): shard p's rows sit in the
    contiguous block ``[p * R, (p + 1) * R)``, padded with -1 sentinel rows
    so that every shard holds the same count.

    row_perm: (padded_rows,) int64 permuted position -> original row
              (-1 = pad).
    """

    num_shards: int
    rows_per_shard: int
    row_perm: np.ndarray

    @property
    def padded_rows(self) -> int:
        return self.num_shards * self.rows_per_shard

    def apply(self, column: np.ndarray, fill=0.0) -> np.ndarray:
        """One per-row array in the sharded order (pad rows ``fill``)."""
        column = np.asarray(column)
        out = np.full((self.padded_rows,) + column.shape[1:], fill, column.dtype)
        real = self.row_perm >= 0
        out[real] = column[self.row_perm[real]]
        return out

    def restore(self, column: np.ndarray) -> np.ndarray:
        """Inverse of :meth:`apply` (drops pad rows)."""
        column = np.asarray(column)
        real = self.row_perm >= 0
        out = np.zeros((int(real.sum()),) + column.shape[1:], column.dtype)
        out[self.row_perm[real]] = column[real]
        return out


def entity_partition_game_data(data: GameData, random_effect: str,
                               assignment: EntityShardAssignment):
    """``data`` in the entity-partitioned row order of ``random_effect``
    (``photon_ml_tpu/game/data.py:723``): rows grouped by their entity's
    owner shard, pad rows of weight 0. Returns ``(permuted GameData,
    EntityRowPartition)``. Dense and padded-ELL shards permute (an ELL pad
    row takes column id ``d`` and value 0, the port's padding); other
    structured shards are refused."""
    from photon_ml_tpu_torch.ops.sparse import SparseFeatures, is_sparse

    part = entity_partition_rows(data.entity_ids[random_effect], assignment)
    real = part.row_perm >= 0
    src = torch.as_tensor(part.row_perm[real])
    dst = torch.as_tensor(np.flatnonzero(real))

    def permute_features(v):
        if is_sparse(v):
            ind = torch.full((part.padded_rows,) + tuple(v.indices.shape[1:]), v.d,
                             dtype=v.indices.dtype)
            val = torch.zeros((part.padded_rows,) + tuple(v.values.shape[1:]),
                              dtype=v.values.dtype)
            ind[dst] = v.indices.cpu()[src]
            val[dst] = v.values.cpu()[src]
            return SparseFeatures(indices=ind, values=val, d=v.d)
        if is_structured(v):
            raise ValueError("entity partitioning permutes dense or plain-ELL shards; "
                             f"got {type(v).__name__}")
        return part.apply(v)

    permuted = GameData(
        features={k: permute_features(v) for k, v in data.features.items()},
        labels=part.apply(data.labels),
        offsets=part.apply(data.offsets),
        weights=part.apply(data.weights),  # pad rows weigh 0: masked out
        entity_ids={k: part.apply(v, fill=-1) for k, v in data.entity_ids.items()},
    )
    return permuted, part


def entity_partition_rows(entity_ids: np.ndarray,
                          assignment: EntityShardAssignment) -> EntityRowPartition:
    """Group rows by their entity's owner shard, stable within a shard
    (``photon_ml_tpu/game/data.py:775``). Rows of unknown entities (-1)
    spread round-robin: they take part in no random-effect solve."""
    eids = np.asarray(entity_ids, np.int64)
    n = eids.shape[0]
    known = eids >= 0
    owner = np.empty(n, np.int64)
    owner[known] = assignment.shard_of_stored(assignment.global_to_stored[eids[known]])
    owner[~known] = np.arange(int((~known).sum())) % assignment.num_shards
    counts = np.bincount(owner, minlength=assignment.num_shards)
    per = int(counts.max()) if counts.size else 1
    row_perm = np.full(per * assignment.num_shards, -1, np.int64)
    order = np.argsort(owner, kind="stable")
    starts = np.concatenate([[0], np.cumsum(counts)])[:-1]
    slot = np.arange(n) - starts[owner[order]]
    row_perm[owner[order] * per + slot] = order
    return EntityRowPartition(num_shards=assignment.num_shards, rows_per_shard=per,
                              row_perm=row_perm)
