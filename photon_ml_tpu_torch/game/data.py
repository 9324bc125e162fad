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
coefficient table (``RandomEffectDataSet.scala:319-358``). The entity
partitions of the entity-sharded layout are not ported yet (ROADMAP.md
queue A, "Parallel").
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
