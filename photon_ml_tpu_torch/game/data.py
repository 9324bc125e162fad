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

Everything stays on the host: the scorer places each coordinate's inputs
on its device. The per-entity training designs, buckets and partitions are
not ported yet (they belong to GAME training).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional

import numpy as np
import torch

from photon_ml_tpu_torch.core.types import LabeledBatch
from photon_ml_tpu_torch.ops.sparse import is_hybrid, is_structured


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
