"""The padded-batch policy shared by the offline scoring driver and the
online engine (counterpart of ``bucket_size``, ``_pad_rows`` and
``pad_game_data`` in ``photon_ml_tpu/serving/engine.py``). The online
engine itself (micro-batching, hot reload, the compile ladder) is not
ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

from photon_ml_tpu_torch.game.data import GameData
from photon_ml_tpu_torch.ops.sparse import SparseFeatures, is_sparse, is_structured

DEFAULT_MIN_BUCKET = 8


def bucket_size(n: int, min_bucket: int = DEFAULT_MIN_BUCKET) -> int:
    """Smallest power of two >= max(n, min_bucket): the shared padded-batch
    policy of the online engine and the offline driver (``cli/score.py``)."""
    if n <= 0:
        raise ValueError(f"batch must be non-empty, got {n} rows")
    return 1 << (max(n, min_bucket) - 1).bit_length()


def _pad_rows(x: np.ndarray, rows: int, fill=0) -> np.ndarray:
    if x.shape[0] == rows:
        return x
    pad = np.full((rows - x.shape[0],) + x.shape[1:], fill, x.dtype)
    return np.concatenate([x, pad], axis=0)


def pad_game_data(data: GameData, rows: int) -> GameData:
    """Pad every row-aligned column of a :class:`GameData` to ``rows``:
    dense features with zero rows, ELL shards with all-pad rows (id ``d``,
    value 0), entity ids with -1 (scores 0), labels/offsets/weights with 0.
    Padding is algebraically invisible to scoring; callers slice scores
    back to the real row count."""
    n = data.num_rows
    if rows == n:
        return data
    if rows < n:
        raise ValueError(f"cannot pad {n} rows down to {rows}")
    features = {}
    for name, v in data.features.items():
        if is_sparse(v):
            extra = rows - v.indices.shape[0]
            pad_i = v.indices.new_full((extra, v.nnz_per_row), v.d)
            pad_v = v.values.new_zeros((extra, v.nnz_per_row))
            features[name] = SparseFeatures(
                indices=torch.cat([v.indices, pad_i], dim=0),
                values=torch.cat([v.values, pad_v], dim=0),
                d=v.d,
            )
        elif is_structured(v):
            raise ValueError(
                f"shard {name!r}: only dense and plain-ELL shards pad "
                "(GameData already rejects hybrid containers)"
            )
        else:
            features[name] = _pad_rows(np.asarray(v), rows)
    return GameData(
        features=features,
        labels=_pad_rows(data.labels, rows),
        offsets=_pad_rows(data.offsets, rows),
        weights=_pad_rows(data.weights, rows),
        entity_ids={k: _pad_rows(v, rows, fill=-1) for k, v in data.entity_ids.items()},
    )
