"""Ingest: Avro training records -> columnar arrays / LabeledBatch
(counterpart of ``photon_ml_tpu/io/ingest.py``, cut down to the pure-Python
Avro codec path).

Sparse (name, term, value) feature lists are indexed against a vocabulary,
duplicate (name, term) entries in one record are summed
(``DataProcessingUtils.scala:70-76`` dedup-by-sum), and the intercept column
is set to 1. Rows land in a dense float matrix or, with ``sparse=True``, in
a padded-ELL ``ops.sparse.SparseFeatures``. GAME input (``game_data``)
gets one matrix per feature shard, dense or padded-ELL, and one entity
index column per random-effect type. Not ported yet: the native C++
reader, the streamed pipeline, the quality fingerprints and the retrying
read.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from photon_ml_tpu_torch.core.types import LabeledBatch
from photon_ml_tpu_torch.io.vocab import FeatureVocabulary, feature_key

# Avro field-name sets (``avro/FieldNamesType.scala:20``)
TRAINING_EXAMPLE_FIELDS = "TRAINING_EXAMPLE"
RESPONSE_PREDICTION_FIELDS = "RESPONSE_PREDICTION"
FIELD_NAME_SETS = (TRAINING_EXAMPLE_FIELDS, RESPONSE_PREDICTION_FIELDS)


def normalize_field_names(records: List[dict], field_names: str) -> List[dict]:
    """Map a foreign field-name set onto the TrainingExample names.
    RESPONSE_PREDICTION calls the label "response". Shallow-copies only
    when renaming is needed."""
    if field_names == TRAINING_EXAMPLE_FIELDS:
        return records
    if field_names != RESPONSE_PREDICTION_FIELDS:
        raise ValueError(
            f"unknown field-name set {field_names!r}; expected one of "
            f"{FIELD_NAME_SETS}"
        )
    out = []
    for rec in records:
        r = dict(rec)
        if "label" not in r:
            r["label"] = r.get("response")
        out.append(r)
    return out


def _read_label(rec: dict, i: int, allow_null_labels: bool) -> float:
    """Scoring input may carry null labels (coerced to 0.0 when the caller
    opts in); training input fails loudly."""
    v = rec.get("label")
    if v is None:
        if not allow_null_labels:
            raise ValueError(
                f"record {i} has a null/missing label; training input "
                "requires labels (pass allow_null_labels=True only for "
                "scoring)"
            )
        return 0.0
    return v


def index_entity_strings(
    raw_entities: Dict[str, np.ndarray],
    entity_vocabs: Optional[Dict[str, dict]] = None,
) -> Tuple[Dict[str, np.ndarray], Dict[str, dict]]:
    """Per-row entity strings -> int32 index columns + vocabularies.

    "" means the row does not carry the key (index -1). When
    ``entity_vocabs`` provides a key's vocabulary (scoring against a
    trained model) it is applied; otherwise one is built from the rows
    that carry the key (training)."""
    from photon_ml_tpu_torch.game.data import (
        apply_entity_vocabulary,
        build_entity_vocabulary,
    )

    entity_ids: Dict[str, np.ndarray] = {}
    out_vocabs: Dict[str, dict] = {}
    for k, raw in raw_entities.items():
        known = np.asarray([r != "" for r in raw])
        if entity_vocabs is not None and k in entity_vocabs:
            vocab_k = dict(entity_vocabs[k])
        else:
            vocab_k, _ = build_entity_vocabulary(raw[known])
        idx = apply_entity_vocabulary(vocab_k, raw)
        entity_ids[k] = np.where(known, idx, -1).astype(np.int32)
        out_vocabs[k] = vocab_k
    return entity_ids, out_vocabs


def _inject_intercept(rows, cols, vals, n, intercept_index):
    """Append one (row, intercept, 1.0) triplet per row (raw features that
    alias the intercept key are skipped by the record walk, so the column
    is otherwise empty)."""
    if intercept_index is None:
        return rows, cols, vals
    return (
        np.concatenate([rows, np.arange(n, dtype=np.int64)]),
        np.concatenate([cols, np.full(n, intercept_index, dtype=np.int64)]),
        np.concatenate([vals, np.ones(n)]),
    )


def _scalar_columns_and_triplets(
    records: List[dict], vocab: FeatureVocabulary, allow_null_labels: bool = False
):
    """Shared record walk for both representations.

    Returns ({labels, offsets, weights, uids}, (rows, cols, vals)): features
    not in the vocabulary are skipped, raw features aliasing the intercept
    key are ignored, and the intercept column (if the vocabulary has one)
    appears exactly once per row with value 1.0."""
    n = len(records)
    labels = np.zeros(n, np.float64)
    offsets = np.zeros(n, np.float64)
    weights = np.ones(n, np.float64)
    uids: List[Optional[str]] = []
    icpt = vocab.intercept_index
    index = vocab.key_to_index
    rows: List[int] = []
    cols: List[int] = []
    vals: List[float] = []
    for i, rec in enumerate(records):
        labels[i] = _read_label(rec, i, allow_null_labels)
        if rec.get("offset") is not None:
            offsets[i] = rec["offset"]
        if rec.get("weight") is not None:
            weights[i] = rec["weight"]
        uids.append(rec.get("uid"))
        for f in rec["features"]:
            j = index.get(feature_key(f["name"], f["term"]))
            if j is not None and j != icpt:
                rows.append(i)
                cols.append(j)
                vals.append(f["value"])
    columns = {
        "labels": labels,
        "offsets": offsets,
        "weights": weights,
        "uids": np.asarray(uids, object),
    }
    triplets = _inject_intercept(
        np.asarray(rows, np.int64),
        np.asarray(cols, np.int64),
        np.asarray(vals, np.float64),
        n,
        icpt,
    )
    return columns, triplets


def training_examples_to_arrays(
    records: List[dict], vocab: FeatureVocabulary, allow_null_labels: bool = False
) -> Dict[str, np.ndarray]:
    """TrainingExampleAvro dicts -> {features (n, d), labels, offsets,
    weights, uids} (host-side numpy)."""
    columns, (rows, cols, vals) = _scalar_columns_and_triplets(
        records, vocab, allow_null_labels=allow_null_labels
    )
    x = np.zeros((len(records), len(vocab)), np.float64)
    np.add.at(x, (rows, cols), vals)
    return {"features": x, **columns}


def training_examples_to_sparse(
    records: List[dict],
    vocab: FeatureVocabulary,
    nnz_per_row: int = 0,
    dtype: Optional[torch.dtype] = None,
    allow_null_labels: bool = False,
    device="cpu",
):
    """TrainingExampleAvro dicts -> (SparseFeatures, columns dict), the
    same semantics as :func:`training_examples_to_arrays` without the
    (n, d) matrix."""
    from photon_ml_tpu_torch.ops.sparse import from_coo

    columns, (rows, cols, vals) = _scalar_columns_and_triplets(
        records, vocab, allow_null_labels=allow_null_labels
    )
    features = from_coo(
        rows, cols, vals, len(records), len(vocab),
        nnz_per_row=nnz_per_row, dtype=dtype or torch.float32, device=device,
    )
    return features, columns


def _assemble_shard_features(
    shard_vocabs: Dict[str, FeatureVocabulary],
    shard_triplets: Dict[str, Tuple[np.ndarray, np.ndarray, np.ndarray]],
    n: int,
    sparse_shards: Optional[set] = None,
):
    """COO triplets per shard -> dense (n, d) float64 numpy matrices, or
    padded-ELL ``SparseFeatures`` (float64, on the CPU) for shards named
    in ``sparse_shards``. The intercept column (if the vocabulary has one)
    is injected as value 1.0 either way. Everything stays on the host; the
    scorer places each shard on its device."""
    from photon_ml_tpu_torch.ops.sparse import from_coo

    sparse_shards = sparse_shards or set()
    unknown = sparse_shards - set(shard_vocabs)
    if unknown:
        raise ValueError(f"sparse_shards not in shard_vocabs: {unknown}")
    features: Dict[str, object] = {}
    for shard, vocab in shard_vocabs.items():
        rows, cols, vals = _inject_intercept(
            *shard_triplets[shard], n, vocab.intercept_index
        )
        if shard in sparse_shards:
            features[shard] = from_coo(rows, cols, vals, n, len(vocab), dtype=torch.float64)
        else:
            x = np.zeros((n, len(vocab)), np.float64)
            np.add.at(x, (rows, cols), vals)
            features[shard] = x
    return features


def game_data_from_avro(
    records: List[dict],
    shard_vocabs: Dict[str, FeatureVocabulary],
    entity_keys: List[str],
    entity_vocabs: Optional[Dict[str, dict]] = None,
    allow_null_labels: bool = False,
    sparse_shards: Optional[set] = None,
):
    """TrainingExampleAvro records -> (GameData, entity_vocabs, uids).

    The GAME analog of ``DataProcessingUtils.getGameDataSetFromGenericRecords``
    (``DataProcessingUtils.scala:34-131``): each feature shard gets its own
    (n, d_shard) matrix (padded-ELL for shards in ``sparse_shards``)
    indexed by its vocabulary (a feature lands in every shard whose
    vocabulary contains it: the reference's section-key bags), and each
    entity key is read from the record's metadataMap into an int32 index
    column (unknown entity -> -1, scoring 0). When ``entity_vocabs`` is
    given (scoring against a trained model) it is applied; otherwise
    vocabularies are built from the data (training)."""
    from photon_ml_tpu_torch.game.data import GameData

    n = len(records)
    labels = np.zeros(n, np.float64)
    offsets = np.zeros(n, np.float64)
    weights = np.ones(n, np.float64)
    uids: List[Optional[str]] = []
    triplets: Dict[str, Tuple[list, list, list]] = {
        shard: ([], [], []) for shard in shard_vocabs
    }
    raw_entities: Dict[str, List[str]] = {k: [] for k in entity_keys}
    shards = [(t, v.key_to_index, v.intercept_index)
              for t, v in zip(triplets.values(), shard_vocabs.values())]
    for i, rec in enumerate(records):
        labels[i] = _read_label(rec, i, allow_null_labels)
        if rec.get("offset") is not None:
            offsets[i] = rec["offset"]
        if rec.get("weight") is not None:
            weights[i] = rec["weight"]
        uids.append(rec.get("uid"))
        meta = rec.get("metadataMap") or {}
        for k in entity_keys:
            raw_entities[k].append(str(meta.get(k, "")))
        for f in rec["features"]:
            key = feature_key(f["name"], f["term"])
            for (r, c, v), index, icpt in shards:
                j = index.get(key)
                if j is not None and j != icpt:
                    r.append(i)
                    c.append(j)
                    v.append(f["value"])
    features = _assemble_shard_features(
        shard_vocabs,
        {
            shard: (
                np.asarray(r, np.int64),
                np.asarray(c, np.int64),
                np.asarray(v, np.float64),
            )
            for shard, (r, c, v) in triplets.items()
        },
        n,
        sparse_shards,
    )
    entity_ids, out_vocabs = index_entity_strings(
        {k: np.asarray(v, object) for k, v in raw_entities.items()},
        entity_vocabs,
    )
    data = GameData.create(
        features=features,
        labels=labels,
        offsets=offsets,
        weights=weights,
        entity_ids=entity_ids,
    )
    return data, out_vocabs, np.asarray(uids, object)


def labeled_batch_from_avro(
    records: List[dict],
    vocab: FeatureVocabulary,
    dtype: Optional[torch.dtype] = None,
    sparse: bool = False,
    nnz_per_row: int = 0,
    allow_null_labels: bool = False,
    device="cpu",
) -> LabeledBatch:
    dtype = dtype or torch.float32
    if sparse:
        features, cols = training_examples_to_sparse(
            records, vocab, nnz_per_row=nnz_per_row, dtype=dtype,
            allow_null_labels=allow_null_labels, device=device,
        )
    else:
        cols = training_examples_to_arrays(
            records, vocab, allow_null_labels=allow_null_labels
        )
        features = cols["features"]
    return LabeledBatch.create(
        features,
        cols["labels"],
        offsets=cols["offsets"],
        weights=cols["weights"],
        dtype=dtype,
        device=device,
    )


class IngestSource:
    """Avro input files -> LabeledBatch or GameData, through the
    pure-Python codec. Records are decoded once and cached."""

    def __init__(self, paths, field_names: str = TRAINING_EXAMPLE_FIELDS):
        if isinstance(paths, str):
            paths = [paths]
        files: List[str] = []
        for p in paths:
            if os.path.isdir(p):
                part = sorted(
                    os.path.join(p, f) for f in os.listdir(p) if f.endswith(".avro")
                )
                if not part:
                    raise FileNotFoundError(f"no .avro files under {p}")
                files.extend(part)
            else:
                files.append(p)
        if not files:
            raise FileNotFoundError(f"no input files in {paths!r}")
        self.files = files
        self.field_names = field_names
        self._records: Optional[List[dict]] = None

    def records(self) -> List[dict]:
        """Decoded records (cached); raises on a valid-but-empty input."""
        if self._records is None:
            from photon_ml_tpu_torch.io.avro import read_avro_file

            recs: List[dict] = []
            for f in self.files:
                recs.extend(read_avro_file(f)[1])
            if not recs:
                raise ValueError(f"no records found in {self.files}")
            self._records = normalize_field_names(recs, self.field_names)
        return self._records

    def labeled_batch(
        self,
        vocab: FeatureVocabulary,
        dtype: Optional[torch.dtype] = None,
        sparse: bool = False,
        nnz_per_row: int = 0,
        allow_null_labels: bool = False,
        device="cpu",
    ) -> Tuple[LabeledBatch, np.ndarray, np.ndarray]:
        """-> (LabeledBatch on ``device``, uids, label_present)."""
        recs = self.records()
        batch = labeled_batch_from_avro(
            recs, vocab, dtype=dtype, sparse=sparse, nnz_per_row=nnz_per_row,
            allow_null_labels=allow_null_labels, device=device,
        )
        uids = np.asarray([r.get("uid") for r in recs], object)
        present = np.asarray([r.get("label") is not None for r in recs], bool)
        return batch, uids, present

    def game_data(
        self,
        shard_vocabs: Dict[str, FeatureVocabulary],
        entity_keys: List[str],
        entity_vocabs: Optional[Dict[str, dict]] = None,
        allow_null_labels: bool = False,
        sparse_shards: Optional[set] = None,
    ):
        """-> (GameData on the host, entity_vocabs, uids, label_present)."""
        recs = self.records()
        data, vocabs, uids = game_data_from_avro(
            recs,
            shard_vocabs,
            entity_keys,
            entity_vocabs=entity_vocabs,
            allow_null_labels=allow_null_labels,
            sparse_shards=sparse_shards,
        )
        present = np.asarray([r.get("label") is not None for r in recs], bool)
        return data, vocabs, uids, present


def make_training_example(
    label: float,
    features: Dict[Tuple[str, str], float],
    uid: Optional[str] = None,
    offset: Optional[float] = None,
    weight: Optional[float] = None,
) -> dict:
    """Synthesize a TrainingExampleAvro dict (test fixtures)."""
    return {
        "uid": uid,
        "label": float(label),
        "features": [
            {"name": n, "term": t, "value": float(v)}
            for (n, t), v in features.items()
        ],
        "metadataMap": None,
        "weight": weight,
        "offset": offset,
    }
