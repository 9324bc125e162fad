"""Ingest: Avro training records -> columnar arrays / LabeledBatch
(counterpart of ``photon_ml_tpu/io/ingest.py``).

Sparse (name, term, value) feature lists are indexed against a vocabulary,
duplicate (name, term) entries in one record are summed
(``DataProcessingUtils.scala:70-76`` dedup-by-sum), and the intercept column
is set to 1. Rows land in a dense float matrix or, with ``sparse=True``, in
a padded-ELL ``ops.sparse.SparseFeatures``. GAME input (``game_data``)
gets one matrix per feature shard, dense or padded-ELL, and one entity
index column per random-effect type. ``IngestSource`` reads through the
native C++ codec (:mod:`photon_ml_tpu_torch.io.native`) when it builds and
the writer schema is in its family, and through the pure-Python codec
otherwise, as the JAX package does; ``IngestSource.codec`` says which ran.
Every read goes through ``_resilient_read`` (the ``ingest.read`` fault
site, retried ``OSError``s, the ``io.ingest.*`` metrics), and every
assembled artifact feeds the installed quality fingerprint collector
(:mod:`photon_ml_tpu_torch.obs.quality`). ``IngestSource.build_vocab`` is
the native vocabulary scan. ``labeled_batch_streamed`` and
``game_data_streamed`` read through the streaming pipeline
(:mod:`photon_ml_tpu_torch.io.pipeline`), bit for bit the one-shot reads.
"""

from __future__ import annotations

import os
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from photon_ml_tpu_torch import obs
from photon_ml_tpu_torch.core.types import LabeledBatch
from photon_ml_tpu_torch.io.vocab import FeatureVocabulary, feature_key
from photon_ml_tpu_torch.obs import quality as _quality
from photon_ml_tpu_torch.resilience import faults as _faults
from photon_ml_tpu_torch.resilience import retry as _retry


def _host(x):
    """A tensor (on any device) as a numpy array; anything else as is."""
    return x.detach().cpu().numpy() if torch.is_tensor(x) else x


def _vocab_names(vocab, limit: int) -> List[str]:
    """Human names for a vocabulary's leading ``limit`` columns (the
    fingerprint cap) — ``name`` or ``name\\x01term`` rendered readable."""
    names = []
    for j in range(min(len(vocab), limit)):
        name, term = vocab.name_term(j)
        names.append(f"{name}\x01{term}" if term else str(name))
    return names


def _feed_fingerprint(features_by_shard, labels, weights, vocabs=None):
    """Feed the installed quality fingerprint collector (no-op when
    none is installed — the common case costs one global read). Dense
    (n, d) shards contribute per-column sketches, read on the host;
    sparse containers contribute labels/weights only."""
    coll = _quality.fingerprint_collector()
    if coll is None:
        return
    weights = _host(weights)
    for shard, m in (features_by_shard or {}).items():
        if getattr(m, "ndim", 0) != 2:
            continue
        vocab = (vocabs or {}).get(shard)
        coll.observe_rows(
            shard,
            np.asarray(_host(m)),
            weights,
            names=(_vocab_names(vocab, coll.max_features) if vocab is not None else None),
        )
    if labels is not None:
        coll.observe_labels(np.asarray(_host(labels)), weights)


def _feed_fingerprint_entities(entities, weights=None):
    coll = _quality.fingerprint_collector()
    if coll is None:
        return
    for kind, keys in (entities or {}).items():
        coll.observe_categorical(kind, keys, _host(weights))


def _resilient_read(fn, *args, label: str, logger=None, paths=None, **kwargs):
    """Run one input-read with the ``ingest.read`` fault site armed and
    transient ``OSError`` retried (backoff; resilience.retry). A flaky
    network filesystem — or an injected fault drill — costs a retry, not
    the run. Non-I/O errors (bad schema, bad records) propagate
    immediately.

    ``paths`` (the files this read covers) feeds the obs layer:
    ``io.ingest.files`` / ``io.ingest.bytes_read`` counters and a
    ``io.ingest.read_ms`` latency histogram, plus a span on the active
    tracer."""

    def attempt():
        _faults.fire("ingest.read")
        return fn(*args, **kwargs)

    t0 = time.perf_counter()
    with obs.span("io.ingest.read", cat="io", label=label):
        out = _retry.retry_call(attempt, retries=3, label=label, logger=logger)
    reg = obs.registry()
    reg.observe("io.ingest.read_ms", (time.perf_counter() - t0) * 1e3)
    for p in paths or ():
        reg.inc("io.ingest.files")
        try:
            reg.inc("io.ingest.bytes_read", os.path.getsize(p))
        except OSError:
            pass  # metrics must never fail a read that succeeded
    return out


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
    """Avro input files -> LabeledBatch or GameData: one native decode pass
    per artifact when the C++ codec builds and takes the files' schema,
    else the pure-Python codec, whose records are decoded once and cached.
    ``codec`` is the codec of the last artifact read ("native" or
    "python"; None before the first)."""

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
        self.codec: Optional[str] = None
        self._records: Optional[List[dict]] = None

    @property
    def label_field(self) -> str:
        return "response" if self.field_names == RESPONSE_PREDICTION_FIELDS else "label"

    def _check_nonempty(self, n: int):
        """Valid-but-empty inputs fail loudly here rather than training a
        degenerate model."""
        if n == 0:
            raise ValueError(f"no records found in {self.files}")

    def records(self) -> List[dict]:
        """Decoded records (cached); raises on a valid-but-empty input."""
        if self._records is None:
            from photon_ml_tpu_torch.io.avro import read_avro_file

            recs: List[dict] = []
            for f in self.files:
                _, r = _resilient_read(read_avro_file, f, label=f"read {f}", paths=[f])
                recs.extend(r)
            self._check_nonempty(len(recs))
            self._records = normalize_field_names(recs, self.field_names)
        return self._records

    def _read_native(self, vocabs, entity_keys, allow_null_labels):
        """The native codec's columns, or None where it does not build or
        refuses the schema (the caller takes the Python codec)."""
        from photon_ml_tpu_torch.io import native

        if not native.native_available():
            return None
        try:
            out = _resilient_read(
                native.read_columnar, self.files, vocabs, entity_keys,
                label_field=self.label_field, allow_null_labels=allow_null_labels,
                label=f"native read {self.files}", paths=self.files,
            )
        except native.UnsupportedSchema:
            return None
        self._check_nonempty(out["n"])
        return out

    def build_vocab(
        self,
        add_intercept: bool = True,
        selected_keys: Optional[set] = None,
    ) -> FeatureVocabulary:
        """Distinct (name, term) scan (``FeatureIndexingJob`` analog): the
        native parallel scan when the C++ codec builds, the Python codec's
        records only where the native reader refuses the schema."""
        from photon_ml_tpu_torch.io import native

        if native.native_available():
            try:
                keys, n_scanned = native.scan_feature_keys(
                    self.files, label_field=self.label_field
                )
                # a valid-but-empty input fails here exactly as the Python
                # path does, not with an intercept-only vocabulary
                self._check_nonempty(n_scanned)
                self.codec = "native"
                if selected_keys is not None:
                    keys = [k for k in keys if k in selected_keys]
                return FeatureVocabulary(sorted(keys), add_intercept=add_intercept)
            except native.UnsupportedSchema:
                pass
        self.codec = "python"
        return FeatureVocabulary.from_records(
            self.records(), add_intercept=add_intercept, selected_keys=selected_keys
        )

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
        out = self._read_native([vocab], (), allow_null_labels)
        if out is None:
            self.codec = "python"
            recs = self.records()
            batch = labeled_batch_from_avro(
                recs, vocab, dtype=dtype, sparse=sparse, nnz_per_row=nnz_per_row,
                allow_null_labels=allow_null_labels, device=device,
            )
            uids = np.asarray([r.get("uid") for r in recs], object)
            present = np.asarray([r.get("label") is not None for r in recs], bool)
            _feed_fingerprint({"features": batch.features}, batch.labels,
                              batch.effective_weights(), vocabs={"features": vocab})
            return batch, uids, present
        self.codec = "native"
        n = out["n"]
        rows, cols, vals = _inject_intercept(*out["coo"][0], n, vocab.intercept_index)
        dtype = dtype or torch.float32
        if sparse:
            from photon_ml_tpu_torch.ops.sparse import from_coo

            features = from_coo(rows, cols, vals, n, len(vocab), nnz_per_row=nnz_per_row,
                                dtype=dtype, device=device)
        else:
            features = np.zeros((n, len(vocab)), np.float64)
            np.add.at(features, (rows.astype(np.int64), cols.astype(np.int64)), vals)
        batch = LabeledBatch.create(
            features, out["labels"], offsets=out["offsets"], weights=out["weights"],
            dtype=dtype, device=device,
        )
        _feed_fingerprint({"features": features}, out["labels"], out["weights"],
                          vocabs={"features": vocab})
        return batch, out["uids"], out["label_present"]

    def labeled_batch_streamed(
        self,
        vocab: FeatureVocabulary,
        dtype: Optional[torch.dtype] = None,
        allow_null_labels: bool = False,
        chunk_mb: Optional[float] = None,
        decode_threads: int = 0,
        prefetch_depth: Optional[int] = None,
        stage_timeout_s: Optional[float] = None,
        epoch_policy: str = "fail",
        device="cpu",
        stats=None,
    ) -> Tuple[LabeledBatch, np.ndarray, np.ndarray]:
        """-> (LabeledBatch on ``device``, uids, label_present) through the
        streaming pipeline: the files decode on a bounded thread pool, the
        decoded columns stage into a ring of uniform ``chunk_mb`` row
        blocks (pinned for a CUDA device), and each block is copied into
        its rows of the dataset's preallocated tensors on a side stream
        while the next decodes. Bit for bit :meth:`labeled_batch` (dense);
        the fingerprint is fed per staged chunk. ``stats`` (a
        ``PipelineStats``) collects the pipeline's stage times."""
        from photon_ml_tpu_torch.io import native
        from photon_ml_tpu_torch.io import pipeline as pipeline_mod

        if not native.native_available():
            raise RuntimeError(
                "streamed ingest requires the native reader "
                "(io.native); use labeled_batch() for the Python codec"
            )
        config = pipeline_mod.config_for(chunk_mb, decode_threads, prefetch_depth,
                                         stage_timeout_s, epoch_policy)
        try:
            with pipeline_mod.IngestPipeline(
                self.files, [vocab], label_field=self.label_field,
                allow_null_labels=allow_null_labels, config=config, stats=stats,
            ) as pipe:
                out = pipe.labeled_batch(dtype=dtype, device=device)
        except native.UnsupportedSchema as e:
            raise RuntimeError(
                f"streamed ingest: native reader rejected {self.files!r} "
                f"({e}); use labeled_batch()"
            )
        self.codec = "native"
        return out

    def game_data_streamed(
        self,
        shard_vocabs: Dict[str, FeatureVocabulary],
        entity_keys: List[str],
        entity_vocabs: Optional[Dict[str, dict]] = None,
        allow_null_labels: bool = False,
        sparse_shards: Optional[set] = None,
        chunk_mb: Optional[float] = None,
        decode_threads: int = 0,
        prefetch_depth: Optional[int] = None,
        stage_timeout_s: Optional[float] = None,
        epoch_policy: str = "fail",
        stats=None,
    ):
        """-> (GameData on the host, entity_vocabs, uids, label_present),
        decoded by the streaming pipeline's bounded pool in place of the
        one-shot map: the output of :meth:`game_data` on the same files
        (the shard assembly, entity indexing and label policy are shared
        code)."""
        from photon_ml_tpu_torch.game.data import GameData
        from photon_ml_tpu_torch.io import native
        from photon_ml_tpu_torch.io import pipeline as pipeline_mod

        if not native.native_available():
            raise RuntimeError(
                "streamed ingest requires the native reader "
                "(io.native); use game_data() for the Python codec"
            )
        shards = list(shard_vocabs)
        config = pipeline_mod.config_for(chunk_mb, decode_threads, prefetch_depth,
                                         stage_timeout_s, epoch_policy)
        try:
            with pipeline_mod.IngestPipeline(
                self.files, [shard_vocabs[s] for s in shards],
                entity_keys=tuple(entity_keys), label_field=self.label_field,
                allow_null_labels=allow_null_labels, config=config, stats=stats,
            ) as pipe:
                out = pipe.read_columnar()
        except native.UnsupportedSchema as e:
            raise RuntimeError(
                f"streamed ingest: native reader rejected {self.files!r} "
                f"({e}); use game_data()"
            )
        self._check_nonempty(out["n"])
        self.codec = "native"
        n = out["n"]
        features = _assemble_shard_features(
            shard_vocabs, {shard: out["coo"][si] for si, shard in enumerate(shards)}, n,
            sparse_shards,
        )
        entity_ids, out_vocabs = index_entity_strings(
            {k: out["entities"][k] for k in entity_keys}, entity_vocabs
        )
        data = GameData.create(
            features=features, labels=out["labels"], offsets=out["offsets"],
            weights=out["weights"], entity_ids=entity_ids,
        )
        _feed_fingerprint(features, out["labels"], out["weights"], vocabs=shard_vocabs)
        _feed_fingerprint_entities({k: out["entities"][k] for k in entity_keys},
                                   out["weights"])
        return data, out_vocabs, out["uids"], out["label_present"]

    def game_data(
        self,
        shard_vocabs: Dict[str, FeatureVocabulary],
        entity_keys: List[str],
        entity_vocabs: Optional[Dict[str, dict]] = None,
        allow_null_labels: bool = False,
        sparse_shards: Optional[set] = None,
    ):
        """-> (GameData on the host, entity_vocabs, uids, label_present)."""
        from photon_ml_tpu_torch.game.data import GameData

        shards = list(shard_vocabs)
        out = self._read_native([shard_vocabs[s] for s in shards], tuple(entity_keys),
                                allow_null_labels)
        if out is None:
            self.codec = "python"
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
            _feed_fingerprint(dict(data.features), data.labels, np.asarray(data.weights),
                              vocabs=shard_vocabs)
            return data, vocabs, uids, present
        self.codec = "native"
        n = out["n"]
        features = _assemble_shard_features(
            shard_vocabs, {shard: out["coo"][si] for si, shard in enumerate(shards)}, n,
            sparse_shards,
        )
        entity_ids, out_vocabs = index_entity_strings(
            {k: out["entities"][k] for k in entity_keys}, entity_vocabs
        )
        data = GameData.create(
            features=features, labels=out["labels"], offsets=out["offsets"],
            weights=out["weights"], entity_ids=entity_ids,
        )
        _feed_fingerprint(features, out["labels"], out["weights"], vocabs=shard_vocabs)
        _feed_fingerprint_entities({k: out["entities"][k] for k in entity_keys},
                                   out["weights"])
        return data, out_vocabs, out["uids"], out["label_present"]


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
