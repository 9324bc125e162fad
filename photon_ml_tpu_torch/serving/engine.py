"""Device-resident online GAME scoring engine (counterpart of
``photon_ml_tpu/serving/engine.py``).

The offline driver (``cli/score.py``) is a batch job: load model, score one
big dataset, exit. A resident engine loads the GAME model once, keeps it on
the card, and answers small concurrent requests at low latency. The JAX
package's three design rules, and what each becomes here:

1. **Device residency.** The fixed-effect vector, every random-effect
   table (pre-compacted through :class:`~photon_ml_tpu_torch.game.scoring.
   CompactReTable`: (E, k) active pairs instead of a dense (E, d) slab) and
   the factored latent tables are placed on the device once at
   construction and passed to every call; a request moves only its own
   rows host -> device.

2. **Power-of-two padded buckets.** Every batch is padded to the next
   power of two (floor ``min_bucket``). The JAX engine compiles one XLA
   executable per bucket ahead of time. PyTorch traces nothing, so a
   bucket's counterpart is a prepared scorer (:class:`_BucketScorer`): its
   device input buffers for the bucket, allocated once, and one trial run
   so the caching allocator holds the call's working set. Building one is
   counted in ``compile_count``, ``stats.record_compile()`` and the
   process-wide :func:`~photon_ml_tpu_torch.serving.stats.bucket_builds`,
   and shared through :class:`SharedCompileCache` by the same structural
   key. After warmup on a fixed bucket set, steady-state traffic builds
   nothing and asks the CUDA allocator for no new memory segment.

3. **Cold-start = fixed-effect-only.** A request whose entity id is unknown
   (or absent) carries index -1, and every random-effect scorer scores it 0
   — the reference's cogroup-with-default-0 semantics
   (``model/RandomEffectModel.scala:117-146``), equal to ``score_game_data``
   on the same rows.

Requests are featurized densely on the host (one (B, d) array per shard),
as in the JAX engine; the device work is a dense product per fixed effect,
a compact-table gather per random effect and a factored gather, the plain
tensor operations of :mod:`photon_ml_tpu_torch.game.scoring`. ``device=None``
means the card and raises without one.

The engine is synchronous and thread-safe for scoring; coalescing of
concurrent requests belongs to :mod:`.batcher`, versioning/hot-reload to
:mod:`.registry`. With a baseline (``baseline=``, or the export's
``quality-fingerprint.json`` read by ``from_model_dir``) the engine carries
a :class:`~photon_ml_tpu_torch.obs.quality.DriftMonitor` that samples the
unpadded host features and the scores of every batch that is not
fixed-effect-only. The entity-sharded engine is the subclass in
:mod:`.sharding` (its hooks: ``_precompact``, ``_pin_params``,
``_build_scorer`` and ``_placement_fingerprint``, which keys the shared
scorer cache by placement). Each built bucket scorer books its analytic
cost in the process cost book (:meth:`ScoringEngine._record_cost`, keyed
``"serving.score"`` and the bucket, ``"<bucket>-fixed"`` for the degraded
ladder), and a traced ``serving.score`` span carries the cost book's
shares over its synchronized window (``bytes_per_s``; ``hbm_util`` and
``mfu`` on an H100, None elsewhere).
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from typing import Callable, Dict, Mapping, Optional, Sequence

import numpy as np
import torch

from photon_ml_tpu_torch import obs
from photon_ml_tpu_torch.game.data import GameData
from photon_ml_tpu_torch.game.factored import is_factored_params
from photon_ml_tpu_torch.game.scoring import (
    CompactReTable,
    _factored_scores,
    _fixed_scores,
    _placed,
    _random_scores_compact_dense,
    precompact_model,
)
from photon_ml_tpu_torch.io.schemas import NAME_TERM_DELIMITER
from photon_ml_tpu_torch.ops.sparse import SparseFeatures, is_sparse, is_structured
from photon_ml_tpu_torch.resilience import faults as _faults
from photon_ml_tpu_torch.serving.stats import ServingStats, record_build
from photon_ml_tpu_torch.utils.device import resolve_device, to_numpy

DEFAULT_MIN_BUCKET = 8
DEFAULT_MAX_BUCKET = 1024


def bucket_size(n: int, min_bucket: int = DEFAULT_MIN_BUCKET) -> int:
    """Smallest power of two >= max(n, min_bucket): the shared padded-batch
    policy of the online engine and the offline driver (``cli/score.py``)."""
    if n <= 0:
        raise ValueError(f"batch must be non-empty, got {n} rows")
    return 1 << (max(n, min_bucket) - 1).bit_length()


def warmup_buckets(
    max_batch: int, min_bucket: int = DEFAULT_MIN_BUCKET
) -> Sequence[int]:
    """The power-of-two ladder [bucket_size(min_bucket) .. bucket_size(
    max_batch)]: the fixed bucket set to build so any batch of at most
    ``max_batch`` rows scores without a build."""
    out = []
    b = bucket_size(1, min_bucket)
    top = bucket_size(max_batch, min_bucket)
    while b <= top:
        out.append(b)
        b *= 2
    return out


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


def _host_tensor(x: np.ndarray) -> torch.Tensor:
    """A host array as a CPU tensor without a copy where numpy allows
    (torch cannot wrap a read-only array: that one is copied)."""
    x = np.ascontiguousarray(x)
    if not x.flags.writeable:
        x = x.copy()
    return torch.from_numpy(x)


class SharedCompileCache:
    """Process-wide bucket-scorer ladder shared across engines.

    Bucket scorers take the model params as ARGUMENTS, so a scorer depends
    only on the engine's structural signature — class, coordinate order,
    shard map, RE keys, param shapes/dtypes, placement, and the per-call
    (bucket, dims, fixed_only) contract — never on the weights. N tenants
    serving same-shaped models share ONE build per bucket.

    Thread-safe with build-once semantics: a per-key lock means two tenants
    warming the same bucket concurrently build once and both get the
    survivor, without serializing builds for DIFFERENT keys behind one
    global lock.
    """

    def __init__(self):
        self._cache: Dict[tuple, object] = {}
        self._locks: Dict[tuple, threading.Lock] = {}
        self._meta = threading.Lock()
        self.hits = 0
        self.compiles = 0

    def get(self, key: tuple, build: Callable[[], object]) -> object:
        with self._meta:
            hit = self._cache.get(key)
            if hit is not None:
                self.hits += 1
                return hit
            lock = self._locks.setdefault(key, threading.Lock())
        with lock:
            with self._meta:
                hit = self._cache.get(key)
                if hit is not None:
                    self.hits += 1
                    return hit
            built = build()
            with self._meta:
                self._cache[key] = built
                self.compiles += 1
            return built

    def snapshot(self) -> dict:
        with self._meta:
            return {
                "entries": len(self._cache),
                "hits": int(self.hits),
                "compiles": int(self.compiles),
            }


class _BucketScorer:
    """One padded bucket's prepared scorer: the counterpart of the JAX
    engine's AOT executable. Holds the bucket's device input buffers (a
    (bucket, d) feature buffer per shard, a (bucket,) entity buffer per RE
    key) and a lock, since concurrent calls on one bucket share them. A
    call copies the batch's n rows into the buffers (the rows past n are
    zeroed, the entity rows past n set to -1), runs the engine's scoring
    body on the device and returns the n scores on the host."""

    def __init__(self, engine: "ScoringEngine", bucket: int, dims: Dict[str, int],
                 fixed_only: bool):
        self.bucket = bucket
        self.fixed_only = fixed_only
        device = engine.device
        self.feats = {
            s: torch.zeros((bucket, dims[s]), dtype=engine.dtype, device=device)
            for s in engine._used_shards
        }
        self.ents = {} if fixed_only else {
            rk: torch.full((bucket,), -1, dtype=torch.int64, device=device)
            for rk in engine._re_keys
        }
        self._lock = threading.Lock()

    def __call__(self, engine: "ScoringEngine", params, feats: Dict[str, np.ndarray],
                 ents: Dict[str, np.ndarray], n: int) -> np.ndarray:
        with self._lock:
            for s, buf in self.feats.items():
                buf[:n].copy_(_host_tensor(feats[s]))
                if n < self.bucket:
                    buf[n:].zero_()
            for rk, buf in self.ents.items():
                buf.copy_(_host_tensor(_pad_rows(ents[rk], self.bucket, fill=-1)))
            if self.fixed_only:
                out = engine._score_padded_fixed(params, self.feats)
            else:
                out = engine._score_padded(params, self.feats, self.ents)
            return to_numpy(out[:n])


@dataclasses.dataclass
class ScoreRequest:
    """One scoring request.

    features: feature -> value; keys are ``"name\\x01term"`` strings,
        ``(name, term)`` tuples, or bare names (empty term). Applied
        against every shard's vocabulary — each shard picks the features
        it knows, exactly like ingest; unknown keys are ignored.
    entities: random-effect type -> raw entity id (missing or unknown ids
        score fixed-effect-only).
    offset: added to the returned score (the data offset column).
    """

    features: Mapping
    entities: Mapping = dataclasses.field(default_factory=dict)
    offset: float = 0.0


class ScoringEngine:
    """In-process online scorer for one loaded GAME model version.

    Construct from in-memory params (``ScoringEngine(params, shards,
    random_effects, shard_vocabs, re_vocabs)``) or straight from a model
    export directory (:meth:`from_model_dir`). Scoring entry points:

    - :meth:`score` — featurize :class:`ScoreRequest` objects and score.
    - :meth:`score_arrays` — pre-featurized (B, d) arrays per shard.
    - :meth:`score_data` — a dense-sharded :class:`GameData` (offline
      parity testing; returns margins WITHOUT offsets, like
      ``score_game_data``).
    """

    def __init__(
        self,
        params: Dict[str, object],
        shards: Dict[str, str],
        random_effects: Dict[str, Optional[str]],
        shard_vocabs: Optional[Dict[str, object]] = None,
        re_vocabs: Optional[Dict[str, dict]] = None,
        *,
        dtype: torch.dtype = torch.float64,
        min_bucket: int = DEFAULT_MIN_BUCKET,
        max_bucket: int = DEFAULT_MAX_BUCKET,
        device=None,
        stats: Optional[ServingStats] = None,
        baseline=None,
        drift=None,
        hbm_cache_entities: Optional[int] = None,
        admission_log_path: Optional[str] = None,
        compile_cache: Optional["SharedCompileCache"] = None,
    ):
        self.device = resolve_device(device)
        self.dtype = dtype
        self.np_dtype = torch.empty((), dtype=dtype).numpy().dtype
        self.min_bucket = min_bucket
        self.max_bucket = max_bucket
        self.shards = dict(shards)
        self.random_effects = dict(random_effects)
        self.shard_vocabs = dict(shard_vocabs or {})
        self.re_vocabs = dict(re_vocabs or {})
        self.stats = stats if stats is not None else ServingStats()
        # drift monitor: live request-feature/score sketches vs the model's
        # train-time baseline (obs.quality). It lives ON the engine, so a
        # registry hot reload swaps the baseline atomically with the model;
        # gauges and events go to this engine's stats registry
        if drift is not None:
            self.drift = drift
        elif baseline is not None:
            from photon_ml_tpu_torch.obs.quality import DriftMonitor

            self.drift = DriftMonitor(baseline, registry=self.stats.registry)
        else:
            self.drift = None
        self._coord_order = sorted(params)
        self._used_shards = sorted({self.shards[name] for name in self._coord_order})
        # feature dims observable from the raw params (dense tables, fixed
        # vectors, factored projections) — the warmup fallback when a shard
        # has no vocabulary and its params arrive already compacted
        self._shard_dim_hints: Dict[str, int] = {}
        for name, p in params.items():
            shard = self.shards[name]
            if is_factored_params(p):
                self._shard_dim_hints[shard] = int(np.shape(p.projection)[0])
            elif not isinstance(p, CompactReTable) and np.ndim(p) in (1, 2):
                self._shard_dim_hints[shard] = int(np.shape(p)[-1])
        self._re_keys = sorted(
            {rk for rk in self.random_effects.values() if rk is not None}
        )
        # fixed-effect-only coordinates: the degraded-mode scoring set
        # (admission control's "cheaper answer for everyone" fallback)
        self._fixed_coords = [
            name for name in self._coord_order
            if self.random_effects.get(name) is None
        ]
        compact = self._precompact(params)
        # repeat-miss admission log (serving/cache.py): tiered-cache misses
        # and unknown entity ids, by entity key
        self._admission = None
        if admission_log_path:
            from photon_ml_tpu_torch.serving.cache import AdmissionLog

            self._admission = AdmissionLog(admission_log_path, stats=self.stats)
        # tiered HBM/host entity cache (serving/cache.py): one cache per RE
        # key so every coordinate sharing that key agrees on slot ids
        self._caches: Dict[str, object] = {}
        if hbm_cache_entities:
            compact = self._install_caches(compact, int(hbm_cache_entities))
        self._params = self._pin_params(compact)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._compiled: Dict[object, _BucketScorer] = {}
        self._lock = threading.Lock()
        self.compile_count = 0
        # optional process-wide scorer sharing: params are ARGUMENTS of
        # every bucket scorer, so engines whose structural signature
        # matches share one ladder
        self._shared_cache = compile_cache
        self.shared_compile_hits = 0

    # -- construction hooks ------------------------------------------------

    def _precompact(self, params: Dict[str, object]) -> Dict[str, object]:
        """Params -> compact serving form (every (E, d) table becomes a
        :class:`CompactReTable`)."""
        return precompact_model(params)

    def _pin_params(self, compact: Dict[str, object]) -> Dict[str, object]:
        """Place the compact params on the device at the serving dtype
        (compact columns stay int32) and publish the resident-footprint
        gauge. A cached coordinate's tier tensors are already there and
        are kept as they are (``_placed`` returns a tensor that needs no
        move or cast unchanged)."""
        out: Dict[str, object] = {}
        re_bytes = 0
        for name, p in compact.items():
            re_key = self.random_effects.get(name)
            if isinstance(p, CompactReTable):
                out[name] = CompactReTable(
                    columns=_placed(p.columns, torch.int32, self.device),
                    values=_placed(p.values, self.dtype, self.device),
                )
                re_bytes += out[name].columns.nbytes + out[name].values.nbytes
            elif is_factored_params(p):
                out[name] = type(p)(
                    gamma=_placed(p.gamma, self.dtype, self.device),
                    projection=_placed(p.projection, self.dtype, self.device),
                )
                if re_key is not None:
                    re_bytes += out[name].gamma.nbytes
            else:
                out[name] = _placed(p, self.dtype, self.device)
        # per-process resident entity-table footprint; the tiered cache
        # reports its device tier, not the host-RAM tail
        self.stats.registry.set_gauge(
            "serving.shard.resident_re_bytes_per_process", re_bytes
        )
        return out

    def _install_caches(
        self, compact: Dict[str, object], capacity: int
    ) -> Dict[str, object]:
        """Stand up one :class:`~photon_ml_tpu_torch.serving.cache.
        TieredEntityCache` per RE key over every entity-keyed table and
        return params whose entity tables are the device-tier tensors.
        Promotion writes the tiers in place (contents, never shapes), so
        these params and the bucket scorers stay valid for the engine's
        life."""
        from photon_ml_tpu_torch.serving.cache import TieredEntityCache

        sizes: Dict[str, int] = {}
        for name in self._coord_order:
            re_key = self.random_effects.get(name)
            p = compact[name]
            if re_key is None:
                continue
            rows = int(np.shape(p.gamma if is_factored_params(p) else p.columns)[0])
            if sizes.setdefault(re_key, rows) != rows:
                raise ValueError(
                    f"coordinate {name!r}: {rows} entity rows, other "
                    f"coordinates keyed {re_key!r} have {sizes[re_key]}"
                )
        for re_key, rows in sizes.items():
            # admission-log key resolver: global row index -> raw vocab
            # key, so the log speaks entity KEYS, never positions
            reverse = {
                idx: raw for raw, idx in (self.re_vocabs.get(re_key) or {}).items()
            }
            self._caches[re_key] = TieredEntityCache(
                re_key,
                num_entities=rows,
                capacity=capacity,
                dtype=self.dtype,
                device=self.device,
                stats=self.stats,
                admission_log=self._admission,
                entity_key_of=(
                    (lambda e, _r=reverse: str(_r.get(e, e))) if reverse else None
                ),
            )
        out = dict(compact)
        for name in self._coord_order:
            re_key = self.random_effects.get(name)
            if re_key is None:
                continue
            cache = self._caches[re_key]
            p = compact[name]
            if isinstance(p, CompactReTable):
                cache.add_table(name, "columns", to_numpy(p.columns, np.int32))
                cache.add_table(name, "values", to_numpy(p.values, self.np_dtype))
            elif is_factored_params(p):
                cache.add_table(name, "gamma", to_numpy(p.gamma, self.np_dtype))
            else:  # pragma: no cover — precompact leaves only these kinds
                raise ValueError(f"coordinate {name!r}: cannot cache {type(p).__name__}")
        for cache in self._caches.values():
            cache.seal()
        for re_key, cache in self._caches.items():
            tiers = cache.device_tables()
            for name in self._coord_order:
                if self.random_effects.get(name) != re_key:
                    continue
                p = out[name]
                if isinstance(p, CompactReTable):
                    out[name] = CompactReTable(
                        columns=tiers[(name, "columns")], values=tiers[(name, "values")]
                    )
                else:
                    out[name] = type(p)(gamma=tiers[(name, "gamma")],
                                        projection=p.projection)
        return out

    @contextlib.contextmanager
    def _cache_hold(self):
        """Hold every tiered cache's lock (RE keys in sorted order) for one
        scoring call: slot resolution and the device reads of the tier
        must see the same tier contents, and promotion writes the tier in
        place under the same lock."""
        with contextlib.ExitStack() as stack:
            for re_key in sorted(self._caches):
                stack.enter_context(self._caches[re_key].hold())
            yield

    def _translate_entities(self, entity_ids: Dict[str, np.ndarray]):
        """Global entity indices -> ids the scorers gather with. Without a
        cache: the identity. With one (the caller holds
        :meth:`_cache_hold`), each RE key's ids map to device-tier slots —
        a miss maps to -1 (fixed-effect-only for that row, == cold-start
        semantics) and enqueues an async promotion; a miss costs fidelity
        on that request, never a stall of the batch."""
        if not self._caches:
            return entity_ids
        out = dict(entity_ids)
        for re_key in sorted(self._caches):
            col = entity_ids.get(re_key)
            if col is not None:
                out[re_key] = self._caches[re_key].translate(np.asarray(col, np.int32))
        return out

    def cache_snapshot(self) -> Optional[dict]:
        """Hit/miss/promotion/demotion counters per RE key (None when no
        tiered cache is installed)."""
        if not self._caches:
            return None
        return {rk: c.snapshot() for rk, c in sorted(self._caches.items())}

    def admission_snapshot(self) -> Optional[dict]:
        """Repeat-miss admission-log state (None when no log is
        configured) — surfaced through registry ``health()``."""
        if self._admission is None:
            return None
        return self._admission.snapshot()

    @property
    def admission_log(self):
        return self._admission

    def close(self) -> None:
        """Release background resources (cache promotion workers, the
        admission log's final flush). The registry calls this when a
        version retires; idempotent."""
        for cache in self._caches.values():
            cache.close()
        if self._admission is not None:
            self._admission.flush()

    # -- construction ------------------------------------------------------

    @classmethod
    def from_model_dir(cls, root: str, **kw) -> "ScoringEngine":
        """Load a GAME model export (training-output layout, written by
        either package) and stand up an engine over it. Integrity
        verification belongs to the registry (:mod:`.registry`) — this
        loads whatever is on disk. The export's quality fingerprint, when
        present and readable, becomes the engine's drift baseline; a
        missing or corrupt one is counted (``quality.baseline_*``) and the
        engine serves without drift monitoring — never refuses to serve."""
        from photon_ml_tpu_torch.io.models import load_game_model_auto
        from photon_ml_tpu_torch.obs.quality import try_load_fingerprint

        params, shards, random_effects, shard_vocabs, re_vocabs = load_game_model_auto(root)
        if "baseline" not in kw and "drift" not in kw:
            kw = dict(kw, baseline=try_load_fingerprint(root))
        return cls(params, shards, random_effects, shard_vocabs, re_vocabs, **kw)

    # -- scoring body ------------------------------------------------------

    def _score_padded(self, params, feats, ents):
        """Sum of coordinate scores over padded (B, d) dense shards on the
        device, with the scoring functions ``score_game_data`` uses, so
        online and offline scores agree to float rounding."""
        n = feats[self._used_shards[0]].shape[0]
        total = torch.zeros((n,), dtype=self.dtype, device=self.device)
        for name in self._coord_order:
            p = params[name]
            f = feats[self.shards[name]]
            re_key = self.random_effects.get(name)
            if re_key is None:
                total = total + _fixed_scores(p, f)
            elif is_factored_params(p):
                total = total + _factored_scores(p.gamma, p.projection, f, ents[re_key])
            else:
                total = total + _random_scores_compact_dense(
                    p.columns, p.values, f, ents[re_key]
                )
        return total

    def _score_padded_fixed(self, params, feats):
        """Degraded-mode body: ONLY the fixed-effect coordinates. No entity
        gathers, no random-effect tables touched — the cheap scorer
        admission control falls back to under sustained pressure. A model
        with no fixed coordinate scores 0 (the cold-start value every
        random effect already returns)."""
        n = feats[self._used_shards[0]].shape[0]
        total = torch.zeros((n,), dtype=self.dtype, device=self.device)
        for name in self._fixed_coords:
            total = total + _fixed_scores(params[name], feats[self.shards[name]])
        return total

    # -- the bucket ladder -------------------------------------------------

    def _ensure_compiled(
        self,
        bucket: int,
        dims: Optional[Dict[str, int]] = None,
        fixed_only: bool = False,
    ) -> _BucketScorer:
        """Scorer for one padded bucket; ``dims`` (shard -> feature dim)
        defaults to the vocabularies' lengths. Shard dims are a fixed
        property of the model, so the ladder keys on (bucket, mode)."""
        cache_key = (bucket, "fixed") if fixed_only else bucket
        with self._lock:
            hit = self._compiled.get(cache_key)
        if hit is not None:
            self.stats.record_bucket(bucket, hit=True)
            return hit

        fresh = [False]

        def _build():
            fresh[0] = True
            return self._build_scorer(bucket, dims, fixed_only)

        if self._shared_cache is not None:
            # local miss: consult the process-wide ladder keyed by the
            # engine's structural signature
            scorer = self._shared_cache.get(
                self._compile_cache_key(bucket, dims, fixed_only), _build
            )
            if not fresh[0]:
                self.shared_compile_hits += 1
        else:
            scorer = _build()
        with self._lock:
            prior = self._compiled.setdefault(cache_key, scorer)
        if prior is scorer and fresh[0]:
            self.compile_count += 1
            self.stats.record_compile()
        self.stats.record_bucket(bucket, hit=False)
        return prior

    def _build_scorer(self, bucket, dims, fixed_only) -> _BucketScorer:
        """Allocate one bucket's input buffers and run the scoring body
        once on them (zero rows, every entity -1), so that the caching
        allocator already holds what a call of this bucket needs."""
        t0 = time.perf_counter()
        dims = dims or {s: self._shard_dim(s) for s in self._used_shards}
        scorer = _BucketScorer(self, bucket, dims, fixed_only)
        zeros = {s: np.zeros((0, dims[s]), self.np_dtype) for s in self._used_shards}
        none = {rk: np.zeros(0, np.int32) for rk in self._re_keys}
        scorer(self, self._params, zeros, none, 0)
        record_build(bucket, fixed_only, time.perf_counter() - t0)
        self._record_cost(bucket, dims, fixed_only)
        return scorer

    def _record_cost(self, bucket, dims, fixed_only) -> None:
        """Book one call of a bucket's scoring body in the process cost
        book. FLOPs and the analytic bytes count each coordinate's gather
        and dot at the bucket's rows and widths: a fixed effect's (B, d)
        product, a compact table's (B, k) gather and pick, a factored
        effect's (B, d) x (d, r) product and (B, r) gather. The roofline
        bytes read each input once: every shard's feature buffer, every
        fixed vector and projection, each entity-id column, and of each
        resident table the rows a bucket can touch (at most B of them),
        plus the (B,) scores written."""
        item = torch.empty((), dtype=self.dtype).element_size()
        b = int(bucket)
        names = self._fixed_coords if fixed_only else self._coord_order
        flops = 0.0
        analytic = 0.0
        roofline = float(b * item)
        for s in {self.shards[name] for name in names}:
            roofline += float(b * dims[s] * item)
        if not fixed_only:
            roofline += float(b * 8 * len(self._re_keys))
        for name in names:
            p = self._params[name]
            d = int(dims[self.shards[name]])
            if self.random_effects.get(name) is None:
                flops += 2.0 * b * d
                analytic += float((b * d + d) * item)
                roofline += float(d * item)
            elif is_factored_params(p):
                e, r = (int(x) for x in p.gamma.shape)
                flops += 2.0 * b * d * r + 2.0 * b * r
                analytic += float((b * d + d * r + b * r) * item + b * 8)
                roofline += float((d * r + min(b, e) * r) * item)
            else:
                e, k = (int(x) for x in p.columns.shape)
                flops += 2.0 * b * k
                analytic += float(b * k * (4 + 2 * item) + b * 8)
                roofline += float(min(b, e) * k * (4 + item))
        obs.cost_book().record(
            "serving.score", f"{b}-fixed" if fixed_only else str(b),
            analytic_flops=flops, analytic_bytes=analytic + b * item,
            roofline_bytes=roofline, dtype=self.dtype)

    def _compile_cache_key(self, bucket, dims, fixed_only) -> tuple:
        """Structural signature under which this engine's scorers are
        shareable: everything the scoring body depends on EXCEPT the
        weight values."""
        leaves = []
        for name in self._coord_order:
            p = self._params[name]
            if isinstance(p, CompactReTable):
                leaves += [p.columns, p.values]
            elif is_factored_params(p):
                leaves += [p.gamma, p.projection]
            else:
                leaves.append(p)
        return (
            type(self).__name__,
            self._placement_fingerprint(),
            tuple(self._coord_order),
            tuple(sorted(self.shards.items())),
            tuple(sorted(self.random_effects.items())),
            str(self.dtype),
            tuple(type(self._params[n]).__name__ for n in self._coord_order),
            tuple((tuple(t.shape), str(t.dtype)) for t in leaves),
            int(bucket),
            tuple(sorted(dims.items())) if dims else None,
            bool(fixed_only),
        )

    def _placement_fingerprint(self) -> str:
        """Where the scorers' buffers live — part of the shared-cache key
        because a scorer's buffers serve one device."""
        return repr(self.device)

    def _shard_dim(self, shard: str) -> int:
        """Feature dimension of a shard, from its vocab or its params."""
        if shard in self.shard_vocabs:
            return len(self.shard_vocabs[shard])
        if shard in self._shard_dim_hints:
            return self._shard_dim_hints[shard]
        for name in self._coord_order:
            if self.shards[name] != shard:
                continue
            p = self._params[name]
            if isinstance(p, CompactReTable):
                # compact pad column id == d by construction
                raise ValueError(
                    f"shard {shard!r}: dimension unknown without a "
                    "vocabulary (compact tables do not carry d)"
                )
            if is_factored_params(p):
                return int(p.projection.shape[0])
            return int(np.shape(p)[-1])
        raise KeyError(f"no coordinate uses shard {shard!r}")

    def warmup(
        self,
        buckets: Optional[Sequence[int]] = None,
        max_batch: Optional[int] = None,
        include_degraded: bool = False,
    ) -> Sequence[int]:
        """Build the scorers for a fixed bucket set (default: the
        power-of-two ladder up to ``max_batch`` or ``max_bucket``). After
        this, any batch of at most the largest warmed bucket scores with
        zero builds. ``include_degraded`` also builds the fixed-effect-only
        ladder, so the FIRST degraded batch under overload doesn't pay a
        build right when latency matters most. Returns the warmed
        buckets."""
        if buckets is None:
            buckets = warmup_buckets(max_batch or self.max_bucket, self.min_bucket)
        # watermark the warmup: the ladder's buffers are the engine's
        # device-memory commitment point (hbm.serving.warmup.* gauges)
        with obs.hbm_watermark("serving.warmup", device=self.device):
            for b in buckets:
                self._ensure_compiled(int(b))
                if include_degraded:
                    self._ensure_compiled(int(b), fixed_only=True)
        return list(buckets)

    # -- featurization (host-side, numpy only) -----------------------------

    def _feature_index(self, shard: str, key) -> Optional[int]:
        vocab = self.shard_vocabs[shard]
        if isinstance(key, tuple):
            return vocab.get(*key)
        if NAME_TERM_DELIMITER not in key:
            key = key + NAME_TERM_DELIMITER
        return vocab.key_to_index.get(key)

    def featurize(self, requests: Sequence[ScoreRequest]):
        """Requests -> (dense (B, d) per shard, (B,) int32 per RE type,
        (B,) offsets). Unknown feature keys are ignored (each shard picks
        what its vocabulary knows, like ingest); unknown entity ids map to
        -1 (cold start); shard intercept columns are set to 1.0 exactly as
        ingest injects them."""
        from photon_ml_tpu_torch.io.models import _maybe_int

        if not self.shard_vocabs:
            raise ValueError(
                "featurize needs shard vocabularies; construct the engine "
                "with shard_vocabs or use score_arrays/score_data"
            )
        b = len(requests)
        feats = {
            s: np.zeros((b, len(self.shard_vocabs[s])), self.np_dtype)
            for s in self._used_shards
        }
        for s in self._used_shards:
            icpt = self.shard_vocabs[s].intercept_index
            if icpt is not None:
                feats[s][:, icpt] = 1.0
        for i, r in enumerate(requests):
            for key, val in r.features.items():
                for s in self._used_shards:
                    j = self._feature_index(s, key)
                    if j is not None:
                        feats[s][i, j] = val
        ents = {rk: np.full(b, -1, np.int32) for rk in self._re_keys}
        for rk in self._re_keys:
            vocab = self.re_vocabs.get(rk, {})
            col = ents[rk]
            unknown = []
            for i, r in enumerate(requests):
                raw = r.entities.get(rk)
                if raw is None:
                    continue
                e = vocab.get(raw)
                if e is None:
                    e = vocab.get(_maybe_int(raw))
                if e is not None:
                    col[i] = e
                else:
                    unknown.append(str(raw))
            if unknown and self._admission is not None:
                # entities the model has never seen: the other half of
                # the admission stream (cache misses cover the known-
                # but-cold half)
                self._admission.note(rk, unknown)
        offsets = np.asarray([r.offset for r in requests], np.float64)
        return feats, ents, offsets

    # -- scoring -----------------------------------------------------------

    def score_arrays(
        self,
        features: Dict[str, np.ndarray],
        entity_ids: Optional[Dict[str, np.ndarray]] = None,
        offsets: Optional[np.ndarray] = None,
        fixed_only: bool = False,
    ) -> np.ndarray:
        """Score pre-featurized dense rows. ``features`` maps every shard
        the model uses to a (B, d_shard) array; ``entity_ids`` maps each
        random-effect type to (B,) int32 indices (-1 = unknown). With
        ``fixed_only`` the random-effect/factored coordinates are skipped
        (degraded mode: every row scores as if cold-start). Returns (B,)
        float scores (+ offsets when given) on the host."""
        entity_ids = entity_ids or {}
        missing = [s for s in self._used_shards if s not in features]
        if missing:
            raise KeyError(f"missing feature shard(s): {missing}")
        n = int(np.shape(features[self._used_shards[0]])[0])
        bucket = bucket_size(n, self.min_bucket)
        # chaos seam: device scoring. raise-mode surfaces through the
        # batcher to the request futures (engine state untouched, the NEXT
        # batch scores clean); delay-mode is the tail-latency drill;
        # corrupt-mode poisons the scores with NaN
        action = _faults.fire("serving.score", key=str(bucket))
        feats = {s: np.asarray(features[s], self.np_dtype) for s in self._used_shards}
        scorer = self._ensure_compiled(
            bucket,
            {s: feats[s].shape[1] for s in self._used_shards},
            fixed_only=fixed_only,
        )
        with contextlib.ExitStack() as stack:
            ents = {}
            unknown = 0
            if not fixed_only:
                stack.enter_context(self._cache_hold())
                translated = self._translate_entities(entity_ids)
                for rk in self._re_keys:
                    col = translated.get(rk)
                    col = np.full(n, -1, np.int32) if col is None else np.asarray(col, np.int32)
                    # rows scoring cold-start on this RE type
                    unknown += int(np.count_nonzero(col < 0))
                    ents[rk] = col
            with obs.span(
                "serving.score",
                cat="serving",
                bucket=bucket,
                rows=n,
                fixed_only=fixed_only,
                unknown_entities=unknown,
            ) as sp:
                t0 = time.perf_counter()
                out = scorer(self, self._params, feats, ents, n)
                if action.corrupt:
                    out = np.full_like(out, np.nan)
                elapsed = time.perf_counter() - t0
                # per-bucket latency of the copy in, the device work and the
                # copy out: the aggregate device_ms histogram cannot say
                # WHICH padded size is slow
                self.stats.record_bucket_latency(bucket, elapsed)
                if obs.get_tracer() is not None:
                    # the scores' copy to the host synchronized, so the
                    # window holds the whole call: the cost book's shares
                    # for this bucket
                    obs.annotate_span(
                        sp,
                        obs.cost_book().lookup(
                            "serving.score",
                            f"{bucket}-fixed" if fixed_only else str(bucket),
                        ),
                        seconds=elapsed,
                        device=self.device,
                    )
        if offsets is not None:
            out = out + np.asarray(offsets, out.dtype)
        if self.drift is not None and not fixed_only:
            # this batch's unpadded host features and scores into the live
            # drift window; degraded batches are skipped (fixed-effect-only
            # scores are another distribution by design, not model drift)
            self.drift.observe({s: np.asarray(features[s]) for s in self._used_shards}, out)
        return out

    def score(
        self, requests: Sequence[ScoreRequest], fixed_only: bool = False
    ) -> np.ndarray:
        """Featurize and score a batch of requests (scores include each
        request's offset). ``fixed_only`` is the degraded serving mode:
        random effects are skipped, every request scores like cold-start."""
        feats, ents, offsets = self.featurize(requests)
        return self.score_arrays(feats, ents, offsets, fixed_only=fixed_only)

    def score_data(self, data: GameData) -> np.ndarray:
        """Score a dense-sharded :class:`GameData` through the bucketed
        online path; returns margins WITHOUT offsets — directly comparable
        to ``score_game_data`` on the same data."""
        for s in self._used_shards:
            if is_structured(data.features[s]):
                raise ValueError(
                    f"shard {s!r}: the online engine featurizes densely; "
                    "score structured shards through score_game_data"
                )
        feats = {s: to_numpy(data.features[s]) for s in self._used_shards}
        return self.score_arrays(feats, dict(data.entity_ids))
