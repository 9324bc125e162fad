"""Tiered HBM/host entity cache for the serving engine (counterpart of
``photon_ml_tpu/serving/cache.py``).

The GAME workload the paper serves — one tiny model per user/item at
"hundreds of billions of coefficients" — has a Zipf-shaped access
pattern: a small hot head of entities takes almost all traffic while the
cold tail is touched rarely. Pinning EVERY entity's coefficients in HBM
(what the engine did before) makes serving capacity a function of the
coldest entity; this module makes it a function of the *working set*:

- **HBM tier.** A fixed-capacity slab of ``capacity`` entity rows per
  table on the engine's device, passed to every bucket scorer as an
  ordinary parameter. Promotion writes row *contents* in place
  (``index_copy_``) and never changes a shape, so the power-of-two bucket
  scorers survive every promotion.
- **Host tier.** The full compact tables stay in host RAM — the durable
  source every promotion copies from.
- **Miss semantics.** A request whose entity is not resident maps to
  slot ``-1``; every random-effect kernel scores ``-1`` as 0, so the
  miss scores *fixed-effect-only* — numerically the engine's degraded
  ``_score_padded_fixed`` answer and the cold-start answer, to 1e-10 —
  while the promotion runs on a background worker. A miss costs
  fidelity on that one request; it NEVER stalls the batch or holds the
  scoring path behind a host->device copy.
- **Async promotion/demotion.** Misses enqueue; the worker drains them
  in first-miss order, evicting least-recently-used residents when the
  tier is full. Promotions land through an in-place row copy of at most
  ``promote_batch`` rows per batch (the JAX package's jitted sentinel-
  padded scatter). With ``worker=False`` promotion is driven explicitly
  (:meth:`promote_pending`) — the deterministic mode the replay tests
  use.
- **Consistency.** The tier is written in place, so a scoring call must
  read it as it was when its slots were resolved: the engine holds
  :meth:`TieredEntityCache.hold` (the cache's re-entrant lock) from slot
  resolution until the call's scores are back on the host, and a
  promotion batch claims slots and writes rows under the same lock.

One cache serves one RE key and every coordinate keyed by it (all such
coordinates must agree on slot ids because the scoring body gathers them
with ONE entity column). Chaos drills arm the
``serving.cache_tier`` fault site, probed once per promotion batch.
"""

from __future__ import annotations

import collections
import json
import os
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from photon_ml_tpu_torch import obs
from photon_ml_tpu_torch.resilience import faults as _faults
from photon_ml_tpu_torch.utils.device import resolve_device

DEFAULT_PROMOTE_BATCH = 64

ADMISSION_LOG_VERSION = 1
DEFAULT_ADMISSION_CAPACITY = 4096
DEFAULT_ADMISSION_FLUSH_EVERY = 64


class AdmissionLog:
    """Bounded repeat-miss admission log: the serving->training feedback
    channel of the lifecycle loop (docs/LIFECYCLE.md).

    Every cache miss (a known-but-cold entity) and every unknown entity
    id the engine featurizes records ``(entity key, miss count, last
    seen)`` here; the retrain orchestrator promotes repeat-missed keys
    (count >= its threshold) into the next training set. Properties:

    - **Bounded.** At most ``capacity`` entries across all RE keys;
      over capacity the lowest-(misses, last_seen) entry is evicted, so
      a scan of one-off ids can never grow the log without limit.
    - **Atomic-swap persistence.** Flushes write ``<path>.tmp`` then
      ``os.replace`` — a reader (the orchestrator, possibly another
      process) never sees a torn log. The ``cache.admission_log`` fault
      site is probed per flush; a failed write keeps the entries in
      memory and the next flush retries. Scoring is never touched.
    - **Crash-tolerant load.** An unreadable/garbage file starts the
      log empty (counted in ``serving.cache.admission_logged`` from
      zero) rather than failing engine construction.

    Writes happen OFF the scoring path: ``note()`` is O(keys) dict
    updates; the file write runs from the cache promotion worker (or an
    explicit :meth:`flush`)."""

    def __init__(
        self,
        path: str,
        *,
        capacity: int = DEFAULT_ADMISSION_CAPACITY,
        flush_every: int = DEFAULT_ADMISSION_FLUSH_EVERY,
        stats=None,
    ):
        self.path = path
        self.capacity = int(capacity)
        self.flush_every = int(flush_every)
        self.stats = stats
        self._lock = threading.Lock()
        # re_key -> {entity key -> [miss_count, last_seen_unix]}
        self._entries: Dict[str, Dict[str, List[float]]] = {}
        self._pending_notes = 0
        self._dirty = False
        for rk, ents in self.load(path).items():
            self._entries[rk] = {
                k: [int(v["misses"]), float(v["last_seen"])]
                for k, v in ents.items()
            }

    @staticmethod
    def load(path: str) -> Dict[str, Dict[str, dict]]:
        """Read a persisted log -> ``{re_key: {key: {misses, last_seen}}}``.
        Missing or torn files read as empty (the degraded outcome of a
        ``cache.admission_log`` corrupt fault: admissions are lost, the
        loop just re-learns them; nothing raises)."""
        try:
            with open(path) as f:
                doc = json.load(f)
            entries = doc.get("entries", {})
            out: Dict[str, Dict[str, dict]] = {}
            for rk, ents in entries.items():
                out[str(rk)] = {
                    str(k): {
                        "misses": int(v["misses"]),
                        "last_seen": float(v["last_seen"]),
                    }
                    for k, v in ents.items()
                }
            return out
        except (OSError, ValueError, KeyError, TypeError, AttributeError):
            return {}

    def note(self, re_key: str, keys, now: Optional[float] = None) -> int:
        """Record one miss per key (a cache miss or an unknown entity
        id). Returns the number of NEW log entries created — that count
        feeds ``serving.cache.admission_logged``."""
        if now is None:
            now = time.time()
        created = 0
        with self._lock:
            ents = self._entries.setdefault(re_key, {})
            for key in keys:
                key = str(key)
                entry = ents.get(key)
                if entry is None:
                    ents[key] = [1, now]
                    created += 1
                else:
                    entry[0] += 1
                    entry[1] = now
            self._pending_notes += len(keys)
            if keys:
                self._dirty = True
            self._evict_locked()
        if created and self.stats is not None:
            self.stats.record_admission_logged(created)
        return created

    def _evict_locked(self) -> None:
        total = sum(len(e) for e in self._entries.values())
        while total > self.capacity:
            victim = min(
                (
                    (entry[0], entry[1], rk, key)
                    for rk, ents in self._entries.items()
                    for key, entry in ents.items()
                ),
            )
            del self._entries[victim[2]][victim[3]]
            total -= 1

    def promotable(self, min_misses: int = 2) -> Dict[str, List[str]]:
        """Repeat-missed keys per RE key (miss count >= ``min_misses``)
        — the orchestrator's admission set, most-missed first."""
        with self._lock:
            out: Dict[str, List[str]] = {}
            for rk, ents in self._entries.items():
                keys = [
                    k for k, v in ents.items() if v[0] >= int(min_misses)
                ]
                keys.sort(key=lambda k: (-ents[k][0], k))
                if keys:
                    out[rk] = keys
            return out

    def maybe_flush(self) -> bool:
        """Flush when enough notes accumulated since the last write —
        the promotion worker's cheap call."""
        with self._lock:
            due = self._dirty and self._pending_notes >= self.flush_every
        return self.flush() if due else False

    def flush(self) -> bool:
        """Atomic-swap write of the current entries. Returns True when a
        write landed; False on a (possibly injected) failure, in which
        case everything stays in memory and the next flush retries."""
        with self._lock:
            if not self._dirty:
                return False
            doc = {
                "version": ADMISSION_LOG_VERSION,
                "capacity": self.capacity,
                "entries": {
                    rk: {
                        k: {"misses": v[0], "last_seen": v[1]}
                        for k, v in ents.items()
                    }
                    for rk, ents in self._entries.items()
                },
            }
        tmp = self.path + ".tmp"
        try:
            # chaos seam: the admission-log write. raise = failed
            # atomic swap (entries stay in memory, next flush retries);
            # corrupt = torn log the tolerant loader must survive.
            action = _faults.fire("cache.admission_log", key=self.path)
            with open(tmp, "w") as f:
                json.dump(doc, f)
            os.replace(tmp, self.path)
            if action is not None and action.corrupt:
                _faults.corrupt_file(self.path)
        except OSError as e:
            obs.emit_event(
                "serving.admission_log_write_failed",
                cat="serving",
                path=self.path,
                error=repr(e),
            )
            return False
        finally:
            try:
                os.remove(tmp)
            except FileNotFoundError:
                pass  # the swap landed (or the write never started)
        with self._lock:
            self._pending_notes = 0
            self._dirty = False
        return True

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "path": self.path,
                "capacity": self.capacity,
                "entries": int(
                    sum(len(e) for e in self._entries.values())
                ),
                "dirty": bool(self._dirty),
            }


class TieredEntityCache:
    """Hot-head HBM tier + host-RAM tail for one RE key's row tables."""

    def __init__(
        self,
        re_key: str,
        *,
        num_entities: int,
        capacity: int,
        dtype=torch.float64,
        device=None,
        stats=None,
        worker: bool = True,
        promote_batch: int = DEFAULT_PROMOTE_BATCH,
        preload_head: bool = True,
        admission_log: Optional[AdmissionLog] = None,
        entity_key_of: Optional[Callable[[int], str]] = None,
    ):
        if capacity < 1:
            raise ValueError(f"cache capacity must be >= 1, got {capacity}")
        self.re_key = re_key
        # repeat-miss admission log (shared across this engine's caches):
        # every translate() miss is noted BY ENTITY KEY (entity_key_of
        # maps a global row index back to the raw vocab key) so the
        # retrain orchestrator can admit the repeat-missed tail into the
        # next training set. Noting happens outside the slot lock.
        self.admission_log = admission_log
        self._entity_key_of = entity_key_of or str
        self.num_entities = int(num_entities)
        self.capacity = int(min(capacity, max(num_entities, 1)))
        self.dtype = dtype
        self.device = resolve_device(device)
        self.stats = stats
        self.promote_batch = int(promote_batch)
        self._preload_head = preload_head
        self._worker_enabled = worker
        # host tier: (name, field) -> (E, ...) numpy (the cold tail's
        # durable copy); device tier filled at seal()
        self._host: Dict[Tuple[str, str], np.ndarray] = {}
        self._dev: Dict[Tuple[str, str], torch.Tensor] = {}
        # slot bookkeeping: global entity -> HBM slot (-1 = cold) and
        # the inverse; last_used drives LRU demotion
        self.slot_of = np.full(self.num_entities, -1, np.int32)
        self.entity_of = np.full(self.capacity, -1, np.int32)
        self._last_used = np.zeros(self.capacity, np.int64)
        self._tick = 0
        self._free: List[int] = list(range(self.capacity - 1, -1, -1))
        self._pending: "collections.deque" = collections.deque()
        self._pending_set: set = set()
        # batches taken off the queue whose copy has not landed yet: flush()
        # waits for these too, so that it is a barrier on the tier itself
        self._in_flight = 0
        # bumped on every promotion batch (the tier's contents changed)
        self.generation = 0
        # re-entrant: the engine holds it across a whole scoring call
        # (hold()) and translate() takes it again inside
        self._lock = threading.RLock()
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._sealed = False

    # -- construction ------------------------------------------------------

    def add_table(self, name: str, field: str, host: np.ndarray) -> None:
        """Register one entity-keyed row table (e.g. a CompactReTable's
        columns) with the host tier; rows [0, num_entities)."""
        if self._sealed:
            raise RuntimeError("cache already sealed")
        host = np.ascontiguousarray(host)
        if host.shape[0] != self.num_entities:
            raise ValueError(
                f"table {name}.{field} has {host.shape[0]} rows, cache "
                f"covers {self.num_entities} entities"
            )
        self._host[(name, field)] = host

    def seal(self) -> None:
        """Allocate the HBM tier, optionally preload the head (entities
        [0, capacity) — the Zipf hot set under a popularity-ranked
        vocabulary), and start the promotion worker."""
        if self._sealed:
            return
        self._sealed = True
        for key, host in self._host.items():
            self._dev[key] = torch.zeros(
                (self.capacity,) + host.shape[1:],
                dtype=torch.from_numpy(host[:0]).dtype,
                device=self.device,
            )
        if self._preload_head and self.num_entities:
            head = list(range(min(self.capacity, self.num_entities)))
            with self._lock:
                for e in head:
                    self._pending.append(e)
                    self._pending_set.add(e)
            self.promote_pending()
        if self._worker_enabled:
            self._thread = threading.Thread(
                target=self._run, name=f"cache-tier-{self.re_key}",
                daemon=True,
            )
            self._thread.start()

    # -- scoring-path surface ----------------------------------------------

    def hold(self):
        """The cache's lock, for a scoring call to hold from slot
        resolution until its device reads of the tier are done (promotion
        writes the tier in place under it)."""
        return self._lock

    def translate(self, ents: np.ndarray):
        """Global entity indices -> HBM slot ids. Cold/unknown (< 0 or
        not resident) -> -1; misses enqueue for async promotion. O(B)
        numpy, no device work — this IS the scoring path, so it never
        blocks on a copy.

        The JAX cache returns the tier arrays captured with the slots
        (``with_tables``). Here the tier tensors are written in place by
        promotion, and a slot id is only meaningful against the tier
        contents it was resolved for, so a scoring call holds
        :meth:`hold` from this call until its device reads are done."""
        ents = np.asarray(ents, np.int32)
        known = (ents >= 0) & (ents < self.num_entities)
        slots = np.full(ents.shape, -1, np.int32)
        with self._lock:
            slots[known] = self.slot_of[ents[known]]
            hit = slots >= 0
            self._tick += 1
            self._last_used[slots[hit]] = self._tick
            missed = np.unique(ents[known & ~hit])
            for e in missed.tolist():
                if e not in self._pending_set:
                    self._pending.append(e)
                    self._pending_set.add(e)
        hits = int(np.count_nonzero(hit))
        misses = int(np.count_nonzero(known) - hits)
        if self.stats is not None:
            self.stats.record_cache(hits, misses)
        if misses:
            # request-causality breadcrumb (docs/OBSERVABILITY.md): the
            # miss inherits the batch identity from the batcher's
            # ambient span context, so a traced request that scored
            # degraded shows WHY — which tier missed, how many entities.
            # Rides the batched flush (no per-miss fsync on the scoring
            # path); instant tracer write only when tracing is on.
            tracer = obs.get_tracer()
            if tracer is not None:
                ctx = obs.current_span_context() or {}
                tracer.add_instant(
                    "serving.cache.miss",
                    cat="serving",
                    args={
                        "re_key": self.re_key,
                        "hits": hits,
                        "misses": misses,
                        **(
                            {"batch_id": ctx["batch_id"]}
                            if "batch_id" in ctx else {}
                        ),
                    },
                    flush=False,
                )
        if self.admission_log is not None and missed.size:
            self.admission_log.note(
                self.re_key,
                [self._entity_key_of(e) for e in missed.tolist()],
            )
        if misses and self._thread is not None:
            self._wake.set()
        return slots

    def device_tables(self) -> Dict[Tuple[str, str], torch.Tensor]:
        """The HBM tier tensors (fixed for the cache's life: promotion
        writes their rows in place under the lock)."""
        with self._lock:
            return dict(self._dev)

    # -- promotion / demotion ----------------------------------------------

    def _claim_slots(self, entities: List[int]) -> List[Tuple[int, int]]:
        """Assign a slot per entity (free first, then LRU victim),
        updating the maps; returns (entity, slot) pairs. Caller holds
        the lock."""
        out = []
        demoted = 0
        for e in entities:
            if self.slot_of[e] >= 0:
                continue  # raced: already resident
            if self._free:
                slot = self._free.pop()
            else:
                # LRU victim: oldest last_used, lowest slot on ties —
                # deterministic under a replayed trace
                slot = int(np.argmin(self._last_used))
                old = int(self.entity_of[slot])
                if old >= 0:
                    self.slot_of[old] = -1
                    demoted += 1
            self.slot_of[e] = slot
            self.entity_of[slot] = e
            self._last_used[slot] = self._tick
            out.append((e, slot))
        if demoted and self.stats is not None:
            self.stats.record_demotions(demoted)
        return out

    def promote_pending(self, max_batches: Optional[int] = None) -> int:
        """Drain the miss queue into the HBM tier, ``promote_batch``
        entities per in-place row copy. Returns the number promoted. The
        worker calls this; tests call it directly for deterministic
        replay. A ``serving.cache_tier`` fault (raise-mode) fails the
        batch — the entities stay cold and re-enqueue on their next
        miss; the scoring path never sees the error."""
        total = 0
        batches = 0
        while max_batches is None or batches < max_batches:
            with self._lock:
                batch = []
                while self._pending and len(batch) < self.promote_batch:
                    e = self._pending.popleft()
                    self._pending_set.discard(e)
                    batch.append(e)
                if batch:
                    self._in_flight += 1
            if not batch:
                break
            batches += 1
            try:
                total += self._promote_batch(batch)
            finally:
                with self._lock:
                    self._in_flight -= 1
        if total and self.stats is not None:
            self.stats.record_promotions(total)
        if total:
            tracer = obs.get_tracer()
            if tracer is not None:
                # promotion runs on the async worker, outside any batch
                # context — the event still lands on the shared timeline
                # so a miss followed by a promotion reads causally
                tracer.add_instant(
                    "serving.cache.promotion",
                    cat="serving",
                    args={"re_key": self.re_key, "promoted": total},
                    flush=False,
                )
        return total

    def _promote_batch(self, batch) -> int:
        """One batch's host->device copy; the entities promoted."""
        try:
            # chaos seam: the host->HBM promotion copy. raise = a failed
            # tier transfer (entities stay cold, served fixed-effect-only);
            # delay = a slow tier.
            _faults.fire("serving.cache_tier", key=self.re_key)
        except OSError:
            if self.stats is not None:
                self.stats.record_cache_tier_error()
            return 0
        with self._lock:
            pairs = self._claim_slots(batch)
            if not pairs:
                return 0
            slots = torch.as_tensor([slot for _, slot in pairs], dtype=torch.int64).to(
                self.device)
            rows_of = np.asarray([e for e, _ in pairs], np.int64)
            for key, host in self._host.items():
                rows = torch.from_numpy(host[rows_of]).to(self.device)
                self._dev[key].index_copy_(0, slots, rows)
            self.generation += 1
        return len(pairs)

    def flush(self, timeout: float = 10.0) -> None:
        """Block until the pending queue is drained and every batch taken
        off it has landed (worker mode), or drain it inline
        (worker=False) — the determinism barrier."""
        if self._thread is None:
            self.promote_pending()
            return
        import time as _time

        deadline = _time.monotonic() + timeout
        self._wake.set()
        while _time.monotonic() < deadline:
            with self._lock:
                if not self._pending and not self._in_flight:
                    return
            self._wake.set()
            _time.sleep(0.002)

    def _run(self) -> None:
        while not self._stop.is_set():
            self._wake.wait(timeout=0.1)
            self._wake.clear()
            if self._stop.is_set():
                return
            try:
                self.promote_pending()
                if self.admission_log is not None:
                    # persistence rides the worker, never the scoring
                    # path: a slow/failed write costs nothing but log
                    # freshness
                    self.admission_log.maybe_flush()
            except Exception as e:  # noqa: BLE001 — worker must survive
                obs.emit_event(
                    "serving.cache_tier_worker_error",
                    cat="serving",
                    re_key=self.re_key,
                    error=repr(e),
                )

    def close(self) -> None:
        self._stop.set()
        self._wake.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        if self.admission_log is not None:
            self.admission_log.flush()

    # -- readout -----------------------------------------------------------

    def resident(self) -> int:
        with self._lock:
            return int(np.count_nonzero(self.entity_of >= 0))

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "capacity": self.capacity,
                "entities": self.num_entities,
                "resident": int(np.count_nonzero(self.entity_of >= 0)),
                "pending": len(self._pending),
                "worker": self._thread is not None,
            }
