"""The streaming ingest pipeline and out-of-core epochs (counterpart of
``photon_ml_tpu/io/pipeline.py``).

1. **Parallel decode.** Input files are planned into ``chunk_mb``-sized
   file groups and decoded on a bounded thread pool, one context-managed
   :class:`~photon_ml_tpu_torch.io.native.NativeAvroReader` per file per
   attempt, so a retry never leaks a native handle. Emission keeps the
   file order and never runs more than ``prefetch_depth`` groups ahead of
   the consumer. A transient read failure retries through the
   ``ingest.read`` seam without duplicating or dropping a chunk.
2. **Staging.** Decoded columns are cut into uniform ``rows_per_chunk``
   row blocks in a preallocated ring of ``prefetch_depth + 1`` host
   slots. For a CUDA device the slots are pinned host tensors, allocated
   once. A slot is handed out again only after the copy that read it has
   landed: the copy records a CUDA event, and ``acquire`` waits on it. A
   ``non_blocking`` copy from pinned memory returns before its bytes have
   moved, so without that wait a refilled slot would corrupt the chunk in
   flight (the JAX package's owned-buffer lesson).
3. **Transfer.** Each staged chunk is copied into device tensors of its
   own on a side CUDA stream while the next chunk decodes and stages, so
   a copy attempt the watchdog abandons writes only into memory nobody
   reads. ``labeled_batch`` deposits each device chunk into its rows of
   the dataset's tensors, preallocated on the device from the files'
   record counts (read from the Avro block headers through the
   ``ingest.read`` seam), and releases it: the device peak is the dataset
   plus the chunks in flight, never twice the dataset
   (``hbm_watermark("io.ingest.assemble")``).
4. **Out-of-core epochs.** :class:`StreamedDesign` keeps uniform chunks on
   the host (pinned once, for a CUDA device) and
   :class:`StreamingObjective` streams them through the dense objective
   passes at every evaluation: two device slots as a double buffer, chunk
   i+1's copy issued on the copy stream before chunk i's pass, a slot
   refilled only after the compute-stream event that follows the pass that
   read it. Partials sum on the device in chunk order, and the L2 term is
   added once per sweep (``models.training.train_glm_streamed``). On the
   card a sweep's seconds are the device's, read from CUDA events around
   every copy and pass once they have fired, never the host's time to
   queue the work.

On the CPU the slots are plain arrays and every copy is synchronous. A
failed copy or event on the card raises (after the ``pipeline.transfer``
seam's retries, for an ``OSError``); nothing falls back to the host.

Spans ``ingest.decode`` / ``ingest.stage`` / ``ingest.transfer`` /
``ingest.oocore.sweep``, the ``ingest.pipeline.*`` and ``ingest.oocore.*``
metrics and the stall counters are the JAX package's names.
"""

from __future__ import annotations

import dataclasses
import os
import threading
import time
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from photon_ml_tpu_torch import obs
from photon_ml_tpu_torch.obs import quality as _quality
from photon_ml_tpu_torch.resilience import faults as _faults

DEFAULT_CHUNK_MB = 64.0
DEFAULT_PREFETCH_DEPTH = 2

EPOCH_POLICIES = ("fail", "skip")

# the columns of a staged chunk, widest first
COLUMNS = ("features", "labels", "offsets", "weights", "mask")


class StageStall(OSError):
    """A pipeline stage blew past its watchdog deadline. An ``OSError``,
    so the retry seam treats a stall like a transient read failure: the
    abandoned attempt's thread is orphaned (daemon, never joined) and the
    stage runs again."""

    def __init__(self, stage: str, label: str, timeout_s: float):
        super().__init__(
            f"pipeline stage {stage!r} stalled past {timeout_s}s ({label})"
        )
        self.stage = stage
        self.timeout_s = timeout_s


def _with_watchdog(fn, timeout_s: Optional[float], stage: str, label: str,
                   on_abandon=None):
    """Run ``fn()`` under a stall deadline: the work moves to a daemon
    thread and the caller waits at most ``timeout_s``, then raises
    :class:`StageStall` into the retry seam. ``on_abandon(thread)`` lets
    the owner track the stray. ``timeout_s`` None or 0 runs ``fn`` inline."""
    if not timeout_s:
        return fn()
    box: Dict[str, object] = {}
    done = threading.Event()

    def run():
        try:
            box["ok"] = fn()
        except BaseException as e:  # noqa: BLE001 — re-raised below
            box["err"] = e
        finally:
            done.set()

    t = threading.Thread(target=run, name=f"watchdog-{stage}", daemon=True)
    t.start()
    if not done.wait(timeout_s):
        if on_abandon is not None:
            on_abandon(t)
        reg = obs.registry()
        reg.inc("ingest.pipeline.watchdog_stalls")
        reg.inc(f"ingest.pipeline.watchdog_stalls.{stage}")
        obs.emit_event("io.pipeline.stall", cat="io", stage=stage, label=label,
                       timeout_s=timeout_s)
        raise StageStall(stage, label, timeout_s)
    if "err" in box:
        raise box["err"]  # type: ignore[misc]
    return box.get("ok")


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """The pipeline's knobs (``--ingest-chunk-mb`` / ``--decode-threads`` /
    ``--prefetch-depth`` / ``--stage-timeout-s`` / ``--epoch-policy``).

    chunk_mb: target decoded-chunk size; plans the files into decode
    groups by on-disk size and sizes the uniform staged row blocks
    (``rows_per_chunk = chunk_mb / row_bytes``).
    decode_threads: concurrent decode workers; 0 = min(groups, cores, 16).
    prefetch_depth: chunks decode and staging may run ahead of the
    consumer; the staging ring has depth + 1 slots.
    stage_timeout_s: per-stage watchdog deadline (None: off).
    epoch_policy: what an exhausted retry budget does: ``"fail"`` raises,
    ``"skip"`` logs and counts the lost group
    (``ingest.pipeline.groups_skipped``) and continues without its rows.
    """

    chunk_mb: float = DEFAULT_CHUNK_MB
    decode_threads: int = 0
    prefetch_depth: int = DEFAULT_PREFETCH_DEPTH
    stage_timeout_s: Optional[float] = None
    epoch_policy: str = "fail"

    def validate(self) -> None:
        if not self.chunk_mb > 0:
            raise ValueError(f"chunk_mb must be > 0, got {self.chunk_mb}")
        if self.decode_threads < 0:
            raise ValueError(
                f"decode_threads must be >= 0 (0 = auto), got {self.decode_threads}"
            )
        if self.prefetch_depth < 1:
            raise ValueError(f"prefetch_depth must be >= 1, got {self.prefetch_depth}")
        if self.stage_timeout_s is not None and not self.stage_timeout_s > 0:
            raise ValueError(
                f"stage_timeout_s must be > 0 or None, got {self.stage_timeout_s}"
            )
        if self.epoch_policy not in EPOCH_POLICIES:
            raise ValueError(
                f"epoch_policy must be one of {EPOCH_POLICIES}, got {self.epoch_policy!r}"
            )


def config_for(chunk_mb: Optional[float] = None, decode_threads: int = 0,
               prefetch_depth: Optional[int] = None,
               stage_timeout_s: Optional[float] = None,
               epoch_policy: str = "fail") -> PipelineConfig:
    """The drivers' ingest knobs as a :class:`PipelineConfig`: None takes
    the default chunk size and depth, a stage timeout of 0 turns the
    watchdog off."""
    return PipelineConfig(
        chunk_mb=DEFAULT_CHUNK_MB if chunk_mb is None else chunk_mb,
        decode_threads=decode_threads,
        prefetch_depth=DEFAULT_PREFETCH_DEPTH if prefetch_depth is None else prefetch_depth,
        stage_timeout_s=stage_timeout_s or None,
        epoch_policy=epoch_policy,
    )


def plan_file_groups(files: Sequence[str], chunk_mb: float) -> List[List[str]]:
    """Input files -> decode groups by cumulative on-disk size (whole files
    only; a file larger than the budget is a group of its own)."""
    budget = chunk_mb * (1 << 20)
    groups: List[List[str]] = []
    cur: List[str] = []
    size = 0.0
    for f in files:
        try:
            s = float(os.path.getsize(f))
        except OSError:
            s = budget  # unknown size: conservatively its own group
        if cur and size + s > budget:
            groups.append(cur)
            cur, size = [], 0.0
        cur.append(f)
        size += s
    if cur:
        groups.append(cur)
    return groups


def count_records(path: str) -> int:
    """The records of an Avro container file, summed from its block
    headers (each block states its record count and byte size) without
    decoding one."""
    from photon_ml_tpu_torch.io.avro import MAGIC, _decode_bytes, _decode_long

    size = os.path.getsize(path)
    total = 0
    with open(path, "rb") as f:
        if f.read(4) != MAGIC:
            raise ValueError(f"{path} is not an Avro container file")
        while True:
            count = _decode_long(f)
            if count == 0:
                break
            if count < 0:
                _decode_long(f)
                count = -count
            for _ in range(2 * count):
                _decode_bytes(f)
        f.seek(16, os.SEEK_CUR)  # the sync marker
        while f.tell() < size:
            total += _decode_long(f)
            f.seek(_decode_long(f) + 16, os.SEEK_CUR)
    return total


class PipelineStats:
    """Thread-safe per-stage busy-time accumulators for one pipeline run.
    ``overlap_frac`` is the share of stage-covered wall time during which
    two or more counted stage intervals were in flight; ``stall_frac`` the
    share of the wall the consumer spent waiting on decode."""

    def __init__(self):
        self._lock = threading.Lock()
        self.decode_s = 0.0
        self.stage_s = 0.0
        self.transfer_s = 0.0
        self.consume_s = 0.0
        self.stall_s = 0.0
        self.wall_s = 0.0
        self.chunks = 0
        self.records = 0
        self.bytes_to_device = 0
        self.stalls = 0
        self.retries = 0
        self.groups_skipped = 0
        # counted stage intervals (stage, start, end), perf_counter time
        self._intervals: List[Tuple[str, float, float]] = []

    def note(self, stage: str, seconds: float, t0: Optional[float] = None, **inc) -> None:
        with self._lock:
            setattr(self, f"{stage}_s", getattr(self, f"{stage}_s") + seconds)
            if t0 is not None and seconds > 0:
                self._intervals.append((stage, t0, t0 + seconds))
            for k, v in inc.items():
                setattr(self, k, getattr(self, k) + v)

    def note_stall(self, seconds: float) -> None:
        with self._lock:
            self.stall_s += seconds
            self.stalls += 1

    def finish(self, wall_s: float) -> "PipelineStats":
        with self._lock:
            self.wall_s += wall_s
        return self

    def busy_s(self) -> float:
        return self.decode_s + self.stage_s + self.transfer_s + self.consume_s

    def overlap_frac(self) -> float:
        """Share of the stage-covered wall time with two or more counted
        intervals in flight (a sweep line over the recorded spans)."""
        with self._lock:
            ivs = list(self._intervals)
        if not ivs:
            return 0.0
        events: List[Tuple[float, int]] = []
        for _, a, b in ivs:
            events.append((a, 1))
            events.append((b, -1))
        events.sort()
        union = 0.0
        multi = 0.0
        depth = 0
        prev = events[0][0]
        for t, d in events:
            if t > prev:
                if depth >= 1:
                    union += t - prev
                if depth >= 2:
                    multi += t - prev
            prev = t
            depth += d
        return multi / union if union > 0 else 0.0

    def stall_frac(self) -> float:
        if self.wall_s <= 0.0:
            return 0.0
        return min(1.0, self.stall_s / self.wall_s)

    def snapshot(self) -> Dict[str, float]:
        with self._lock:
            out = {
                "decode_s": self.decode_s,
                "stage_s": self.stage_s,
                "transfer_s": self.transfer_s,
                "consume_s": self.consume_s,
                "stall_s": self.stall_s,
                "wall_s": self.wall_s,
                "chunks": float(self.chunks),
                "records": float(self.records),
                "bytes_to_device": float(self.bytes_to_device),
                "stalls": float(self.stalls),
                "retries": float(self.retries),
                "groups_skipped": float(self.groups_skipped),
            }
        out["overlap_frac"] = self.overlap_frac()
        out["stall_frac"] = self.stall_frac()
        return out


def _dtypes(dtype) -> Tuple[torch.dtype, np.dtype]:
    """(torch dtype, numpy dtype) of a torch or numpy float dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype, torch.empty(0, dtype=dtype).numpy().dtype
    np_dtype = np.dtype(dtype)
    return torch.from_numpy(np.empty(0, np_dtype)).dtype, np_dtype


def _is_cuda(device) -> bool:
    return device is not None and torch.device(device).type == "cuda"


def _host_tensor(shape, dtype: torch.dtype, pin: bool) -> torch.Tensor:
    """A zeroed host tensor, in pinned memory when ``pin``."""
    return torch.zeros(shape, dtype=dtype, pin_memory=pin)


class _StagingRing:
    """Preallocated host staging slots, reused round-robin. A slot is
    handed out again only after the copy issued from it has landed: on a
    CUDA device ``note_transfer`` keeps the event recorded after that copy
    and ``acquire`` waits on it. ``pin`` makes the slots pinned host
    tensors (CUDA only), so that the copies run asynchronously."""

    def __init__(self, nslots: int, pin: bool = False):
        self._slots: List[Optional[Dict[str, torch.Tensor]]] = [None] * nslots
        self._events: List[Optional[object]] = [None] * nslots
        self._next = 0
        self.pin = pin

    def acquire(self, rows: int, d: int, dtype) -> Tuple[int, Dict[str, torch.Tensor]]:
        t_dtype, _ = _dtypes(dtype)
        s = self._next % len(self._slots)
        self._next += 1
        event = self._events[s]
        if event is not None:
            # the copy that read this slot must land before it is refilled
            event.synchronize()
            self._events[s] = None
        buf = self._slots[s]
        if (buf is None or tuple(buf["features"].shape) != (rows, d)
                or buf["features"].dtype != t_dtype):
            buf = {k: _host_tensor((rows, d) if k == "features" else (rows,), t_dtype, self.pin)
                   for k in COLUMNS}
            self._slots[s] = buf
        return s, buf

    def note_transfer(self, slot: int, event) -> None:
        """``event``: the CUDA event recorded after the copy that read the
        slot (None where the copy was synchronous)."""
        self._events[slot] = event


@dataclasses.dataclass
class StagedChunk:
    """One uniform row block staged for transfer. ``features`` etc. are
    numpy views into a ring slot and ``tensors`` the same memory as host
    tensors: valid until ``prefetch_depth`` further chunks have been
    staged; consumers copy before moving on."""

    index: int
    start_row: int
    rows: int  # real rows (< features.shape[0] only for a padded tail)
    features: np.ndarray
    labels: np.ndarray
    offsets: np.ndarray
    weights: np.ndarray
    mask: np.ndarray
    ring_slot: int = -1
    tensors: Optional[Dict[str, torch.Tensor]] = None


def rows_per_chunk_for(chunk_mb: float, d: int, itemsize: int = 8) -> int:
    """Uniform staged-chunk row count: ``chunk_mb`` of dense row bytes
    (features + the four scalar columns)."""
    row_bytes = itemsize * (d + 4)
    return max(1, int(chunk_mb * (1 << 20) / max(row_bytes, 1)))


def _dense_part(part: dict, vocab, vocab_index: int) -> np.ndarray:
    """One decoded part's COO triplets -> its dense (n, d) float64 block
    with the intercept column injected: the per-row math of
    ``IngestSource.labeled_batch``, so the assembled dataset is bit for bit
    the one-shot read's."""
    from photon_ml_tpu_torch.io.ingest import _inject_intercept

    n = part["n"]
    rows, cols, vals = part["coo"][vocab_index]
    rows, cols, vals = _inject_intercept(rows, cols, vals, n, vocab.intercept_index)
    x = np.zeros((n, len(vocab)), np.float64)
    np.add.at(x, (rows.astype(np.int64), cols.astype(np.int64)), vals)
    return x


class IngestPipeline:
    """Avro input files -> ordered stream of decoded parts / staged chunks
    / device chunks, with decode, staging and transfer overlapped.

    One instance is one pass over the input; :meth:`parts`, :meth:`chunks`
    and the assembly entry points each start a fresh decode pool. The
    native vocabulary maps build once and are shared read-only by every
    per-file reader; use the pipeline as a context manager (or call
    :meth:`close`) to release them."""

    def __init__(
        self,
        paths: Sequence[str],
        vocabs: Sequence,
        entity_keys: Sequence[str] = (),
        label_field: str = "label",
        allow_null_labels: bool = False,
        config: PipelineConfig = PipelineConfig(),
        stats: Optional[PipelineStats] = None,
    ):
        from photon_ml_tpu_torch.io import native

        config.validate()
        if not paths:
            raise FileNotFoundError("no input files")
        if native.get_lib() is None:
            raise RuntimeError(
                f"ingest pipeline requires the native reader: {native.native_error()}"
            )
        self.files = list(paths)
        self.vocabs = list(vocabs)
        self.entity_keys = tuple(entity_keys)
        self.label_field = label_field
        self.allow_null_labels = allow_null_labels
        self.config = config
        self.stats = stats if stats is not None else PipelineStats()
        self._native = native
        self.groups = plan_file_groups(self.files, config.chunk_mb)
        cores = os.cpu_count() or 1
        self.decode_workers = max(
            1, config.decode_threads or min(len(self.groups), cores, 16)
        )
        # container blocks inside each file split the remaining cores
        self.block_threads = max(
            1, cores // max(1, min(self.decode_workers, len(self.groups)))
        )
        schema = native._read_header_schema(self.files[0])
        self._schema = schema
        self._field_prog, self._feat_desc = native.compile_schema(
            schema, label_field=label_field, want_entities=bool(self.entity_keys)
        )
        self._vocabset = native.NativeVocabSet(
            [v.index_to_key for v in self.vocabs],
            [v.intercept_index for v in self.vocabs],
        )
        self._closed = False
        # attempts abandoned by the watchdog: a decode still reads the
        # shared vocabulary maps, so close() must not free them under a live
        # call; a transfer still reads its ring slot into tensors of its own
        self._stray_threads: List[threading.Thread] = []
        self.assemble_watermark = None
        obs.emit_event(
            "io.pipeline.start", cat="io", files=len(self.files), groups=len(self.groups),
            decode_workers=self.decode_workers, block_threads=self.block_threads,
            chunk_mb=config.chunk_mb, prefetch_depth=config.prefetch_depth,
        )

    # -- lifecycle ----------------------------------------------------------

    def close(self) -> None:
        if not self._closed:
            self._closed = True
            # a still-hung stray after the grace period leaks the maps: a
            # bounded leak beats a use-after-free
            for t in self._stray_threads:
                t.join(timeout=30.0)
            if any(t.is_alive() for t in self._stray_threads):
                obs.emit_event("io.pipeline.stray_leak", cat="io",
                               threads=sum(t.is_alive() for t in self._stray_threads))
                return
            self._vocabset.close()

    def __enter__(self) -> "IngestPipeline":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- stage 1: parallel decode ------------------------------------------

    def _decode_group(self, index: int, group: List[str]) -> dict:
        """Decode one file group into a columnar part dict (the
        ``native.read_columnar`` layout). Each attempt builds fresh
        context-managed readers, so a retry through the ``ingest.read``
        seam restarts the group cleanly."""
        from photon_ml_tpu_torch.io.ingest import _resilient_read

        native = self._native

        def decode_once():
            # the decode-pool fault site: raise-mode restarts the group
            # through the retry below, delay-mode is the stalled decoder
            # the watchdog turns into a retry
            _faults.fire("pipeline.decode", key=str(index))
            parts = []
            for path in group:
                with native.NativeAvroReader(
                    self._field_prog, self._feat_desc, self._vocabset, self.entity_keys
                ) as reader:
                    reader.feed_file(path, expected_schema=self._schema,
                                     decode_threads=self.block_threads)
                    parts.append(native._extract_columns(
                        reader, self.entity_keys, len(self.vocabs)))
            return parts

        def decode_attempt():
            return _with_watchdog(decode_once, self.config.stage_timeout_s, "decode",
                                  f"chunk {index}", on_abandon=self._stray_threads.append)

        t0 = time.perf_counter()
        with obs.span("ingest.decode", cat="io", chunk=index, files=len(group)):
            parts = _resilient_read(
                decode_attempt, label=f"pipeline decode chunk {index} ({group[0]}...)",
                paths=group,
            )
        part = parts[0] if len(parts) == 1 else _merge_parts(
            parts, self.entity_keys, len(self.vocabs))
        if not self.allow_null_labels and not part["label_present"].all():
            i = int(np.argmin(part["label_present"]))
            raise ValueError(
                f"record {i} of chunk {index} ({group}) has a null/missing label; "
                "training input requires labels (pass allow_null_labels=True only "
                "for scoring)"
            )
        dt = time.perf_counter() - t0
        self.stats.note("decode", dt, t0=t0, records=part["n"])
        reg = obs.registry()
        reg.observe("ingest.pipeline.decode_ms", dt * 1e3)
        reg.inc("ingest.pipeline.records", part["n"])
        return part

    def _skip_group(self, index: int, err: BaseException) -> bool:
        """The epoch policy on an exhausted decode-retry budget: ``skip``
        logs and counts the lost group and lets the epoch continue;
        ``fail`` says no."""
        from photon_ml_tpu_torch.resilience.retry import RetryBudgetExceeded

        if self.config.epoch_policy != "skip" or not isinstance(err, RetryBudgetExceeded):
            return False
        self.stats.note("decode", 0.0, groups_skipped=1)
        obs.registry().inc("ingest.pipeline.groups_skipped")
        obs.emit_event("io.pipeline.group_skipped", cat="io", chunk=index,
                       files=self.groups[index], error=repr(err))
        return True

    def parts(self, indices: Optional[Sequence[int]] = None) -> Iterator[dict]:
        """Ordered iterator of decoded columnar parts, one per file group
        (the groups ``indices``, default all). Decode runs on a thread pool
        that stays within ``prefetch_depth`` parts (plus one in flight per
        worker) of the consumer; the consumer's waits count as stalls. A
        group whose retries exhaust follows ``epoch_policy``."""
        order = list(range(len(self.groups)) if indices is None else indices)
        groups = [self.groups[i] for i in order]
        nworkers = min(self.decode_workers, len(groups))
        if nworkers <= 1 and len(groups) <= 1:
            for index, group in zip(order, groups):
                try:
                    yield self._decode_group(index, group)
                except BaseException as e:  # noqa: BLE001 — policy gate
                    if not self._skip_group(index, e):
                        raise
            return
        cond = threading.Condition()
        results: Dict[int, Tuple[str, object]] = {}
        state = {"next_to_take": 0, "consumed": 0, "cancel": False}
        budget = self.config.prefetch_depth + nworkers

        def worker():
            while True:
                with cond:
                    while True:
                        if state["cancel"]:
                            return
                        i = state["next_to_take"]
                        if i >= len(groups):
                            return
                        if i - state["consumed"] < budget:
                            state["next_to_take"] = i + 1
                            break
                        cond.wait(0.05)
                try:
                    out = ("ok", self._decode_group(order[i], groups[i]))
                except BaseException as e:  # noqa: BLE001 — re-raised below
                    out = ("error", e)
                with cond:
                    results[i] = out
                    cond.notify_all()

        threads = [threading.Thread(target=worker, name=f"ingest-decode-{t}", daemon=True)
                   for t in range(nworkers)]
        for t in threads:
            t.start()
        reg = obs.registry()
        try:
            for i in range(len(groups)):
                with cond:
                    if i not in results:
                        t0 = time.perf_counter()
                        while i not in results:
                            cond.wait()
                        dt = time.perf_counter() - t0
                        self.stats.note_stall(dt)
                        reg.inc("ingest.pipeline.stalls")
                        reg.observe("ingest.pipeline.stall_ms", dt * 1e3)
                    kind, payload = results.pop(i)
                    state["consumed"] = i + 1
                    cond.notify_all()
                if kind == "error":
                    if self._skip_group(order[i], payload):
                        continue
                    raise payload
                yield payload
        finally:
            with cond:
                state["cancel"] = True
                cond.notify_all()
            for t in threads:
                t.join(timeout=10.0)

    # -- stage 2: uniform-row staging --------------------------------------

    def chunks(
        self,
        vocab_index: int = 0,
        dtype=torch.float64,
        rows_per_chunk: Optional[int] = None,
        pad_tail: bool = False,
        ring: Optional[_StagingRing] = None,
        parts: Optional[Iterator[dict]] = None,
    ) -> Iterator[StagedChunk]:
        """Decoded parts (``parts``, default :meth:`parts`) -> uniform
        ``rows_per_chunk`` row blocks staged in the ring (dense features
        and the scalar columns, cast to ``dtype``). With ``pad_tail`` the
        last block is zero-padded to the uniform shape with its mask
        zeroed; otherwise it keeps its real row count."""
        vocab = self.vocabs[vocab_index]
        d = len(vocab)
        _, np_dtype = _dtypes(dtype)
        rpc = rows_per_chunk or rows_per_chunk_for(self.config.chunk_mb, d, np_dtype.itemsize)
        if ring is None:
            ring = _StagingRing(self.config.prefetch_depth + 1)
        index = 0
        start_row = 0
        slot = -1
        tbuf: Optional[Dict[str, torch.Tensor]] = None
        buf: Optional[Dict[str, np.ndarray]] = None
        fill = 0

        def start_block():
            nonlocal slot, tbuf, buf, fill
            slot, tbuf = ring.acquire(rpc, d, dtype)
            buf = {k: t.numpy() for k, t in tbuf.items()}
            fill = 0

        names_cache: Dict[int, List[str]] = {}

        def chunk_names(coll) -> List[str]:
            limit = min(d, coll.max_features)
            if limit not in names_cache:
                names = []
                for j in range(limit):
                    name, term = vocab.name_term(j)
                    names.append(f"{name}{term}" if term else str(name))
                names_cache[limit] = names
            return names_cache[limit]

        def emit(rows: int) -> StagedChunk:
            nonlocal index, start_row
            # the quality fingerprint sketches the staged rows here, while
            # they are host arrays (the streamed and out-of-core paths hold
            # no in-core batch to sketch later); the sketches copy at once
            coll = _quality.fingerprint_collector()
            if coll is not None:
                coll.observe_batch(buf["features"][:rows], buf["labels"][:rows],
                                   buf["weights"][:rows], shard="features",
                                   names=chunk_names(coll))
            if pad_tail and rows < rpc:
                for k in ("features", "labels", "offsets", "weights"):
                    buf[k][rows:] = 0.0
            buf["mask"][:rows] = 1.0
            if pad_tail:
                buf["mask"][rows:] = 0.0
            keep = rpc if pad_tail else rows
            out = StagedChunk(
                index=index, start_row=start_row, rows=rows,
                **{k: buf[k][:keep] for k in COLUMNS},
                ring_slot=slot, tensors={k: tbuf[k][:keep] for k in COLUMNS},
            )
            index += 1
            start_row += rows
            return out

        start_block()
        for part in self.parts() if parts is None else parts:
            n = part["n"]
            if n == 0:
                continue
            t0 = time.perf_counter()
            with obs.span("ingest.stage", cat="io", rows=n):
                dense = _with_watchdog(lambda: _dense_part(part, vocab, vocab_index),
                                       self.config.stage_timeout_s, "stage", f"{n} rows")
                cols = {"labels": part["labels"], "offsets": part["offsets"],
                        "weights": part["weights"]}
                off = 0
                while off < n:
                    take = min(rpc - fill, n - off)
                    np.copyto(buf["features"][fill:fill + take], dense[off:off + take],
                              casting="unsafe")
                    for k, src in cols.items():
                        np.copyto(buf[k][fill:fill + take], src[off:off + take],
                                  casting="unsafe")
                    fill += take
                    off += take
                    if fill == rpc:
                        self.stats.note("stage", time.perf_counter() - t0, t0=t0, chunks=1)
                        obs.registry().inc("ingest.pipeline.chunks")
                        yield emit(rpc)
                        t0 = time.perf_counter()
                        start_block()
            self.stats.note("stage", time.perf_counter() - t0, t0=t0)
        if fill > 0:
            self.stats.note("stage", 0.0, chunks=1)
            obs.registry().inc("ingest.pipeline.chunks")
            yield emit(fill)
        self._ring = ring  # the ring lives as long as the pipeline

    # -- stage 3: device transfer ------------------------------------------

    def device_chunks(
        self,
        vocab_index: int = 0,
        dtype=torch.float32,
        rows_per_chunk: Optional[int] = None,
        pad_tail: bool = False,
        device="cpu",
        parts: Optional[Iterator[dict]] = None,
    ) -> Iterator[dict]:
        """Staged chunks -> chunks on ``device``, each a dict of ``index``,
        ``start_row``, ``rows`` and the five columns in tensors of its own,
        yielded as soon as its copy is issued: the decode pool runs ahead
        on its threads, and on a CUDA device the copy runs on a side copy
        stream while the consumer's work on the previous chunk runs on its
        own, so a consumer that releases each chunk holds one on the device.
        The consumer's stream waits on the copy's event, and the tensors
        are recorded on it for the caching allocator."""
        device = torch.device(device)
        cuda = _is_cuda(device)
        ring = _StagingRing(self.config.prefetch_depth + 1, pin=cuda)
        streams = (torch.cuda.Stream(device=device),
                   torch.cuda.current_stream(device)) if cuda else None
        for staged in self.chunks(vocab_index=vocab_index, dtype=dtype,
                                  rows_per_chunk=rows_per_chunk, pad_tail=pad_tail,
                                  ring=ring, parts=parts):
            yield self._handed_over(self._transfer(staged, ring, device, streams), streams)

    @staticmethod
    def _handed_over(dev: dict, streams) -> dict:
        event = dev.pop("event")
        if streams is not None:
            consumer = streams[1]
            consumer.wait_event(event)
            for k in COLUMNS:
                dev[k].record_stream(consumer)
        return dev

    def _transfer(self, staged: StagedChunk, ring: _StagingRing, device, streams) -> dict:
        """Copy one staged chunk to ``device`` into new tensors. On a CUDA
        device (``streams``: the copy stream and the consumer's) the copies
        run on the copy stream after it has waited for the consumer, and
        the event recorded after them goes to the ring (the slot's release)
        and into the result under ``"event"``. On the CPU the copies are
        synchronous. An attempt the watchdog abandons writes only into its
        own new tensors, which nothing reads, so a stray that wakes after
        the retry cannot touch the dataset."""
        from photon_ml_tpu_torch.resilience import retry as _retry

        src = staged.tensors
        nbytes = sum(t.numel() * t.element_size() for t in src.values())
        t0 = time.perf_counter()

        def copy_once():
            # the host-to-device fault site: the ring slot still belongs to
            # this chunk, so a retried copy re-reads intact memory
            _faults.fire("pipeline.transfer", key=str(staged.index))
            if streams is None:
                return {k: src[k].clone() for k in COLUMNS}, None
            stream, consumer = streams
            stream.wait_stream(consumer)
            with torch.cuda.stream(stream):
                out = {}
                for k in COLUMNS:
                    out[k] = torch.empty(src[k].shape, dtype=src[k].dtype, device=device)
                    out[k].copy_(src[k], non_blocking=True)
                event = torch.cuda.Event()
                event.record(stream)
            return out, event

        attempts = {"n": 0}

        def copy_attempt():
            attempts["n"] += 1
            return _with_watchdog(copy_once, self.config.stage_timeout_s, "transfer",
                                  f"chunk {staged.index}", on_abandon=self._stray_threads.append)

        with obs.span("ingest.transfer", cat="io", chunk=staged.index, bytes=nbytes):
            dev, event = _retry.retry_call(
                copy_attempt, retries=2, base_delay=0.02, max_delay=0.25,
                label=f"pipeline transfer chunk {staged.index}",
            )
        if attempts["n"] > 1:
            self.stats.note("transfer", 0.0, retries=attempts["n"] - 1)
        ring.note_transfer(staged.ring_slot, event)
        dt = time.perf_counter() - t0
        self.stats.note("transfer", dt, t0=t0, bytes_to_device=nbytes)
        reg = obs.registry()
        reg.inc("ingest.pipeline.bytes_to_device", nbytes)
        reg.observe("ingest.pipeline.transfer_ms", dt * 1e3)
        return {"index": staged.index, "start_row": staged.start_row, "rows": staged.rows,
                **dev, "event": event}

    # -- assembly entry points ---------------------------------------------

    def _group_records(self, index: int) -> int:
        """The records of file group ``index`` from its block headers, read
        through the ``ingest.read`` seam (retried like a decode)."""
        from photon_ml_tpu_torch.io.ingest import _resilient_read

        group = self.groups[index]
        return _resilient_read(lambda: sum(count_records(f) for f in group),
                               label=f"pipeline count chunk {index} ({group[0]}...)")

    def labeled_batch(self, vocab_index: int = 0, dtype=None, device="cpu"):
        """-> (LabeledBatch on ``device``, uids, label_present): the whole
        dataset assembled on the device, bit for bit the one-shot
        ``IngestSource.labeled_batch`` on the same files. The (n, d) and
        (n,) tensors are preallocated from the groups' record counts (a
        group whose count exhausts its retries follows ``epoch_policy``,
        as its decode would), and each device chunk is deposited into its
        rows and released, so the device peak
        (``hbm_watermark("io.ingest.assemble")``, kept in
        ``assemble_watermark``) is the dataset plus the chunks in flight."""
        from photon_ml_tpu_torch.core.types import LabeledBatch

        device = torch.device(device)
        out_dtype, _ = _dtypes(dtype or torch.float32)
        cuda = _is_cuda(device)
        t_start = time.perf_counter()
        kept: List[int] = []
        capacity = 0
        for i in range(len(self.groups)):
            try:
                capacity += self._group_records(i)
            except BaseException as e:  # noqa: BLE001 — policy gate
                if not self._skip_group(i, e):
                    raise
                continue
            kept.append(i)
        if capacity == 0:
            raise ValueError(f"no records found in {self.files}")
        d = len(self.vocabs[vocab_index])
        uids_parts: List[np.ndarray] = []
        present_parts: List[np.ndarray] = []

        def parts_with_meta():
            # tee the host metadata off the decoded parts while the staged
            # chunks go to the device
            for part in self.parts(kept):
                uids_parts.append(part["uids"])
                present_parts.append(part["label_present"])
                yield part

        total = 0
        with obs.hbm_watermark("io.ingest.assemble", device=device if cuda else None) as wm:
            buf = {k: torch.empty((capacity, d) if k == "features" else (capacity,),
                                  dtype=out_dtype, device=device) for k in COLUMNS}
            for dev in self.device_chunks(vocab_index=vocab_index, dtype=out_dtype,
                                          device=device, parts=parts_with_meta()):
                lo, hi = dev["start_row"], dev["start_row"] + dev["rows"]
                if hi > capacity:
                    raise ValueError(
                        f"{self.files} decoded more records than their block "
                        f"headers state ({capacity})")
                t0 = time.perf_counter()
                for k in COLUMNS:
                    buf[k][lo:hi].copy_(dev[k])
                # the chunk's last reference: its memory returns to the
                # allocator before the next chunk is copied (the peak is the
                # dataset and one chunk)
                del dev
                self.stats.note("consume", time.perf_counter() - t0, t0=t0)
                total = hi
            if cuda:
                # the dataset is complete once the last deposit has run
                t0 = time.perf_counter()
                torch.cuda.current_stream(device).synchronize()
                self.stats.note("consume", time.perf_counter() - t0, t0=t0)
        self.assemble_watermark = wm
        self.stats.finish(time.perf_counter() - t_start)
        if total == 0:
            raise ValueError(f"no records found in {self.files}")
        if total < capacity:
            # groups skipped by the epoch policy in decode: the rows decoded,
            # in order
            buf = {k: t[:total] for k, t in buf.items()}
        batch = LabeledBatch(buf["features"], buf["labels"], buf["offsets"],
                             buf["weights"], buf["mask"])
        return batch, np.concatenate(uids_parts), np.concatenate(present_parts)

    def read_columnar(self) -> dict:
        """The pipeline's ``native.read_columnar(files, vocabs, ...)``: the
        same output dict, decoded by the bounded pool (the GAME ingest,
        ``IngestSource.game_data_streamed``)."""
        t_start = time.perf_counter()
        parts = list(self.parts())
        if not parts:
            raise ValueError(f"no records found in {self.files}")
        out = parts[0] if len(parts) == 1 else _merge_parts(
            parts, self.entity_keys, len(self.vocabs))
        self.stats.finish(time.perf_counter() - t_start)
        return out


def _merge_parts(parts: List[dict], entity_keys: Sequence[str], nvocabs: int) -> dict:
    """Concatenate decoded parts in order; COO row ids shift by the running
    row total (the merge of ``native.read_columnar``)."""
    n = sum(p["n"] for p in parts)
    row_base = np.cumsum([0] + [p["n"] for p in parts])[:-1]
    coo = []
    for vi in range(nvocabs):
        rows = np.concatenate([p["coo"][vi][0].astype(np.int64) + base
                               for p, base in zip(parts, row_base)])
        cols = np.concatenate([p["coo"][vi][1] for p in parts])
        vals = np.concatenate([p["coo"][vi][2] for p in parts])
        coo.append((rows, cols, vals))
    return {
        "n": n,
        "labels": np.concatenate([p["labels"] for p in parts]),
        "label_present": np.concatenate([p["label_present"] for p in parts]),
        "offsets": np.concatenate([p["offsets"] for p in parts]),
        "weights": np.concatenate([p["weights"] for p in parts]),
        "uids": np.concatenate([p["uids"] for p in parts]),
        "entities": {k: np.concatenate([p["entities"][k] for p in parts])
                     for k in entity_keys},
        "coo": coo,
    }


# ---------------------------------------------------------------------------
# out-of-core epochs: StreamedDesign + StreamingObjective
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class StreamedDesign:
    """A host-resident chunked dense dataset for out-of-core training: each
    objective pass streams the uniform chunks to ``device``. Every chunk
    has the shape (``rows_per_chunk``, d); padding rows carry mask 0 and so
    vanish from every masked sum. For a CUDA device the chunks are pinned
    host tensors, pinned once when the design is built (``pin_s``)."""

    chunks: List[Dict[str, torch.Tensor]]
    n: int
    d: int
    rows_per_chunk: int
    dtype: torch.dtype
    device: torch.device = torch.device("cpu")
    pin_s: float = 0.0

    def __post_init__(self):
        self._slots = None  # the two device slots, made at the first sweep
        self._copy_stream = None
        self._origin = None  # the event the sweeps' device times count from

    @property
    def num_chunks(self) -> int:
        return len(self.chunks)

    @property
    def chunk_bytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in self.chunks[0].values())

    @property
    def bytes_per_epoch(self) -> int:
        return self.chunk_bytes * self.num_chunks

    @staticmethod
    def _chunk(source: Dict[str, object], rows: int, rpc: int, d: int,
               dtype: torch.dtype, pin: bool) -> Dict[str, torch.Tensor]:
        """A fresh host chunk of ``rpc`` rows holding the first ``rows`` of
        each column of ``source`` (tensors or arrays), zero below."""
        out = {}
        for k in COLUMNS:
            t = _host_tensor((rpc, d) if k == "features" else (rpc,), dtype, pin)
            t[:rows] = torch.as_tensor(source[k][:rows], dtype=dtype)
            out[k] = t
        return out

    @staticmethod
    def from_pipeline(pipeline: IngestPipeline, vocab_index: int = 0,
                      dtype=torch.float64, rows_per_chunk: Optional[int] = None,
                      device="cpu") -> "StreamedDesign":
        """Decode (in parallel) and stage (uniform, padded) once, and keep
        the chunks on the host, copied out of the reused ring into their
        own tensors (pinned for a CUDA device; ``pin_s`` is their
        allocation and copy)."""
        device = torch.device(device)
        pin = _is_cuda(device)
        t_dtype, _ = _dtypes(dtype)
        d = len(pipeline.vocabs[vocab_index])
        out: List[Dict[str, torch.Tensor]] = []
        n = 0
        rpc = None
        pin_s = 0.0
        for staged in pipeline.chunks(vocab_index=vocab_index, dtype=t_dtype,
                                      rows_per_chunk=rows_per_chunk, pad_tail=True):
            rpc = staged.features.shape[0]
            n += staged.rows
            t0 = time.perf_counter()
            out.append(StreamedDesign._chunk(staged.tensors, rpc, rpc, d, t_dtype, pin))
            pin_s += time.perf_counter() - t0
        if not out:
            raise ValueError(f"no records found in {pipeline.files}")
        return StreamedDesign(chunks=out, n=n, d=d, rows_per_chunk=rpc, dtype=t_dtype,
                              device=device, pin_s=pin_s if pin else 0.0)

    @staticmethod
    def from_batch(batch, rows_per_chunk: int, device=None) -> "StreamedDesign":
        """Split an in-core dense LabeledBatch into an out-of-core design
        streamed to ``device`` (default: the batch's)."""
        feats = batch.features
        if not torch.is_tensor(feats) or feats.ndim != 2:
            raise ValueError("StreamedDesign requires dense features")
        device = torch.device(device if device is not None else batch.labels.device)
        pin = _is_cuda(device)
        n, d = feats.shape
        cols = {"features": feats.cpu(), **{k: getattr(batch, k).cpu() for k in COLUMNS[1:]}}
        t0 = time.perf_counter()
        chunks = []
        for lo in range(0, n, rows_per_chunk):
            hi = min(lo + rows_per_chunk, n)
            chunks.append(StreamedDesign._chunk({k: v[lo:hi] for k, v in cols.items()},
                                                hi - lo, rows_per_chunk, d, feats.dtype, pin))
        return StreamedDesign(chunks=chunks, n=n, d=d, rows_per_chunk=rows_per_chunk,
                              dtype=feats.dtype, device=device,
                              pin_s=time.perf_counter() - t0 if pin else 0.0)

    def device_slots(self):
        """(the two device slots, the copy stream, the timing origin) for a
        CUDA device, made once and kept for the design's life; the origin
        is a timed event that every sweep's device intervals count from."""
        if self._slots is None:
            self._copy_stream = torch.cuda.Stream(device=self.device)
            self._slots = [
                {"chunk": {k: torch.empty(t.shape, dtype=t.dtype, device=self.device)
                           for k, t in self.chunks[0].items()},
                 "copied": None, "consumed": None}
                for _ in range(2)
            ]
            self._origin = torch.cuda.Event(enable_timing=True)
            self._origin.record(torch.cuda.current_stream(self.device))
        return self._slots, self._copy_stream, self._origin


def _batch_of(chunk: Dict[str, torch.Tensor]):
    from photon_ml_tpu_torch.core.types import LabeledBatch

    return LabeledBatch(chunk["features"], chunk["labels"], chunk["offsets"],
                        chunk["weights"], chunk["mask"])


class StreamingObjective:
    """The exact full-dataset GLM objective over a :class:`StreamedDesign`,
    one chunk at a time: every evaluation streams all chunks to the device
    (the double buffer: chunk i+1's copy issued on the copy stream before
    chunk i's pass), runs the per-chunk pass of the port's
    :class:`~photon_ml_tpu_torch.ops.objective.GLMObjective` on a dense
    masked batch, sums the partials on the device in chunk order, and adds
    the L2 term once. Value, gradient, Hessian-vector product and diagonal
    are plain row sums, so the only difference from the in-core objective
    is the reassociation at the chunk boundaries. Nothing here reads the
    device from the host: the solver reads the value it needs.

    ``stats`` gets each sweep's copy and pass intervals, its wall and its
    bytes. On the CPU they are host times. On the card they are device
    times from timed CUDA events (the copies on the copy stream, the passes
    on the compute stream, the sweep from its first event to the event
    after its last pass), read once the sweep's last event has fired: at a
    later sweep if it already has, else at :meth:`flush_timing`."""

    def __init__(self, design: StreamedDesign, loss, l2_weight: float = 0.0,
                 stats: Optional[PipelineStats] = None):
        from photon_ml_tpu_torch.ops.objective import GLMObjective

        self.design = design
        self.loss = loss
        self.l2_weight = float(l2_weight)
        self.stats = stats if stats is not None else PipelineStats()
        self._obj = GLMObjective(loss=loss)
        self._unread: List[tuple] = []  # card sweeps whose events are unread

    # -- per-chunk partial passes (no L2) -----------------------------------

    def _vg_pass(self, w, batch):
        val, grad, _ = self._obj.value_grad_curvature(w, batch)
        return val, grad

    def _hv_pass(self, w, v, batch):
        curv = self._obj.hessian_coefficients(w, batch)
        return (self._obj.hessian_vector_at(curv, v, batch),)

    def _diag_pass(self, w, batch):
        return (self._obj.hessian_diagonal(w, batch),)

    # -- one epoch ------------------------------------------------------------

    def _sweep(self, kind: str, pass_fn, *w_args):
        """Stream every chunk through ``pass_fn`` and return the partials
        summed in chunk order."""
        design = self.design
        reg = obs.registry()
        with obs.span("ingest.oocore.sweep", cat="io", kind=kind,
                      chunks=design.num_chunks):
            if _is_cuda(design.device):
                self._read_timing(block=False)
                carry = self._sweep_cuda(pass_fn, w_args)
            else:
                t0 = time.perf_counter()
                carry = None
                for chunk in design.chunks:
                    tc0 = time.perf_counter()
                    partial = pass_fn(*w_args, _batch_of(chunk))
                    carry = partial if carry is None else tuple(
                        a + b for a, b in zip(carry, partial))
                    self.stats.note("consume", time.perf_counter() - tc0, t0=tc0)
                wall = time.perf_counter() - t0
                self.stats.finish(wall)
                reg.observe("ingest.oocore.sweep_ms", wall * 1e3)
        reg.inc("ingest.oocore.sweeps")
        reg.inc(f"ingest.oocore.sweeps.{kind}")
        return carry

    def _sweep_cuda(self, pass_fn, w_args):
        design = self.design
        slots, copy_stream, origin = design.device_slots()
        compute = torch.cuda.current_stream(design.device)
        copies: List[Tuple[object, object]] = []
        passes: List[Tuple[object, object]] = []

        def timed(stream):
            event = torch.cuda.Event(enable_timing=True)
            event.record(stream)
            return event

        def issue(i):
            slot = slots[i % 2]
            # the slot is refilled only after the pass that read it (before
            # its first use: after the compute stream's work so far)
            if slot["consumed"] is None:
                copy_stream.wait_stream(compute)
            else:
                copy_stream.wait_event(slot["consumed"])
            with torch.cuda.stream(copy_stream):
                c0 = timed(copy_stream)
                for k, t in design.chunks[i].items():
                    slot["chunk"][k].copy_(t, non_blocking=True)
                slot["copied"] = timed(copy_stream)
            copies.append((c0, slot["copied"]))

        start = timed(compute)
        issue(0)
        carry = None
        for i in range(design.num_chunks):
            if i + 1 < design.num_chunks:
                issue(i + 1)
            slot = slots[i % 2]
            compute.wait_event(slot["copied"])
            p0 = timed(compute)
            partial = pass_fn(*w_args, _batch_of(slot["chunk"]))
            carry = partial if carry is None else tuple(
                a + b for a, b in zip(carry, partial))
            slot["consumed"] = timed(compute)
            passes.append((p0, slot["consumed"]))
        self._unread.append((origin, start, copies, passes))
        return carry

    def _read_timing(self, block: bool) -> None:
        """Note the card sweeps whose last event has fired (every one, once
        it has, with ``block``) into ``stats``: each copy and pass as a
        device interval from the design's origin, the sweep's wall from its
        first event to its last, and its bytes."""
        reg = obs.registry()
        while self._unread:
            origin, start, copies, passes = self._unread[0]
            end = passes[-1][1]
            if block:
                end.synchronize()
            elif not end.query():
                return
            self._unread.pop(0)

            def at(event):
                return origin.elapsed_time(event) / 1e3

            first = min(at(start), at(copies[0][0]))
            for stage, intervals in (("transfer", copies), ("consume", passes)):
                for a, b in intervals:
                    self.stats.note(stage, at(b) - at(a), t0=at(a))
            wall = at(end) - first
            self.stats.note("transfer", 0.0, bytes_to_device=self.design.bytes_per_epoch)
            self.stats.finish(wall)
            reg.observe("ingest.oocore.sweep_ms", wall * 1e3)

    def flush_timing(self) -> None:
        """Wait for the card sweeps still unread and note them in ``stats``
        (nothing to do on the CPU)."""
        self._read_timing(block=True)

    # -- the solver surface ---------------------------------------------------

    def value_and_grad(self, w: torch.Tensor):
        """Full-dataset (value, grad) at ``w`` (a tensor on the design's
        device), L2 included."""
        val, grad = self._sweep("value_and_grad", self._vg_pass, w)
        if self.l2_weight:
            val = val + 0.5 * self.l2_weight * torch.dot(w, w)
            grad = grad + self.l2_weight * w
        return val, grad

    def hessian_vector(self, w: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        """Full-dataset H(w) @ v, L2 included."""
        (hv,) = self._sweep("hessian_vector", self._hv_pass, w, v)
        if self.l2_weight:
            hv = hv + self.l2_weight * v
        return hv

    def hessian_diagonal(self, w: torch.Tensor) -> torch.Tensor:
        """diag(H) + l2 (feeds the coefficient variances)."""
        (diag,) = self._sweep("hessian_diagonal", self._diag_pass, w)
        return diag + self.l2_weight
