"""Pod-level (multi-process) observability: identity, clock sync, merging
(a copy of ``photon_ml_tpu/obs/dist.py``; the identity is set from
``torch.distributed``'s rank and world size, and the environment fallback
reads the PHOTON_PROCESS_* variables alone).

Everything the obs layer built so far is strictly per-process: each host
of a pod writes its own ``trace.json`` / ``events.jsonl`` / ``metrics.json``
with its own monotonic epoch, and nothing relates host 3's coordinate
pass to the all-reduce host 0 was blocked in at the same instant. The
GAME workload only makes sense at multi-host scale ("hundreds of
billions of coefficients" sharded across a cluster), so this module adds
the three missing pieces:

- **Process identity.** :func:`process_identity` resolves this process's
  ``(index, count)`` — explicitly set by ``parallel.multihost`` once a
  ``torch.distributed`` world is joined, or from the
  ``PHOTON_PROCESS_INDEX`` / ``PHOTON_PROCESS_COUNT`` environment
  variables. The tracer stamps it on every artifact: the
  Chrome ``pid`` becomes the process index (distinct Perfetto tracks),
  the process-name metadata gains a ``host.<i>`` label, JSONL records
  carry a ``host`` field, and :func:`host_metric_prefix` gives merged
  metrics their ``host.<i>.`` namespace. Deliberately env-and-explicit
  only — resolving identity must never initialize a device backend (the
  tracer is importable from CPU-only subprocesses).

- **Clock sync.** Per-process trace timestamps are microseconds since
  each tracer's OWN ``perf_counter`` epoch; two shards cannot be laid on
  one timeline without a common instant. :func:`emit_clock_sync` records
  a ``clock.sync`` instant event — optionally behind a caller-supplied
  barrier (``multihost.emit_pod_sync`` passes a ``torch.distributed``
  barrier), so every process's sync event marks the SAME
  wall instant regardless of host clock skew.

- **Shard merging.** :func:`merge_trace_shards` folds per-process
  ``trace.json`` documents into ONE Perfetto-loadable pod trace:
  per-shard clocks are aligned at the shared ``clock.sync`` event
  (fallback: the ``epoch_unix`` metadata when a shard predates sync
  events or crashed before emitting one), pids are rewritten to process
  indices with fresh ``process_name``/``process_sort_index`` metadata,
  exact-duplicate events (re-read shards, duplicated span ids) are
  dropped, and the result is ts-sorted and normalized to a non-negative
  origin. Truncated or missing shards are SKIPPED with a warning, never
  fatal — a post-mortem merge must work with whatever survived.

Pure stdlib, like the tracer: mergeable on any host.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

from photon_ml_tpu_torch.obs.trace import get_tracer

__all__ = [
    "SYNC_EVENT_NAME",
    "process_identity",
    "set_process_identity",
    "host_metric_prefix",
    "emit_clock_sync",
    "load_trace_shard",
    "merge_trace_shards",
    "merge_events_shards",
    "merge_metrics_shards",
    "reset_process_identity",
]

SYNC_EVENT_NAME = "clock.sync"

# explicit identity (set by parallel.multihost after the distributed
# runtime joins, or by tests); None = fall back to the environment
_identity: Optional[Tuple[int, int]] = None


def set_process_identity(index: int, count: int) -> None:
    """Pin this process's pod identity for every obs artifact. Tracers
    constructed AFTER this call stamp it; ``parallel.multihost`` calls it
    the moment the distributed runtime joins."""
    global _identity
    if count <= 0:
        raise ValueError(f"process_count must be positive, got {count}")
    if not (0 <= index < count):
        raise ValueError(f"process_index {index} outside [0, {count})")
    _identity = (int(index), int(count))


def process_identity() -> Tuple[int, int]:
    """``(process_index, process_count)`` — explicit identity if set,
    else the PHOTON_PROCESS_* environment, else ``(0, 1)``. Never touches
    a device backend."""
    if _identity is not None:
        return _identity
    env = os.environ
    idx = env.get("PHOTON_PROCESS_INDEX")
    cnt = env.get("PHOTON_PROCESS_COUNT")
    try:
        if cnt is not None and int(cnt) > 1:
            return (int(idx or 0), int(cnt))
    except ValueError:
        pass
    return (0, 1)


def host_metric_prefix(index: Optional[int] = None) -> str:
    """``"host.<i>."`` in a multi-process run, ``""`` single-process —
    the namespace merged pod metrics live under."""
    idx, count = process_identity()
    if index is not None:
        return f"host.{index}."
    return f"host.{idx}." if count > 1 else ""


def emit_clock_sync(sync_id: str = "startup", barrier=None) -> None:
    """Record a ``clock.sync`` instant event on the active tracer.

    With ``barrier`` (a callable; ``multihost`` passes a
    ``torch.distributed`` barrier) every process blocks until all peers arrive,
    so the events mark one shared wall instant — the anchor
    :func:`merge_trace_shards` aligns per-shard clocks on. Instant events
    flush immediately, so the sync marker survives a later crash. No-op
    untraced."""
    tracer = get_tracer()
    if tracer is None:
        return
    if barrier is not None:
        barrier()
    idx, count = process_identity()
    tracer.add_instant(
        SYNC_EVENT_NAME,
        cat="dist",
        args={
            "sync_id": sync_id,
            "unix_time": time.time(),
            "process_index": idx,
            "process_count": count,
        },
    )


# ---------------------------------------------------------------------------
# Shard merging
# ---------------------------------------------------------------------------


def load_trace_shard(path: str) -> Tuple[Optional[dict], Optional[str]]:
    """Read one shard's ``trace.json``. Returns ``(doc, warning)`` —
    exactly one is None. A directory resolves to ``<dir>/trace.json``.
    Missing, unreadable, truncated, or shape-invalid files are a warning,
    not an exception: merges run during post-mortems."""
    if os.path.isdir(path):
        path = os.path.join(path, "trace.json")
    try:
        with open(path, encoding="utf-8") as f:
            doc = json.load(f)
    except OSError as e:
        return None, f"{path}: unreadable ({e})"
    except json.JSONDecodeError as e:
        return None, f"{path}: truncated/corrupt trace JSON ({e})"
    if not isinstance(doc, dict) or not isinstance(
        doc.get("traceEvents"), list
    ):
        return None, f"{path}: not a Chrome trace-event document"
    return doc, None


def _shard_sync_events(doc: dict) -> Dict[str, dict]:
    """sync_id -> first matching ``clock.sync`` event of one shard."""
    out: Dict[str, dict] = {}
    for ev in doc.get("traceEvents", ()):
        if ev.get("name") == SYNC_EVENT_NAME and ev.get("ph") == "i":
            sid = str((ev.get("args") or {}).get("sync_id", ""))
            out.setdefault(sid, ev)
    return out


def _pick_sync_id(per_shard: Sequence[Dict[str, dict]]) -> Optional[str]:
    """The sync_id to align on: present in the most shards, ties broken
    toward ``"startup"`` (the barrier-backed one)."""
    counts: Dict[str, int] = {}
    for syncs in per_shard:
        for sid in syncs:
            counts[sid] = counts.get(sid, 0) + 1
    if not counts:
        return None
    best = max(counts.values())
    candidates = sorted(s for s, c in counts.items() if c == best)
    if "startup" in candidates:
        return "startup"
    return candidates[0]


def _dedupe_key(ev: dict) -> tuple:
    """Identity of one event for duplicate dropping: phase, name, track,
    window, (for async/flow phases) the explicit id, and the request id
    / trace id when the span carries one in args. Re-read shards and
    duplicated span ids collapse; distinct same-name spans at different
    instants survive — and two replicas' ``serving.request`` spans that
    happen to share a (pid, tid, ts, dur) window are kept apart by their
    instance-namespaced request ids (or the frontend's per-request trace
    ids, which wire_read/reply_write spans carry instead) rather than
    being wrongly collapsed."""
    args = ev.get("args") or {}
    return (
        ev.get("ph"),
        ev.get("name"),
        ev.get("pid"),
        ev.get("tid"),
        round(float(ev.get("ts", 0.0)), 3),
        round(float(ev.get("dur", 0.0)), 3),
        ev.get("id"),
        args.get("request_id"),
        args.get("trace"),
    )


def merge_trace_shards(
    shards: Sequence[Tuple[dict, str]],
) -> Tuple[dict, dict]:
    """Per-process trace documents -> one pod trace document.

    ``shards`` is ``[(doc, label), ...]`` (label = source path, used in
    warnings). Returns ``(merged_doc, info)`` where ``info`` carries
    ``{"shards", "events", "duplicates_dropped", "aligned_by",
    "warnings"}``. See the module docstring for the algorithm.
    """
    warnings: List[str] = []
    metas = []
    for pos, (doc, label) in enumerate(shards):
        meta = doc.get("metadata") or {}
        idx = meta.get("process_index")
        metas.append(
            {
                "doc": doc,
                "label": label,
                "index": int(idx) if isinstance(idx, int) else pos,
                "epoch_unix": meta.get("epoch_unix"),
                "syncs": _shard_sync_events(doc),
            }
        )
    if not metas:
        return (
            {"traceEvents": [], "displayTimeUnit": "ms", "metadata": {}},
            {
                "shards": 0,
                "events": 0,
                "duplicates_dropped": 0,
                "aligned_by": "none",
                "warnings": ["no shards to merge"],
            },
        )
    # positional fallback above may collide with explicit indices
    # (e.g. one shard lost its metadata); disambiguate deterministically
    used: Dict[int, int] = {}
    for m in metas:
        while m["index"] in used:
            m["index"] += 1
        used[m["index"]] = 1

    ref = min(metas, key=lambda m: m["index"])
    sync_id = _pick_sync_id([m["syncs"] for m in metas])
    aligned_by = "sync" if sync_id is not None else "epoch_unix"
    ref_sync = ref["syncs"].get(sync_id) if sync_id is not None else None

    merged: List[dict] = []
    seen: set = set()
    dupes = 0
    for m in metas:
        offset = 0.0
        shard_sync = (
            m["syncs"].get(sync_id) if sync_id is not None else None
        )
        if ref_sync is not None and shard_sync is not None:
            # the two sync events mark ONE barrier instant: aligning
            # them corrects both epoch offsets and host clock skew
            offset = float(ref_sync["ts"]) - float(shard_sync["ts"])
        elif (
            m["epoch_unix"] is not None
            and ref["epoch_unix"] is not None
        ):
            offset = (
                float(m["epoch_unix"]) - float(ref["epoch_unix"])
            ) * 1e6
            if m is not ref and aligned_by == "sync":
                warnings.append(
                    f"{m['label']}: no {sync_id!r} sync event; aligned "
                    "by wall-clock epoch (skew not corrected)"
                )
        pid = m["index"]
        name = "photon_ml_tpu"
        for ev in m["doc"].get("traceEvents", ()):
            if ev.get("ph") == "M":
                if ev.get("name") == "process_name":
                    raw = (ev.get("args") or {}).get("name", name)
                    # one host.<i> label regardless of whether the
                    # shard already carried one
                    name = str(raw).split(" host.")[0]
                continue  # fresh metadata is emitted per shard below
            out = dict(ev)
            out["pid"] = pid
            if ev.get("ph") != "M":
                out["ts"] = round(float(ev.get("ts", 0.0)) + offset, 3)
            key = _dedupe_key(out)
            if key in seen:
                dupes += 1
                continue
            seen.add(key)
            merged.append(out)
        merged.append(
            {
                "ph": "M",
                "name": "process_name",
                "pid": pid,
                "tid": 0,
                "ts": 0,
                "args": {"name": f"host.{pid} {name}"},
            }
        )
        merged.append(
            {
                "ph": "M",
                "name": "process_sort_index",
                "pid": pid,
                "tid": 0,
                "ts": 0,
                "args": {"sort_index": pid},
            }
        )
    # normalize: Perfetto handles negative ts poorly; shift the merged
    # timeline so the earliest non-metadata event lands at 0
    non_meta = [e for e in merged if e["ph"] != "M"]
    if non_meta:
        t_min = min(float(e["ts"]) for e in non_meta)
        if t_min != 0.0:
            for e in non_meta:
                e["ts"] = round(float(e["ts"]) - t_min, 3)
    merged.sort(key=lambda e: (e.get("ph") != "M", float(e.get("ts", 0.0))))
    doc = {
        "traceEvents": merged,
        "displayTimeUnit": "ms",
        "metadata": {
            "merged_shards": len(metas),
            "aligned_by": aligned_by,
            "sync_id": sync_id,
            "process_count": max(
                [len(metas)]
                + [
                    int((m["doc"].get("metadata") or {}).get(
                        "process_count", 0
                    ) or 0)
                    for m in metas
                ]
            ),
        },
    }
    info = {
        "shards": len(metas),
        "events": len(non_meta),
        "duplicates_dropped": dupes,
        "aligned_by": aligned_by,
        "warnings": warnings,
    }
    return doc, info


def merge_events_shards(
    paths: Sequence[Tuple[str, int]],
) -> Tuple[List[dict], List[str]]:
    """Per-process ``events.jsonl`` files -> one host-tagged record list
    sorted by ``time_unix``. ``paths`` is ``[(path, process_index),...]``.
    Unparseable lines (a record torn mid-write by the crash the merge is
    investigating) are skipped and counted, never fatal."""
    records: List[dict] = []
    warnings: List[str] = []
    for path, idx in paths:
        if os.path.isdir(path):
            path = os.path.join(path, "events.jsonl")
        try:
            with open(path, encoding="utf-8") as f:
                lines = f.readlines()
        except OSError as e:
            warnings.append(f"{path}: unreadable ({e})")
            continue
        bad = 0
        for line in lines:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                bad += 1
                continue
            if isinstance(rec, dict):
                rec.setdefault("host", idx)
                records.append(rec)
        if bad:
            warnings.append(f"{path}: skipped {bad} torn record(s)")
    records.sort(key=lambda r: r.get("time_unix", 0.0))
    return records, warnings


def merge_metrics_shards(
    snapshots: Sequence[Tuple[dict, int]],
) -> dict:
    """Per-process ``metrics.json`` snapshots -> one pod snapshot with
    every instrument under its ``host.<i>.`` prefix, plus ``pod.*``
    counter sums (the cross-host aggregate a dashboard wants first)."""
    out: dict = {"counters": {}, "gauges": {}, "histograms": {}}
    pod: Dict[str, float] = {}
    for snap, idx in snapshots:
        prefix = host_metric_prefix(index=idx)
        for kind in ("counters", "gauges", "histograms"):
            for name, value in (snap.get(kind) or {}).items():
                out[kind][prefix + name] = value
                if kind == "counters":
                    pod[name] = pod.get(name, 0.0) + float(value)
    for name, total in pod.items():
        out["counters"][f"pod.{name}"] = total
    return out


def reset_process_identity() -> None:
    """Forget the explicit identity (``parallel.multihost`` calls it when
    the process leaves its world); the environment decides again."""
    global _identity
    _identity = None
