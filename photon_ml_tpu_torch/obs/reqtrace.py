"""Request-causality layer: trace ids, hop notes, timeline rebuild (a copy of
``photon_ml_tpu/obs/reqtrace.py``).

The serving fabric (docs/FRONTEND.md) answers every request through five
independently-instrumented layers — wire frame, tenant admission, the
micro-batcher's coalescing window, a replica hop (possibly several, when
a breaker forces failover), and the sharded engine's device call. Each
layer already records spans/events, but nothing tied them together: a
slow request was five disconnected log lines. This module is the Dapper
seam:

- **Trace ids.** :func:`ensure_trace_id` accepts a client-supplied
  ``trace`` field from the wire envelope (validated — the id crosses
  process boundaries and lands in filenames/JSONL, so the alphabet is
  closed) or issues a fresh one. The id rides the tenant envelope and
  the batcher item; the batcher stamps it on the per-request
  ``serving.request`` retro-span, whose ``batch_id`` is the join key the
  batch-scoped spans below it (``serving.score``, ``replica.hop``,
  ``serving.cache.miss``) already carry via the ambient span context.
- **Hop notes.** :func:`collect_notes` opens a thread-local channel for
  the duration of one batch score call; :func:`note` (called by
  :class:`~photon_ml_tpu_torch.frontend.replicas.ReplicaRouter` per attempt)
  reports replica hops upward without the router needing a reference to
  the batcher — that is how a request's retro-span learns it was
  failover-touched, which in turn drives 100%-keep exemplar sampling
  (obs/exemplars.py).
- **Timeline rebuild.** :func:`reconstruct_timeline` inverts the join
  offline: given ``events.jsonl`` records (one shard, or several merged
  by ``photon-obs merge`` / :func:`obs.dist.merge_events_shards`) and a
  trace id, it returns the causal timeline — wire-read, queue wait,
  batch assembly, replica hop(s), device call, merge, reply-write — with
  failover/degraded/truncation flags. ``photon-obs request`` renders it;
  the ``trace_loss`` chaos drill asserts over it.

Pure stdlib on purpose: importable from CPU-only subprocesses and before
backend selection, like :mod:`obs.trace`.
"""

from __future__ import annotations

import itertools
import os
import re
import threading
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

__all__ = [
    "new_trace_id",
    "valid_trace_id",
    "ensure_trace_id",
    "collect_notes",
    "note",
    "trace_ids",
    "reconstruct_timeline",
    "find_orphans",
]

# Client-supplied ids: bounded length, closed alphabet. Anything else is
# replaced (never errored — a malformed trace id must not fail scoring).
_TRACE_RE = re.compile(r"^[A-Za-z0-9._:-]{1,64}$")

# Issued ids: 8 random bytes + a process-wide sequence. The random half
# keeps ids unique across processes/restarts without coordination; the
# sequence half keeps them unique within a process even if the entropy
# source ever repeats.
_SEQ = itertools.count(1)


def new_trace_id() -> str:
    return f"{os.urandom(8).hex()}-{next(_SEQ):x}"


def valid_trace_id(candidate: Any) -> bool:
    return isinstance(candidate, str) and bool(_TRACE_RE.match(candidate))


def ensure_trace_id(candidate: Any) -> Tuple[str, bool]:
    """``(trace_id, issued)``: the validated client id, or a fresh one
    (``issued=True``) when the client sent none — or sent garbage."""
    if valid_trace_id(candidate):
        return candidate, False
    return new_trace_id(), True


# ---------------------------------------------------------------------------
# Hop notes: router -> batcher, per batch, without a reference cycle
# ---------------------------------------------------------------------------

_notes = threading.local()


class collect_notes:
    """Context manager opening a per-thread note channel for one batch
    score call. The list it yields accumulates every :func:`note` made
    on this thread inside the block — the replica router's hop reports.
    Nesting replaces the channel for the inner block (batchers never
    nest, but a drill's direct ``score`` call inside a traced flush must
    not corrupt the outer channel)."""

    __slots__ = ("_prev", "notes")

    def __enter__(self) -> List[Dict[str, Any]]:
        self._prev = getattr(_notes, "active", None)
        self.notes = _notes.active = []
        return self.notes

    def __exit__(self, *exc) -> bool:
        _notes.active = self._prev
        return False


def note(**fields) -> None:
    """Report one hop/annotation to the collecting batcher, if any is
    listening on this thread. No-op otherwise — callers never check."""
    active = getattr(_notes, "active", None)
    if active is not None:
        active.append(fields)


# ---------------------------------------------------------------------------
# Offline timeline reconstruction
# ---------------------------------------------------------------------------

# Records joined into a timeline via the batch id (batch-scoped work the
# per-request span shares with its batchmates).
_BATCH_SCOPED = (
    "serving.score",
    "serving.route.merge",
    "serving.route.group",
    "serving.route.pad",
    "replica.hop",
    "serving.cache.miss",
    "serving.cache.promotion",
    "replica.down",
)


def trace_ids(records: Iterable[Dict[str, Any]]) -> List[str]:
    """Every distinct trace id present, in first-seen order."""
    seen: Dict[str, None] = {}
    for rec in records:
        tid = rec.get("trace")
        if isinstance(tid, str) and tid not in seen:
            seen[tid] = None
    return list(seen)


def _segments(request_span: Dict[str, Any],
              events: Sequence[Dict[str, Any]]) -> Dict[str, float]:
    """The no-unattributed-gap decomposition: wire read and queue/
    assembly/device from the retro-span's args, reply write from the
    frontend's own retro-span."""
    seg: Dict[str, float] = {}
    for key in ("wire_read_ms", "queue_wait_ms", "assembly_ms",
                "device_ms"):
        val = request_span.get(key)
        if isinstance(val, (int, float)):
            seg[key] = float(val)
    for rec in events:
        if rec.get("name") == "frontend.reply_write":
            seg["reply_write_ms"] = float(rec.get("duration_ms", 0.0))
    return seg


def reconstruct_timeline(
    records: Sequence[Dict[str, Any]], trace_id: str
) -> Optional[Dict[str, Any]]:
    """One trace id -> its causal timeline, or None when the id appears
    nowhere.

    Two-phase join: (1) records explicitly stamped with the trace id
    (frontend wire spans, the per-request ``serving.request`` span);
    (2) batch-scoped records sharing a ``batch_id`` with phase 1 — but
    never a record stamped with a DIFFERENT trace (a batchmate's
    ``serving.request`` is its own timeline's, not ours). Events come
    back sorted by ``time_unix``.
    """
    own = [r for r in records if r.get("trace") == trace_id]
    if not own:
        return None
    batch_ids = {
        r["batch_id"] for r in own
        if isinstance(r.get("batch_id"), int)
    }
    shared = [
        r for r in records
        if r.get("trace") is None
        and r.get("batch_id") in batch_ids
        and r.get("name") in _BATCH_SCOPED
    ]
    events = sorted(
        own + shared, key=lambda r: r.get("time_unix", 0.0)
    )
    request_spans = [
        r for r in own if r.get("name") == "serving.request"
    ]
    # an error-marked retro-span (the batcher's failed-batch path) links
    # the batch for the join but does NOT complete the timeline
    ok_spans = [r for r in request_spans if not r.get("error")]
    hops = [
        {
            "replica": r.get("replica"),
            "attempt": r.get("attempt"),
            "error": bool(r.get("error")),
            "host": r.get("host"),
        }
        for r in events
        if r.get("name") == "replica.hop"
    ]
    cache_misses = sum(
        int(r.get("misses", 0)) for r in events
        if r.get("name") == "serving.cache.miss"
    )
    complete = bool(ok_spans)
    first = ok_spans[0] if ok_spans else (
        request_spans[0] if request_spans else {}
    )
    timeline = {
        "trace": trace_id,
        "complete": complete,
        # seen at the frontend / in-flight but never scored: a replica
        # kill (or shed/expiry) truncated it — the photo of a request
        # the fabric lost, explicitly marked instead of orphaned
        "truncated": not complete,
        "failover": any(h["error"] for h in hops) or bool(
            first.get("failover")
        ),
        "degraded": bool(first.get("degraded")),
        "error": first.get("error"),
        "request_id": first.get("request_id"),
        "batch_ids": sorted(batch_ids),
        "hops": hops,
        "cache_misses": cache_misses,
        "segments": _segments(first, events),
        "hosts": sorted({
            r["host"] for r in events if isinstance(r.get("host"), int)
        }),
        "events": events,
    }
    return timeline


def find_orphans(
    records: Sequence[Dict[str, Any]],
    timelines: Sequence[Dict[str, Any]],
) -> List[Dict[str, Any]]:
    """Request-scoped records claimed by NO reconstructed timeline —
    the ``trace_loss`` drill's zero-orphan assertion. A record is
    request-scoped when it carries a ``trace`` or names batch-scoped
    work with a ``batch_id``."""
    claimed_traces = {t["trace"] for t in timelines}
    claimed_batches = set()
    for t in timelines:
        claimed_batches.update(t.get("batch_ids", ()))
    orphans = []
    for rec in records:
        tid = rec.get("trace")
        if tid is not None:
            if tid not in claimed_traces:
                orphans.append(rec)
            continue
        if (
            rec.get("name") in _BATCH_SCOPED
            and isinstance(rec.get("batch_id"), int)
            and rec["batch_id"] not in claimed_batches
        ):
            orphans.append(rec)
    return orphans
