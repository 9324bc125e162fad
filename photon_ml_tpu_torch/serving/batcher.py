"""Deadline-based micro-batching with admission control for the scoring
engine (a copy of ``photon_ml_tpu/serving/batcher.py``).

One device call amortizes dispatch overhead across every request that
arrives within a small window: the worker takes the first queued request,
then keeps collecting until ``max_batch`` requests coalesce or
``max_wait_ms`` elapses from the first one — the classic serving trade of
a bounded latency tax for multiplied throughput. Because the engine pads
to power-of-two buckets, any occupancy in (bucket/2, bucket] costs the
same device time, so coalescing is nearly free once the first request has
paid the wait.

Overload handling is layered (docs/ROBUSTNESS.md):

- **Deadlines.** A request may carry a deadline; once it passes, the
  request is dropped BEFORE batch assembly and its Future resolves to
  :class:`DeadlineExceeded`. The caller already stopped waiting — scoring
  it anyway would burn device work on an answer nobody reads (which is
  exactly what a timed-out ``score_sync`` used to do).
- **Bounded queue + admission control.** When ``queue_depth`` requests
  are already waiting, :meth:`MicroBatcher.submit` first expires dead
  requests (oldest first), then — if the newcomer outranks queued work —
  sheds the oldest strictly-lower-``priority`` request, and only then
  fails fast with :class:`Backpressure`. An unbounded queue just converts
  overload into latency collapse.
- **Degraded mode.** Under *sustained* pressure (queue above its high
  water mark for ``degrade_after_s``) batches route to an optional
  ``degraded_score_fn`` — fixed-effect-only scoring, a cheaper answer for
  every request instead of no answer for some — and recover to full
  fidelity after the queue stays below the low water mark.

Shutdown integrates with :class:`photon_ml_tpu_torch.resilience.shutdown.
GracefulShutdown` through its ``register_drain`` hook: ``begin_drain`` is
signal-safe (sets a flag, never blocks), new submissions are refused, and
every request already queued is scored before the worker exits — a
SIGTERM drops zero accepted requests.
"""

from __future__ import annotations

import itertools
import queue
import threading
import time
from concurrent.futures import Future
from typing import Callable, List, Optional, Sequence

import numpy as np

from photon_ml_tpu_torch import obs
from photon_ml_tpu_torch.obs import exemplars as _exemplars
from photon_ml_tpu_torch.obs import reqtrace as _reqtrace
from photon_ml_tpu_torch.serving.stats import ServingStats, SloTracker


class Backpressure(RuntimeError):
    """The bounded request queue is full (or the batcher is draining)."""


class DeadlineExceeded(TimeoutError):
    """The request's deadline passed while it waited in the queue; it was
    dropped before reaching the device (counted as ``expired``)."""


# process-wide batcher instance ids: every MicroBatcher gets one, and
# request ids are namespaced by it (rid = instance_id << 32 | seq).
# Without the namespace, R replicated batchers each count 1, 2, 3, ...
# and their `serving.request` spans collide in merged traces — the
# merge dedup would silently drop one replica's requests as duplicates.
_INSTANCE_IDS = itertools.count(1)


class _Item:
    __slots__ = ("request", "future", "enqueued", "rid", "deadline",
                 "priority", "over_quota", "trace", "wire_ms")

    def __init__(self, request, rid: int = 0, deadline: Optional[float] = None,
                 priority: int = 0, over_quota: bool = False,
                 trace: Optional[str] = None,
                 wire_ms: Optional[float] = None):
        self.request = request
        self.future: Future = Future()
        self.enqueued = time.perf_counter()
        self.rid = rid
        self.deadline = deadline  # absolute perf_counter seconds, or None
        self.priority = priority
        self.over_quota = over_quota
        # request-causality fields (docs/OBSERVABILITY.md): the frontend-
        # issued trace id and the wire-read time it measured for this
        # request's frame, stamped onto the serving.request retro-span
        self.trace = trace
        self.wire_ms = wire_ms

    def expired(self, now: float) -> bool:
        return self.deadline is not None and now > self.deadline


class _RequestQueue:
    """Bounded FIFO with the two admission-control scans the stdlib
    Queue cannot do: drop expired entries oldest-first, and evict the
    oldest strictly-lower-priority entry for an outranking newcomer.
    API mirrors ``queue.Queue`` (same ``Empty``/``Full`` exceptions) so
    the worker loop reads unchanged."""

    def __init__(self, maxsize: int):
        self.maxsize = maxsize
        self._items: List[_Item] = []
        self._cond = threading.Condition()

    def qsize(self) -> int:
        with self._cond:
            return len(self._items)

    def empty(self) -> bool:
        return self.qsize() == 0

    def put_nowait(self, item: _Item) -> None:
        with self._cond:
            if len(self._items) >= self.maxsize:
                raise queue.Full
            self._items.append(item)
            self._cond.notify()

    def get(self, timeout: Optional[float] = None) -> _Item:
        with self._cond:
            if timeout is None:
                while not self._items:
                    self._cond.wait()
            else:
                deadline = time.perf_counter() + timeout
                while not self._items:
                    remaining = deadline - time.perf_counter()
                    if remaining <= 0:
                        raise queue.Empty
                    self._cond.wait(remaining)
            return self._items.pop(0)

    def get_nowait(self) -> _Item:
        with self._cond:
            if not self._items:
                raise queue.Empty
            return self._items.pop(0)

    def pop_expired(self, now: float) -> List[_Item]:
        """Remove every expired entry (oldest first) — dead requests
        should never hold queue slots a live one could use."""
        with self._cond:
            dead = [it for it in self._items if it.expired(now)]
            if dead:
                self._items = [
                    it for it in self._items if not it.expired(now)
                ]
            return dead

    def shed_lowest(self, priority: int) -> Optional[_Item]:
        """Remove and return the OLDEST entry whose priority is strictly
        below ``priority`` (oldest-first among the lowest priority
        present), or None when nothing is outranked."""
        return self.shed_victim(priority, over_quota=False)

    def shed_victim(
        self, priority: int, over_quota: bool = False
    ) -> Optional[_Item]:
        """Quota-aware shed policy (docs/FRONTEND.md): pick the queued
        entry an arriving request may evict, or None.

        - A tenant at quota is shed BEFORE any under-quota tenant,
          regardless of priority: if over-quota entries are queued and
          the newcomer is under quota, the oldest lowest-priority
          over-quota entry goes — quota is the outer fairness ring,
          priority only orders work inside it.
        - Otherwise the priority rule among the newcomer's own class:
          oldest strictly-lower-priority entry; ties never shed.
        - An over-quota newcomer may only evict over-quota entries
          (strictly lower priority); it can never displace an
          under-quota tenant's work.
        """
        with self._cond:
            if not self._items:
                return None
            if not over_quota:
                over = [it for it in self._items if it.over_quota]
                if over:
                    lowest = min(it.priority for it in over)
                    for i, it in enumerate(self._items):
                        if it.over_quota and it.priority == lowest:
                            return self._items.pop(i)
            # newcomer's own class: over-quota newcomers only look at
            # over-quota entries; under-quota newcomers (no over-quota
            # queued, per above) look at everything
            pool = (
                [it for it in self._items if it.over_quota]
                if over_quota
                else self._items
            )
            if not pool:
                return None
            lowest = min(it.priority for it in pool)
            if lowest >= priority:
                return None
            for i, it in enumerate(self._items):
                if it.priority == lowest and (
                    it.over_quota or not over_quota
                ):
                    return self._items.pop(i)
        return None


class _DegradeController:
    """Sustained-pressure detector with hysteresis: queue occupancy above
    ``high_water`` continuously for ``degrade_after_s`` switches degraded
    mode ON; occupancy below ``low_water`` continuously for
    ``recover_after_s`` switches it back OFF. Brief spikes (one bursty
    batch) don't flap the mode; genuine overload does."""

    def __init__(
        self,
        high_water: float = 0.8,
        low_water: float = 0.25,
        degrade_after_s: float = 0.5,
        recover_after_s: float = 2.0,
    ):
        self.high_water = high_water
        self.low_water = low_water
        self.degrade_after_s = degrade_after_s
        self.recover_after_s = recover_after_s
        self.degraded = False
        self._above_since: Optional[float] = None
        self._below_since: Optional[float] = None
        self._lock = threading.Lock()

    def note(self, depth: int, maxsize: int,
             now: Optional[float] = None) -> Optional[bool]:
        """Feed one occupancy observation; returns the new mode when it
        FLIPPED (True = degraded engaged, False = recovered), else None."""
        now = time.perf_counter() if now is None else now
        frac = depth / maxsize if maxsize > 0 else 0.0
        with self._lock:
            if frac >= self.high_water:
                self._below_since = None
                if self._above_since is None:
                    self._above_since = now
                if (
                    not self.degraded
                    and now - self._above_since >= self.degrade_after_s
                ):
                    self.degraded = True
                    return True
            elif frac <= self.low_water:
                self._above_since = None
                if self._below_since is None:
                    self._below_since = now
                if (
                    self.degraded
                    and now - self._below_since >= self.recover_after_s
                ):
                    self.degraded = False
                    return False
            else:
                # hysteresis band: hold the current mode, restart timers
                self._above_since = None
                self._below_since = None
        return None


class MicroBatcher:
    """Coalesce concurrent scoring requests into one device call.

    ``score_fn(requests) -> (B,) scores`` is the downstream scorer —
    ``ScoringEngine.score``, or ``ModelRegistry.score`` for hot-reloadable
    serving (the registry counts in-flight batches per model version).
    ``degraded_score_fn``, when given, is the cheaper fallback batches
    route to under sustained pressure (``ModelRegistry.score_fixed_only``).
    """

    def __init__(
        self,
        score_fn: Callable[[Sequence[object]], np.ndarray],
        *,
        max_batch: int = 64,
        max_wait_ms: float = 2.0,
        queue_depth: int = 1024,
        stats: Optional[ServingStats] = None,
        slo: Optional[SloTracker] = None,
        degraded_score_fn: Optional[
            Callable[[Sequence[object]], np.ndarray]
        ] = None,
        degrade: Optional[_DegradeController] = None,
        presort_fn: Optional[Callable[[Sequence[object]], np.ndarray]] = None,
        auto_start: bool = True,
    ):
        if max_batch <= 0:
            raise ValueError(f"max_batch must be positive, got {max_batch}")
        self._score_fn = score_fn
        self._degraded_score_fn = degraded_score_fn
        # shard-routed micro-batching: an entity-sharded engine supplies its
        # primary-owner-shard key (ShardedScoringEngine.shard_presort_key),
        # so each flushed batch is stably grouped by owning shard before
        # the score call and the engine's routed sub-batches are contiguous
        self._presort_fn = presort_fn
        self._degrade = (
            degrade
            if degrade is not None
            else (_DegradeController() if degraded_score_fn else None)
        )
        self.max_batch = max_batch
        self.max_wait_s = max_wait_ms / 1e3
        self._q = _RequestQueue(maxsize=queue_depth)
        self.stats = stats if stats is not None else ServingStats()
        self.slo = slo
        # request ids: monotone per batcher and NAMESPACED by a process-
        # wide instance id (rid = instance_id << 32 | seq), stamped at
        # submit and propagated through _flush into the engine's score
        # span (obs.span_context) — the request-scoped trace key that
        # stays unique across replicated batchers in one merged trace
        self.instance_id = next(_INSTANCE_IDS)
        self._rids = itertools.count(1)
        self._draining = threading.Event()
        self._stopped = threading.Event()
        self._thread: Optional[threading.Thread] = None
        if auto_start:
            self.start()

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "MicroBatcher":
        if self._thread is None or not self._thread.is_alive():
            self._stopped.clear()
            self._thread = threading.Thread(
                target=self._run, name="micro-batcher", daemon=True
            )
            self._thread.start()
        return self

    def begin_drain(self) -> None:
        """Stop accepting new requests; queued ones still score. Non-
        blocking and idempotent — safe as a ``GracefulShutdown`` drain
        hook (signal-handler context)."""
        self._draining.set()

    def drain(self, timeout: Optional[float] = 30.0) -> bool:
        """``begin_drain`` + wait for the worker to finish the backlog.
        Returns True when the queue fully drained and the worker exited;
        a False return means accepted work is still queued — callers
        owning a process (``cli/serve.py``) must surface it loudly."""
        self.begin_drain()
        if self._thread is not None and self._thread.is_alive():
            self._thread.join(timeout)
        return self._stopped.is_set() and self._q.empty()

    def queue_depth(self) -> int:
        return self._q.qsize()

    def degraded(self) -> bool:
        return bool(self._degrade is not None and self._degrade.degraded)

    def health(self) -> dict:
        """Queue/shed/degrade state for the ``{"cmd": "health"}``
        endpoint — the admission-control counterpart of the registry's
        breaker snapshot."""
        return {
            "queue_depth": self._q.qsize(),
            "queue_capacity": self._q.maxsize,
            "draining": self._draining.is_set(),
            "degraded": self.degraded(),
            "expired": int(self.stats.expired),
            "shed": int(self.stats.shed),
            "rejected": int(self.stats.rejected),
            "errors": int(self.stats.errors),
            "requests": int(self.stats.requests),
        }

    def __enter__(self) -> "MicroBatcher":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.drain()

    # -- submission --------------------------------------------------------

    def submit(
        self,
        request,
        *,
        deadline_ms: Optional[float] = None,
        priority: int = 0,
        over_quota: bool = False,
        trace: Optional[str] = None,
        wire_read_ms: Optional[float] = None,
    ) -> Future:
        """Enqueue one request; the Future resolves to its float score.

        ``deadline_ms``: drop the request (Future gets
        :class:`DeadlineExceeded`) if it hasn't STARTED scoring within
        this many milliseconds — expiry happens before batch assembly, so
        an expired request costs zero device work. ``priority``: higher
        values outrank queued lower ones when the queue is full (the shed
        policy); ties never shed. ``over_quota``: the submitting tenant
        is past its admission quota — the request still scores when there
        is room, but it is first in line to shed and may itself only
        displace other over-quota work (docs/FRONTEND.md). ``trace`` /
        ``wire_read_ms``: the frontend-issued trace id and wire-read
        time, carried through to the ``serving.request`` retro-span and
        the exemplar store (docs/OBSERVABILITY.md). Raises
        :class:`Backpressure` when draining or when admission control
        cannot make room."""
        if self._draining.is_set():
            raise Backpressure("batcher is draining; not accepting requests")
        now = time.perf_counter()
        item = _Item(
            request,
            rid=(self.instance_id << 32) | next(self._rids),
            deadline=(now + deadline_ms / 1e3) if deadline_ms else None,
            priority=priority,
            over_quota=over_quota,
            trace=trace,
            wire_ms=wire_read_ms,
        )
        try:
            self._q.put_nowait(item)
        except queue.Full:
            self._admit_under_pressure(item, now)
        self._note_pressure()
        return item.future

    def _admit_under_pressure(self, item: _Item, now: float) -> None:
        """Queue-full admission control: (1) expire dead requests —
        oldest first — and retry; (2) shed per the quota-aware policy
        (over-quota work first, then oldest strictly-lower-priority);
        (3) reject the newcomer."""
        for dead in self._q.pop_expired(now):
            self._expire(dead)
        try:
            self._q.put_nowait(item)
            return
        except queue.Full:
            pass
        victim = self._q.shed_victim(item.priority, item.over_quota)
        if victim is not None:
            self._shed(victim)
            try:
                self._q.put_nowait(item)
                return
            except queue.Full:  # pragma: no cover — racing submitters
                pass
        self.stats.record_rejected()
        self.stats.record_queue_depth(self._q.qsize())
        raise Backpressure(
            f"request queue full ({self._q.maxsize} deep)"
        ) from None

    def _note_pressure(self) -> None:
        depth = self._q.qsize()
        self.stats.record_queue_depth(depth)
        if self._degrade is None:
            return
        flipped = self._degrade.note(depth, self._q.maxsize)
        if flipped is not None:
            self.stats.record_degraded(flipped)
            obs.emit_event(
                "serving.degraded" if flipped else "serving.recovered",
                cat="serving",
                queue_depth=depth,
                queue_capacity=self._q.maxsize,
            )

    @staticmethod
    def _offer_exemplar(
        item: _Item,
        latency_s: float,
        outcome: str,
        degraded: bool = False,
        failover: bool = False,
    ) -> None:
        """Feed the finished request to the process exemplar store, if
        one is installed — errors/expiries/sheds are 100%-kept there
        (obs/exemplars.py); one global read when sampling is off."""
        st = _exemplars.store()
        if st is not None:
            st.record(
                item.trace,
                latency_s * 1e3,
                outcome=outcome,
                degraded=degraded,
                failover=failover,
            )

    def _expire(self, item: _Item) -> None:
        now = time.perf_counter()
        self.stats.record_expired()
        if self.slo is not None:
            self.slo.record(now - item.enqueued, ok=False)
        self._offer_exemplar(item, now - item.enqueued, "expired")
        if not item.future.done():
            item.future.set_exception(
                DeadlineExceeded(
                    f"request {item.rid} expired after "
                    f"{(now - item.enqueued) * 1e3:.1f}ms in queue"
                )
            )

    def _shed(self, item: _Item) -> None:
        self.stats.record_shed()
        if self.slo is not None:
            self.slo.record(
                time.perf_counter() - item.enqueued, ok=False
            )
        self._offer_exemplar(
            item, time.perf_counter() - item.enqueued, "shed"
        )
        if not item.future.done():
            why = "over quota" if item.over_quota else \
                f"priority {item.priority}"
            item.future.set_exception(
                Backpressure(
                    f"request {item.rid} ({why}) shed for an arriving "
                    "request under queue pressure"
                )
            )

    def score_sync(self, request, timeout: Optional[float] = None) -> float:
        """Convenience: submit one request and block for its score. A
        ``timeout`` doubles as the request's deadline: if it can't start
        scoring in time it is DROPPED (not abandoned-but-still-scored,
        the old behavior that burned device work nobody read)."""
        fut = self.submit(
            request,
            deadline_ms=timeout * 1e3 if timeout is not None else None,
        )
        return fut.result(timeout)

    # -- worker ------------------------------------------------------------

    def _run(self) -> None:
        try:
            while True:
                try:
                    first = self._take_live(timeout=0.05)
                except queue.Empty:
                    if self._draining.is_set():
                        return
                    continue
                t_first = time.perf_counter()
                batch = [first]
                deadline = t_first + self.max_wait_s
                while len(batch) < self.max_batch:
                    wait = deadline - time.perf_counter()
                    # draining: no reason to hold the window open — take
                    # whatever is queued and flush
                    if self._draining.is_set():
                        wait = 0.0
                    try:
                        if wait > 0:
                            it = self._q.get(timeout=wait)
                        else:
                            it = self._q.get_nowait()
                    except queue.Empty:
                        break
                    if it.expired(time.perf_counter()):
                        self._expire(it)
                        continue
                    batch.append(it)
                self._flush(batch, t_first)
        finally:
            self._stopped.set()

    def _take_live(self, timeout: float) -> _Item:
        """Pop until a non-expired item; expired ones resolve + count
        on the way — a dead request never seeds a batch window."""
        deadline = time.perf_counter() + timeout
        while True:
            remaining = deadline - time.perf_counter()
            if remaining <= 0:
                return self._q.get_nowait()
            it = self._q.get(timeout=remaining)
            if it.expired(time.perf_counter()):
                self._expire(it)
                continue
            return it

    def _flush(self, batch, t_first: Optional[float] = None) -> None:
        self._note_pressure()
        # last expiry gate: the coalescing window itself may have outlived
        # a deadline — expired requests are dropped before the device call
        now = time.perf_counter()
        live = []
        for it in batch:
            if it.expired(now):
                self._expire(it)
            else:
                live.append(it)
        batch = live
        if not batch:
            return
        if self._presort_fn is not None and len(batch) > 1:
            try:
                keys = np.asarray(self._presort_fn([it.request for it in batch]))
                batch = [batch[i] for i in np.argsort(keys, kind="stable")]
            except Exception:  # noqa: BLE001 — grouping is an optimization
                pass  # an unsorted batch still scores correctly
        degraded = self.degraded() and self._degraded_score_fn is not None
        score_fn = self._degraded_score_fn if degraded else self._score_fn
        t0 = time.perf_counter()
        if t_first is None:
            t_first = t0
        bid = batch[0].rid
        try:
            # ambient span context: the engine's `serving.score` span
            # (and anything below it) inherits the batch identity, so a
            # request id found in a trace leads straight to its device
            # call. The note channel carries replica-hop reports back up
            # (obs/reqtrace.py) — how the per-request retro-span learns
            # its batch was failover-touched.
            with _reqtrace.collect_notes() as hop_notes, obs.span_context(
                batch_id=bid, batch_size=len(batch), degraded=degraded
            ):
                scores = np.asarray(
                    score_fn([it.request for it in batch])
                )
        except BaseException as e:  # noqa: BLE001 — futures carry the error
            self.stats.record_error()
            t_err = time.perf_counter()
            failover = any(n.get("error") for n in hop_notes)
            tracer = obs.get_tracer()
            for it in batch:
                if self.slo is not None:
                    self.slo.record(t_err - it.enqueued, ok=False)
                self._offer_exemplar(
                    it, t_err - it.enqueued, "error",
                    degraded=degraded, failover=failover,
                )
                if tracer is not None:
                    # the failed request still gets its retro-span —
                    # carrying the error instead of segments — so its
                    # timeline reconstructs as explicitly TRUNCATED and
                    # the batch's hop/down records are never orphaned
                    end_us = tracer.now_us()
                    dur_us = (t_err - it.enqueued) * 1e6
                    args = {
                        "request_id": it.rid,
                        "batch_id": bid,
                        "degraded": degraded,
                        "failover": failover,
                        "error": type(e).__name__,
                    }
                    if it.trace is not None:
                        args["trace"] = it.trace
                    tracer.add_span(
                        "serving.request", end_us - dur_us, dur_us,
                        cat="serving", args=args,
                    )
                if not it.future.done():
                    it.future.set_exception(e)
            return
        failover = any(n.get("error") for n in hop_notes)
        t1 = time.perf_counter()
        self.stats.record_batch(len(batch), t1 - t0)
        if degraded:
            self.stats.record_degraded_batch()
        tracer = obs.get_tracer()
        device_ms = (t1 - t0) * 1e3
        assembly_ms = max(t0 - t_first, 0.0) * 1e3
        for it, s in zip(batch, scores):
            latency = t1 - it.enqueued
            self.stats.record_request_latency(latency)
            if self.slo is not None:
                self.slo.record(latency)
            self._offer_exemplar(
                it, latency, "ok", degraded=degraded, failover=failover
            )
            if tracer is not None:
                # request-scoped trace: one retro-emitted span per
                # request covering enqueue -> result, decomposed into
                # wire read (when the frontend fed it), queue-wait
                # (sitting in the bounded queue), batch assembly (the
                # coalescing window), and the device call
                end_us = tracer.now_us()
                dur_us = latency * 1e6
                args = {
                    "request_id": it.rid,
                    "batch_id": bid,
                    "degraded": degraded,
                    "failover": failover,
                    "queue_wait_ms": round(
                        max(t_first - it.enqueued, 0.0) * 1e3, 4
                    ),
                    "assembly_ms": round(assembly_ms, 4),
                    "device_ms": round(device_ms, 4),
                }
                if it.trace is not None:
                    args["trace"] = it.trace
                if it.wire_ms is not None:
                    args["wire_read_ms"] = round(it.wire_ms, 4)
                tracer.add_span(
                    "serving.request",
                    end_us - dur_us,
                    dur_us,
                    cat="serving",
                    args=args,
                )
            if not it.future.done():
                it.future.set_result(float(s))
