"""Replicated shard groups: R replicas of the scoring engine behind a
least-outstanding-requests router with per-replica health (a copy of
``photon_ml_tpu/frontend/replicas.py``).

The entity-sharded engine scales serving *capacity* in P; this module
scales *throughput* in R. Each replica is an independent scorer (a
:class:`~photon_ml_tpu_torch.serving.registry.ModelRegistry`, a
:class:`~photon_ml_tpu_torch.serving.sharding.ShardedScoringEngine`, or any
``batch -> scores`` callable); replicas on one card are separate
registries, each with its tables resident, sharing one scorer ladder
through the process-wide cache (:func:`~photon_ml_tpu_torch.frontend.
tenants.process_compile_cache`). The router owns which replica a batch
lands on:

- **Least outstanding requests.** Among healthy replicas, the one with
  the fewest in-flight batches wins; ties rotate round-robin so a
  serialized submitter still spreads load. Outstanding counts, not pure
  round-robin, because replica latency is not uniform: a replica slowed
  by a reload or a straggling device naturally sheds load to its peers.
- **Per-replica breaker.** ``failure_threshold`` consecutive scoring
  failures mark a replica DOWN for a doubling backoff (the
  :class:`~photon_ml_tpu_torch.serving.registry.ReloadCircuitBreaker` shape);
  after the backoff one probe batch is allowed through — success closes
  the breaker, failure doubles the wait. A down replica receives no
  traffic and costs arriving requests nothing.
- **Whole-replica failover.** A batch that fails on one replica retries
  on the next-healthiest; only when EVERY replica has failed it does the
  error surface. Zero lost requests across a whole-replica loss — the
  ``replica_loss`` chaos drill holds the router to exactly that.

Fault site ``replica.route`` (key = replica name) probes every routed
attempt: raise-mode is a replica dying mid-batch (the failover path),
delay-mode a slow replica (the load-skew path).
"""

from __future__ import annotations

import threading
import time
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

from photon_ml_tpu_torch import obs
from photon_ml_tpu_torch.obs import reqtrace as _reqtrace
from photon_ml_tpu_torch.resilience import faults as _faults

__all__ = ["Replica", "ReplicaRouter", "AllReplicasDown"]


class AllReplicasDown(RuntimeError):
    """Every replica failed to score the batch (each failure already
    counted against its breaker); the batch's requests get this error."""


class _ReplicaBreaker:
    """closed -> open (after N consecutive failures, doubling backoff)
    -> half-open (one probe after the backoff) -> closed on success."""

    def __init__(self, failure_threshold: int, backoff_s: float,
                 max_backoff_s: float):
        self.failure_threshold = failure_threshold
        self.base_backoff_s = backoff_s
        self.max_backoff_s = max_backoff_s
        self.failures = 0
        self.state = "closed"
        self._backoff_s = backoff_s
        self._open_until = 0.0
        self._lock = threading.Lock()

    def allow(self, now: Optional[float] = None) -> bool:
        now = time.monotonic() if now is None else now
        with self._lock:
            if self.state == "closed":
                return True
            if now >= self._open_until:
                self.state = "half-open"
                return True
            return False

    def record_success(self) -> None:
        with self._lock:
            self.failures = 0
            self.state = "closed"
            self._backoff_s = self.base_backoff_s

    def record_failure(self, now: Optional[float] = None) -> bool:
        """Count one failure; returns True when the breaker OPENED."""
        now = time.monotonic() if now is None else now
        with self._lock:
            self.failures += 1
            tripped = (
                self.state == "half-open"
                or self.failures >= self.failure_threshold
            )
            if not tripped:
                return False
            opened = self.state != "open"
            if self.state == "half-open":
                # failed probe: wait longer before the next one
                self._backoff_s = min(
                    self._backoff_s * 2.0, self.max_backoff_s
                )
                opened = True
            self.state = "open"
            self._open_until = now + self._backoff_s
            return opened

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "state": self.state,
                "failures": int(self.failures),
                "backoff_s": float(self._backoff_s),
                "open_for_s": max(
                    self._open_until - time.monotonic(), 0.0
                ) if self.state == "open" else 0.0,
            }


class Replica:
    """One scoring replica: a name, a ``batch -> scores`` callable, an
    in-flight counter, and a breaker. ``score_fn`` may be a registry's
    bound ``score`` (hot-reloadable replicas) or an engine's."""

    def __init__(self, name: str,
                 score_fn: Callable[[Sequence[object]], np.ndarray],
                 *, failure_threshold: int = 3, backoff_s: float = 0.5,
                 max_backoff_s: float = 30.0):
        self.name = name
        self.score_fn = score_fn
        self.breaker = _ReplicaBreaker(
            failure_threshold, backoff_s, max_backoff_s
        )
        self.outstanding = 0
        self.batches = 0
        self.failures = 0
        self._lock = threading.Lock()

    def snapshot(self) -> dict:
        with self._lock:
            out = {
                "outstanding": int(self.outstanding),
                "batches": int(self.batches),
                "failures": int(self.failures),
            }
        out.update(self.breaker.snapshot())
        return out


class ReplicaRouter:
    """Route scoring batches across R replicas; fail over on error.

    Drops in as a :class:`~photon_ml_tpu_torch.serving.batcher.MicroBatcher`
    ``score_fn`` — the batcher coalesces, the router places. The first
    successful replica's scores are returned; every failed attempt is
    counted against that replica's breaker and the batch moves on to the
    next-healthiest replica. ``on_failover`` (if given) is called with
    ``(from_name, to_name, error)`` after each successful failover —
    the drill/bench hook that measures ``replica_failover_s``.
    """

    def __init__(
        self,
        replicas: Sequence[Tuple[str, Callable]],
        *,
        failure_threshold: int = 3,
        backoff_s: float = 0.5,
        max_backoff_s: float = 30.0,
        on_failover: Optional[Callable[[str, str, BaseException], None]] = None,
    ):
        if not replicas:
            raise ValueError("need at least one replica")
        self.replicas: List[Replica] = []
        for item in replicas:
            if isinstance(item, Replica):
                self.replicas.append(item)
            else:
                name, fn = item
                self.replicas.append(Replica(
                    str(name), fn,
                    failure_threshold=failure_threshold,
                    backoff_s=backoff_s,
                    max_backoff_s=max_backoff_s,
                ))
        if len({r.name for r in self.replicas}) != len(self.replicas):
            raise ValueError("replica names must be unique")
        self.on_failover = on_failover
        self._lock = threading.Lock()
        self._rr = 0  # tie rotation among equally-loaded replicas
        self.failovers = 0
        self.last_failover_s: Optional[float] = None

    # -- placement ---------------------------------------------------------

    def _candidates(self) -> List[Replica]:
        """Healthy replicas by (outstanding, index) — least-loaded first;
        down replicas excluded entirely."""
        now = time.monotonic()
        up = [
            (r.outstanding, i, r)
            for i, r in enumerate(self.replicas)
            if r.breaker.allow(now)
        ]
        up.sort(key=lambda t: (t[0], t[1]))
        return [r for (_, _, r) in up]

    def score(self, requests: Sequence[object]) -> np.ndarray:
        """Score one batch on the least-loaded healthy replica, failing
        over until a replica succeeds; raises :class:`AllReplicasDown`
        only when none does."""
        tried: List[str] = []
        last_err: Optional[BaseException] = None
        t_fail: Optional[float] = None
        while True:
            cands = [
                r for r in self._candidates() if r.name not in tried
            ]
            if not cands:
                obs.registry().inc("replica.exhausted")
                raise AllReplicasDown(
                    f"all replicas failed ({', '.join(tried) or 'none up'})"
                ) from last_err
            # ties among equally-loaded replicas rotate round-robin —
            # a serialized submitter (outstanding always 0 at placement)
            # still spreads load instead of pinning replica 0
            min_out = cands[0].outstanding
            pool = [r for r in cands if r.outstanding == min_out]
            with self._lock:
                rep = pool[self._rr % len(pool)]
                self._rr += 1
            tried.append(rep.name)
            attempt = len(tried)
            with rep._lock:
                rep.outstanding += 1
                rep.batches += 1
            try:
                # chaos seam: raise = this replica dying mid-batch,
                # delay = a slow replica skewing the router's load view.
                # The hop span inherits the batch identity from the
                # batcher's ambient span context, so a trace id leads
                # through every attempted replica — failed hops record
                # with error=True (docs/OBSERVABILITY.md).
                with obs.span(
                    "replica.hop", cat="frontend",
                    replica=rep.name, attempt=attempt,
                ):
                    _faults.fire("replica.route", key=rep.name)
                    scores = rep.score_fn(requests)
            except BaseException as e:  # noqa: BLE001 — failover decides
                last_err = e
                _reqtrace.note(
                    kind="hop", replica=rep.name,
                    attempt=attempt, error=True,
                )
                with rep._lock:
                    rep.failures += 1
                if rep.breaker.record_failure():
                    ctx = obs.current_span_context() or {}
                    obs.emit_event(
                        "replica.down", cat="frontend",
                        replica=rep.name, error=type(e).__name__,
                        **(
                            {"batch_id": ctx["batch_id"]}
                            if "batch_id" in ctx else {}
                        ),
                    )
                obs.registry().inc(f"replica.failures.{rep.name}")
                if t_fail is None:
                    t_fail = time.monotonic()
                continue
            finally:
                with rep._lock:
                    rep.outstanding -= 1
            _reqtrace.note(
                kind="hop", replica=rep.name, attempt=attempt, error=False,
            )
            rep.breaker.record_success()
            obs.registry().inc(f"replica.batches.{rep.name}")
            if t_fail is not None:
                # a failover happened and THIS replica absorbed it
                dt = time.monotonic() - t_fail
                with self._lock:
                    self.failovers += 1
                    self.last_failover_s = dt
                obs.registry().observe("replica.failover_ms", dt * 1e3)
                if self.on_failover is not None:
                    self.on_failover(tried[-2], rep.name, last_err)
            return scores

    # -- introspection -----------------------------------------------------

    def health(self) -> dict:
        return {
            "replicas": {r.name: r.snapshot() for r in self.replicas},
            "up": sum(
                1 for r in self.replicas if r.breaker.allow()
            ),
            "failovers": int(self.failovers),
            "last_failover_s": self.last_failover_s,
        }
