"""Multi-tenant engine layer: per-tenant registries over ONE admission
queue, sharing the bucket-scorer ladder (a copy of
``photon_ml_tpu/frontend/tenants.py``).

photon-ml's fleet posture is many same-shaped models (one architecture,
per-market/per-surface weights) serving side by side. The naive build —
one engine + one batcher per tenant — pays N scorer ladders and gives
admission control N blind queues that cannot trade load against each
other. This layer inverts both:

- **One admission queue.** Every tenant's requests ride the SAME
  :class:`~photon_ml_tpu_torch.serving.batcher.MicroBatcher` (deadlines,
  priority shed, degrade, drain), wrapped in a tenant envelope. The
  batcher's quota-aware shed policy (``over_quota`` submits) is what
  makes sharing safe: a tenant past its ``max_outstanding`` quota is
  first in line to shed and can never displace under-quota work — quota
  is the outer fairness ring, priority orders work inside it.
- **One scorer ladder.** Tenants' engines take a process-wide
  :class:`~photon_ml_tpu_torch.serving.engine.SharedCompileCache`; bucket
  scorers key on the engine's structural signature and its device, so N
  same-shaped tenants (and replicas) on one card pay ONE warmup's builds
  instead of N (params are arguments, each tenant scores with its own
  weights).
- **Per-tenant accounting.** Each tenant gets its own deadline/priority
  defaults, an outstanding-request quota, an
  :class:`~photon_ml_tpu_torch.serving.stats.SloTracker`, and shed/expired/
  rejected counters — the ``{"cmd": "tenants"}`` admin snapshot reads
  straight from here.

Scoring runs on the shared batcher's worker thread: each tenant's
sub-batch is one engine call, whose scores come to the host once.

Fault site ``tenant.quota`` (key = tenant name) probes every admission:
raise-mode fails the quota check CLOSED (the request is rejected, never
silently admitted past quota); corrupt-mode forces the over-quota mark.
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import Future
from typing import Callable, Dict, Optional, Sequence

import numpy as np

from photon_ml_tpu_torch import obs
from photon_ml_tpu_torch.resilience import faults as _faults
from photon_ml_tpu_torch.serving.batcher import Backpressure, MicroBatcher
from photon_ml_tpu_torch.serving.engine import SharedCompileCache
from photon_ml_tpu_torch.serving.stats import ServingStats, SloTracker

__all__ = [
    "TenantState",
    "TenantManager",
    "UnknownTenant",
    "process_compile_cache",
]

# the process-wide scorer ladder: the serve CLI's frontend mode hands it
# to every tenant's and replica's engine
_PROCESS_CACHE = SharedCompileCache()


def process_compile_cache() -> SharedCompileCache:
    return _PROCESS_CACHE


class UnknownTenant(KeyError):
    """Request named a tenant the manager has no registry for."""


class _TenantRequest:
    """Envelope the shared batcher carries: which tenant, which inner
    request. ``__slots__`` because one exists per in-flight request."""

    __slots__ = ("tenant", "inner")

    def __init__(self, tenant: str, inner):
        self.tenant = tenant
        self.inner = inner


class TenantState:
    """One tenant's scorer + policy + accounting."""

    def __init__(
        self,
        name: str,
        score_fn: Callable[[Sequence[object]], np.ndarray],
        *,
        deadline_ms: Optional[float] = None,
        priority: int = 0,
        max_outstanding: Optional[int] = None,
        target_p99_ms: float = 10.0,
        registry=None,
    ):
        self.name = name
        self.score_fn = score_fn
        self.registry = registry  # ModelRegistry when hot-reloadable
        self.deadline_ms = deadline_ms
        self.priority = int(priority)
        self.max_outstanding = (
            int(max_outstanding) if max_outstanding else None
        )
        self.slo = SloTracker(target_p99_ms=target_p99_ms)
        self.outstanding = 0
        self.submitted = 0
        self.completed = 0
        self.failed = 0
        self.rejected = 0
        self.over_quota_submits = 0
        self._lock = threading.Lock()

    def snapshot(self) -> dict:
        with self._lock:
            out = {
                "priority": self.priority,
                "deadline_ms": self.deadline_ms,
                "max_outstanding": self.max_outstanding,
                "outstanding": int(self.outstanding),
                "submitted": int(self.submitted),
                "completed": int(self.completed),
                "failed": int(self.failed),
                "rejected": int(self.rejected),
                "over_quota_submits": int(self.over_quota_submits),
            }
        out["slo"] = self.slo.snapshot()
        return out


class TenantManager:
    """N tenants, one admission queue, one scorer ladder.

    ``add_tenant(name, score_fn_or_registry, ...)`` registers a tenant;
    ``submit(tenant, request)`` applies that tenant's deadline/priority/
    quota and enqueues on the shared batcher, whose worker groups each
    flushed batch back by tenant and scores every tenant's sub-batch
    with its own scorer (order restored before the futures resolve).
    """

    def __init__(
        self,
        *,
        max_batch: int = 64,
        max_wait_ms: float = 2.0,
        queue_depth: int = 1024,
        stats: Optional[ServingStats] = None,
        slo: Optional[SloTracker] = None,
        compile_cache: Optional[SharedCompileCache] = None,
        auto_start: bool = True,
    ):
        self.compile_cache = (
            compile_cache if compile_cache is not None else _PROCESS_CACHE
        )
        self._tenants: Dict[str, TenantState] = {}
        self._tlock = threading.Lock()
        self.stats = stats if stats is not None else ServingStats()
        # `slo` is the AGGREGATE tracker (all tenants, one window) the
        # compat admin channel's {"cmd": "slo"} reads; per-tenant
        # trackers live on each TenantState
        self.batcher = MicroBatcher(
            self._score_batch,
            max_batch=max_batch,
            max_wait_ms=max_wait_ms,
            queue_depth=queue_depth,
            stats=self.stats,
            slo=slo,
            auto_start=auto_start,
        )

    # -- tenant registration -----------------------------------------------

    def add_tenant(
        self,
        name: str,
        scorer,
        *,
        deadline_ms: Optional[float] = None,
        priority: int = 0,
        max_outstanding: Optional[int] = None,
        target_p99_ms: float = 10.0,
    ) -> TenantState:
        """Register one tenant. ``scorer`` is a ``batch -> scores``
        callable (an engine's or router's ``score``) or an object with a
        bound ``score`` (a :class:`ModelRegistry` — kept on the state so
        the admin channel can reach per-tenant reload/health)."""
        score_fn = scorer if callable(scorer) else scorer.score
        registry = None if callable(scorer) else scorer
        st = TenantState(
            str(name), score_fn,
            deadline_ms=deadline_ms, priority=priority,
            max_outstanding=max_outstanding, target_p99_ms=target_p99_ms,
            registry=registry,
        )
        with self._tlock:
            if name in self._tenants:
                raise ValueError(f"tenant {name!r} already registered")
            self._tenants[name] = st
        obs.registry().inc("tenant.registered")
        return st

    def tenant(self, name: str) -> TenantState:
        with self._tlock:
            try:
                return self._tenants[name]
            except KeyError:
                raise UnknownTenant(name) from None

    def tenants(self) -> Dict[str, TenantState]:
        with self._tlock:
            return dict(self._tenants)

    # -- submission --------------------------------------------------------

    def submit(
        self,
        tenant: str,
        request,
        *,
        deadline_ms: Optional[float] = None,
        priority: Optional[int] = None,
        trace: Optional[str] = None,
        wire_read_ms: Optional[float] = None,
    ) -> Future:
        """Admit one request under the tenant's policy; the Future
        resolves to its float score. ``deadline_ms``/``priority``
        override the tenant's defaults for this one request (the compat
        channel's per-line fields keep working through the shared
        queue); ``trace``/``wire_read_ms`` thread the frontend's
        request-causality fields through the envelope unchanged
        (docs/OBSERVABILITY.md). Raises :class:`UnknownTenant`,
        :class:`Backpressure`
        (queue full past the shed policy, or the quota seam failing
        closed), or surfaces :class:`DeadlineExceeded` through the
        Future like the bare batcher does."""
        st = self.tenant(tenant)
        t0 = time.perf_counter()
        # chaos seam: the quota check fails CLOSED — an unreadable quota
        # rejects the request rather than admitting past the limit
        try:
            action = _faults.fire("tenant.quota", key=st.name)
        except OSError as e:
            with st._lock:
                st.rejected += 1
            obs.registry().inc(f"tenant.rejected.{st.name}")
            raise Backpressure(
                f"tenant {st.name!r}: quota check failed closed"
            ) from e
        with st._lock:
            over = bool(
                st.max_outstanding is not None
                and st.outstanding >= st.max_outstanding
            )
            if action.corrupt:
                over = True
            st.submitted += 1
            if over:
                st.over_quota_submits += 1
        try:
            fut = self.batcher.submit(
                _TenantRequest(st.name, request),
                deadline_ms=(
                    st.deadline_ms if deadline_ms is None else deadline_ms
                ),
                priority=st.priority if priority is None else int(priority),
                over_quota=over,
                trace=trace,
                wire_read_ms=wire_read_ms,
            )
        except Backpressure:
            with st._lock:
                st.rejected += 1
            obs.registry().inc(f"tenant.rejected.{st.name}")
            raise
        with st._lock:
            st.outstanding += 1

        def _done(f: Future, st=st, t0=t0):
            ok = f.exception() is None
            with st._lock:
                st.outstanding -= 1
                if ok:
                    st.completed += 1
                else:
                    st.failed += 1
            st.slo.record(time.perf_counter() - t0, ok=ok)

        fut.add_done_callback(_done)
        return fut

    # -- the shared batcher's score_fn -------------------------------------

    def _score_batch(self, envelopes: Sequence[_TenantRequest]):
        """Group one flushed batch by tenant, score each tenant's rows
        with its own scorer, and restore submission order."""
        groups: Dict[str, list] = {}
        for i, env in enumerate(envelopes):
            groups.setdefault(env.tenant, []).append(i)
        out = np.zeros(len(envelopes))
        for name, idx in groups.items():
            st = self.tenant(name)
            scores = np.asarray(
                st.score_fn([envelopes[i].inner for i in idx])
            )
            out[idx] = scores
        return out

    # -- lifecycle / introspection -----------------------------------------

    def begin_drain(self) -> None:
        self.batcher.begin_drain()

    def drain(self, timeout: Optional[float] = 30.0) -> bool:
        return self.batcher.drain(timeout)

    def slo_snapshot(self) -> dict:
        return {
            name: st.slo.snapshot()
            for name, st in self.tenants().items()
        }

    def snapshot(self) -> dict:
        """The ``{"cmd": "tenants"}`` admin payload: per-tenant policy +
        accounting + SLO, the shared queue, and the shared ladder."""
        return {
            "tenants": {
                name: st.snapshot()
                for name, st in self.tenants().items()
            },
            "queue": self.batcher.health(),
            "compile_cache": self.compile_cache.snapshot(),
        }
