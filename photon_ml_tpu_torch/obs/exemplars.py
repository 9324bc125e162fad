"""Tail-based exemplar sampling: latency buckets -> live trace ids (a copy of
``photon_ml_tpu/obs/exemplars.py``).

A p99 number tells you the tail exists; an *exemplar* hands you an
actual request from it. This module keeps bounded rings of recent trace
ids, keyed two ways:

- **by outcome class** — ``error`` / ``expired`` / ``shed`` /
  ``degraded`` / ``failover`` requests are kept at **100%** (the
  requests you will be asked about are precisely the ones something
  went wrong for), the rolling slow tail likewise, and the healthy fast
  path is sampled at a small deterministic fraction (it is only needed
  as a baseline to diff the tail against);
- **by latency bucket** — the SAME log-spaced buckets as the
  ``serving.request_latency_ms`` histogram
  (:meth:`~photon_ml_tpu_torch.obs.metrics.LatencyHistogram.bucket_index`),
  so a spike in a histogram bucket resolves directly to recent trace
  ids from that bucket, served by the ``{"cmd": "exemplars"}`` admin
  command (cli/serve.py) and fed to ``photon-obs request``.

The *rolling* slow tail needs no configuration: the store keeps a small
window of recent latencies and refreshes its slow threshold (the
window's ``1 - tail_frac`` quantile) every ``_REFRESH`` records — a
fleet whose baseline drifts from 2ms to 20ms keeps sampling its
relative tail instead of flooding the rings.

Everything is bounded (``deque(maxlen=...)``) and the record path is a
few comparisons plus at most two ring appends under one lock —
``benchmarks/obs_overhead.py`` gates the serving leg with this enabled.
Like :mod:`obs.trace`, pure stdlib: importable before backend selection
and from CPU-only subprocesses.

Process-global store: :func:`install_store` / :func:`store` /
:func:`set_store`, mirroring ``obs.metrics.registry``. With no store
installed the batcher's record call is one global read — serving pays
nothing until an operator opts in.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Any, Dict, List, Optional

from photon_ml_tpu_torch.obs.metrics import LatencyHistogram

__all__ = [
    "ExemplarStore",
    "install_store",
    "set_store",
    "store",
]

# outcome classes kept at 100% (docs/OBSERVABILITY.md sampling table)
KEEP_CLASSES = ("error", "expired", "shed", "degraded", "failover")
_REFRESH = 64


class ExemplarStore:
    """Bounded exemplar rings with tail-based admission.

    ``fast_fraction`` — deterministic sampling rate for healthy
    fast-path requests (counter-crossing, not RNG: reproducible in
    tests and immune to seeding). ``tail_frac`` — the rolling slow-tail
    width (0.05 = the slowest ~5% of the recent window always kept).
    ``ring_size`` — per-bucket / per-class ring capacity. ``lo_ms`` /
    ``hi_ms`` / ``bins`` must match the latency histogram the exemplars
    annotate (defaults match ``LatencyHistogram``'s).
    """

    def __init__(
        self,
        *,
        fast_fraction: float = 0.01,
        tail_frac: float = 0.05,
        ring_size: int = 8,
        window: int = 256,
        lo_ms: float = 1e-3,
        hi_ms: float = 6e4,
        bins: int = 64,
    ):
        if not 0.0 <= fast_fraction <= 1.0:
            raise ValueError(
                f"fast_fraction must be in [0, 1]: {fast_fraction}"
            )
        self.fast_fraction = float(fast_fraction)
        self.tail_frac = float(tail_frac)
        self.ring_size = int(ring_size)
        # counts-free histogram reused purely for the bucket math, so
        # bucket<->le mapping cannot drift from the real latency metric
        self._hist = LatencyHistogram(lo_ms=lo_ms, hi_ms=hi_ms, bins=bins)
        self._buckets: Dict[int, deque] = {}
        self._classes: Dict[str, deque] = {}
        self._window = deque(maxlen=int(window))
        self._slow_ms = float("inf")
        self._lock = threading.Lock()
        self.recorded = 0
        self.kept = 0
        self.kept_by = {
            "class": 0,
            "slow": 0,
            "sampled": 0,
        }
        self._sampled_quota = 0.0

    # -- admission ----------------------------------------------------------

    def _refresh_slow_threshold(self) -> None:
        if not self._window or self.tail_frac <= 0.0:
            self._slow_ms = float("inf")
            return
        ordered = sorted(self._window)
        k = min(
            len(ordered) - 1,
            max(0, int(len(ordered) * (1.0 - self.tail_frac))),
        )
        self._slow_ms = ordered[k]

    def record(
        self,
        trace: Optional[str],
        latency_ms: float,
        *,
        outcome: str = "ok",
        degraded: bool = False,
        failover: bool = False,
    ) -> bool:
        """Offer one finished request; returns True when kept. ``trace``
        may be None (untraced submitter) — the decision still counts so
        sampling statistics stay honest, but nothing enters a ring."""
        classes = []
        if outcome != "ok":
            classes.append(outcome if outcome in KEEP_CLASSES else "error")
        if degraded:
            classes.append("degraded")
        if failover:
            classes.append("failover")
        with self._lock:
            self.recorded += 1
            self._window.append(latency_ms)
            if self.recorded % _REFRESH == 1:
                self._refresh_slow_threshold()
            if classes:
                why = "class"
            elif latency_ms >= self._slow_ms:
                why = "slow"
                classes.append("slow")
            else:
                # deterministic fraction: keep when the accumulated
                # quota crosses an integer boundary
                self._sampled_quota += self.fast_fraction
                if self._sampled_quota < 1.0:
                    return False
                self._sampled_quota -= 1.0
                why = "sampled"
                classes.append("sampled")
            self.kept += 1
            self.kept_by[why] += 1
            if trace is None:
                return True
            entry = {
                "trace": trace,
                "latency_ms": round(float(latency_ms), 4),
                "outcome": outcome,
            }
            b = self._hist.bucket_index(latency_ms)
            ring = self._buckets.get(b)
            if ring is None:
                ring = self._buckets[b] = deque(maxlen=self.ring_size)
            ring.append(entry)
            for cls in classes:
                cring = self._classes.get(cls)
                if cring is None:
                    cring = self._classes[cls] = deque(
                        maxlen=self.ring_size
                    )
                cring.append(entry)
        return True

    # -- readout ------------------------------------------------------------

    def lookup(
        self,
        *,
        ge_ms: Optional[float] = None,
        cls: Optional[str] = None,
    ) -> List[Dict[str, Any]]:
        """Recent exemplars, newest last. ``ge_ms`` keeps only buckets
        whose upper edge is >= the floor (the "hand me the p99 bucket's
        traces" query); ``cls`` reads one outcome-class ring."""
        with self._lock:
            if cls is not None:
                return list(self._classes.get(cls, ()))
            out = []
            for b in sorted(self._buckets):
                if ge_ms is not None and self._hist.bucket_le(b) < ge_ms:
                    continue
                out.extend(self._buckets[b])
        return out

    def snapshot(self) -> Dict[str, Any]:
        """The ``{"cmd": "exemplars"}`` payload: config, admission
        counts, and every non-empty ring with its bucket edge."""
        with self._lock:
            buckets = [
                {
                    "bucket": b,
                    "le_ms": (
                        self._hist.bucket_le(b)
                        if self._hist.bucket_le(b) != float("inf")
                        else None
                    ),
                    "exemplars": list(ring),
                }
                for b, ring in sorted(self._buckets.items())
                if ring
            ]
            classes = {
                cls: list(ring)
                for cls, ring in sorted(self._classes.items())
                if ring
            }
            return {
                "config": {
                    "fast_fraction": self.fast_fraction,
                    "tail_frac": self.tail_frac,
                    "ring_size": self.ring_size,
                },
                "recorded": int(self.recorded),
                "kept": int(self.kept),
                "kept_by": dict(self.kept_by),
                "slow_threshold_ms": (
                    None if self._slow_ms == float("inf")
                    else round(self._slow_ms, 4)
                ),
                "buckets": buckets,
                "classes": classes,
            }


# ---------------------------------------------------------------------------
# Process-global store (the registry()/set_registry shape)
# ---------------------------------------------------------------------------

_store: Optional[ExemplarStore] = None
_store_lock = threading.Lock()


def store() -> Optional[ExemplarStore]:
    """The installed store, or None (sampling disabled — the batcher's
    record path is then one global read)."""
    return _store


def set_store(st: Optional[ExemplarStore]) -> Optional[ExemplarStore]:
    """Install ``st`` process-wide (None uninstalls); returns the
    previous store so callers can restore it."""
    global _store
    with _store_lock:
        prev = _store
        _store = st
    return prev


def install_store(**kwargs) -> ExemplarStore:
    """Construct-and-install convenience for drivers (cli/serve.py)."""
    st = ExemplarStore(**kwargs)
    set_store(st)
    return st
