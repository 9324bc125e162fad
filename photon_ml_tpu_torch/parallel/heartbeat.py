"""Heartbeat monitor: detect a dead or straggling peer before a collective
deadlocks on it (counterpart of ``photon_ml_tpu/parallel/heartbeat.py``).

Every rank publishes a timestamp beat on a small-key transport — the
process group's ``torch.distributed.Store`` in a world of several
processes, an in-process table for single-process drills — reads its
peers' beats, and feeds the obs layer:

- ``pod.heartbeat.age_s.h<i>`` — staleness of peer i's last beat (gauge)
- ``pod.heartbeat.beats``      — beats this process published (counter)
- ``pod.heartbeat.misses``     — stale-peer observations (counter)
- ``pod.heartbeat.slowest_host`` / ``pod.heartbeat.slowest_age_s`` — the
  straggler the collective watchdog names when an exchange times out.

A peer whose beat goes stale past ``miss_intervals * interval_s`` is LOST
(a ``heartbeat.peer_lost`` event), and :meth:`HeartbeatMonitor.check`
raises :class:`~photon_ml_tpu_torch.resilience.hostloss.HostLossDetected`.

:class:`InProcessHeartbeats` simulates peers that beat on every read,
except a peer whose ``heartbeat.miss`` fault (key = its index) is armed:
raise mode silences it, delay mode makes it a straggler. In a world the
same fault, armed on a rank with its own index as the key, silences that
rank's beats on the store.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Tuple

from photon_ml_tpu_torch.resilience import faults as _faults
from photon_ml_tpu_torch.resilience.hostloss import HostLossDetected

__all__ = [
    "HeartbeatMonitor",
    "InProcessHeartbeats",
    "DistributedKVHeartbeats",
    "current_monitor",
    "install_monitor",
]


class InProcessHeartbeats:
    """Single-process emulation transport: ``num_processes`` synthetic
    peers that beat on every :meth:`read` unless an armed
    ``heartbeat.miss`` fault (key = str(peer)) suppresses the beat (raise
    mode) or delays the read (delay mode)."""

    def __init__(self, num_processes: int, clock=time.monotonic):
        self.num_processes = int(num_processes)
        self._clock = clock
        now = clock()
        self._beats: Dict[int, float] = {p: now for p in range(self.num_processes)}
        self._lock = threading.Lock()

    def publish(self, pid: int, t: float) -> None:
        with self._lock:
            self._beats[int(pid)] = float(t)

    def read(self, self_pid: int) -> Dict[int, float]:
        now = self._clock()
        with self._lock:
            for p in range(self.num_processes):
                if p == self_pid:
                    continue
                try:
                    _faults.fire("heartbeat.miss", key=str(p))
                except _faults.InjectedFault:
                    continue
                self._beats[p] = now
            return dict(self._beats)


class DistributedKVHeartbeats:
    """The world's transport: beats ride the process group's key-value
    store (the rendezvous every rank already depends on), so reading a
    peer's beat never touches a device collective. A key not yet written
    or a failed read leaves the previous beat in place: staleness
    accumulates, which is the signal. Beats are wall-clock times, so ranks
    on one host (or hosts with synchronized clocks) compare them."""

    KEY_PREFIX = "photon/heartbeat/"

    def __init__(self, num_processes: int, store=None):
        self.num_processes = int(num_processes)
        if store is None:
            import torch.distributed as dist

            if not dist.is_initialized():
                raise RuntimeError(
                    "DistributedKVHeartbeats needs the process group's store; "
                    "call initialize_multihost() first (single-process drills "
                    "use InProcessHeartbeats)"
                )
            store = dist.distributed_c10d._get_default_store()
        self._store = store
        self._beats: Dict[int, float] = {}

    def publish(self, pid: int, t: float) -> None:
        """This rank's beat; an armed ``heartbeat.miss`` fault whose key is
        this rank's index silences it (raise mode: the drill of a rank that
        went silent) or delays it."""
        try:
            _faults.fire("heartbeat.miss", key=str(int(pid)))
        except _faults.InjectedFault:
            return
        try:
            self._store.set(f"{self.KEY_PREFIX}{int(pid)}", repr(float(t)))
        except Exception:  # noqa: BLE001 — the liveness channel is best-effort
            pass

    def read(self, self_pid: int) -> Dict[int, float]:
        for p in range(self.num_processes):
            key = f"{self.KEY_PREFIX}{p}"
            try:
                if self._store.check([key]):
                    self._beats[p] = float(self._store.get(key))
            except Exception:  # noqa: BLE001 — a stale beat is the signal
                continue
        return dict(self._beats)


class HeartbeatMonitor:
    """Publishes this rank's beat and watches the peers'. :meth:`start`
    polls on a daemon thread every ``interval_s``; an un-started monitor
    polls inside :meth:`check`. A peer staler than ``miss_intervals *
    interval_s`` is lost for good: one that comes back must rejoin as a
    fresh restart. Peers with no beat yet age from the monitor's start."""

    def __init__(
        self,
        interval_s: float = 5.0,
        miss_intervals: float = 3.0,
        transport=None,
        process_index: Optional[int] = None,
        process_count: Optional[int] = None,
        clock=None,
    ):
        from photon_ml_tpu_torch.parallel.mesh import world

        if interval_s <= 0:
            raise ValueError(f"interval_s must be > 0, got {interval_s}")
        if miss_intervals <= 0:
            raise ValueError(f"miss_intervals must be > 0, got {miss_intervals}")
        self.interval_s = float(interval_s)
        self.miss_intervals = float(miss_intervals)
        n_world, rank = world()
        self.process_index = rank if process_index is None else int(process_index)
        self.process_count = n_world if process_count is None else int(process_count)
        if transport is None:
            if self.process_count > 1 and n_world > 1:
                transport = DistributedKVHeartbeats(self.process_count)
                clock = clock or time.time
            else:
                clock = clock or time.monotonic
                transport = InProcessHeartbeats(self.process_count, clock=clock)
        self.transport = transport
        self._clock = clock or time.monotonic
        self._baseline = self._clock()
        self._lost: Dict[int, float] = {}
        self._ages: Dict[int, float] = {}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def poll_once(self) -> Dict[int, float]:
        """One beat and read cycle; returns peer -> beat age (seconds),
        updates the ``pod.heartbeat.*`` metrics and records newly lost
        peers (``heartbeat.peer_lost``)."""
        from photon_ml_tpu_torch import obs

        now = self._clock()
        self.transport.publish(self.process_index, now)
        beats = self.transport.read(self.process_index)
        reg = obs.registry()
        reg.inc("pod.heartbeat.beats")
        threshold = self.miss_intervals * self.interval_s
        ages: Dict[int, float] = {}
        newly_lost: List[int] = []
        with self._lock:
            for p in range(self.process_count):
                if p == self.process_index:
                    continue
                age = now - beats.get(p, self._baseline)
                ages[p] = age
                reg.set_gauge(f"pod.heartbeat.age_s.h{p}", round(age, 4))
                if age > threshold:
                    reg.inc("pod.heartbeat.misses")
                    if p not in self._lost:
                        self._lost[p] = age
                        newly_lost.append(p)
            self._ages = ages
            if ages:
                slow = max(ages, key=ages.get)
                reg.set_gauge("pod.heartbeat.slowest_host", slow)
                reg.set_gauge("pod.heartbeat.slowest_age_s", round(ages[slow], 4))
        for p in newly_lost:
            obs.emit_event(
                "heartbeat.peer_lost",
                cat="resilience",
                peer=p,
                age_s=round(ages[p], 4),
                threshold_s=round(threshold, 4),
                host=self.process_index,
            )
        return ages

    def lost_peers(self) -> List[int]:
        with self._lock:
            return sorted(self._lost)

    def slowest(self) -> Optional[Tuple[int, float]]:
        """(peer, beat age) of the stalest peer at the last poll; None
        before any poll."""
        with self._lock:
            if not self._ages:
                return None
            slow = max(self._ages, key=self._ages.get)
            return slow, self._ages[slow]

    def check(self) -> None:
        """Raise :class:`HostLossDetected` if any peer is lost (polling
        first on an un-started monitor)."""
        if self._thread is None:
            self.poll_once()
        if self._lost:
            raise HostLossDetected(self.lost_peers(), reason="heartbeat")

    def start(self) -> "HeartbeatMonitor":
        if self._thread is not None:
            return self
        self._stop.clear()

        def loop():
            while not self._stop.wait(self.interval_s):
                try:
                    self.poll_once()
                except Exception:  # noqa: BLE001 — the monitor must not die
                    pass

        t = threading.Thread(target=loop, name="photon-heartbeat", daemon=True)
        self._thread = t
        t.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=5.0)
            self._thread = None

    def __enter__(self) -> "HeartbeatMonitor":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()


_MONITOR: Optional[HeartbeatMonitor] = None


def install_monitor(monitor: Optional[HeartbeatMonitor]):
    """Set (or clear, with None) the process-wide monitor; returns the
    previous one."""
    global _MONITOR
    prev = _MONITOR
    _MONITOR = monitor
    return prev


def current_monitor() -> Optional[HeartbeatMonitor]:
    return _MONITOR
