"""Preemption-safe shutdown: SIGTERM/SIGINT -> finish the pass, then stop
(counterpart of ``photon_ml_tpu/resilience/shutdown.py``).

The descent loop polls a flag at PASS BOUNDARIES. With a checkpoint
directory it writes a final checkpoint and a ``preempted.json`` marker
there, and a run restarted with ``resume`` continues from it; the training
driver saves no model for a preempted run. The first request counts
``resilience.preemptions``, emits ``resilience.preemption_requested``,
flushes the tracer's buffered span records and dumps the installed flight
recorder (``flight-preemption.json`` on a signal, ``flight-shutdown.json``
on a programmatic request), while the driver's observe envelope still
holds it.

Signal handlers only install on the main thread (Python restriction);
elsewhere, or in tests, ``request()`` or a custom ``stop_check`` callable
triggers the same path.
"""

from __future__ import annotations

import json
import os
import signal
import threading
from typing import Optional

PREEMPTED_MARKER = "preempted.json"


class GracefulShutdown:
    """Arms SIGTERM/SIGINT to set a flag instead of killing the process.
    ``requested`` is polled by the descent loop at pass boundaries; the
    previous handlers are restored on exit (a second signal during teardown
    behaves normally)."""

    SIGNALS = (signal.SIGTERM, signal.SIGINT)

    def __init__(self, logger=None):
        self._logger = logger
        self._event = threading.Event()
        self._prev = {}
        self._drain_hooks = []
        self.signum: Optional[int] = None

    @property
    def requested(self) -> bool:
        return self._event.is_set()

    def request(self, signum: Optional[int] = None) -> None:
        """Programmatic trigger (tests, cluster-manager hooks)."""
        if signum is not None:
            self.signum = signum
        first = not self._event.is_set()
        self._event.set()
        if first:
            # obs note BEFORE draining: may run in signal-handler context,
            # and both calls are non-blocking (counter inc + list append)
            from photon_ml_tpu_torch import obs

            obs.registry().inc("resilience.preemptions")
            obs.emit_event("resilience.preemption_requested", cat="resilience",
                           signum=signum)
            # a SIGTERM'd process leaves its last buffered span records on
            # disk and, with a recorder installed, its post-mortem: bounded
            # file writes, best-effort either way
            try:
                tracer = obs.get_tracer()
                if tracer is not None:
                    tracer.flush()
                obs.flight_dump("preemption" if signum is not None else "shutdown")
            except Exception:  # noqa: BLE001 — shutdown must proceed
                pass
            self.drain()

    def register_drain(self, hook):
        """Register a callable to run once when shutdown is requested.
        Hooks may run in signal-handler context, so they must not block.
        Returns the hook (decorator-friendly)."""
        self._drain_hooks.append(hook)
        return hook

    def drain(self) -> None:
        """Invoke every registered drain hook; a raising hook is logged and
        skipped, so one bad hook does not stop the shutdown."""
        for hook in list(self._drain_hooks):
            try:
                hook()
            except Exception as e:  # noqa: BLE001 — shutdown must proceed
                if self._logger is not None:
                    self._logger.warn(f"drain hook {hook!r} failed: {e}")

    def __call__(self) -> bool:
        """A GracefulShutdown IS a ``stop_check`` callable."""
        return self.requested

    def _handle(self, signum, frame):
        self.request(signum)
        if self._logger is not None:
            try:
                name = signal.Signals(signum).name
            except ValueError:
                name = str(signum)
            self._logger.warn(f"received {name}: finishing the current pass, then stopping")

    def install(self) -> "GracefulShutdown":
        if threading.current_thread() is not threading.main_thread():
            return self  # the signal API is main-thread-only; the flag still works
        for sig in self.SIGNALS:
            self._prev[sig] = signal.signal(sig, self._handle)
        return self

    def uninstall(self) -> None:
        for sig, prev in self._prev.items():
            signal.signal(sig, prev)
        self._prev.clear()

    def __enter__(self) -> "GracefulShutdown":
        return self.install()

    def __exit__(self, *exc) -> None:
        self.uninstall()


def write_preempted_marker(checkpoint_dir: str, step: int,
                           signum: Optional[int] = None) -> str:
    """Record that the run exited early but resumable. The marker is
    advisory (resume works off the checkpoints alone), but it tells
    drivers and operators 'preempted mid-run' from 'finished'."""
    os.makedirs(checkpoint_dir, exist_ok=True)
    path = os.path.join(checkpoint_dir, PREEMPTED_MARKER)
    with open(path, "w") as f:
        json.dump({"step": step, "signal": signum}, f)
    return path


def read_preempted_marker(checkpoint_dir: str) -> Optional[dict]:
    try:
        with open(os.path.join(checkpoint_dir, PREEMPTED_MARKER)) as f:
            return json.load(f)
    except (FileNotFoundError, json.JSONDecodeError):
        return None


def clear_preempted_marker(checkpoint_dir: str) -> None:
    try:
        os.remove(os.path.join(checkpoint_dir, PREEMPTED_MARKER))
    except FileNotFoundError:
        pass
