"""Preemption-safe shutdown: SIGTERM/SIGINT -> finish the pass, then stop
(counterpart of ``photon_ml_tpu/resilience/shutdown.py``).

The descent loop polls a flag at PASS BOUNDARIES. With checkpoints (not
ported yet: ROADMAP.md queue A, "I/O runtime") the JAX package writes a
final one and a ``preempted.json`` marker there; here a stop at a pass
boundary ends the run, and the training driver then saves nothing, as the
JAX driver does without checkpoints. The JAX package's observability event
and flight dump on a request wait for queue A's "Host layers with no
device math".

Signal handlers only install on the main thread (Python restriction);
elsewhere, or in tests, ``request()`` or a custom ``stop_check`` callable
triggers the same path.
"""

from __future__ import annotations

import signal
import threading
from typing import Optional


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
