"""Run logging: timestamped, level-filtered, teeing to a run-directory file
(counterpart of ``photon_ml_tpu/utils/logging.py``; the reference's
``util/PhotonLogger.scala:35-503``). Every driver run leaves its full log in
the output directory, and ``timed`` logs a phase's wall clock (and traces it
as a span).

``PHOTON_LOG_LEVEL`` (env) overrides the constructed level.
"""

from __future__ import annotations

import contextlib
import os
import sys
import time
from typing import Optional, TextIO

_LEVELS = {"DEBUG": 10, "INFO": 20, "WARN": 30, "ERROR": 40}

ENV_LEVEL_VAR = "PHOTON_LOG_LEVEL"


def _resolve_level(level: str) -> int:
    """Constructor level, unless ``PHOTON_LOG_LEVEL`` overrides it. An
    unknown env value is reported and ignored."""
    env = os.environ.get(ENV_LEVEL_VAR)
    if env:
        name = env.strip().upper()
        if name in _LEVELS:
            return _LEVELS[name]
        print(
            f"{ENV_LEVEL_VAR}={env!r} is not one of {sorted(_LEVELS)}; "
            f"using {level!r}",
            file=sys.stderr,
        )
    return _LEVELS[level.upper()]


class PhotonLogger:
    """Timestamped leveled logger writing to stderr and (optionally) a file.

    ``PhotonLogger(path)`` opens ``path`` for append; ``None`` is
    console-only."""

    def __init__(
        self,
        path: Optional[str] = None,
        level: str = "DEBUG",
        stream: Optional[TextIO] = None,
    ):
        self.level = _resolve_level(level)
        self.stream = stream if stream is not None else sys.stderr
        self._file = None
        if path is not None:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            self._file = open(path, "a", encoding="utf-8")

    def _emit(self, level: str, msg: str) -> None:
        if _LEVELS[level] < self.level:
            return
        now = time.time()
        stamp = time.strftime("%Y-%m-%d %H:%M:%S", time.localtime(now))
        line = f"{stamp} [{level}] {msg}"
        # a closed stream/file must not turn a log call into an error
        if not getattr(self.stream, "closed", False):
            print(line, file=self.stream)
        if self._file is not None and not self._file.closed:
            self._file.write(line + "\n")
            self._file.flush()

    def debug(self, msg: str) -> None:
        self._emit("DEBUG", msg)

    def info(self, msg: str) -> None:
        self._emit("INFO", msg)

    def warn(self, msg: str) -> None:
        self._emit("WARN", msg)

    def error(self, msg: str) -> None:
        self._emit("ERROR", msg)

    def close(self) -> None:
        if self._file is not None:
            self._file.close()
            self._file = None

    def __enter__(self) -> "PhotonLogger":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


@contextlib.contextmanager
def timed(logger: Optional[PhotonLogger], label: str):
    """Log the wall clock of a phase (``Driver.scala:232-291`` timing) AND
    emit a span of the phase to the active tracer, so every phase a driver
    times shows up in the trace. Failed phases still report their
    duration."""
    from photon_ml_tpu_torch.obs.trace import span as _span

    t0 = time.perf_counter()
    ok = True
    try:
        with _span(label, cat="phase"):
            yield
    except BaseException:
        ok = False
        raise
    finally:
        dt = time.perf_counter() - t0
        if logger is not None:
            logger.info(f"{label} took {dt:.3f}s" + ("" if ok else " (failed)"))
