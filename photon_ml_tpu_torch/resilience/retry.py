"""Bounded exponential-backoff retry for transient I/O (a copy of
``photon_ml_tpu/resilience/retry.py``, whose observability events and
counters wait for the port's host layers, ROADMAP.md queue A item 10).

Policy: exponential backoff with full jitter (decorrelates a fleet of
preempted workers re-reading the same shard), bounded by both an attempt
budget and a wall-clock deadline, retrying only exception types that
plausibly heal (``OSError``).
"""

from __future__ import annotations

import random
import time
from typing import Callable, Optional, Tuple, Type

DEFAULT_RETRY_ON: Tuple[Type[BaseException], ...] = (OSError,)


class RetryBudgetExceeded(Exception):
    """All attempts failed; carries the last error as ``__cause__``."""

    def __init__(self, label: str, attempts: int, elapsed: float):
        super().__init__(f"{label}: gave up after {attempts} attempts ({elapsed:.2f}s)")
        self.attempts = attempts
        self.elapsed = elapsed


def backoff_delays(
    retries: int,
    base_delay: float = 0.05,
    factor: float = 2.0,
    max_delay: float = 2.0,
    jitter: float = 1.0,
    seed: Optional[int] = None,
):
    """Yield the sleep before each retry: ``min(max, base*factor**i)``
    scaled by a uniform full-jitter draw in ``[1-jitter/2, 1+jitter/2]``.
    ``seed`` pins the draws."""
    rng = random.Random(seed)
    for i in range(retries):
        cap = min(max_delay, base_delay * factor**i)
        yield cap * (1.0 + jitter * (rng.random() - 0.5))


def retry_call(
    fn: Callable,
    *args,
    retries: int = 4,
    base_delay: float = 0.05,
    factor: float = 2.0,
    max_delay: float = 2.0,
    deadline: Optional[float] = None,
    jitter: float = 1.0,
    retry_on: Tuple[Type[BaseException], ...] = DEFAULT_RETRY_ON,
    logger=None,
    label: Optional[str] = None,
    seed: Optional[int] = None,
    **kwargs,
):
    """Call ``fn(*args, **kwargs)``, retrying ``retry_on`` failures.

    Gives up (raising :class:`RetryBudgetExceeded` from the last error)
    when ``retries`` re-attempts are spent OR the next sleep would cross
    ``deadline`` seconds of total elapsed time. Other exceptions propagate
    at once (a programming error is not transient)."""
    label = label or getattr(fn, "__name__", "call")
    t0 = time.monotonic()
    delays = backoff_delays(retries, base_delay, factor, max_delay, jitter, seed)
    attempt = 0
    while True:
        attempt += 1
        try:
            return fn(*args, **kwargs)
        except retry_on as e:
            elapsed = time.monotonic() - t0
            sleep = next(delays, None)
            if sleep is None or (deadline is not None and elapsed + sleep > deadline):
                raise RetryBudgetExceeded(label, attempt, elapsed) from e
            if logger is not None:
                logger.warn(f"{label}: attempt {attempt} failed ({e!r}); "
                            f"retrying in {sleep:.3f}s")
            time.sleep(sleep)
