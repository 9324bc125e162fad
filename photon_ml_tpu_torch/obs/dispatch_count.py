"""Kernel-launch counting: how many launches of which kernel did a block
make? (Counterpart of ``photon_ml_tpu/obs/dispatch_count.py``.)

The JAX package counts XLA executables: it wraps the Python layer every
jitted execution funnels through and keys the counts by the executable's
name (``solve_path``, ``superpass``, ...). The port runs no executables:
its device work is eager PyTorch plus the hand-written kernels, each of
whose wrappers adds one to its count in ``kernels.dispatch`` where it
launches. So here a block's counts are the deltas of
``kernels.dispatch.launch_counts()`` across it, keyed by kernel name
(``fused_vgc``, ``fused_hvp``, ``ell_matvec``, ``colsort_reduce``, ...).
Counting patches nothing and costs nothing on the launch path; a plain
PyTorch op (and a kernel's plain version on the CPU) is not counted.

The launch counts are process-wide, so a block counts every thread's
launches while it is open. Blocks nest: each sees the launches of the
window it wraps.
"""

from __future__ import annotations

import contextlib
import fnmatch
from typing import Dict, Iterator, Optional

__all__ = ["DispatchCounts", "count_dispatches"]


def _launch_counts() -> Dict[str, int]:
    from photon_ml_tpu_torch.kernels import dispatch

    return dispatch.launch_counts()


class DispatchCounts:
    """Per-kernel launch counts observed inside one ``count_dispatches()``
    window, plus assertion helpers. While the window is open the counts
    are live; on exit they are frozen."""

    def __init__(self) -> None:
        self._start = _launch_counts()
        self._frozen: Optional[Dict[str, int]] = None

    @property
    def by_name(self) -> Dict[str, int]:
        return self.snapshot()

    def _close(self) -> None:
        self._frozen = self._deltas()

    def _deltas(self) -> Dict[str, int]:
        now = _launch_counts()
        return {k: now[k] - self._start.get(k, 0) for k in now
                if now[k] != self._start.get(k, 0)}

    def total(self) -> int:
        return sum(self.snapshot().values())

    def for_program(self, pattern: str) -> int:
        """Total launches of kernels whose name matches ``pattern``
        (fnmatch, or a substring)."""
        return sum(
            c for n, c in self.snapshot().items()
            if fnmatch.fnmatch(n, pattern) or pattern in n
        )

    def assert_program(self, pattern: str, expected: int) -> None:
        """Assert the kernels matching ``pattern`` launched exactly
        ``expected`` times."""
        got = self.for_program(pattern)
        if got != expected:
            raise AssertionError(
                f"expected {expected} launch(es) of {pattern!r}, "
                f"counted {got}; all kernels: {self.snapshot()}"
            )

    def snapshot(self) -> Dict[str, int]:
        if self._frozen is not None:
            return dict(self._frozen)
        return self._deltas()


@contextlib.contextmanager
def count_dispatches() -> Iterator[DispatchCounts]:
    """Count every kernel launch inside the block, per kernel name.
    Reentrant; CPU and CUDA alike (on the CPU the kernels run their plain
    versions and nothing is counted)."""
    counts = DispatchCounts()
    try:
        yield counts
    finally:
        counts._close()
