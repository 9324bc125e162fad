"""Counts of the port's own builds (counterpart of
``photon_ml_tpu/obs/compile_events.py``, whose ``xla.compiles`` counter
counts XLA backend compiles).

The port compiles no programs at run time. What it builds is:

- a kernel library: one ``nvcc`` run per ``kernels/csrc/*.cu`` source
  that is not built yet (``kernels.build.build``), counted under
  ``kernels.builds`` with a ``kernels.build`` instant event carrying the
  library and the seconds;
- a launch plan: a kernel wrapper's full check of a new key of dtypes,
  shapes and devices, kept for later calls with the same key
  (``kernels.launch.keep``), counted under ``kernels.launch_plans`` with
  a ``kernels.launch_plan`` instant event carrying the kernel.

Both stand where the JAX package counts ``xla.compiles``: a steady-state
loop that builds nothing new shows zero growth in both. The counters are
process-wide and always on (registry writes and, under a tracer, one
instant event).
"""

from __future__ import annotations

import threading
from typing import Dict

# symbol imports: the package rebinds its `trace` attribute to the
# context-manager function once __init__ runs
from photon_ml_tpu_torch.obs.metrics import registry as _registry
from photon_ml_tpu_torch.obs.trace import emit_event as _emit_event

__all__ = ["build_events", "note_build", "note_launch_plan"]

_lock = threading.Lock()
_events: Dict[str, int] = {"builds": 0, "launch_plans": 0}


def note_build(library: str, seconds: float) -> None:
    """One ``nvcc`` build of ``library`` that took ``seconds``."""
    with _lock:
        _events["builds"] += 1
    _registry().inc("kernels.builds")
    _emit_event("kernels.build", cat="kernels", library=library,
                duration_ms=round(seconds * 1e3, 3))


def note_launch_plan(kernel: str) -> None:
    """One new launch plan of ``kernel``'s wrapper."""
    with _lock:
        _events["launch_plans"] += 1
    _registry().inc("kernels.launch_plans")
    _emit_event("kernels.launch_plan", cat="kernels", kernel=kernel)


def build_events() -> Dict[str, int]:
    """Process-wide ``{"builds", "launch_plans"}`` counted so far."""
    with _lock:
        return dict(_events)
