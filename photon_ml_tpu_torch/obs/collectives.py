"""Collective profiler: per-reduction counts, bytes and blocked wall time
(counterpart of ``photon_ml_tpu/obs/collectives.py``). Three series per
(reduction, mesh width W), in the metrics registry:

- ``collective.<name>.w<W>.count``   — executions (counter)
- ``collective.<name>.w<W>.bytes``   — cumulative payload bytes (counter)
- ``collective.<name>.w<W>.wall_ms`` — blocked wall per execution
  (histogram), present only where the call blocks

:func:`record_collective` is the primitive. ``parallel/mesh.py``'s
``all_reduce``, ``all_gather`` and ``reduce_scatter`` feed it from their
count hook for every collective they issue: the count and the bytes
always, the wall time only where the call blocks until the exchange is
done (a gloo collective, or an NCCL one followed by a device sync, which
the mesh takes only under a tracer). An NCCL collective returns once it is
enqueued on the stream, and its enqueue is never timed as the exchange.
:func:`collective_span` brackets a host-level exchange with a span and the
metrics. The JAX package's trace-time notes of in-program collectives
(``note_traced_collective``) have no counterpart: the port issues every
collective eagerly, through the mesh.

Everything here is registry writes — cheap, lock-guarded, and always on
(no tracer required).
"""

from __future__ import annotations

import contextlib
import time
from typing import Optional

from photon_ml_tpu_torch.obs.metrics import MetricsRegistry
from photon_ml_tpu_torch.obs.metrics import registry as _registry
from photon_ml_tpu_torch.obs.trace import span as _span

__all__ = [
    "collective_metric_key",
    "record_collective",
    "record_collective_share",
    "collective_span",
    "tree_bytes",
]


def collective_metric_key(name: str, mesh_width: int) -> str:
    """``collective.<name>.w<W>`` — the metric-name stem shared by the
    count/bytes/wall_ms series of one (reduction, mesh width) pair."""
    return f"collective.{name}.w{int(mesh_width)}"


def record_collective(
    name: str,
    mesh_width: int = 1,
    count: float = 1,
    nbytes: float = 0,
    wall_s: Optional[float] = None,
    registry: Optional[MetricsRegistry] = None,
) -> None:
    """Record one (or ``count``) executions of a collective: increments
    the count/bytes counters and, when ``wall_s`` is given, observes the
    wall histogram. The one write path every profiling surface uses."""
    reg = registry if registry is not None else _registry()
    key = collective_metric_key(name, mesh_width)
    reg.inc(f"{key}.count", count)
    if nbytes:
        reg.inc(f"{key}.bytes", float(nbytes))
    if wall_s is not None:
        reg.observe(f"{key}.wall_ms", wall_s * 1e3)


def record_collective_share(
    name: str,
    mesh_width: int,
    collective_wall_s: float,
    pass_wall_s: float,
    registry: Optional[MetricsRegistry] = None,
) -> float:
    """Record ``collective_wall_frac`` — collective wall as a share of
    the ENCLOSING pass wall — as the gauge
    ``collective.<name>.w<W>.wall_frac`` (plus the underlying wall
    histogram via :func:`record_collective`): the direct measure of how
    much communication did not hide under compute. Clamped to [0, 1]; a
    degenerate pass wall records 0."""
    frac = 0.0
    if pass_wall_s > 0:
        frac = min(max(collective_wall_s / pass_wall_s, 0.0), 1.0)
    reg = registry if registry is not None else _registry()
    key = collective_metric_key(name, mesh_width)
    reg.set_gauge(f"{key}.wall_frac", round(frac, 6))
    record_collective(
        name,
        mesh_width=mesh_width,
        wall_s=max(collective_wall_s, 0.0),
        registry=reg,
    )
    return frac


@contextlib.contextmanager
def collective_span(
    name: str,
    mesh_width: int = 1,
    nbytes: float = 0,
    registry: Optional[MetricsRegistry] = None,
):
    """Bracket a HOST-OBSERVABLE collective (the call blocks until the
    exchange completes — a gloo collective, a host object exchange) with a
    ``collective.<name>`` span and the count/bytes/wall metrics. The
    caller must actually block inside the body; an NCCL enqueue would time
    the enqueue, not the exchange."""
    t0 = time.perf_counter()
    with _span(
        f"collective.{name}",
        cat="collective",
        mesh_width=int(mesh_width),
        bytes=float(nbytes),
    ):
        yield
    record_collective(
        name,
        mesh_width=mesh_width,
        nbytes=nbytes,
        wall_s=time.perf_counter() - t0,
        registry=registry,
    )


def tree_bytes(tree) -> int:
    """Total buffer bytes across nested lists, tuples and dict values of
    tensors (payload-size helper for :func:`collective_span` callers).
    Leaves without ``numel``/``element_size`` (or ``nbytes``) contribute
    0."""
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(tree_bytes(leaf) for leaf in tree)
    numel = getattr(tree, "numel", None)
    size = getattr(tree, "element_size", None)
    if callable(numel) and callable(size):
        return int(numel()) * int(size())
    nb = getattr(tree, "nbytes", None)
    return int(nb) if isinstance(nb, (int, float)) else 0
