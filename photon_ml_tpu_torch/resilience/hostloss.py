"""Host-loss recovery contract for multi-process training (counterpart of
``photon_ml_tpu/resilience/hostloss.py``).

A world of processes has no scheduler: when one rank dies or wedges, the
survivors' next collective blocks. The survivors instead:

1. DETECT — the heartbeat monitor (:mod:`photon_ml_tpu_torch.parallel.
   heartbeat`) or the collective watchdog (:mod:`photon_ml_tpu_torch.
   parallel.multihost`) raises, or ``torch.distributed`` itself fails a
   collective (a backend error, a timeout).
2. MARK — a ``host-loss.json`` marker records why and which peers.
3. EXIT — the driver exits with :data:`HOST_LOSS_EXIT_CODE`, distinct from
   success (0), failure (1), config errors (2) and the serving drain exit
   (3), so a cluster manager can tell "restart me" from "do not retry".

The marker's bytes are the JAX package's.
"""

from __future__ import annotations

import json
import os
from typing import List, Optional, Sequence

HOST_LOSS_EXIT_CODE = 43

HOST_LOSS_MARKER = "host-loss.json"


class HostLossDetected(RuntimeError):
    """A peer process is dead or unreachable (missed heartbeats, or a
    collective that timed out past its retry budget); carries the lost
    peer indices."""

    def __init__(self, peers: Sequence[int], reason: str = "heartbeat"):
        peers = sorted(int(p) for p in peers)
        super().__init__(
            f"host loss detected ({reason}): peer process(es) {peers} "
            "missing — survivors checkpoint and exit "
            f"{HOST_LOSS_EXIT_CODE} for an elastic restart"
        )
        self.peers: List[int] = list(peers)
        self.reason = reason


def _torch_collective_errors() -> tuple:
    """``torch.distributed``'s own failures of a collective: its backend
    and distributed errors and its store timeout (each where this torch
    has it)."""
    import torch.distributed as dist

    names = ("DistBackendError", "DistNetworkError", "DistStoreError", "DistError")
    return tuple(t for t in (getattr(dist, n, None) for n in names) if isinstance(t, type))


def is_host_loss(exc: BaseException) -> bool:
    """True when ``exc`` maps to the host-loss exit: a
    :class:`HostLossDetected`, the watchdog's ``CollectiveTimeout`` or
    ``CollectiveAbandoned``, or a ``torch.distributed`` collective failure,
    found anywhere down the cause chain (retry wrappers re-raise with the
    original as ``__cause__``). Matched by type, never by name."""
    from photon_ml_tpu_torch.parallel.multihost import (
        CollectiveAbandoned,
        CollectiveTimeout,
    )

    types = (HostLossDetected, CollectiveTimeout, CollectiveAbandoned) + _torch_collective_errors()
    seen = set()
    while exc is not None and id(exc) not in seen:
        seen.add(id(exc))
        if isinstance(exc, types):
            return True
        exc = exc.__cause__ or exc.__context__
    return False


def write_host_loss_marker(
    checkpoint_dir: str,
    step: int,
    peers: Sequence[int],
    reason: str = "heartbeat",
    final_checkpoint: bool = True,
) -> str:
    """Record that the run exited on host loss (advisory, like
    ``preempted.json``); ``final_checkpoint`` False records that the final
    save failed."""
    os.makedirs(checkpoint_dir, exist_ok=True)
    path = os.path.join(checkpoint_dir, HOST_LOSS_MARKER)
    with open(path, "w") as f:
        json.dump(
            {
                "step": int(step),
                "peers": sorted(int(p) for p in peers),
                "reason": reason,
                "exit_code": HOST_LOSS_EXIT_CODE,
                "final_checkpoint": bool(final_checkpoint),
            },
            f,
        )
    from photon_ml_tpu_torch import obs

    obs.registry().inc("resilience.host_losses")
    obs.emit_event(
        "resilience.host_loss_marker_written",
        cat="resilience",
        step=int(step),
        peers=sorted(int(p) for p in peers),
        reason=reason,
    )
    return path


def read_host_loss_marker(checkpoint_dir: str) -> Optional[dict]:
    path = os.path.join(checkpoint_dir, HOST_LOSS_MARKER)
    try:
        with open(path) as f:
            return json.load(f)
    except (FileNotFoundError, json.JSONDecodeError):
        return None


def clear_host_loss_marker(checkpoint_dir: str) -> None:
    try:
        os.remove(os.path.join(checkpoint_dir, HOST_LOSS_MARKER))
    except FileNotFoundError:
        pass
