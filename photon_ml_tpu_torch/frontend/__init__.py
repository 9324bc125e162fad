"""Production serving fabric (counterpart of ``photon_ml_tpu/frontend``):
the tier that turns one scoring engine into a *service*.

- :mod:`.server`   — asyncio front end: multiplexed connections,
  length-prefixed binary + JSON-lines framing, streaming batch replies,
  queue-full answered as explicit ``RESOURCE_EXHAUSTED`` (never a
  silent drop).
- :mod:`.tenants`  — multi-tenant engine layer: per-tenant registries
  sharing ONE process-wide bucket-scorer ladder, per-tenant deadlines/
  priorities/quotas riding the shared admission queue, per-tenant SLO
  trackers.
- :mod:`.replicas` — R replicas of the (optionally P-shard) engine
  behind a least-outstanding-requests router with per-replica breakers
  and whole-replica failover: throughput scales in R, capacity in P.

Entry point: ``python -m photon_ml_tpu_torch.cli.serve --frontend-port
...`` (the original JSON-lines protocol stays as the compat admin
channel).
"""

from photon_ml_tpu_torch.frontend.replicas import (
    AllReplicasDown,
    Replica,
    ReplicaRouter,
)
from photon_ml_tpu_torch.frontend.server import FrontendClient, FrontendServer
from photon_ml_tpu_torch.frontend.tenants import (
    TenantManager,
    TenantState,
    UnknownTenant,
    process_compile_cache,
)

__all__ = [
    "AllReplicasDown",
    "Replica",
    "ReplicaRouter",
    "FrontendClient",
    "FrontendServer",
    "TenantManager",
    "TenantState",
    "UnknownTenant",
    "process_compile_cache",
]
