"""Mesh parallelism on ``torch.distributed`` (counterpart of
``photon_ml_tpu/parallel``): a JAX mesh of P devices is a world of P
ranks, one per device, whose axes (``("data", "feature")`` or
``("host", "device")``) are a ``DeviceMesh``'s process groups.

  | the JAX package                  | here                                  |
  |----------------------------------|---------------------------------------|
  | psum over 'data' (GSPMD)         | all-reduce over the 'data' group      |
  | w sharded over 'feature'         | each rank holds its block of w        |
  | margins block-sum over 'feature' | one all-reduce (or one per row chunk) |
  | jax.distributed.initialize       | torch.distributed.init_process_group  |
  | the coordinator's KV store       | the process group's Store             |

The solvers' loops run on every rank, each taking its branches from host
reads of reduced scalars, which the all-reduces give every rank bit for
bit. Entity-sharded GAME (a 1-D 'entity' mesh, ``make_entity_mesh``)
keeps each rank's entities and their rows on its device; its
random-effect update issues no collective. Sharded serving is not ported
yet (ROADMAP.md, queue A item 9c).
"""

from photon_ml_tpu_torch.parallel.mesh import (
    Mesh,
    active_mesh,
    collective_counts,
    default_mesh,
    entity_block,
    make_entity_mesh,
    make_feature_mesh,
    make_game_mesh,
    make_host_device_mesh,
    make_mesh,
    rank_device,
    reset_collective_counts,
    row_axis,
    set_mesh,
    shard_batch,
    shard_bucketed_design,
    shard_design,
    split_rows,
)
from photon_ml_tpu_torch.parallel.overlap import (
    collective_mode,
    feature_block_sum,
    overlap_chunks,
)
from photon_ml_tpu_torch.parallel.heartbeat import (
    DistributedKVHeartbeats,
    HeartbeatMonitor,
    InProcessHeartbeats,
    current_monitor,
    install_monitor,
)
from photon_ml_tpu_torch.parallel.multihost import (
    CollectiveAbandoned,
    CollectiveResilience,
    CollectiveTimeout,
    allgather_host,
    allgather_objects,
    allgather_strings,
    collective_resilience,
    configure_collective_resilience,
    fetch_replicated,
    global_entity_space,
    hierarchical_psum,
    initialize_multihost,
    make_global_batch,
    make_global_re_design,
    reshard_replicated,
    process_local_paths,
    process_local_rows,
    resilient_host_exchange,
    shutdown_multihost,
)

# the training entry points import the solvers and the objective, which
# import this package's mesh; they load on first use
_DISTRIBUTED = (
    "distributed_train_glm",
    "feature_sharded_train_glm",
    "hierarchical_value_and_grad",
    "shard_map_value_and_grad",
)


def __getattr__(name):
    if name in _DISTRIBUTED:
        from photon_ml_tpu_torch.parallel import distributed

        return getattr(distributed, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "Mesh",
    "make_mesh",
    "make_entity_mesh",
    "make_game_mesh",
    "make_feature_mesh",
    "make_host_device_mesh",
    "default_mesh",
    "active_mesh",
    "rank_device",
    "set_mesh",
    "row_axis",
    "shard_batch",
    "shard_bucketed_design",
    "entity_block",
    "shard_design",
    "split_rows",
    "collective_counts",
    "reset_collective_counts",
    "collective_mode",
    "feature_block_sum",
    "overlap_chunks",
    "hierarchical_psum",
    "hierarchical_value_and_grad",
    "resilient_host_exchange",
    "distributed_train_glm",
    "feature_sharded_train_glm",
    "shard_map_value_and_grad",
    "allgather_host",
    "allgather_strings",
    "allgather_objects",
    "fetch_replicated",
    "reshard_replicated",
    "global_entity_space",
    "make_global_re_design",
    "initialize_multihost",
    "shutdown_multihost",
    "make_global_batch",
    "process_local_paths",
    "process_local_rows",
    "CollectiveResilience",
    "CollectiveAbandoned",
    "CollectiveTimeout",
    "collective_resilience",
    "configure_collective_resilience",
    "DistributedKVHeartbeats",
    "HeartbeatMonitor",
    "InProcessHeartbeats",
    "current_monitor",
    "install_monitor",
]
