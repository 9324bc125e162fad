"""Joining a multi-process world, input splits, host exchanges and their
watchdog (counterpart of ``photon_ml_tpu/parallel/multihost.py``).

One process per device joins one ``torch.distributed`` world
(:func:`initialize_multihost`): NCCL for CUDA devices, gloo for the CPU.
Joining happens only on an explicit signal — the arguments, or a
launcher's ``WORLD_SIZE`` > 1 with ``RANK`` and ``MASTER_ADDR`` (what
``torchrun`` sets), the counterparts of the JAX package's
``JAX_COORDINATOR_ADDRESS`` / ``JAX_NUM_PROCESSES`` / ``JAX_PROCESS_ID``.
Every rank then builds the same mesh over the whole world
(:mod:`.mesh`)::

    initialize_multihost()           # no-op in a single process
    mesh = make_mesh()               # every rank of the world
    models = distributed_train_glm(batch, config, mesh)

Every host exchange here (:func:`allgather_host` and what rides it) runs
under the collective watchdog when one is configured
(:func:`configure_collective_resilience`): a deadline per attempt, the
stall recorded with straggler attribution from the heartbeat monitor,
retries through the resilience backoff, and a budget whose exhaustion is
the host-loss contract (:mod:`photon_ml_tpu_torch.resilience.hostloss`).
"""

from __future__ import annotations

import dataclasses
import os
import threading
import time
from typing import Callable, Optional

import numpy as np

from photon_ml_tpu_torch.parallel.mesh import DATA_AXIS, split_rows, world
from photon_ml_tpu_torch.resilience import faults as _faults

_INITIALIZED = False


def process_count() -> int:
    return world()[0]


def process_index() -> int:
    return world()[1]


# ---------------------------------------------------------------------------
# the collective watchdog
# ---------------------------------------------------------------------------


class CollectiveTimeout(OSError):
    """A host collective exceeded its watchdog deadline. An OSError, so the
    retry seam classifies it as transient: a straggler may still arrive on
    the retry; a dead host exhausts the budget and becomes host loss."""

    def __init__(self, label: str, timeout_s: float, attempt: int):
        super().__init__(
            f"collective {label!r} exceeded its {timeout_s:.3g}s watchdog "
            f"deadline (attempt {attempt})"
        )
        self.label = label
        self.timeout_s = timeout_s
        self.attempt = attempt


class CollectiveAbandoned(RuntimeError):
    """An abandoned attempt was still in flight when its retry came due in
    a world of several processes: reissuing could pair the orphan with a
    peer's next exchange and desync the collective order, so this escalates
    to the host-loss contract instead. Not an OSError: never retried."""

    def __init__(self, label: str, waited_s: float):
        super().__init__(
            f"collective {label!r} abandoned: a timed-out attempt was "
            f"still in flight {waited_s:.3g}s after issue — reissuing "
            "would desync collective order across processes; escalating "
            "to the host-loss contract"
        )
        self.label = label
        self.waited_s = waited_s


@dataclasses.dataclass
class CollectiveResilience:
    """Watchdog policy for host collectives. ``timeout_s`` None (default)
    keeps the bare blocking exchange."""

    timeout_s: Optional[float] = None
    retries: int = 2


_RESILIENCE = CollectiveResilience()


def configure_collective_resilience(
    timeout_s: Optional[float] = None, retries: int = 2
) -> CollectiveResilience:
    """Install the watchdog policy for every host collective here (the
    drivers' ``collective_timeout_s``). Returns the previous policy."""
    global _RESILIENCE
    if timeout_s is not None and timeout_s <= 0:
        raise ValueError(f"timeout_s must be > 0, got {timeout_s}")
    if retries < 0:
        raise ValueError(f"retries must be >= 0, got {retries}")
    prev = _RESILIENCE
    _RESILIENCE = CollectiveResilience(timeout_s=timeout_s, retries=retries)
    return prev


def collective_resilience() -> CollectiveResilience:
    return _RESILIENCE


def _note_stall(label: str, waited_s: float, attempt: int) -> None:
    """One watchdog trip: the ``collective.stalls`` counter, the
    ``collective.stall_ms`` histogram and a ``collective.stall`` event
    naming the slowest peer when a heartbeat monitor is installed."""
    from photon_ml_tpu_torch import obs

    reg = obs.registry()
    reg.inc("collective.stalls")
    reg.observe("collective.stall_ms", waited_s * 1e3)
    slowest_host, slowest_age = None, None
    from photon_ml_tpu_torch.parallel.heartbeat import current_monitor

    mon = current_monitor()
    if mon is not None and mon.slowest() is not None:
        slowest_host, slowest_age = mon.slowest()
        reg.set_gauge("pod.heartbeat.slowest_host", slowest_host)
        reg.set_gauge("pod.heartbeat.slowest_age_s", round(slowest_age, 4))
    obs.emit_event(
        "collective.stall",
        cat="collective",
        label=label,
        waited_s=round(waited_s, 4),
        attempt=attempt,
        slowest_host=slowest_host,
        slowest_age_s=round(slowest_age, 4) if slowest_age is not None else None,
    )


def _resilient_exchange(label: str, fn: Callable):
    """Run one host collective under the configured watchdog and retry
    policy. Probes the ``collective.stall`` fault site (key = label) inside
    each attempt. In a world of several processes a retry first waits one
    more deadline for the abandoned attempt: a late result is consumed, a
    live orphan raises :class:`CollectiveAbandoned`."""
    cfg = _RESILIENCE

    def attempt_body():
        _faults.fire("collective.stall", key=label)
        return fn()

    if cfg.timeout_s is None:
        return attempt_body()

    from photon_ml_tpu_torch.resilience import retry as _retry

    attempts = [0]
    orphan: list = [None]

    def deadline_attempt():
        attempts[0] += 1
        prev = orphan[0]
        if prev is not None:
            orphan[0] = None
            p_thread, p_result, _p_error, p_t0 = prev
            if process_count() > 1:
                p_thread.join(cfg.timeout_s)
                if p_thread.is_alive():
                    waited = time.perf_counter() - p_t0
                    from photon_ml_tpu_torch import obs

                    obs.registry().inc("collective.abandoned")
                    obs.emit_event("collective.abandoned", cat="collective", label=label,
                                   waited_s=round(waited, 4), attempt=attempts[0])
                    raise CollectiveAbandoned(label, waited)
                if p_result:
                    return p_result[0]

        result: list = []
        error: list = []

        def work():
            try:
                result.append(attempt_body())
            except BaseException as e:  # noqa: BLE001 — re-raised below
                error.append(e)

        t = threading.Thread(target=work, name=f"collective-{label}", daemon=True)
        t0 = time.perf_counter()
        t.start()
        t.join(cfg.timeout_s)
        if t.is_alive():
            _note_stall(label, time.perf_counter() - t0, attempts[0])
            orphan[0] = (t, result, error, t0)
            raise CollectiveTimeout(label, cfg.timeout_s, attempts[0])
        if error:
            raise error[0]
        return result[0]

    return _retry.retry_call(deadline_attempt, retries=cfg.retries, label=f"collective {label}")


def resilient_host_exchange(label: str, fn: Callable):
    """The watchdog, retry and stall attribution of the built-in host
    collectives, for a caller's own exchange point; ``fn`` blocks until
    the exchange completes."""
    return _resilient_exchange(label, fn)


# ---------------------------------------------------------------------------
# joining
# ---------------------------------------------------------------------------


def initialize_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
    init_method: Optional[str] = None,
    timeout_s: Optional[float] = None,
) -> bool:
    """Join this process to a ``torch.distributed`` world. True when a
    world is joined (or already was), False for the single-process no-op,
    so drivers call it unconditionally.

    The signal to join is explicit: ``init_method``, a
    ``coordinator_address`` ("host:port") or ``num_processes`` > 1, or
    else the launcher's ``WORLD_SIZE`` > 1 with ``RANK`` and
    ``MASTER_ADDR``. ``backend`` defaults to NCCL when a card is present
    and gloo otherwise; under a launcher this process's card is
    ``cuda:{LOCAL_RANK}``."""
    global _INITIALIZED
    import datetime

    import torch
    import torch.distributed as dist

    if dist.is_initialized():
        _INITIALIZED = True
        return True
    env = os.environ
    from_env = (
        init_method is None and coordinator_address is None and num_processes is None
        and int(env.get("WORLD_SIZE", "1") or "1") > 1
        and env.get("RANK") is not None and env.get("MASTER_ADDR")
    )
    if from_env:
        num_processes = int(env["WORLD_SIZE"])
        process_id = int(env["RANK"])
        init_method = "env://"
    elif init_method is None:
        if not (coordinator_address or (num_processes or 0) > 1):
            return False
        if coordinator_address is None:
            raise ValueError("a world of several processes needs coordinator_address "
                             "or init_method")
        init_method = f"tcp://{coordinator_address}"
    if num_processes is None or process_id is None:
        raise ValueError("initialize_multihost needs num_processes and process_id")
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(int(env.get("LOCAL_RANK", "0") or "0"))
    kw = {}
    if timeout_s is not None:
        kw["timeout"] = datetime.timedelta(seconds=timeout_s)
    dist.init_process_group(backend, init_method=init_method, world_size=int(num_processes),
                            rank=int(process_id), **kw)
    _INITIALIZED = True
    # every obs artifact from here on is stamped with this rank, and an
    # installed tracer gets the barrier-backed clock.sync anchor
    emit_pod_sync()
    return True


def emit_pod_sync() -> None:
    """Stamp this process's obs identity from ``torch.distributed``'s rank
    and world size and emit a barrier-backed ``clock.sync`` trace event
    (JAX ``parallel/multihost.py:329-352``; no event untraced, the
    identity is stamped always; nothing unjoined). Called by
    :func:`initialize_multihost`; drivers call it again once their tracer
    is installed. The barrier rides the watchdog and retry policy of every
    host exchange (a dead peer must not wedge the sync)."""
    import torch.distributed as dist

    from photon_ml_tpu_torch.obs import dist as obs_dist

    if not dist.is_initialized():
        return
    obs_dist.set_process_identity(dist.get_rank(), dist.get_world_size())
    barrier = None
    if dist.get_world_size() > 1:
        def barrier():
            _resilient_exchange("pod_sync", lambda: dist.barrier())

    obs_dist.emit_clock_sync(sync_id="startup", barrier=barrier)


def shutdown_multihost() -> None:
    """Leave the world joined by :func:`initialize_multihost` (no-op
    unjoined); the obs identity goes back to the environment's."""
    global _INITIALIZED
    import torch.distributed as dist

    from photon_ml_tpu_torch.obs import dist as obs_dist

    if dist.is_initialized():
        dist.destroy_process_group()
    obs_dist.reset_process_identity()
    _INITIALIZED = False


def _require_joined(caller: str) -> None:
    """A configured but unjoined world is an error: an input split taken
    before joining would hand every process the whole input."""
    import torch.distributed as dist

    if dist.is_initialized():
        return
    configured = int(os.environ.get("WORLD_SIZE", "1") or "1")
    if configured > 1:
        raise RuntimeError(
            f"a world of {configured} processes is configured (WORLD_SIZE) but this "
            f"process has not joined it; call initialize_multihost() before {caller}()"
        )


def process_local_rows(total_rows: int) -> range:
    """The contiguous row range this rank ingests: the even split of a
    global row space over the world (everything in a single process)."""
    _require_joined("process_local_rows")
    return split_rows(total_rows, process_count(), process_index())


def process_local_paths(paths):
    """The input part files this rank ingests: round-robin by sorted
    position. Every rank raises when any rank's share would be empty."""
    _require_joined("process_local_paths")
    paths = sorted(paths)
    n = process_count()
    if len(paths) < n:
        raise ValueError(
            f"{len(paths)} part files for {n} processes — every process "
            "needs at least one input file"
        )
    return paths[process_index()::n]


# ---------------------------------------------------------------------------
# host exchanges
# ---------------------------------------------------------------------------


def allgather_host(x) -> np.ndarray:
    """A small host array -> the concatenation (axis 0, rank order) of
    every rank's value, on every rank. Rides the watchdog when one is
    configured; probes the ``collective.allreduce`` fault site."""

    def exchange():
        _faults.fire("collective.allreduce", key="allgather_host")
        arr = np.asarray(x)
        if process_count() == 1:
            return arr
        import torch.distributed as dist

        from photon_ml_tpu_torch.obs import collectives as obs_coll

        out = [None] * process_count()
        # a host exchange: the call blocks until every rank's part is here
        with obs_coll.collective_span("allgather_host", mesh_width=process_count(),
                                      nbytes=int(arr.nbytes)):
            dist.all_gather_object(out, arr)
        return np.concatenate([np.asarray(o) for o in out], axis=0)

    return _resilient_exchange("allgather_host", exchange)


def allgather_objects(obj) -> list:
    """Every rank's picklable ``obj``, in rank order, on every rank (under
    the watchdog when one is configured)."""

    def exchange():
        _faults.fire("collective.allreduce", key="allgather_objects")
        if process_count() == 1:
            return [obj]
        import torch.distributed as dist

        from photon_ml_tpu_torch.obs import collectives as obs_coll

        out = [None] * process_count()
        with obs_coll.collective_span("allgather_objects", mesh_width=process_count()):
            dist.all_gather_object(out, obj)
        return out

    return _resilient_exchange("allgather_objects", exchange)


def allgather_strings(strs) -> list:
    """Every rank's list of strings -> one list in rank order, identical
    on every rank."""
    if process_count() == 1:
        return list(strs)
    enc = [s.encode("utf-8") for s in strs]
    local_count = len(enc)
    local_max = max((len(b) for b in enc), default=0)
    meta = allgather_host(np.asarray([[local_count, local_max]], np.int64))
    max_count = int(meta[:, 0].max())
    max_len = max(int(meta[:, 1].max()), 1)
    buf = np.zeros((max_count, max_len), np.uint8)
    lens = np.zeros((max_count,), np.int64)
    for i, b in enumerate(enc):
        buf[i, : len(b)] = np.frombuffer(b, np.uint8)
        lens[i] = len(b)
    g_buf = allgather_host(buf).reshape(-1, max_count, max_len)
    g_lens = allgather_host(lens).reshape(-1, max_count)
    out = []
    for p in range(process_count()):
        for i in range(int(meta[p, 0])):
            out.append(g_buf[p, i, : g_lens[p, i]].tobytes().decode("utf-8"))
    return out


def global_entity_space(local_num_entities: int):
    """(global entity count, this rank's entity base) of the multi-process
    GAME branch (``photon_ml_tpu/parallel/multihost.py:550``): every
    entity's rows live in exactly one rank's input split, and this rank's
    local entity e is global entity ``base + e``."""
    counts = allgather_host(np.asarray([local_num_entities], np.int64))
    return int(counts.sum()), int(counts[: process_index()].sum())


def reshard_replicated(x, mesh=None, axis: Optional[str] = None):
    """A tensor whose leading axis is sharded over a mesh axis (this rank
    holds its block) -> the whole tensor, the blocks in rank order, on every
    rank: one all-gather (``photon_ml_tpu/parallel/multihost.py:569``).
    ``axis`` defaults to the mesh's rows' axis; without a mesh or a world
    the tensor passes through."""
    import torch

    from photon_ml_tpu_torch.parallel.mesh import active_mesh, all_gather, row_axis

    mesh = mesh if mesh is not None else active_mesh()
    if not torch.is_tensor(x) or mesh is None:
        return x
    axis = axis or row_axis(mesh)
    if axis is None:
        return x
    return all_gather(x, axis, "gather", mesh=mesh).reshape((-1,) + tuple(x.shape[1:]))


def gather_rows_to_host(x, mesh=None, axis: Optional[str] = None) -> np.ndarray:
    """The whole tensor of :func:`reshard_replicated` on the host, gathered
    in pieces: each all-gather moves ceil(B / P) rows of every rank's
    B-row block, so that what the gather holds on the card at once is at
    most one block, whatever the world's size. A tensor outside a world
    comes back as it is, on the host."""
    import torch

    from photon_ml_tpu_torch.parallel.mesh import active_mesh, all_gather, row_axis

    mesh = mesh if mesh is not None else active_mesh()
    axis = (axis or row_axis(mesh)) if mesh is not None else None
    if mesh is None or axis is None:
        return fetch_replicated(x)
    size = mesh.axis_size(axis)
    rows = int(x.shape[0])
    piece = max(1, -(-rows // size))
    out = None
    for lo in range(0, max(rows, 1), piece):
        got = fetch_replicated(all_gather(x[lo:lo + piece], axis, "host_copy", mesh=mesh))
        if out is None:
            out = np.empty((size, rows) + tuple(got.shape[2:]), got.dtype)
        out[:, lo:lo + got.shape[1]] = got
    return out.reshape((size * rows,) + out.shape[2:])


def fetch_replicated(x):
    """A value on the host: a tensor (every rank holds the same one after
    a reduction, or after :func:`reshard_replicated`) as a numpy array;
    anything else unchanged."""
    import torch

    if torch.is_tensor(x):
        t = x.detach().cpu()
        return (t.to(torch.float64) if t.dtype == torch.bfloat16 else t).numpy()
    return x


def make_global_re_design(design, mesh, num_entities_global: int, entity_base: int,
                          row_base: int):
    """This rank's random-effect design as its part of the global one
    (``photon_ml_tpu/parallel/multihost.py:605``). The input rows are
    ENTITY-PARTITIONED over the ranks (every entity's rows in one rank's
    split) and every rank builds with the same bucket count (pin
    ``num_buckets``). Each bucket is padded to the world's largest lane
    count and row cap (pad lanes masked, the global sentinel as their
    entity), and its lanes' entity indices become global (``entity_base``
    + local). The rows stay on this rank: ``row_index`` stays local (the
    rank's rows start at global row ``row_base``; the JAX package's global
    arrays need it, the port's rank-local ones do not). Returns the padded
    design, its ``num_entities`` the global count."""
    import torch

    from photon_ml_tpu_torch.game.data import BucketedRandomEffectDesign, RandomEffectDesign

    if isinstance(design, RandomEffectDesign):
        design = BucketedRandomEffectDesign(
            buckets=[design], entity_index=[np.arange(design.num_entities, dtype=np.int32)],
            num_entities=design.num_entities)
    n_buckets = allgather_host(np.asarray([design.num_buckets], np.int64))
    if not (n_buckets == n_buckets[0]).all():
        raise ValueError(f"processes built different bucket counts {n_buckets.tolist()} — "
                         "pin num_buckets in the coordinate spec")
    buckets, index = [], []
    for bucket, eidx in zip(design.buckets, design.entity_index):
        shapes = allgather_host(np.asarray([[bucket.num_entities, bucket.rows_per_entity]],
                                           np.int64))
        e_max, r_max = int(shapes[:, 0].max()), int(shapes[:, 1].max())
        pe, pr = e_max - bucket.num_entities, r_max - bucket.rows_per_entity

        def pad2(t, fill=0.0):
            return torch.nn.functional.pad(t, (0, pr, 0, pe), value=fill)

        buckets.append(RandomEffectDesign(
            features=torch.nn.functional.pad(bucket.features, (0, 0, 0, pr, 0, pe)),
            labels=pad2(bucket.labels), weights=pad2(bucket.weights), mask=pad2(bucket.mask),
            row_index=pad2(bucket.row_index, fill=-1)))
        ei = np.asarray(eidx, np.int64)
        ei_g = np.where(ei < design.num_entities, ei + entity_base, num_entities_global)
        ei_g = np.pad(ei_g, (0, e_max - ei_g.shape[0]), constant_values=num_entities_global)
        index.append(ei_g.astype(np.int32))
    return BucketedRandomEffectDesign(buckets=buckets, entity_index=index,
                                      num_entities=num_entities_global)


def make_global_batch(local_batch, mesh):
    """This rank's process-local batch as its 'data' shard of the global
    batch (the JAX package's ``make_array_from_process_local_data``): the
    rows stay where they are, and every rank must hold the same number of
    rows and, for ELL, the same width (checked across the world)."""
    from photon_ml_tpu_torch.ops.sparse import is_sparse

    x = local_batch.features
    shape = [local_batch.labels.shape[0], x.nnz_per_row if is_sparse(x) else x.shape[-1]]
    shapes = allgather_host(np.asarray([shape], np.int64))
    if not (shapes == shapes[0]).all():
        raise ValueError(
            f"ranks hold batches of other shapes {shapes.tolist()}: every rank "
            "needs the same row count and width (pin nnz_per_row)"
        )
    if mesh.axis_size(DATA_AXIS) != mesh.size:
        raise ValueError("make_global_batch row-shards over a 'data' mesh")
    return local_batch


def hierarchical_psum(x, intra_axis: str = "device", inter_axis: str = "host", mesh=None):
    """Two-level sum over a ('host', 'device') mesh of a tensor or a tuple
    of them: a reduce-scatter over the fast intra-host axis, an all-reduce
    of each rank's 1/D slice over the slow inter-host axis (the only
    cross-host traffic), then an all-gather over the intra axis. Leaves
    flatten and pad to a multiple of the intra size."""
    import torch

    from photon_ml_tpu_torch.parallel.mesh import active_mesh, all_gather, all_reduce, reduce_scatter

    mesh = mesh if mesh is not None else active_mesh()
    n_intra = 1 if mesh is None else mesh.axis_size(intra_axis)

    def reduce_leaf(leaf):
        flat = leaf.reshape(-1)
        size = flat.shape[0]
        pad = (-size) % n_intra
        if pad:
            flat = torch.cat([flat, flat.new_zeros((pad,))])
        scat = reduce_scatter(flat, intra_axis, "hierarchical.scatter", mesh=mesh)
        part = all_reduce(scat, inter_axis, "hierarchical.inter", mesh=mesh)
        full = all_gather(part, intra_axis, "hierarchical.gather", mesh=mesh).reshape(-1)
        return full[:size].reshape(leaf.shape)

    if isinstance(x, (tuple, list)):
        return type(x)(reduce_leaf(t) for t in x)
    return reduce_leaf(x)
