"""Meshes over a ``torch.distributed`` world, the active mesh, and the
collectives every sharded solve reduces through (counterpart of
``photon_ml_tpu/parallel/mesh.py``).

A JAX mesh of P devices is a world of P ranks here, one rank per device.
A :class:`Mesh` names the world's ranks along axes (``("data",)``,
``("data", "feature")`` or ``("host", "device")``) through a
``torch.distributed.device_mesh.DeviceMesh`` and its per-axis process
groups; the product of its axes is the world size. A world of one with no
process group is a mesh with no groups, whose reductions are the identity.

Axis conventions (as in the JAX package):
  'data'    — batch rows of the fixed-effect problem;
  'entity'  — random-effect entities and, in entity-sharded GAME, the
              entity-partitioned batch rows too;
  'feature' — coefficient columns (the huge-d regime);
  'host' / 'device' — the slow and fast axes of a hierarchical reduction.

:func:`set_mesh` installs the active mesh, which decides every reduction
of a solve: the objective's row sums over the axis that holds the rows
('data', else 'entity': :func:`row_axis`), the margins over 'feature', and the solvers' inner products of sharded vectors
(:func:`feature_sum`). Every collective goes through :func:`all_reduce`
(or its gather and scatter siblings), which counts it by label, so a run
can report its collectives and their bytes per objective pass, and feeds
the collective profiler (``obs.collectives``): ``collective.<label>.w<W>``
count and bytes always, and the blocked wall time where the call blocks
until the exchange is done (gloo; NCCL only under a tracer, after a
device sync — an NCCL enqueue is never timed as the exchange).
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import threading
import time
from typing import Dict, Optional, Tuple

import torch

DATA_AXIS = "data"
ENTITY_AXIS = "entity"
FEATURE_AXIS = "feature"
HOST_AXIS = "host"
DEVICE_AXIS = "device"


def world() -> Tuple[int, int]:
    """(world size, rank) of the joined process group; (1, 0) unjoined."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def rank_device(device=None) -> torch.device:
    """The device of this rank: ``device`` when given, else
    ``cuda:{LOCAL_RANK}`` (0 without the variable). Raises when that card
    does not exist: ranks never share a card unless the caller says so."""
    if device is not None:
        dev = torch.device(device)
    else:
        local = int(os.environ.get("LOCAL_RANK", "0") or "0")
        dev = torch.device("cuda", local)
    if dev.type == "cuda":
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        index = 0 if dev.index is None else dev.index
        if index >= count:
            raise RuntimeError(
                f"rank device {dev}: this machine has {count} CUDA device(s); pass "
                "device= to place ranks explicitly (device='cpu' for the CPU)"
            )
    return dev


@dataclasses.dataclass(eq=False)
class Mesh:
    """Named axes over the world's ranks. ``groups[axis]`` is the process
    group of this rank's line along ``axis`` (None in a world of one
    without a process group); ``coordinate[axis]`` is this rank's index
    along it."""

    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]
    groups: Dict[str, object]
    coordinate: Dict[str, int]
    device_mesh: object = None

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        out = 1
        for s in self.sizes:
            out *= s
        return out

    def axis_size(self, axis: str) -> int:
        """Extent of ``axis`` (1 when the mesh has no such axis)."""
        return self.shape.get(axis, 1)

    def index(self, axis: str) -> int:
        return self.coordinate.get(axis, 0)

    def group(self, axis: str):
        return self.groups.get(axis)

    def flat_index(self) -> int:
        """This rank's position over all axes flattened (row-major)."""
        out = 0
        for name, size in zip(self.axis_names, self.sizes):
            out = out * size + self.coordinate[name]
        return out


def _make(names: Tuple[str, ...], sizes: Tuple[int, ...], what: str) -> Mesh:
    import torch.distributed as dist

    total = 1
    for s in sizes:
        total *= s
    n_world, rank = world()
    if total > n_world:
        raise ValueError(f"{what} needs {total} devices, have {n_world}")
    if total < n_world:
        raise ValueError(
            f"{what} covers {total} of the world's {n_world} ranks; a mesh is the "
            "whole world (one rank per device): start a world of its size"
        )
    if not (dist.is_available() and dist.is_initialized()):
        return Mesh(names, sizes, {n: None for n in names}, {n: 0 for n in names})
    from torch.distributed.device_mesh import DeviceMesh

    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    dm = DeviceMesh(device_type, torch.arange(total).reshape(sizes), mesh_dim_names=names)
    coords = dm.get_coordinate()
    return Mesh(
        names, sizes,
        {n: dm.get_group(n) for n in names},
        {n: int(c) for n, c in zip(names, coords)},
        device_mesh=dm,
    )


def make_mesh(n_data: Optional[int] = None) -> Mesh:
    """1-D 'data' mesh over the world (default: the whole world)."""
    n_world, _ = world()
    n = n_world if n_data is None else int(n_data)
    if n > n_world:
        raise ValueError(f"mesh of {n} 'data' devices requested, have {n_world}")
    return _make((DATA_AXIS,), (n,), f"mesh of {n} 'data' devices")


def make_entity_mesh(n_entity: Optional[int] = None) -> Mesh:
    """1-D 'entity' mesh over the world (default: the whole world) for
    entity-sharded GAME descent: random-effect tables, their bucket lanes
    and the entity-partitioned rows all shard over this one axis."""
    n_world, _ = world()
    n = n_world if n_entity is None else int(n_entity)
    if n > n_world:
        raise ValueError(f"mesh of {n} 'entity' devices requested, have {n_world}")
    return _make((ENTITY_AXIS,), (n,), f"mesh of {n} 'entity' devices")


def make_game_mesh(n_data: int, n_entity: int) -> Mesh:
    """2-D ('data', 'entity') mesh: fixed-effect solves shard rows over both
    axes flattened; random-effect bucket solves shard over 'entity'."""
    return _make((DATA_AXIS, ENTITY_AXIS), (int(n_data), int(n_entity)),
                 f"mesh {n_data}x{n_entity}")


def make_feature_mesh(n_data: int, n_feature: int) -> Mesh:
    """2-D ('data', 'feature') mesh: rows over 'data', coefficient columns
    over 'feature'."""
    return _make((DATA_AXIS, FEATURE_AXIS), (int(n_data), int(n_feature)),
                 f"mesh {n_data}x{n_feature}")


def make_host_device_mesh(n_host: int, n_device: int) -> Mesh:
    """2-D ('host', 'device') mesh for the hierarchical reduction: 'device'
    the fast intra-host axis, 'host' the slow one."""
    return _make((HOST_AXIS, DEVICE_AXIS), (int(n_host), int(n_device)),
                 f"mesh {n_host}x{n_device}")


def default_mesh() -> Mesh:
    return make_mesh()


# -- the active mesh ----------------------------------------------------------

_active: list = []
_active_lock = threading.Lock()


@contextlib.contextmanager
def set_mesh(mesh: Mesh):
    """Install ``mesh`` as the active mesh for the block (nestable)."""
    with _active_lock:
        _active.append(mesh)
    try:
        yield mesh
    finally:
        with _active_lock:
            _active.remove(mesh)


@contextlib.contextmanager
def whole_vectors():
    """No active mesh for the block: for work on vectors already gathered
    whole (the map of a solution back to raw feature space)."""
    with _active_lock:
        _active.append(None)
    try:
        yield
    finally:
        with _active_lock:
            _active.pop(len(_active) - 1 - _active[::-1].index(None))


def active_mesh() -> Optional[Mesh]:
    return _active[-1] if _active else None


def active_axis_size(axis: str) -> int:
    mesh = active_mesh()
    return 1 if mesh is None else mesh.axis_size(axis)


def feature_sharded() -> bool:
    """True when the active mesh splits the coefficient axis: then every
    coefficient-space vector of a solve is this rank's block of it."""
    return active_axis_size(FEATURE_AXIS) > 1


# -- counted collectives -------------------------------------------------------

_counts_lock = threading.Lock()
_counts: Dict[str, Dict[str, int]] = {}


def _count(label: str, t: torch.Tensor, width: int = 1) -> float:
    """Count one collective of payload ``t`` over an axis of ``width``
    ranks, here and in the collective profiler; returns the start time
    that :func:`_timed` reads."""
    from photon_ml_tpu_torch.obs.collectives import record_collective

    nbytes = t.numel() * t.element_size()
    with _counts_lock:
        c = _counts.setdefault(label, {"count": 0, "bytes": 0})
        c["count"] += 1
        c["bytes"] += nbytes
    record_collective(label, mesh_width=width, nbytes=nbytes)
    return time.perf_counter()


def _timed(label: str, width: int, group, t0: float, out: torch.Tensor) -> None:
    """Record the blocked wall time of a collective issued at ``t0`` where
    the call blocked until the exchange was done: a gloo group's, or an
    NCCL group's under a tracer, after a sync of ``out``'s device. An
    untraced NCCL collective records no time (its return is the
    enqueue)."""
    import torch.distributed as dist

    from photon_ml_tpu_torch.obs.collectives import record_collective
    from photon_ml_tpu_torch.obs.trace import get_tracer

    if dist.get_backend(group) != "gloo":
        if get_tracer() is None or out.device.type != "cuda":
            return
        torch.cuda.synchronize(out.device)
    record_collective(label, mesh_width=width, count=0, wall_s=time.perf_counter() - t0)


def collective_counts() -> Dict[str, Dict[str, int]]:
    """label -> {"count", "bytes"} of the collectives issued since the last
    reset (bytes: each payload's size on this rank)."""
    with _counts_lock:
        return {k: dict(v) for k, v in _counts.items()}


def reset_collective_counts() -> None:
    with _counts_lock:
        _counts.clear()


_OPS = {"sum": "SUM", "min": "MIN", "max": "MAX"}


def _group(mesh: Optional[Mesh], axis: str):
    """The process group a collective over ``axis`` runs on, or None when
    it is the identity: no mesh, no such axis, no process group, or an
    axis of size 1 beside others (a mesh of one axis keeps its group of
    one, so that a world of one still runs its collectives)."""
    if mesh is None or axis not in mesh.axis_names:
        return None
    if len(mesh.axis_names) > 1 and mesh.axis_size(axis) == 1:
        return None
    return mesh.group(axis)


def all_reduce(t: torch.Tensor, axis: str, label: str, op: str = "sum",
               mesh: Optional[Mesh] = None, async_op: bool = False):
    """``t`` reduced over the active mesh's ``axis`` (in place on a copy of
    ``t``; ``t`` itself when the collective is the identity, ``_group``).
    With ``async_op`` returns (tensor, work handle or None): read the tensor
    only after ``work.wait()``."""
    import torch.distributed as dist

    mesh = mesh if mesh is not None else active_mesh()
    group = _group(mesh, axis)
    if group is None:
        return (t, None) if async_op else t
    out = t.clone()
    width = mesh.axis_size(axis)
    t0 = _count(label, out, width)
    work = dist.all_reduce(out, op=getattr(dist.ReduceOp, _OPS[op]), group=group,
                           async_op=async_op)
    if not async_op:
        _timed(label, width, group, t0, out)
    return (out, work) if async_op else out


def all_gather(t: torch.Tensor, axis: str, label: str,
               mesh: Optional[Mesh] = None) -> torch.Tensor:
    """The (size, *t.shape) stack of every rank's ``t`` along ``axis``, in
    axis order (``t[None]`` without a group)."""
    import torch.distributed as dist

    mesh = mesh if mesh is not None else active_mesh()
    group = _group(mesh, axis)
    if group is None:
        return t[None]
    t = t.contiguous()
    size = mesh.axis_size(axis)
    out = t.new_empty((size * t.numel(),))
    t0 = _count(label, t, size)
    gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
    gather(out, t.reshape(-1), group=group)
    _timed(label, size, group, t0, out)
    return out.reshape((size,) + tuple(t.shape))


def reduce_scatter(flat: torch.Tensor, axis: str, label: str,
                   mesh: Optional[Mesh] = None) -> torch.Tensor:
    """This rank's 1/size slice of the sum over ``axis`` of a flat tensor
    whose length divides by the axis size."""
    import torch.distributed as dist

    mesh = mesh if mesh is not None else active_mesh()
    group = _group(mesh, axis)
    if group is None:
        return flat
    size = mesh.axis_size(axis)
    out = flat.new_empty((flat.numel() // size,))
    t0 = _count(label, flat, size)
    scatter = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor
    scatter(out, flat.contiguous(), group=group)
    _timed(label, size, group, t0, out)
    return out


def feature_sum(partial: torch.Tensor, label: str = "dot") -> torch.Tensor:
    """A coefficient-space reduction (an inner product, a norm's square, an
    L1 sum) from this rank's partial: the partial itself unless the active
    mesh splits the coefficient axis, then its sum over 'feature'."""
    if not feature_sharded():
        return partial
    return all_reduce(partial, FEATURE_AXIS, label)


def row_axis(mesh: Optional[Mesh] = None) -> Optional[str]:
    """The axis of the active mesh (or of ``mesh``) that holds the batch
    rows: 'data' where the mesh has it, else 'entity' (the entity-sharded
    GAME layout, where each rank holds its entities' rows), else None."""
    mesh = mesh if mesh is not None else active_mesh()
    if mesh is None:
        return None
    for axis in (DATA_AXIS, ENTITY_AXIS):
        if axis in mesh.axis_names:
            return axis
    return None


def data_sum(t: torch.Tensor, label: str, op: str = "sum") -> torch.Tensor:
    """``t`` reduced over the active mesh's rows' axis (:func:`row_axis`;
    ``t`` itself with no mesh or a mesh without one)."""
    axis = row_axis()
    return t if axis is None else all_reduce(t, axis, label, op=op)


# -- placement -----------------------------------------------------------------


def split_rows(total_rows: int, num_processes: int, process_id: int) -> range:
    """Contiguous even split of a global row space: the ranges over all
    process ids are disjoint and cover [0, total_rows)."""
    per = -(-total_rows // num_processes)
    return range(
        min(process_id * per, total_rows),
        min((process_id + 1) * per, total_rows),
    )


def _pad_design(x, n_to: int):
    from photon_ml_tpu_torch.ops import sparse as sparse_ops

    pad = n_to - x.shape[0]
    if pad == 0:
        return x
    if sparse_ops.is_structured(x):
        return sparse_ops.pad_rows(x, pad)
    return torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])


def _rows_of(x, lo: int, hi: int, device: torch.device):
    """Rows [lo, hi) of a design, placed on ``device`` (contiguous)."""
    from photon_ml_tpu_torch.ops import sparse as sparse_ops

    if sparse_ops.is_hybrid(x):
        raise ValueError(
            "hybrid designs are single-device: their bucketed cold segments "
            "have unequal row counts, which the row-sharded mesh path does "
            "not partition"
        )
    if sparse_ops.is_feature_sharded(x):
        return sparse_ops.feature_sharded_to(sparse_ops.feature_sharded_rows(x, lo, hi), device)
    if sparse_ops.is_sparse(x):
        return sparse_ops.SparseFeatures(indices=x.indices[lo:hi].to(device).contiguous(),
                                         values=x.values[lo:hi].to(device).contiguous(), d=x.d)
    return x[lo:hi].to(device).contiguous()


def shard_design(design, mesh: Mesh, device=None):
    """This rank's contiguous rows of a design over all of ``mesh``'s axes
    flattened, padded first to a multiple of the mesh size with all-padding
    rows, on ``device`` (default: the design's)."""
    n = design.shape[0]
    per = -(-n // mesh.size)
    lo = mesh.flat_index() * per
    dev = _device_of(design) if device is None else torch.device(device)
    return _rows_of(_pad_design(design, per * mesh.size), lo, lo + per, dev)


def shard_batch(batch, mesh: Mesh, device=None):
    """This rank's row shard of ``batch`` over all of ``mesh``'s axes
    flattened (the JAX package's ``batch_sharding``): its contiguous rows,
    padded first to a multiple of the mesh size with masked rows, as
    ``LabeledBatch.pad_to`` pads, on ``device`` (default: the batch's)."""
    return shard_rows(batch, mesh.size, mesh.flat_index(), device)


def shard_rows(batch, n_shards: int, index: int, device=None):
    """Shard ``index`` of ``n_shards`` contiguous row shards of ``batch``."""
    from photon_ml_tpu_torch.core.types import LabeledBatch

    per = -(-batch.batch_size // n_shards)
    padded = LabeledBatch.pad_to(batch, per * n_shards)
    lo, hi = index * per, (index + 1) * per
    dev = padded.labels.device if device is None else torch.device(device)

    def col(t):
        return t[lo:hi].to(dev).contiguous()

    return LabeledBatch(
        features=_rows_of(padded.features, lo, hi, dev),
        labels=col(padded.labels),
        offsets=col(padded.offsets),
        weights=col(padded.weights),
        mask=col(padded.mask),
    )


def entity_block(x, mesh: Mesh, device=None):
    """This rank's block of an entity-major array (the counterpart of the
    JAX package's ``entity_sharding`` placement): its contiguous
    ``len / size`` leading rows along 'entity' (all axes flattened), on
    ``device`` (default: the array's). The leading extent must divide by
    the mesh size (a shard-major layout padded per shard)."""
    n = x.shape[0]
    if n % mesh.size:
        raise ValueError(f"{n} entity rows do not shard over {mesh.size} 'entity' devices; "
                         "pad the layout per shard")
    per = n // mesh.size
    lo = mesh.flat_index() * per
    t = x if torch.is_tensor(x) else torch.as_tensor(x)
    dev = t.device if device is None else torch.device(device)
    return t[lo:lo + per].to(dev).contiguous()


def shard_bucketed_design(design, mesh: Mesh, device=None):
    """This rank's lanes of every bucket of a BucketedRandomEffectDesign
    whose lane counts divide by the mesh size (built with
    ``entity_multiple`` = the mesh size), with their lane -> table row
    indices; the table itself stays wherever the caller keeps it."""
    import dataclasses as _dc

    from photon_ml_tpu_torch.game.data import RandomEffectDesign

    buckets = [RandomEffectDesign(*(entity_block(getattr(b, f.name), mesh, device)
                                    for f in _dc.fields(b)))
               for b in design.buckets]
    index = [entity_block(torch.as_tensor(ei), mesh).numpy() for ei in design.entity_index]
    return _dc.replace(design, buckets=buckets, entity_index=index)


def _device_of(x) -> torch.device:
    from photon_ml_tpu_torch.ops import sparse as sparse_ops

    if sparse_ops.is_sparse(x):
        return x.indices.device
    if sparse_ops.is_feature_sharded(x):
        return x.blocks[0].indices.device
    if sparse_ops.is_hybrid(x):
        return x.dense.device
    return x.device
