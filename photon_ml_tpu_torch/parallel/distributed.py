"""Mesh-sharded GLM training (counterpart of
``photon_ml_tpu/parallel/distributed.py``).

Every rank of the world calls the same entry point with the same batch
(every rank ingests the input, as the one JAX process does) and keeps its
shard on its device; every rank returns the same models. The GLM driver
places the shards itself (:func:`place_rows`, :func:`place_feature_shard`)
from a batch on the host, computes the feature summary and the
fingerprint's margins from them (:func:`placed_summary`,
:func:`placed_margins`) and solves on them (:func:`train_placed`).

- :func:`distributed_train_glm`: the rows over 'data'. Each rank runs the
  objective passes on its rows (on an ELL design the fused passes:
  ``fused_vgc``, ``fused_hvp``, ``fused_hdiag``) and all-reduces the value
  with the gradient, the Hessian-vector product and the diagonal over the
  'data' group; ``w`` and the solver state are replicated.
- :func:`feature_sharded_train_glm`: the rows over 'data' and the columns
  over 'feature'. Each rank holds one column block of the design, of ``w``
  and of every solver vector; the margins are a block sum over the
  'feature' group (the blocks of an ELL design run ``ell_matvec`` and the
  column-sorted reduce), every inner product a partial plus one
  all-reduce, and the models are mapped back to the original column order.
- :func:`shard_map_value_and_grad` and :func:`hierarchical_value_and_grad`:
  the explicit-collective value and gradient over a rank's shard, flat
  over 'data' or reduce-scatter / all-reduce / all-gather over
  ('device', 'host').
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from photon_ml_tpu_torch.core.types import Coefficients, LabeledBatch
from photon_ml_tpu_torch.models.training import (
    GLMTrainingConfig,
    TrainedModel,
    solve_dtype,
    train_glm,
)
from photon_ml_tpu_torch.ops import sparse as sparse_ops
from photon_ml_tpu_torch.ops.objective import GLMObjective
from photon_ml_tpu_torch.ops.stats import BasicStatisticalSummary, summarize_features
from photon_ml_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    DEVICE_AXIS,
    FEATURE_AXIS,
    HOST_AXIS,
    Mesh,
    all_gather,
    feature_sum,
    set_mesh,
    shard_batch,
    shard_rows,
)
from photon_ml_tpu_torch.parallel.multihost import hierarchical_psum
from photon_ml_tpu_torch.parallel.overlap import collective_mode


@dataclasses.dataclass(frozen=True)
class Placement:
    """This rank's shard of a batch under ``mesh``: ``local`` holds its
    rows (and with a 'feature' axis its column block) on its device.
    ``col_map`` (a mesh with a 'feature' axis) maps each original column to
    its position in the blocked coefficient space of ``d_shard`` columns a
    block; ``rows`` is the whole batch's row count."""

    mesh: Mesh
    local: LabeledBatch
    rows: int
    col_map: Optional[np.ndarray] = None
    d_shard: int = 0

    @property
    def block_range(self):
        """[lo, hi) of this rank's block in the blocked coefficient space."""
        lo = self.mesh.index(FEATURE_AXIS) * self.d_shard
        return lo, lo + self.d_shard

    def to_blocked(self, v: torch.Tensor, fill: float = 0.0) -> torch.Tensor:
        """This rank's block of a raw (d,) coefficient-space vector."""
        full = v.new_full((self.mesh.axis_size(FEATURE_AXIS) * self.d_shard,), fill)
        full[torch.as_tensor(self.col_map, device=v.device)] = v
        lo, hi = self.block_range
        return full[lo:hi].contiguous()


def place_rows(batch: LabeledBatch, mesh: Mesh, device=None) -> Placement:
    """This rank's rows of ``batch`` (its shard over all of ``mesh``'s axes
    flattened, padded with masked rows to a multiple of the mesh size),
    placed on ``device`` (default: the batch's)."""
    return Placement(mesh, shard_batch(batch, mesh, device), batch.batch_size)


def place_feature_shard(batch: LabeledBatch, mesh: Mesh, device=None) -> Placement:
    """This rank's rows ('data' shard) of its column block ('feature'
    block) of ``batch``, on ``device`` (default: the batch's). A dense
    design pads its columns to a multiple of the 'feature' extent and
    splits them contiguously; an ELL design is blocked by column on the
    host (``ops.sparse.shard_columns``, round-robin), row-balanced when
    ``collective_mode()`` is ``overlap`` and 'data' is 1. Hybrid and
    already-blocked designs are refused in the JAX package's words."""
    if sparse_ops.is_hybrid(batch.features):
        raise ValueError(
            "feature sharding takes dense or ELL (SparseFeatures) designs; "
            "hybrid containers are a single-chip layout — pass the ELL"
        )
    if sparse_ops.is_feature_sharded(batch.features):
        raise ValueError(
            "feature sharding takes dense or ELL (SparseFeatures) designs; "
            "the batch is already column-blocked — pass the pre-blocking ELL "
            "(blocking is internal to feature_sharded_train_glm)"
        )
    n_data = mesh.axis_size(DATA_AXIS)
    n_feat = mesh.axis_size(FEATURE_AXIS)
    f = mesh.index(FEATURE_AXIS)
    d = batch.features.shape[-1]
    dev = batch.labels.device if device is None else torch.device(device)
    x = batch.features
    if sparse_ops.is_sparse(x):
        balance = collective_mode() == "overlap" and n_data == 1 and n_feat > 1
        # blocked on the host; this rank keeps its block alone
        blocked = sparse_ops.shard_columns(
            sparse_ops.cast_values(x, x.values.dtype, "cpu"), n_feat, balance_rows=balance)
        col_map = sparse_ops.blocked_column_map(d, n_feat)
        d_shard = blocked.d_shard
        features = sparse_ops.feature_sharded_block(blocked, f)
    else:
        d_shard = -(-d // n_feat)
        col_map = np.arange(d, dtype=np.int64)
        x = torch.cat([x, x.new_zeros((x.shape[0], n_feat * d_shard - d))], dim=1)
        features = x[:, f * d_shard:(f + 1) * d_shard]
    local = shard_rows(dataclasses.replace(batch, features=features), n_data,
                       mesh.index(DATA_AXIS), dev)
    return Placement(mesh, local, batch.batch_size, col_map, d_shard)


def train_placed(placed: Placement, config: GLMTrainingConfig,
                 initial_coefficients: Optional[Coefficients] = None,
                 **kwargs) -> Sequence[TrainedModel]:
    """``train_glm`` on a placed shard with its mesh active. On a column
    block, normalization, box constraints and the intercept are laid out
    in the blocked space (columns added by the blocking solve to 0), and
    every returned model is in the original column order, the same on
    every rank."""
    if placed.col_map is None:
        with set_mesh(placed.mesh):
            return train_glm(placed.local, config,
                             initial_coefficients=initial_coefficients, **kwargs)
    col_map, d_block = placed.col_map, placed.mesh.axis_size(FEATURE_AXIS) * placed.d_shard
    lo, hi = placed.block_range

    def local_bound(v, fill):
        full = _block_vector(v, col_map, d_block, fill)
        return None if full is None else full[lo:hi]

    blocked_config = dataclasses.replace(
        config,
        intercept_index=(None if config.intercept_index is None
                         else int(col_map[config.intercept_index])),
        lower_bounds=local_bound(config.lower_bounds, -np.inf),
        upper_bounds=local_bound(config.upper_bounds, np.inf),
    )
    init = None
    if initial_coefficients is not None:
        dev = placed.local.labels.device
        dtype = solve_dtype(placed.local)
        w0 = torch.zeros((d_block,), dtype=dtype, device=dev)
        w0[torch.as_tensor(col_map, device=dev)] = initial_coefficients.means.to(dev, dtype)
        init = Coefficients(means=w0)
    with set_mesh(placed.mesh):
        models = train_glm(placed.local, blocked_config, initial_coefficients=init, **kwargs)
    # every returned model back in the original column order
    unblock = torch.as_tensor(col_map)
    out = []
    for tm in models:
        coef = tm.model.coefficients
        u = unblock.to(coef.means.device)
        coef = Coefficients(
            means=coef.means[u],
            variances=None if coef.variances is None else coef.variances[u],
        )
        out.append(dataclasses.replace(tm, model=tm.model.with_coefficients(coef)))
    return out


def placed_summary(placed: Placement) -> BasicStatisticalSummary:
    """The whole batch's feature summary from the placed shards: each rank
    sums its rows, reduced over 'data' (``ops.stats``); on column blocks
    each statistic is then gathered over 'feature' and taken back to the
    original column order. The same on every rank."""
    with set_mesh(placed.mesh):
        summary = summarize_features(placed.local)
        if placed.col_map is None:
            return summary
        cols = torch.as_tensor(placed.col_map, device=summary.mean.device)
        return dataclasses.replace(summary, **{
            f.name: all_gather(getattr(summary, f.name), FEATURE_AXIS, "gather").reshape(-1)[cols]
            for f in dataclasses.fields(summary) if f.name != "count"})


def placed_margins(placed: Placement, means: torch.Tensor) -> torch.Tensor:
    """The (n,) margins x . w + offset of every row of the whole batch for
    raw coefficients ``means``, from the placed shards (each rank's rows,
    its block's partials summed over 'feature', gathered over 'data'); the
    same on every rank."""
    local = placed.local
    w = means.to(local.labels.device, solve_dtype(local))
    if placed.col_map is not None:
        w = placed.to_blocked(w)
    with set_mesh(placed.mesh):
        z = sparse_ops.matvec(local.features, w) + local.offsets
        return all_gather(z, DATA_AXIS, "gather").reshape(-1)[:placed.rows]


def distributed_train_glm(
    batch: LabeledBatch,
    config: GLMTrainingConfig,
    mesh: Mesh,
    device=None,
    **kwargs,
) -> Sequence[TrainedModel]:
    """``train_glm`` on this rank's rows of ``batch`` (its 'data' shard,
    padded with masked rows to a multiple of the mesh size), placed on
    ``device`` (default: the batch's), with ``mesh`` active."""
    return train_placed(place_rows(batch, mesh, device), config, **kwargs)


def _block_vector(v, col_map: np.ndarray, d_block: int, fill: float) -> Optional[np.ndarray]:
    if v is None:
        return None
    out = np.full((d_block,), fill, dtype=np.float64)
    out[col_map] = np.asarray(v.cpu() if torch.is_tensor(v) else v, dtype=np.float64)
    return out


def feature_sharded_train_glm(
    batch: LabeledBatch,
    config: GLMTrainingConfig,
    mesh: Mesh,
    initial_coefficients: Optional[Coefficients] = None,
    device=None,
    **kwargs,
) -> Sequence[TrainedModel]:
    """``train_glm`` with the design sharded over both ('data', 'feature')
    axes and the coefficients over 'feature': the huge-d regime where
    ``w`` no longer fits on one device. This rank keeps rows
    ``data``-shard of columns ``feature``-block, on ``device`` (default:
    the batch's) (:func:`place_feature_shard`, :func:`train_placed`)."""
    return train_placed(place_feature_shard(batch, mesh, device), config,
                        initial_coefficients=initial_coefficients, **kwargs)


def shard_map_value_and_grad(objective: GLMObjective, mesh: Mesh):
    """Explicit-collective value and gradient: f(w, shard) -> (value, grad)
    on this rank's rows, the partials summed over 'data' by one all-reduce
    with L2 added once after it; the outputs are the same on every rank."""
    obj = objective.with_axis(DATA_AXIS)

    def vg(w, batch: LabeledBatch):
        with set_mesh(mesh):
            return obj.value_and_grad(w, batch)

    return vg


def hierarchical_value_and_grad(objective: GLMObjective, mesh: Mesh):
    """Explicit-collective value and gradient over a ('host', 'device')
    mesh with the hierarchical reduction order
    (``multihost.hierarchical_psum``): this rank's pure data partials
    reduce-scatter over 'device', all-reduce over 'host', all-gather over
    'device'; L2 is added once, to the reduced value. Rows shard over both
    axes flattened (``mesh.shard_batch``)."""
    if HOST_AXIS not in mesh.axis_names or DEVICE_AXIS not in mesh.axis_names:
        raise ValueError(
            f"hierarchical_value_and_grad needs a ('{HOST_AXIS}', "
            f"'{DEVICE_AXIS}') mesh (make_host_device_mesh); got axes "
            f"{mesh.axis_names}"
        )
    obj0 = dataclasses.replace(objective, axis_name=None, l2_weight=0.0)

    def vg(w, batch: LabeledBatch):
        with set_mesh(mesh):
            val, grad = obj0.value_and_grad(w, batch)
            val, grad = hierarchical_psum((val.reshape(1), grad), intra_axis=DEVICE_AXIS,
                                          inter_axis=HOST_AXIS, mesh=mesh)
            val = val[0]
            if objective.l2_weight != 0.0:
                val = val + 0.5 * objective.l2_weight * feature_sum(torch.dot(w, w))
                grad = grad + objective.l2_weight * w
        return val, grad

    return vg
