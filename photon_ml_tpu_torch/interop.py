"""Carry data across from the JAX package as numpy arrays.

The inputs are numpy arrays taken from ``photon_ml_tpu``'s
``Coefficients``, ``SparseFeatures``, ``HybridFeatures``, ``LabeledBatch``,
``NormalizationContext`` and ``SolverConfig`` (``np.asarray`` of their
fields); this module never imports that package. bfloat16 arrays
(numpy's ``ml_dtypes`` bfloat16) are converted exactly through float32.
``game_model_from_numpy`` / ``game_model_to_numpy`` carry a GAME model's
parameters both ways, a table or ``FactoredParams`` per coordinate;
``random_projection_from_numpy`` and ``index_map_from_numpy`` take a
``RandomProjection``'s matrix and an ``IndexMapProjection``'s columns, and
``checkpoint_from_numpy`` a ``TrainingCheckpoint``'s fields;
``hybrid_from_numpy`` / ``hybrid_to_numpy`` carry a ``HybridFeatures``
(slab, hot ids, cold segments, row permutation) both ways. The other
bridge is the Avro model files and the checkpoint directories, which
both packages read and write (``io.models``). ``lab_tiles_from_numpy``
takes the column-sorted tiles of ``benchmarks/sparse_kernel_lab.py``,
which that script builds in numpy.
"""

from __future__ import annotations

import numpy as np
import torch

from photon_ml_tpu_torch.core.normalization import NormalizationContext
from photon_ml_tpu_torch.core.types import Coefficients, LabeledBatch
from photon_ml_tpu_torch.game.descent import GameModel
from photon_ml_tpu_torch.game.factored import FactoredParams
from photon_ml_tpu_torch.game.projectors import IndexMapProjection, RandomProjection
from photon_ml_tpu_torch.game.scoring import CompactReTable
from photon_ml_tpu_torch.io.checkpoint import TrainingCheckpoint
from photon_ml_tpu_torch.kernels.lab import LAB_BLOCK, LAB_TILE, ColumnTiles, tile_chains
from photon_ml_tpu_torch.ops.sparse import HybridFeatures, SparseFeatures
from photon_ml_tpu_torch.solvers.common import SolverConfig
from photon_ml_tpu_torch.utils.device import to_numpy


def tensor_from_numpy(a, device="cpu") -> torch.Tensor:
    """numpy -> tensor on ``device`` in the same dtype (bfloat16 kept),
    copied: arrays taken from JAX are read-only views."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(device, torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(device)


def coefficients_from_numpy(means, variances=None, device="cpu") -> Coefficients:
    return Coefficients(
        means=tensor_from_numpy(means, device),
        variances=None if variances is None else tensor_from_numpy(variances, device),
    )


def sparse_from_numpy(indices, values, d: int, device="cpu") -> SparseFeatures:
    return SparseFeatures(
        indices=tensor_from_numpy(np.asarray(indices, np.int32), device),
        values=tensor_from_numpy(values, device),
        d=int(d),
    )


def hybrid_from_numpy(dense, hot_ids, cold_segments, row_perm, device="cpu") -> HybridFeatures:
    """A JAX ``HybridFeatures`` from its fields: the (n, H) slab, the (H,)
    hot ids, the cold segments (each with numpy ``indices`` and ``values``
    and its ``d``) and the (n,) row permutation; ids and the permutation
    become int32."""
    segs = tuple(sparse_from_numpy(s.indices, s.values, s.d, device=device)
                 for s in cold_segments)
    return HybridFeatures(
        dense=tensor_from_numpy(dense, device),
        hot_ids=tensor_from_numpy(np.asarray(hot_ids, np.int32), device),
        cold_segments=segs,
        row_perm=tensor_from_numpy(np.asarray(row_perm, np.int32), device),
    )


def hybrid_to_numpy(hf: HybridFeatures) -> dict:
    """The port's ``HybridFeatures`` as ``{"dense", "hot_ids",
    "cold_segments": [(indices, values, d), ...], "row_perm"}`` of numpy
    arrays (bfloat16 values widened to float64), for the JAX package's
    ``HybridFeatures`` and ``SparseFeatures``."""
    return {
        "dense": to_numpy(hf.dense),
        "hot_ids": to_numpy(hf.hot_ids),
        "cold_segments": [(to_numpy(s.indices), to_numpy(s.values), s.d)
                          for s in hf.cold_segments],
        "row_perm": to_numpy(hf.row_perm),
    }


def labeled_batch_from_numpy(
    features, labels, offsets, weights, mask, device="cpu"
) -> LabeledBatch:
    """``features`` is a dense numpy matrix or a port ``SparseFeatures`` or
    ``HybridFeatures`` (from :func:`sparse_from_numpy` /
    :func:`hybrid_from_numpy`); the columns keep their dtypes."""
    if not isinstance(features, (SparseFeatures, HybridFeatures)):
        features = tensor_from_numpy(features, device)
    return LabeledBatch(
        features=features,
        labels=tensor_from_numpy(labels, device),
        offsets=tensor_from_numpy(offsets, device),
        weights=tensor_from_numpy(weights, device),
        mask=tensor_from_numpy(mask, device),
    )


def game_params_from_numpy(params, device="cpu") -> dict:
    """A GAME model's coordinate parameters, ``{name: value}``, for the
    port's ``score_game_data``. Each value is one of the JAX package's
    forms with numpy fields: a (d,) fixed-effect vector, an (E, d)
    random-effect table, a ``CompactReTable`` (``columns``, ``values``;
    columns become int32) or a ``FactoredParams`` (``gamma``,
    ``projection``). Told apart by their fields, since this module never
    imports that package."""
    out = {}
    for name, p in params.items():
        if hasattr(p, "gamma") and hasattr(p, "projection"):
            out[name] = FactoredParams(
                gamma=tensor_from_numpy(p.gamma, device),
                projection=tensor_from_numpy(p.projection, device),
            )
        elif hasattr(p, "columns") and hasattr(p, "values"):
            out[name] = CompactReTable(
                columns=tensor_from_numpy(np.asarray(p.columns, np.int32), device),
                values=tensor_from_numpy(p.values, device),
            )
        else:
            out[name] = tensor_from_numpy(p, device)
    return out


def _params_from_numpy(p, device):
    if hasattr(p, "gamma") and hasattr(p, "projection"):
        return FactoredParams(gamma=tensor_from_numpy(p.gamma, device),
                              projection=tensor_from_numpy(p.projection, device))
    return tensor_from_numpy(p, device)


def game_model_from_numpy(params, device="cpu") -> GameModel:
    """A JAX ``GameModel``'s params, ``{name: value}`` ((d,) fixed effects,
    (E, d) random-effect tables as numpy, or a ``FactoredParams`` with
    numpy fields), as the port's ``GameModel`` on ``device``: the warm
    start both packages can begin from."""
    return GameModel(params={n: _params_from_numpy(p, device) for n, p in params.items()})


def game_model_to_numpy(model: GameModel) -> dict:
    """The port's ``GameModel`` as ``{name: numpy array}`` (a factored
    coordinate as ``{"gamma": ..., "projection": ...}``), for the JAX
    package's ``GameModel(params=...)`` (its ``FactoredParams(**value)``)."""
    return {
        n: ({"gamma": to_numpy(p.gamma), "projection": to_numpy(p.projection)}
            if isinstance(p, FactoredParams) else to_numpy(p))
        for n, p in model.params.items()
    }


def random_projection_from_numpy(matrix, device="cpu") -> RandomProjection:
    """A JAX ``RandomProjection`` from its (d, k) matrix."""
    return RandomProjection(matrix=tensor_from_numpy(matrix, device))


def index_map_from_numpy(columns, device="cpu") -> IndexMapProjection:
    """A JAX ``IndexMapProjection`` from its (E, k) columns (-1 padded)."""
    return IndexMapProjection(columns=tensor_from_numpy(np.asarray(columns, np.int64), device))


def checkpoint_from_numpy(step, params, history, frozen=(), rng_key=None) -> TrainingCheckpoint:
    """A JAX ``TrainingCheckpoint``'s fields (its params a table or a
    ``FactoredParams`` of numpy per coordinate) as the port's, with no
    generator state: the run it resumes draws from its seed."""
    return TrainingCheckpoint(
        step=int(step),
        params={n: (FactoredParams(gamma=np.asarray(p.gamma), projection=np.asarray(p.projection))
                    if hasattr(p, "gamma") else np.asarray(p))
                for n, p in params.items()},
        rng_key=np.asarray([] if rng_key is None else rng_key, np.uint32),
        history=[dict(h) for h in history],
        frozen=list(frozen),
    )


def normalization_from_numpy(factors=None, shifts=None, device="cpu") -> NormalizationContext:
    """A ``NormalizationContext`` from its (d,) factors and shifts (either
    may be None)."""
    return NormalizationContext(
        factors=None if factors is None else tensor_from_numpy(factors, device),
        shifts=None if shifts is None else tensor_from_numpy(shifts, device),
    )


def solver_config_from_numpy(
    lower_bounds=None, upper_bounds=None, device="cpu", **knobs
) -> SolverConfig:
    """A ``SolverConfig`` with numpy box constraints; ``knobs`` are its
    scalar fields (max_iters, tolerance, ...), as in the JAX package's."""
    return SolverConfig(
        lower_bounds=None if lower_bounds is None else tensor_from_numpy(lower_bounds, device),
        upper_bounds=None if upper_bounds is None else tensor_from_numpy(upper_bounds, device),
        **knobs,
    )


def bounds_from_numpy(lower=None, upper=None):
    """(lower, upper) box constraints from numpy (d,) arrays (either may be
    None; +-inf where a side is open) as float64 CPU tensors, the form
    ``GLMTrainingConfig.lower_bounds`` / ``upper_bounds`` keep."""
    return tuple(
        None if b is None else torch.from_numpy(np.array(b, dtype=np.float64))
        for b in (lower, upper)
    )


def lab_tiles_from_numpy(psc, psr, psv, tile_block, first_of_block, w_blk, device="cpu"):
    """(ColumnTiles, w_pad) from the sparse kernel lab's layout: ``psc``,
    ``psr``, ``psv`` (ntiles, 8, 128) local columns, rows and values,
    ``tile_block`` and ``first_of_block`` (ntiles,), ``w_blk`` (nblocks * 8,
    64) the padded weights. The port's tiles are flat (ntiles, LAB_TILE)
    and its ``w_pad`` (nblocks * LAB_BLOCK,); the width ``d`` of the tiles
    is the padded one, ``nblocks * LAB_BLOCK``, since the lab's arrays do
    not carry ``d``. Raises unless the arrays have those shapes, each
    tile's columns lie in [0, LAB_BLOCK] and are sorted within each block,
    and the tiles' blocks do not decrease."""
    psc, psr, psv = (np.asarray(a) for a in (psc, psr, psv))
    tile_block = np.asarray(tile_block, np.int32)
    w_blk = np.asarray(w_blk)
    ntiles = psc.shape[0]
    tile_shape = (8, LAB_TILE // 8)
    if (any(a.shape != (ntiles, *tile_shape) for a in (psc, psr, psv))
            or w_blk.ndim != 2 or w_blk.shape[0] % 8 or w_blk.shape[1] != LAB_BLOCK // 8
            or tile_block.shape != (ntiles,)):
        raise ValueError(f"lab_tiles_from_numpy: tiles must be (ntiles, {tile_shape[0]}, "
                         f"{tile_shape[1]}), w_blk (nblocks * 8, {LAB_BLOCK // 8}); got "
                         f"{psc.shape}, {psr.shape}, {psv.shape}, {w_blk.shape}")
    nblocks = w_blk.shape[0] // 8
    cols = psc.reshape(ntiles, LAB_TILE).astype(np.int32)
    if cols.size and (cols.min() < 0 or cols.max() > LAB_BLOCK):
        raise ValueError(f"lab_tiles_from_numpy: columns outside [0, {LAB_BLOCK}]")
    if ntiles and (np.any(np.diff(tile_block) < 0) or tile_block[0] < 0
                   or tile_block[-1] >= nblocks):
        raise ValueError("lab_tiles_from_numpy: tile_block must not decrease and must lie "
                         f"in [0, {nblocks})")
    same_block = np.repeat(tile_block, LAB_TILE)
    flat = cols.reshape(-1)
    if np.any((np.diff(flat) < 0) & (same_block[1:] == same_block[:-1])):
        raise ValueError("lab_tiles_from_numpy: columns must be sorted within each block")
    cols_t = tensor_from_numpy(cols, device)
    tb = tensor_from_numpy(tile_block, device)
    tiles = ColumnTiles(
        cols=cols_t,
        rows=tensor_from_numpy(psr.reshape(ntiles, LAB_TILE).astype(np.int32), device),
        vals=tensor_from_numpy(psv.reshape(ntiles, LAB_TILE), device),
        tile_block=tb,
        first_of_block=tensor_from_numpy(np.asarray(first_of_block, np.int32), device),
        chains=tile_chains(cols_t, tb), d=nblocks * LAB_BLOCK, nblocks=nblocks,
    )
    return tiles, tensor_from_numpy(w_blk.reshape(-1), device)
