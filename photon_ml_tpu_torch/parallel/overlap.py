"""The collective strategy of feature-sharded solves and its chunked
reduction schedule (counterpart of ``photon_ml_tpu/parallel/overlap.py``).

``PHOTON_COLLECTIVE_MODE`` selects the strategy (the drivers'
``collective_mode`` sets it):

- ``overlap`` (default): the row-balanced blocked layout, and the (n + P,)
  margins payload of an objective pass reduced in ``overlap_chunks()`` row
  chunks, each chunk's all-reduce issued (``async_op=True``) as soon as
  its partials are computed, while the next chunk's are; every work
  handle is waited on before its sum is read.
- ``fused``: the flat layout and one all-reduce of the whole payload, the
  equivalence oracle.

The schedule applies only under an active mesh whose 'feature' axis is
wider than 1; everywhere else both modes are the plain block sum.
"""

from __future__ import annotations

import os
from typing import Sequence, Tuple

import torch

from photon_ml_tpu_torch.parallel.mesh import FEATURE_AXIS, all_reduce, feature_sharded

__all__ = [
    "COLLECTIVE_MODE_ENV",
    "OVERLAP_CHUNKS_ENV",
    "COLLECTIVE_MODES",
    "collective_mode",
    "overlap_chunks",
    "feature_block_sum",
    "feature_margins",
]

COLLECTIVE_MODE_ENV = "PHOTON_COLLECTIVE_MODE"
OVERLAP_CHUNKS_ENV = "PHOTON_OVERLAP_CHUNKS"
COLLECTIVE_MODES = ("fused", "overlap")
_DEFAULT_CHUNKS = 4


def collective_mode() -> str:
    """The validated ``PHOTON_COLLECTIVE_MODE`` (default ``overlap``)."""
    mode = os.environ.get(COLLECTIVE_MODE_ENV, "overlap").strip().lower() or "overlap"
    if mode not in COLLECTIVE_MODES:
        raise ValueError(f"{COLLECTIVE_MODE_ENV}={mode!r}: expected one of {COLLECTIVE_MODES}")
    return mode


def overlap_chunks() -> int:
    """Row-axis chunk count of the overlap schedule (>= 1)."""
    try:
        c = int(os.environ.get(OVERLAP_CHUNKS_ENV, _DEFAULT_CHUNKS))
    except ValueError:
        return _DEFAULT_CHUNKS
    return max(1, c)


def _chunk_bounds(m: int, chunks: int) -> list:
    chunks = max(1, min(chunks, m))
    bounds = [round(j * m / chunks) for j in range(chunks + 1)]
    return [(lo, hi) for lo, hi in zip(bounds[:-1], bounds[1:]) if hi > lo]


def _chunked() -> bool:
    return collective_mode() == "overlap" and overlap_chunks() >= 2 and feature_sharded()


def reduce_chunks(parts, label: str) -> torch.Tensor:
    """Concatenate the 'feature'-group sums of the chunks ``parts`` yields:
    each chunk's all-reduce is issued as the chunk arrives (the next chunk
    is computed while it flies), and all are waited on at the end."""
    pending = [all_reduce(p, FEATURE_AXIS, label, async_op=True) for p in parts]
    out = []
    for t, work in pending:
        if work is not None:
            work.wait()
        out.append(t)
    return torch.cat(out) if len(out) > 1 else out[0]


def feature_block_sum(payload: torch.Tensor) -> torch.Tensor:
    """``sum(payload, axis=0)`` of an (F, m) block-partials payload — the
    feature-space reduction of an objective pass — added in block order,
    then summed over the 'feature' group under the configured strategy:
    one all-reduce (``fused``) or one per row chunk (``overlap``). With no
    mesh that splits the coefficient axis it is the plain block sum."""
    if payload.dim() != 2:
        raise ValueError(
            f"feature_block_sum takes (F, m) block partials; got shape {tuple(payload.shape)}")
    local = payload[0]
    for f in range(1, payload.shape[0]):
        local = local + payload[f]
    if not feature_sharded():
        return local
    if not _chunked():
        return all_reduce(local, FEATURE_AXIS, "margins")
    return reduce_chunks(
        (local[lo:hi] for lo, hi in _chunk_bounds(local.shape[0], overlap_chunks())),
        "margins")


def feature_margins(x, w: torch.Tensor,
                    dot_pairs: Sequence[Tuple[torch.Tensor, torch.Tensor]] = ()) -> torch.Tensor:
    """The (n + P,) sum over column blocks of ``x``'s margin partials and of
    each coefficient-space dot ``u . v``: this rank's held blocks in block
    order, then the 'feature' group. ``fused``: one all-reduce of the
    whole payload. ``overlap``: the rows in ``overlap_chunks()`` chunks,
    each chunk's partials computed and its all-reduce issued before the
    next chunk's partials, the dots riding the last chunk."""
    from photon_ml_tpu_torch.ops import sparse as sparse_ops

    n = x.shape[0]
    dots = sparse_ops.block_dots(x, dot_pairs) if dot_pairs else None
    if not _chunked():
        (z,) = sparse_ops.margin_partial_chunks(x, w, [(0, n)])
        payload = z if dots is None else torch.cat([z, dots.to(z)])
        if not feature_sharded():
            return payload
        return all_reduce(payload, FEATURE_AXIS, "margins")
    bounds = _chunk_bounds(n, overlap_chunks())

    def parts():
        chunks = sparse_ops.margin_partial_chunks(x, w, bounds)
        for i, z in enumerate(chunks):
            yield torch.cat([z, dots.to(z)]) if (dots is not None and i == len(bounds) - 1) else z

    return reduce_chunks(parts(), "margins")
