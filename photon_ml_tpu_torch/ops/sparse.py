"""Sparse (wide) feature batches: padded row-wise (ELL) and hybrid
designs (counterpart of ``photon_ml_tpu/ops/sparse.py``).

Every ELL row holds up to ``k`` (column, value) pairs, padded with column
id ``d`` (one past the last feature) and value 0, so padding is
algebraically invisible: a gather at id ``d`` reads 0 and a scatter to it
adds nothing. ``matvec``, ``rmatvec`` and ``colsum`` send a dense design
to plain tensor products and an ELL design to the ``ell_matvec`` /
``ell_rmatvec`` / ``ell_colsum`` kernels
(:mod:`photon_ml_tpu_torch.kernels.ell`), which route by the tensors'
device.

A :class:`HybridFeatures` design (built on the host by :func:`to_hybrid`)
is a dense slab of the hot columns, a plain ``torch.matmul`` as in the JAX
package, plus the cold tail as contiguous-row ELL segments, each of its
own width, in a permuted row order; the three contractions run each
segment through the ELL kernels and add the segments' outputs in segment
order.

A :class:`FeatureShardedSparse` design (built on the host by
:func:`shard_columns`, equal to the JAX function's arrays) is the ELL
blocked by column for feature-sharded solves: block f holds the columns
``c % F == f`` under local ids ``c // F``, each block its own (V, k) ELL
over ``d_shard`` local columns padded with ``d_shard``, so on the card a
block's margin partials are one ``ell_matvec`` launch and its ``rmatvec``
/ ``colsum`` the column-sorted reduce on the block's own copy, built once
per block. In the row-balanced layout the overflow tail's partials reach
their rows through a fixed gather table and a row sum, never an atomic
add, so a run on the card equals itself. Under a mesh that splits the
coefficient axis a rank holds only its own block
(:func:`feature_sharded_block`), and :func:`matvec` sums the block
partials over the 'feature' group (:func:`photon_ml_tpu_torch.parallel.
overlap.feature_margins`).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from photon_ml_tpu_torch.kernels.ell import ell_colsum, ell_matvec, ell_rmatvec


@dataclasses.dataclass(frozen=True)
class SparseFeatures:
    """(n, k) padded sparse design matrix with width ``d``.

    indices: (n, k) int32 column ids; padding slots hold ``d``.
    values:  (n, k) float payloads; padding slots hold 0.0.
    d:       number of feature columns.
    """

    indices: torch.Tensor
    values: torch.Tensor
    d: int

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.indices.shape[-2], self.d)

    @property
    def nnz_per_row(self) -> int:
        return self.indices.shape[-1]

    def __matmul__(self, w: torch.Tensor) -> torch.Tensor:
        return matvec(self, w)


@dataclasses.dataclass(frozen=True)
class HybridFeatures:
    """Power-law split of a sparse matrix: a dense slab for the hot
    columns, row-bucketed padded ELL for the cold tail.

    The cold rows are sorted by cold-entry count and cut into contiguous
    segments by the exact-DP padding minimizer of the GAME random-effect
    designs, each an ELL at its own width, so the rows live in a PERMUTED
    order: ``row_perm[i]`` is the original index of stored row i. Callers
    permute the rest of the batch (labels, offsets, weights, mask) once at
    construction; training is row-order invariant.

    dense:         (n, H) slab holding the hot columns (stored row order).
    hot_ids:       (H,) int32 original column ids of the slab columns.
    cold_segments: contiguous-row ELL segments over the same d covering
                   all n rows in stored order (hot columns never appear).
    row_perm:      (n,) int32 stored-row -> original-row map.
    """

    dense: torch.Tensor
    hot_ids: torch.Tensor
    cold_segments: Tuple[SparseFeatures, ...]
    row_perm: torch.Tensor

    @property
    def d(self) -> int:
        return self.cold_segments[0].d

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.dense.shape[-2], self.d)

    @property
    def ndim(self) -> int:
        return 2

    @property
    def dtype(self) -> torch.dtype:
        return self.dense.dtype

    def segment_bounds(self) -> Tuple[Tuple[int, int], ...]:
        """[(lo, hi)) stored-row ranges, one per cold segment."""
        bounds = []
        lo = 0
        for seg in self.cold_segments:
            hi = lo + seg.indices.shape[-2]
            bounds.append((lo, hi))
            lo = hi
        return tuple(bounds)

    def __matmul__(self, w: torch.Tensor) -> torch.Tensor:
        return matvec(self, w)


@dataclasses.dataclass(frozen=True, eq=False)
class FeatureShardedSparse:
    """Column-blocked padded-ELL for coefficient-sharded (huge-d) solves
    (the JAX package's container of the same name).

    blocks:   one ELL per held block, each (V, k) over ``d_shard`` local
              column ids (``c // F`` of original column c in block
              ``c % F``), padding slots holding id ``d_shard``, value 0.
    d_shard:  columns per block; the solver-visible width is
              ``num_blocks * d_shard``.
    d_orig:   the column count before blocking.
    row_map:  (V, F) int32 virtual row -> original row for the
              row-balanced layout (sentinel ``num_rows``: an empty lane),
              or None for the flat layout, where V is the row count.
    num_rows: the logical row count n when ``row_map`` is set.
    aligned_rows: the first ``aligned_rows`` virtual rows are row v itself
              in every block; only the tail past them is routed.
    routes:   per block, for the balanced layout's tail: (rows, table,
              sources, rows on the host) — the distinct rows the tail
              reaches (ascending), an (R, m) table of tail lanes per such
              row (padded with the index of an appended zero), and the
              (V - aligned_rows,) row each tail lane reads from (sentinel
              ``num_rows``). Built on the host with the container.
    """

    blocks: Tuple[SparseFeatures, ...]
    d_shard: int
    d_orig: int
    row_map: Optional[torch.Tensor] = None
    num_rows: Optional[int] = None
    aligned_rows: int = 0
    routes: tuple = ()

    @property
    def num_blocks(self) -> int:
        return len(self.blocks)

    @property
    def is_balanced(self) -> bool:
        return self.row_map is not None

    @property
    def virtual_rows(self) -> int:
        return self.blocks[0].indices.shape[0]

    @property
    def shape(self) -> Tuple[int, int]:
        rows = self.num_rows if self.num_rows is not None else self.virtual_rows
        return (rows, self.num_blocks * self.d_shard)

    @property
    def ndim(self) -> int:
        return 2

    @property
    def dtype(self) -> torch.dtype:
        return self.blocks[0].values.dtype

    @property
    def indices(self) -> torch.Tensor:
        """(V, F, k) column ids, the JAX package's array layout."""
        return torch.stack([b.indices for b in self.blocks], dim=1)

    @property
    def values(self) -> torch.Tensor:
        return torch.stack([b.values for b in self.blocks], dim=1)

    def block_weights(self, f: int, a: torch.Tensor) -> torch.Tensor:
        """Block f's per-virtual-row weights from the per-row ``a``: ``a``
        itself in the flat layout; the aligned head's rows and each tail
        lane's row (an empty lane reads 0) in the balanced one."""
        if not self.is_balanced:
            return a
        al = self.aligned_rows
        src = self.routes[f][2]
        a_ext = torch.cat([a, a.new_zeros((1,))])
        tail = a_ext.index_select(0, torch.clamp(src, max=a.shape[0]))
        return torch.cat([a[:al], tail])

    def __matmul__(self, w: torch.Tensor) -> torch.Tensor:
        return matvec(self, w)


def is_sparse(x) -> bool:
    return isinstance(x, SparseFeatures)


def is_hybrid(x) -> bool:
    return isinstance(x, HybridFeatures)


def is_feature_sharded(x) -> bool:
    return isinstance(x, FeatureShardedSparse)


def is_structured(x) -> bool:
    """Any non-plain-array representation this module owns."""
    return is_sparse(x) or is_hybrid(x) or is_feature_sharded(x)


def values_dtype(x) -> torch.dtype:
    """The stored payload dtype of a dense, ELL, hybrid or blocked design."""
    return x.values.dtype if is_sparse(x) else x.dtype


def cast_values(x, dtype: torch.dtype, device="cpu"):
    """Representation-preserving placement: a dense matrix, an ELL's
    values, or a hybrid's slab and cold values, to ``dtype`` on ``device``
    (column ids and the row permutation stay int32)."""
    device = torch.device(device)
    if is_hybrid(x):
        return HybridFeatures(
            dense=torch.as_tensor(x.dense, dtype=dtype, device=device),
            hot_ids=torch.as_tensor(x.hot_ids, dtype=torch.int32, device=device),
            cold_segments=tuple(cast_values(seg, dtype, device) for seg in x.cold_segments),
            row_perm=torch.as_tensor(x.row_perm, dtype=torch.int32, device=device),
        )
    if is_sparse(x):
        return SparseFeatures(
            indices=torch.as_tensor(x.indices, dtype=torch.int32, device=device),
            values=torch.as_tensor(x.values, dtype=dtype, device=device),
            d=x.d,
        )
    if is_feature_sharded(x):
        return feature_sharded_to(x, device, dtype)
    return torch.as_tensor(x, dtype=dtype, device=device)


def as_dense(x) -> torch.Tensor:
    """``x`` itself if it is a dense tensor; raises for any other object."""
    if not isinstance(x, torch.Tensor):
        raise TypeError(
            f"{type(x).__name__} is not a dense design; the port takes a dense "
            "tensor, a padded-ELL SparseFeatures, a HybridFeatures or a "
            "FeatureShardedSparse"
        )
    return x


def _promoted(x: torch.Tensor, v: torch.Tensor):
    """A dense design and a vector of another dtype, promoted to
    ``torch.promote_types`` (the JAX package's bf16 low-precision dense
    product is not ported)."""
    if x.dtype != v.dtype:
        cd = torch.promote_types(x.dtype, v.dtype)
        return x.to(cd), v.to(cd)
    return x, v


def _cold_sum(x: HybridFeatures, v: torch.Tensor, contract) -> torch.Tensor:
    """The (d,) sum over the cold segments of ``contract(segment, rows of
    v)``, added in segment order as the JAX package adds them. Each segment
    writes a (d,) vector of its own."""
    g = None
    for (lo, hi), seg in zip(x.segment_bounds(), x.cold_segments):
        part = contract(seg, v[lo:hi])
        g = part if g is None else g + part
    return g


def _add_hot(g: torch.Tensor, x: HybridFeatures, hot: torch.Tensor) -> torch.Tensor:
    """g with the slab's sums added at the hot columns. The hot ids are
    unique, so ``index_add_`` has no colliding atomics on the card: each
    column takes one add, and the result is the same from run to run."""
    return g.index_add_(0, x.hot_ids, hot.to(g.dtype))


def _feature_mesh() -> bool:
    from photon_ml_tpu_torch.parallel.mesh import feature_sharded

    return feature_sharded()


def margins_sum_blocks(x) -> bool:
    """True when ``x``'s margins are a sum over column blocks: a blocked
    container, or a dense design under a mesh that splits the coefficient
    axis (a rank holds its columns of it)."""
    return is_feature_sharded(x) or (isinstance(x, torch.Tensor) and _feature_mesh())


def _block_total(parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """The sum of per-block partials, added in block order."""
    out = parts[0]
    for p in parts[1:]:
        out = out + p
    return out


def _block_w(x: "FeatureShardedSparse", w: torch.Tensor, f: int) -> torch.Tensor:
    return w[f * x.d_shard:(f + 1) * x.d_shard]


def margin_partial_chunks(x, w: torch.Tensor, bounds: Sequence[Tuple[int, int]]):
    """This rank's (hi - lo,) margin partials of rows [lo, hi) for each of
    ``bounds`` in turn, summed over the held blocks (a dense design: its
    columns' product), computed one chunk at a time so that a chunk's
    all-reduce flies while the next is computed
    (:func:`photon_ml_tpu_torch.parallel.overlap.feature_margins`)."""
    if not is_feature_sharded(x):
        x, w = _promoted(as_dense(x), w)
        for lo, hi in bounds:
            yield torch.matmul(x[lo:hi], w)
        return
    tails = []
    for f, blk in enumerate(x.blocks):
        if not x.is_balanced or x.routes[f][0].numel() == 0:
            tails.append(None)
            continue
        al = x.aligned_rows
        z_t = ell_matvec(blk.indices[al:], blk.values[al:], _block_w(x, w, f), x.d_shard)
        rows, table, _, rows_host = x.routes[f]
        sums = torch.cat([z_t, z_t.new_zeros((1,))])[table].sum(1)
        tails.append((rows, rows_host, sums))
    head_rows = x.aligned_rows if x.is_balanced else x.shape[0]
    cd = torch.promote_types(x.dtype, w.dtype)
    for lo, hi in bounds:
        parts = []
        for f, blk in enumerate(x.blocks):
            h = min(hi, head_rows)
            if lo < h:
                z = ell_matvec(blk.indices[lo:h], blk.values[lo:h], _block_w(x, w, f), x.d_shard)
                if h < hi:
                    z = torch.cat([z, z.new_zeros((hi - h,))])
            else:
                z = w.new_zeros((hi - lo,), dtype=cd)
            if tails[f] is not None:
                rows, rows_host, sums = tails[f]
                i0, i1 = (int(i) for i in np.searchsorted(rows_host, [lo, hi]))
                if i1 > i0:
                    r = rows[i0:i1] - lo
                    z = z.index_put((r,), z.index_select(0, r) + sums[i0:i1])
            parts.append(z)
        yield _block_total(parts)


def matvec(x, w: torch.Tensor) -> torch.Tensor:
    """Margins contraction: (n, d) @ (d,) -> (n,). A hybrid's output is in
    its STORED (permuted) row order, matching the permuted batch. A blocked
    container (or a dense design under a mesh that splits the coefficient
    axis) sums its block partials over the 'feature' group."""
    if margins_sum_blocks(x):
        return matvec_and_feature_dots(x, w)[0]
    if is_hybrid(x):
        cold = torch.cat([matvec(seg, w) for seg in x.cold_segments])
        dense, hw = _promoted(x.dense, w.index_select(0, x.hot_ids))
        return torch.matmul(dense, hw) + cold
    if is_sparse(x):
        return ell_matvec(x.indices, x.values, w, x.d)
    x, w = _promoted(as_dense(x), w)
    return torch.matmul(x, w)


def rmatvec(x, a: torch.Tensor) -> torch.Tensor:
    """Gradient back-projection: (n, d)^T @ (n,) -> (d,). A hybrid's ``a``
    is in stored row order. A blocked container gives its held blocks'
    coefficients, block after block (one reduce per block)."""
    if is_feature_sharded(x):
        return torch.cat([
            ell_rmatvec(blk.indices, blk.values, x.block_weights(f, a), x.d_shard)
            for f, blk in enumerate(x.blocks)])
    if is_hybrid(x):
        g = _cold_sum(x, a, rmatvec)
        dense, a2 = _promoted(x.dense, a)
        return _add_hot(g, x, torch.matmul(a2, dense))
    if is_sparse(x):
        return ell_rmatvec(x.indices, x.values, a, x.d)
    x, a = _promoted(as_dense(x), a)
    return torch.matmul(x.T, a)


def colsum(x, c: torch.Tensor, square: bool = False) -> torch.Tensor:
    """sum_i c_i * x_ij (or x_ij^2) -> (d,): the column sums of the feature
    summary and the Hessian diagonal."""
    if is_feature_sharded(x):
        return torch.cat([
            ell_colsum(blk.indices, blk.values, x.block_weights(f, c), x.d_shard, square=square)
            for f, blk in enumerate(x.blocks)])
    if is_hybrid(x):
        dense, c2 = _promoted(x.dense, c)
        v = dense * dense if square else dense
        hot = torch.einsum("n,nh->h", c2, v)
        g = _cold_sum(x, c, lambda seg, part: colsum(seg, part, square=square))
        return _add_hot(g, x, hot)
    if is_sparse(x):
        return ell_colsum(x.indices, x.values, c, x.d, square=square)
    x, c = _promoted(as_dense(x), c)
    v = x * x if square else x
    return torch.einsum("n,nd->d", c, v)


def pad_rows(x, pad: int):
    """Append ``pad`` all-padding rows (id d, value 0) to an ELL or a
    hybrid, keeping the padding invariant that zero rows would break; a
    hybrid's new rows go to its last segment and map to themselves. A
    balanced blocked container only counts more rows (its empty lanes keep
    dropping); a flat one pads every block."""
    if is_feature_sharded(x):
        if x.is_balanced:
            return dataclasses.replace(x, num_rows=x.shape[0] + pad)
        return dataclasses.replace(x, blocks=tuple(pad_rows(b, pad) for b in x.blocks))
    if is_hybrid(x):
        n = x.dense.shape[-2]
        segs = list(x.cold_segments)
        segs[-1] = pad_rows(segs[-1], pad)
        return HybridFeatures(
            dense=torch.cat([x.dense, x.dense.new_zeros((pad, x.dense.shape[-1]))]),
            hot_ids=x.hot_ids,
            cold_segments=tuple(segs),
            row_perm=torch.cat([x.row_perm, torch.arange(
                n, n + pad, dtype=torch.int32, device=x.row_perm.device)]),
        )
    return SparseFeatures(
        indices=torch.cat([x.indices, x.indices.new_full((pad, x.nnz_per_row), x.d)]),
        values=torch.cat([x.values, x.values.new_zeros((pad, x.nnz_per_row))]),
        d=x.d,
    )


def row_density(x) -> torch.Tensor:
    """Per-row stored-entry count (diagnostic; a hybrid's in stored
    order)."""
    if is_feature_sharded(x):
        return row_density(feature_sharded_as_ell(x))
    if is_hybrid(x):
        cold = torch.cat([row_density(seg) for seg in x.cold_segments])
        return (x.dense != 0).sum(-1) + cold
    if is_sparse(x):
        return (x.indices < x.d).sum(-1)
    return (as_dense(x) != 0).sum(-1)


def stored_cold_entries(hf: HybridFeatures) -> int:
    """Total stored (non-padding) entries across the cold segments."""
    return sum(int((seg.indices < seg.d).sum()) for seg in hf.cold_segments)


def cold_padded_slots(hf: HybridFeatures) -> int:
    """Total padded ELL slots across the cold segments (the quantity each
    segment's kernels stream)."""
    return sum(seg.indices.numel() for seg in hf.cold_segments)


def cold_as_single_ell(hf: HybridFeatures) -> SparseFeatures:
    """The cold segments as one ELL at the widest segment's width, in
    stored row order. It brings back the padding: for consumers that run
    once a run (the feature summary), not for the solves. A new tensor on
    every call, so the card builds its column-sorted copy again each
    time."""
    kmax = max(seg.nnz_per_row for seg in hf.cold_segments)
    ind, val = [], []
    for seg in hf.cold_segments:
        n, extra = seg.indices.shape[0], kmax - seg.nnz_per_row
        ind.append(torch.cat([seg.indices, seg.indices.new_full((n, extra), seg.d)], dim=1))
        val.append(torch.cat([seg.values, seg.values.new_zeros((n, extra))], dim=1))
    return SparseFeatures(indices=torch.cat(ind), values=torch.cat(val), d=hf.d)


def matvec_and_feature_dots(
    x, w: torch.Tensor, dot_pairs: Sequence[Tuple[torch.Tensor, torch.Tensor]] = ()
):
    """``(matvec(x, w), tuple(u . v for u, v in dot_pairs))`` with the
    coefficient-space dots riding the margins reduction when the margins
    are a block sum (a blocked container, or a dense design under a mesh
    that splits the coefficient axis): the (n,) margin partials and each
    block's (P,) dot partials form one (n + P,) payload, reduced over the
    'feature' group by one all-reduce (``fused``) or in row chunks issued
    as each is computed (``overlap``;
    :func:`photon_ml_tpu_torch.parallel.overlap.feature_margins`). For any
    other design the dots are plain ``torch.dot``."""
    if not margins_sum_blocks(x):
        return matvec(x, w), tuple(torch.dot(u, v) for u, v in dot_pairs)
    from photon_ml_tpu_torch.parallel.overlap import feature_margins

    total = feature_margins(x, w, dot_pairs)
    n = x.shape[0]
    return total[:n], tuple(total[n + i] for i in range(len(dot_pairs)))


def block_dots(x, dot_pairs) -> torch.Tensor:
    """(P,) this rank's partial of each coefficient-space dot: the held
    blocks' sums, added in block order (a dense design: one dot)."""
    if not is_feature_sharded(x):
        return torch.stack([torch.dot(u, v) for u, v in dot_pairs])
    F, ds = x.num_blocks, x.d_shard
    return _block_total([
        torch.stack([torch.dot(u[f * ds:(f + 1) * ds], v[f * ds:(f + 1) * ds])
                     for u, v in dot_pairs])
        for f in range(F)])


def feature_sharded_to(x: FeatureShardedSparse, device, dtype: torch.dtype = None
                       ) -> FeatureShardedSparse:
    """The container on ``device`` (values at ``dtype`` when given)."""
    device = torch.device(device)
    dtype = dtype or x.dtype
    blocks = tuple(
        SparseFeatures(indices=b.indices.to(device, torch.int32).contiguous(),
                       values=b.values.to(device, dtype).contiguous(), d=b.d)
        for b in x.blocks)
    routes = tuple(
        (r[0].to(device), r[1].to(device), r[2].to(device), r[3]) for r in x.routes)
    return dataclasses.replace(
        x, blocks=blocks, routes=routes,
        row_map=None if x.row_map is None else x.row_map.to(device))


def feature_sharded_block(x: FeatureShardedSparse, f: int) -> FeatureShardedSparse:
    """The container holding block ``f`` alone (one rank's share of a
    feature-sharded solve)."""
    return dataclasses.replace(
        x, blocks=(x.blocks[f],),
        row_map=None if x.row_map is None else x.row_map[:, f:f + 1].contiguous(),
        routes=x.routes[f:f + 1])


def feature_sharded_rows(x: FeatureShardedSparse, lo: int, hi: int) -> FeatureShardedSparse:
    """Rows [lo, hi) of a flat blocked container (a rank's 'data' shard).
    The balanced layout routes virtual rows across the whole row axis, so
    it is refused, as the JAX package keeps it to an unsharded row axis."""
    if x.is_balanced:
        if (lo, hi) == (0, x.shape[0]):
            return x
        raise ValueError(
            "the row-balanced blocked layout routes virtual rows within a "
            "block, so it requires the row axis unsharded ('data' = 1)")
    return dataclasses.replace(x, blocks=tuple(
        SparseFeatures(indices=b.indices[lo:hi].contiguous(),
                       values=b.values[lo:hi].contiguous(), d=b.d)
        for b in x.blocks))


def feature_sharded_as_ell(fs: FeatureShardedSparse) -> SparseFeatures:
    """A blocked container as one flat ELL over the BLOCKED column space
    (width F * d_shard; global id = block * d_shard + local), in row
    order: for consumers that run once a run (the feature summary), not
    for the solves. A balanced container is rebuilt through its row map
    on the host, as in the JAX package."""
    d_block = fs.num_blocks * fs.d_shard
    device = fs.blocks[0].indices.device
    if fs.is_balanced:
        ind = fs.indices.cpu().numpy()
        val = fs.values.cpu()
        val = (val.to(torch.float64) if val.dtype == torch.bfloat16 else val).numpy()
        rm = fs.row_map.cpu().numpy()
        keep = ind < fs.d_shard
        vv, ff, _ = np.nonzero(keep)
        rows = rm[vv, ff]
        cols = ff.astype(np.int64) * fs.d_shard + ind[keep]
        return from_coo(rows, cols, val[keep], fs.shape[0], d_block, dtype=fs.dtype,
                        device=device)
    ind, val = fs.indices, fs.values
    n, F, k = ind.shape
    base = (torch.arange(F, dtype=ind.dtype, device=device) * fs.d_shard)[None, :, None]
    glob = torch.where(ind < fs.d_shard, ind + base, torch.full_like(ind, d_block))
    return SparseFeatures(indices=glob.reshape(n, F * k).contiguous(),
                          values=val.reshape(n, F * k).contiguous(), d=d_block)


def blocked_column_map(d: int, num_blocks: int) -> np.ndarray:
    """(d,) original column -> blocked position, for the round-robin
    blocking :func:`shard_columns` applies: column c lives in block c % F
    at local id c // F."""
    c = np.arange(d, dtype=np.int64)
    d_shard = -(-d // num_blocks)
    return (c % num_blocks) * d_shard + c // num_blocks


def balanced_virtual_width(counts: np.ndarray) -> int:
    """The virtual-row width k0 minimizing the aligned balanced layout's
    cost proxy ``slots + 2 * routed_virtual_rows`` over the (F, n)
    per-(block, row) entry counts (the JAX package's exact scan)."""
    kmax = int(counts.max()) if counts.size else 1
    if kmax <= 1:
        return 1
    best_k, best_cost = 1, None
    F, n = counts.shape
    for k in range(1, kmax + 1):
        over = np.maximum(counts - k, 0)
        v_ovf = int((-(-over // k)).sum(axis=1).max())
        cost = F * (n + v_ovf) * k + 2 * F * v_ovf
        if best_cost is None or cost < best_cost:
            best_k, best_cost = k, cost
    return best_k


def _tail_routes(row_map: np.ndarray, n: int, aligned: int) -> tuple:
    """Per block: (rows, table, sources, rows on the host) of the balanced
    layout's tail (:class:`FeatureShardedSparse` ``routes``). The tail
    lanes of one row are consecutive and the rows ascend, so each table
    row lists its lanes in lane order."""
    out = []
    tail = row_map[aligned:]
    t = tail.shape[0]
    for f in range(row_map.shape[1]):
        src = tail[:, f].astype(np.int64)
        lanes = np.flatnonzero(src < n)
        rows, starts, counts = np.unique(src[lanes], return_index=True, return_counts=True)
        m = int(counts.max()) if counts.size else 1
        table = np.full((rows.size, m), t, np.int64)
        for j in range(m):
            has = counts > j
            table[has, j] = lanes[starts[has] + j]
        out.append((torch.from_numpy(rows), torch.from_numpy(table), torch.from_numpy(src),
                    rows))
    return tuple(out)


def shard_columns(
    sf: SparseFeatures,
    num_blocks: int,
    dtype: torch.dtype = None,
    balance_rows: bool = False,
) -> FeatureShardedSparse:
    """Block an ELL matrix by column for feature-sharded solves, on the
    host, once per dataset; the result is placed on ``sf``'s device.
    Columns go round-robin (block = c % F), so a frequency-sorted
    vocabulary spreads its hot columns over the blocks;
    :func:`blocked_column_map` gives the coefficient layout.

    Flat layout (default): every (row, block) lane pads to the dataset's
    widest. ``balance_rows=True`` (the ``overlap`` strategy's layout): each
    block packs its entries into width-k0 virtual rows
    (:func:`balanced_virtual_width`), row r's first k0 entries in virtual
    row r and the rest in routed overflow rows after the head. The arrays
    equal the JAX function's."""
    if num_blocks < 1:
        raise ValueError(f"num_blocks must be >= 1, got {num_blocks}")
    F = num_blocks
    d_shard = -(-sf.d // F)
    out_dtype = dtype or sf.values.dtype
    device = sf.indices.device
    ind = sf.indices.cpu().numpy()
    val_t = sf.values.cpu()
    val = (val_t.to(torch.float64) if val_t.dtype == torch.bfloat16 else val_t).numpy()
    n, k = ind.shape
    keep = ind < sf.d
    rows = np.broadcast_to(np.arange(n)[:, None], ind.shape)[keep]
    cols = ind[keep].astype(np.int64)
    vals = val[keep]
    blk = cols % F
    loc = cols // F
    key = rows * F + blk
    counts = np.bincount(key, minlength=n * F)
    order = np.argsort(key, kind="stable")
    starts = np.concatenate([[0], np.cumsum(counts)])[:-1]
    slot = np.arange(key.size) - starts[key[order]]

    def blocks_of(indices, values):
        return tuple(
            SparseFeatures(
                indices=torch.from_numpy(np.ascontiguousarray(indices[:, f])).to(device),
                values=torch.from_numpy(np.ascontiguousarray(values[:, f])).to(
                    device=device, dtype=out_dtype),
                d=d_shard)
            for f in range(F))

    if balance_rows and F > 1:
        cfr = counts.reshape(n, F).T
        k0 = balanced_virtual_width(cfr)
        over = np.maximum(cfr - k0, 0)
        ovf_per = -(-over // k0)
        v_ovf = int(ovf_per.sum(axis=1).max())
        v_total = n + v_ovf if (n + v_ovf) else 1
        base = np.zeros((F, n), np.int64)
        base[:, 1:] = np.cumsum(ovf_per, axis=1)[:, :-1]
        r_o, b_o, s_o = rows[order], blk[order], slot
        in_head = s_o < k0
        vrow = np.where(in_head, r_o, n + base[b_o, r_o] + np.maximum(s_o - k0, 0) // k0)
        pos = np.where(in_head, s_o, np.maximum(s_o - k0, 0) % k0)
        indices = np.full((v_total, F, k0), d_shard, np.int32)
        values = np.zeros((v_total, F, k0), val.dtype)
        row_map = np.full((v_total, F), n, np.int32)
        row_map[:n] = np.arange(n, dtype=np.int32)[:, None]
        indices[vrow, b_o, pos] = loc[order]
        values[vrow, b_o, pos] = vals[order]
        row_map[vrow, b_o] = r_o
        routes = tuple((r.to(device), t.to(device), s.to(device), h)
                       for r, t, s, h in _tail_routes(row_map, n, n))
        return FeatureShardedSparse(
            blocks=blocks_of(indices, values), d_shard=d_shard, d_orig=sf.d,
            row_map=torch.from_numpy(row_map).to(device), num_rows=n, aligned_rows=n,
            routes=routes)
    k_new = int(counts.max()) if counts.size and counts.max() > 0 else 1
    indices = np.full((n, F, k_new), d_shard, np.int32)
    values = np.zeros((n, F, k_new), val.dtype)
    indices[rows[order], blk[order], slot] = loc[order]
    values[rows[order], blk[order], slot] = vals[order]
    return FeatureShardedSparse(blocks=blocks_of(indices, values), d_shard=d_shard,
                                d_orig=sf.d)


# -- construction ------------------------------------------------------------


def from_coo(
    rows: np.ndarray,
    cols: np.ndarray,
    vals: np.ndarray,
    num_rows: int,
    num_cols: int,
    nnz_per_row: int = 0,
    dtype: torch.dtype = torch.float32,
    device="cpu",
) -> SparseFeatures:
    """Build from COO triplets (host-side, then placed on ``device``).
    Duplicate (row, col) entries are summed (the reference's dedup-by-sum,
    ``DataProcessingUtils.scala:70-76``). ``nnz_per_row`` pads the row
    width and raises if a row is wider; 0 means the widest row (at least
    1). Within a row, entries are in ascending column order."""
    rows = np.asarray(rows, np.int64)
    cols = np.asarray(cols, np.int64)
    vals = np.asarray(vals, np.float64)
    flat = rows * num_cols + cols
    uniq, inv = np.unique(flat, return_inverse=True)
    summed = np.zeros(uniq.size, np.float64)
    np.add.at(summed, inv, vals)
    r = uniq // num_cols
    c = uniq % num_cols
    counts = np.bincount(r, minlength=num_rows)
    k = int(counts.max()) if counts.size and counts.max() > 0 else 1
    if nnz_per_row:
        if k > nnz_per_row:
            raise ValueError(
                f"a row has {k} entries, above nnz_per_row={nnz_per_row}"
            )
        k = nnz_per_row
    indices = np.full((num_rows, k), num_cols, np.int32)
    values = np.zeros((num_rows, k), np.float64)
    starts = np.concatenate([[0], np.cumsum(counts)])[:-1]
    slot = np.arange(uniq.size) - starts[r]
    indices[r, slot] = c
    values[r, slot] = summed
    device = torch.device(device)
    return SparseFeatures(
        indices=torch.from_numpy(indices).to(device),
        values=torch.from_numpy(values).to(device=device, dtype=dtype),
        d=num_cols,
    )


def from_dense(
    x: np.ndarray, nnz_per_row: int = 0, dtype: torch.dtype = torch.float32,
    device="cpu",
) -> SparseFeatures:
    """Sparsify a dense matrix (testing / oracles)."""
    x = np.asarray(x)
    r, c = np.nonzero(x)
    return from_coo(
        r, c, x[r, c], x.shape[0], x.shape[1], nnz_per_row, dtype, device
    )


def to_hybrid(
    sf: SparseFeatures,
    hot_columns: int = -1,
    dtype: torch.dtype = None,
    min_count: int = 64,
    max_slab_bytes: int = 1 << 30,
    num_row_buckets: int = 8,
) -> HybridFeatures:
    """Split an ELL matrix into a dense hot slab and bucketed sparse cold
    segments, on the host, once per dataset; the result is placed on
    ``sf``'s device.

    ``hot_columns`` = H picks the H columns with the most stored entries;
    -1 sizes the slab itself: the columns stored more than ``min_count``
    times, most first, until the slab reaches ``max_slab_bytes`` at the
    target dtype (the JAX package's TPU break-even, kept unchanged so that
    both packages split alike). A slab with no such column takes the one
    column stored most (H = 1).

    The rows are then sorted by their count of cold entries and cut into
    at most ``num_row_buckets`` contiguous ELL segments by the exact-DP
    padding minimizer of ``game/data.py``; ``row_perm`` records stored row
    -> original row. The input must be dedup-summed (``from_coo``'s
    invariant): a (row, column) pair stored twice would sum into one slab
    cell and square differently there than in the ELL, so it is refused.
    """
    from photon_ml_tpu_torch.game.data import _split_minimizing_padding

    out_dtype = dtype or sf.values.dtype
    device = sf.indices.device
    ind = sf.indices.cpu().numpy()
    val_t = sf.values.cpu()
    if val_t.dtype == torch.bfloat16:
        val_t = val_t.to(torch.float64)
    val = val_t.numpy()
    n, k = ind.shape
    sorted_cols = np.sort(np.where(ind < sf.d, ind, -1), axis=-1)
    dup_rows = np.flatnonzero(
        ((sorted_cols[:, 1:] == sorted_cols[:, :-1]) & (sorted_cols[:, 1:] >= 0)).any(axis=-1)
    )
    if dup_rows.size:
        raise ValueError(
            f"to_hybrid requires dedup-summed input (from_coo's invariant); "
            f"{dup_rows.size} rows store a (row, column) pair twice, e.g. row "
            f"{int(dup_rows[0])}"
        )
    flat = ind.reshape(-1)
    keep = flat < sf.d
    counts = np.bincount(flat[keep], minlength=sf.d)
    if hot_columns < 0:
        hot = np.flatnonzero(counts > min_count)
        hot = hot[np.argsort(-counts[hot], kind="stable")]
        h_cap = max(1, max_slab_bytes // (n * out_dtype.itemsize))
        hot = hot[:h_cap]
        if hot.size == 0:
            hot = np.argsort(-counts, kind="stable")[:1]
    else:
        h = max(1, min(hot_columns, sf.d))
        hot = np.argsort(-counts, kind="stable")[:h]
    H = hot.size
    hot_rank = np.full(sf.d + 1, -1, np.int64)
    hot_rank[hot] = np.arange(H)
    is_hot = hot_rank[ind] >= 0  # (n, k); the padding id d is never hot

    # row permutation: ascending cold-entry count (the DP's input)
    cold_entry = ~is_hot & (ind < sf.d)
    cold_counts = cold_entry.sum(axis=1)
    row_perm = np.argsort(cold_counts, kind="stable").astype(np.int32)
    sorted_counts = cold_counts[row_perm]
    bounds = _split_minimizing_padding(sorted_counts, max(1, num_row_buckets)) or [(0, n)]

    # the slab, summed in float32 or float64 (never narrower), stored order
    acc_dtype = np.float64 if out_dtype == torch.float64 else np.float32
    dense = np.zeros((n, H), acc_dtype)
    rows = np.broadcast_to(np.arange(n)[:, None], ind.shape)
    np.add.at(dense, (rows[is_hot], hot_rank[ind[is_hot]]), val[is_hot])
    inv_perm = np.empty(n, np.int64)
    inv_perm[row_perm] = np.arange(n)
    dense = dense[row_perm]

    # cold segments: contiguous stored-row ranges, each its own ELL width
    stored_rows = inv_perm[rows[cold_entry]]
    cold_cols = ind[cold_entry]
    cold_vals = val[cold_entry]
    order = np.argsort(stored_rows, kind="stable")
    stored_rows, cold_cols, cold_vals = stored_rows[order], cold_cols[order], cold_vals[order]
    entry_starts = np.searchsorted(stored_rows, [lo for lo, _ in bounds])
    entry_ends = np.searchsorted(stored_rows, [hi for _, hi in bounds])
    segments = tuple(
        from_coo(stored_rows[es:ee] - lo, cold_cols[es:ee], cold_vals[es:ee], hi - lo, sf.d,
                 dtype=out_dtype, device=device)
        for (lo, hi), es, ee in zip(bounds, entry_starts, entry_ends)
    )
    return HybridFeatures(
        dense=torch.from_numpy(dense).to(device=device, dtype=out_dtype),
        hot_ids=torch.from_numpy(hot.astype(np.int32)).to(device),
        cold_segments=segments,
        row_perm=torch.from_numpy(row_perm).to(device),
    )


def to_dense(sf) -> np.ndarray:
    """Densify (small problems / tests only), host-side, in float64 for
    bf16 payloads (numpy has no bfloat16). A hybrid comes back in its
    ORIGINAL row order (``row_perm`` inverted); a blocked container in the
    blocked column space."""
    if is_feature_sharded(sf):
        return to_dense(feature_sharded_as_ell(sf))
    if is_hybrid(sf):
        stored = np.concatenate([to_dense(seg) for seg in sf.cold_segments])
        slab = sf.dense.cpu()
        stored[:, sf.hot_ids.cpu().numpy()] += slab.to(torch.float64).numpy().astype(
            stored.dtype)
        out = np.empty_like(stored)
        out[sf.row_perm.cpu().numpy()] = stored
        return out
    ind = sf.indices.cpu().numpy()
    val_t = sf.values.cpu()
    if val_t.dtype == torch.bfloat16:
        val_t = val_t.to(torch.float64)
    val = val_t.numpy()
    n, k = ind.shape
    out = np.zeros((n, sf.d), val.dtype)
    keep = (ind >= 0) & (ind < sf.d)
    np.add.at(
        out, (np.repeat(np.arange(n), k)[keep.reshape(-1)], ind[keep]), val[keep]
    )
    return out
