"""The sparse kernel lab's kernels (counterpart of the three Pallas kernels
of ``benchmarks/sparse_kernel_lab.py``) and its column-sorted layout.

- ``lane_gather``: ``out[r, j] = tbl[r, idx[r, j]]`` over (R, 128) tables
  (the lab's ``pallas_lane_gather``), with ``take_along_axis``'s contract:
  an id in [-128, 0) counts from the row's end, and any other id outside
  [0, 128) reads NaN;
- ``column_sorted_tiles``: the lab's layout (its section C). The entries
  of a padded ELL, sorted stably by column, cut into blocks of
  ``LAB_BLOCK`` = 512 columns, each block padded to whole tiles of
  ``LAB_TILE`` = 1024 entries;
- ``onehot_gather``: ``e[t, i] = vals[t, i] * w[tile_block[t] * 512 +
  cols[t, i]]``, 0 where ``cols`` is the miss (512) — the gather side of
  ``z = X w`` (``pallas_onehot_gather``);
- ``onehot_reduce``: ``g[b * 512 + c]`` = the sum of ``upd`` over the
  entries of block ``b`` with local column ``c`` — ``X^T a`` without a
  scatter (``pallas_onehot_reduce``). The CUDA kernel writes every column
  once, with no atomics and in a fixed order, so ``g`` keeps its bits
  from call to call.

The lab's names are kept, so that each counterpart is found. On CUDA
tensors each wrapper launches its kernel in ``csrc/lab.cu`` (or raises);
on CPU tensors it runs its ``*_reference``, the plain PyTorch version. The
CUDA kernels take float32.
"""

from __future__ import annotations

import dataclasses

import torch

from photon_ml_tpu_torch.kernels import dispatch
from photon_ml_tpu_torch.kernels.colsort import run_chains, sorted_slots
from photon_ml_tpu_torch.kernels.ell import device_scope, load_entry, stream_of

__all__ = [
    "LAB_BLOCK",
    "LAB_TILE",
    "LANES",
    "ColumnTiles",
    "column_sorted_tiles",
    "tile_chains",
    "lane_gather",
    "lane_gather_reference",
    "onehot_gather",
    "onehot_gather_reference",
    "onehot_reduce",
    "onehot_reduce_reference",
]

LAB_BLOCK = 512  # columns per block (the lab's CB)
LAB_TILE = 1024  # entries per tile (the lab's T, stored there as (8, 128))
LANES = 128  # lane_gather's row width (the lab's BC)


@dataclasses.dataclass(frozen=True)
class ColumnTiles:
    """Column-sorted entries in tiles (the lab's ``psc``, ``psr``, ``psv``,
    ``tile_block``, ``first_of_block``), with the runs that cross tiles.

    ``cols``, ``rows``, ``vals``: (ntiles, LAB_TILE), the local column in
    the tile's block (``LAB_BLOCK`` at a miss), the row (0 at a miss) and the value
    (0 at a miss); within a block the entries keep the order of a stable
    sort by column, so a column is one run of entries.
    ``tile_block``: (ntiles,) int32, each tile's block; ``first_of_block``:
    (ntiles,) int32, 1 at a block's first tile. ``chains``: (nchains, 3)
    int32, one line per column whose run crosses a tile edge: its global
    column, its first tile and its last tile (``tile_chains``). ``d``: the
    design's width; ``nblocks`` = ceil(d / LAB_BLOCK)."""

    cols: torch.Tensor
    rows: torch.Tensor
    vals: torch.Tensor
    tile_block: torch.Tensor
    first_of_block: torch.Tensor
    chains: torch.Tensor
    d: int
    nblocks: int

    @property
    def ntiles(self) -> int:
        return self.cols.shape[0]

    def global_cols(self) -> torch.Tensor:
        """(ntiles, LAB_TILE) int64 global column ids, ``nblocks *
        LAB_BLOCK`` at a miss (one past the last block)."""
        cols = self.cols.long()
        hit = (cols >= 0) & (cols < LAB_BLOCK)
        gcol = self.tile_block.long()[:, None] * LAB_BLOCK + cols
        return torch.where(hit, gcol, self.nblocks * LAB_BLOCK)


def tile_chains(cols: torch.Tensor, tile_block: torch.Tensor) -> torch.Tensor:
    """(nchains, 3) int32: global column, first tile, last tile of every
    column whose run crosses a tile edge (``colsort.run_chains`` on each
    tile's first and last global columns). Edge t is crossed when both
    tiles are in one block and the column that ends tile t - 1 starts
    tile t (never the miss)."""
    head, tail = cols[:, 0].long(), cols[:, -1].long()
    base = tile_block.long() * LAB_BLOCK
    # a miss never continues a run: -1 at a head, -2 at a tail
    ghead = torch.where(head != LAB_BLOCK, base + head, -1)
    gtail = torch.where(tail != LAB_BLOCK, base + tail, -2)
    return run_chains(ghead, gtail, ghead >= 0)


def column_sorted_tiles(indices: torch.Tensor, values: torch.Tensor, d: int) -> ColumnTiles:
    """The lab's column-sorted tiles of a padded ELL (``indices`` (n, k)
    int, ``values`` (n, k)), built on the tensors' device: the flat column
    ids sorted stably (so rows keep their order within a column), each
    block's entries padded to a multiple of ``LAB_TILE``. Slots with id ``d``
    are the ELL's padding and are left out; any other id outside [0, d)
    raises. Four host reads: the bad ids, the count, the size and the
    chains."""
    if indices.shape != values.shape or indices.dim() != 2:
        raise ValueError(f"column_sorted_tiles: indices {tuple(indices.shape)} and values "
                         f"{tuple(values.shape)} must be the same (n, k)")
    if d < 0:
        raise ValueError(f"column_sorted_tiles: d={d}")
    block, tile = LAB_BLOCK, LAB_TILE
    dev = indices.device
    k = indices.shape[1]
    ids = indices.reshape(-1)
    nblocks = -(-d // block)
    n_bad = int(((ids < 0) | (ids > d)).sum())
    if n_bad:
        raise ValueError(f"column_sorted_tiles: {n_bad} ids outside [0, {d}] "
                         f"(id {d} is the padding)")
    # the design copy's sort (kernels/colsort.py): the valid entries are a
    # prefix of the sorted order, the padding ids (d) after them
    sorted_ids, perm, nvalid = sorted_slots(ids, d)
    sc = sorted_ids[:nvalid].long()
    counts = torch.bincount(sc // block, minlength=nblocks)
    padded = (counts + tile - 1) // tile * tile
    total = int(padded.sum())
    perm = perm[:nvalid]
    blk = sc // block
    starts = torch.cumsum(padded, 0) - padded
    src_starts = torch.cumsum(counts, 0) - counts
    pos = starts[blk] + torch.arange(nvalid, device=dev) - src_starts[blk]
    psc = torch.full((total,), block, dtype=torch.int32, device=dev)
    psr = torch.zeros(total, dtype=torch.int32, device=dev)
    psv = torch.zeros(total, dtype=values.dtype, device=dev)
    psc[pos] = (sc - blk * block).to(torch.int32)
    psr[pos] = torch.div(perm, k, rounding_mode="floor").to(torch.int32)
    psv[pos] = values.reshape(-1)[perm]
    ntiles = total // tile
    tile_block = torch.repeat_interleave(
        torch.arange(nblocks, dtype=torch.int32, device=dev), padded // tile,
        output_size=ntiles)
    first_of_block = torch.ones(ntiles, dtype=torch.int32, device=dev)
    first_of_block[1:] = (tile_block[1:] != tile_block[:-1]).to(torch.int32)
    cols = psc.view(ntiles, tile)
    return ColumnTiles(
        cols=cols, rows=psr.view(ntiles, tile), vals=psv.view(ntiles, tile),
        tile_block=tile_block, first_of_block=first_of_block,
        chains=tile_chains(cols, tile_block), d=int(d), nblocks=nblocks,
    )


# -- checks ------------------------------------------------------------------


def _check_f32(kernel: str, **tensors) -> None:
    for name, t in tensors.items():
        if t.dtype != torch.float32:
            raise TypeError(f"{kernel}: {name} must be float32, got {t.dtype}")


def _check_cuda(kernel: str, *named) -> None:
    """What the CUDA kernels take beyond the plain versions: contiguous
    tensors with 16-byte aligned bases (they load 4 entries at a time)."""
    for name, t in named:
        if not t.is_contiguous():
            raise ValueError(f"{kernel}: {name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{kernel}: {name} must start on a 16-byte boundary")


def _check_tiles(kernel: str, tiles: ColumnTiles, table: torch.Tensor, name: str,
                 shape) -> None:
    if table.shape != tuple(shape):
        raise ValueError(f"{kernel}: {name} must be {tuple(shape)}, got {tuple(table.shape)}")
    if tiles.cols.dtype != torch.int32 or tiles.tile_block.dtype != torch.int32:
        raise TypeError(f"{kernel}: tile columns and tile_block must be int32")


def _check_kernel_layout(kernel: str, tiles: ColumnTiles) -> None:
    if tiles.chains.dtype != torch.int32 or not tiles.chains.is_contiguous():
        raise ValueError(f"{kernel}: chains must be contiguous int32")
    if tiles.nblocks * LAB_BLOCK > 2**31 - 1:
        raise ValueError(f"{kernel}: d={tiles.d} outside int32")


def _launch(kernel: str, entry: str, argtypes, *args) -> None:
    lib, fn = load_entry("lab", entry, argtypes)
    code = fn(*args)
    from photon_ml_tpu_torch.kernels import build

    build.check(lib, code, f"{kernel} launch")
    dispatch.count_launch(kernel)


# -- lane_gather (row 6) -----------------------------------------------------


def lane_gather_reference(tbl: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch ``lane_gather``: ``torch.gather`` along the lanes,
    negative ids from the row's end, NaN where an id stays outside."""
    lanes = tbl.shape[1]
    ids = torch.where(idx < 0, idx + lanes, idx).long()
    ok = (ids >= 0) & (ids < lanes)
    got = torch.gather(tbl, 1, torch.where(ok, ids, 0))
    return torch.where(ok, got, torch.full_like(got, float("nan")))


def lane_gather(tbl: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """out[r, j] = tbl[r, idx[r, j]]: ``tbl`` (R, 128) float32, ``idx``
    (R, 128) int32. CUDA tensors: one launch of the CUDA kernel (a warp per
    row) or an exception; CPU tensors: ``lane_gather_reference``."""
    _check_f32("lane_gather", tbl=tbl)
    if idx.dtype != torch.int32:
        raise TypeError(f"lane_gather: idx must be int32, got {idx.dtype}")
    if tbl.dim() != 2 or tbl.shape[1] != LANES or idx.shape != tbl.shape:
        raise ValueError(f"lane_gather: tbl and idx must be the same (R, {LANES}), got "
                         f"{tuple(tbl.shape)} and {tuple(idx.shape)}")
    rows = tbl.shape[0]
    dispatch.record_kernel_cost("lane_gather", rows, LANES, LANES, 4, flops_per_slot=0.0,
                                extra_bytes=rows * LANES * 4)
    if not dispatch.use_kernel("lane_gather", tbl, idx):
        return lane_gather_reference(tbl, idx)
    _check_cuda("lane_gather", ("tbl", tbl), ("idx", idx))
    out = torch.empty_like(tbl)
    if rows == 0:
        return out
    import ctypes

    with device_scope(tbl.device):
        _launch("lane_gather", "photon_lab_lane_gather",
                [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_void_p],
                tbl.data_ptr(), idx.data_ptr(), out.data_ptr(), rows, stream_of(tbl))
    return out


# -- onehot_gather (row 7) ---------------------------------------------------


def onehot_gather_reference(tiles: ColumnTiles, w: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch ``onehot_gather``: ``vals * w_pad[global column]``,
    ``w_pad`` being ``w`` with zeros to ``nblocks * LAB_BLOCK`` and one more
    zero that the misses read."""
    w_pad = torch.zeros(tiles.nblocks * LAB_BLOCK + 1, dtype=w.dtype, device=w.device)
    w_pad[:tiles.d] = w
    return tiles.vals * w_pad[tiles.global_cols()]


def onehot_gather(tiles: ColumnTiles, w: torch.Tensor) -> torch.Tensor:
    """e = (ntiles, tile) float32, ``e[t, i] = vals[t, i] * w[tile_block[t]
    * LAB_BLOCK + cols[t, i]]`` and 0 at a miss, ``w`` (d,) float32. CUDA
    tensors: one launch of the CUDA kernel (a block per tile) or an
    exception; CPU tensors: ``onehot_gather_reference``."""
    _check_f32("onehot_gather", w=w, vals=tiles.vals)
    _check_tiles("onehot_gather", tiles, w, "w", (tiles.d,))
    ntiles = tiles.ntiles
    dispatch.record_kernel_cost("onehot_gather", ntiles, LAB_TILE, tiles.d, 4,
                                flops_per_slot=1.0,
                                extra_bytes=4 * ntiles * LAB_TILE + 4 * tiles.d)
    if not dispatch.use_kernel("onehot_gather", tiles.cols, tiles.vals, tiles.tile_block, w):
        return onehot_gather_reference(tiles, w)
    _check_kernel_layout("onehot_gather", tiles)
    _check_cuda("onehot_gather", ("cols", tiles.cols), ("vals", tiles.vals),
                ("tile_block", tiles.tile_block), ("w", w))
    out = torch.empty_like(tiles.vals)
    if ntiles == 0:
        return out
    import ctypes

    with device_scope(w.device):
        _launch("onehot_gather", "photon_lab_onehot_gather",
                [ctypes.c_void_p] * 5 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p],
                tiles.cols.data_ptr(), tiles.vals.data_ptr(), tiles.tile_block.data_ptr(),
                w.data_ptr(), out.data_ptr(), ntiles, tiles.d, stream_of(w))
    return out


# -- onehot_reduce (row 8) ---------------------------------------------------


def onehot_reduce_reference(tiles: ColumnTiles, upd: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch ``onehot_reduce``: ``index_add_`` of every entry into
    its global column of a (nblocks * LAB_BLOCK + 1,) buffer whose last entry
    takes the misses, then dropped."""
    out = torch.zeros(tiles.nblocks * LAB_BLOCK + 1, dtype=upd.dtype, device=upd.device)
    out.index_add_(0, tiles.global_cols().reshape(-1), upd.reshape(-1))
    return out[:-1]


def onehot_reduce(tiles: ColumnTiles, upd: torch.Tensor) -> torch.Tensor:
    """g = (nblocks * LAB_BLOCK,) float32 column sums of ``upd`` (ntiles,
    LAB_TILE) float32 over the tiles; the caller takes ``[:d]``. A block with
    no tiles, and a column no entry names, is 0. CUDA tensors: the output
    cleared and two launches, the tiles then the runs that cross tiles, no
    atomics (or an exception); CPU tensors: ``onehot_reduce_reference``."""
    _check_f32("onehot_reduce", upd=upd)
    _check_tiles("onehot_reduce", tiles, upd, "upd", tuple(tiles.cols.shape))
    ntiles = tiles.ntiles
    width = tiles.nblocks * LAB_BLOCK
    dispatch.record_kernel_cost("onehot_reduce", ntiles, LAB_TILE, tiles.d, 4,
                                flops_per_slot=1.0, extra_bytes=4 * width)
    if not dispatch.use_kernel("onehot_reduce", tiles.cols, upd, tiles.tile_block,
                               tiles.chains):
        return onehot_reduce_reference(tiles, upd)
    _check_kernel_layout("onehot_reduce", tiles)
    _check_cuda("onehot_reduce", ("cols", tiles.cols), ("upd", upd),
                ("tile_block", tiles.tile_block))
    if ntiles == 0:
        return torch.zeros(width, dtype=torch.float32, device=upd.device)
    # g, then the two partials of each tile's edge runs
    buf = torch.empty(width + 2 * ntiles, dtype=torch.float32, device=upd.device)
    g = buf[:width]
    import ctypes

    with device_scope(upd.device):
        _launch("onehot_reduce", "photon_lab_onehot_reduce",
                [ctypes.c_void_p] * 5 + [ctypes.c_longlong, ctypes.c_longlong,
                                         ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p],
                tiles.cols.data_ptr(), upd.data_ptr(), tiles.tile_block.data_ptr(),
                tiles.chains.data_ptr(), g.data_ptr(), tiles.chains.shape[0], ntiles,
                buf[width:].data_ptr(), width, stream_of(upd))
    return g
