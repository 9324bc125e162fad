"""A design's column-sorted copy and the fixed-order column reduce over it
(``csrc/colsort.cuh``, ``csrc/colsort.cu``): the X^T side of the fused
passes, ``ell_rmatvec`` and ``ell_colsum`` on CUDA tensors.

- :class:`DesignColumns` (built by :func:`build_design_columns`, kept with
  the design by :func:`design_columns`): the padded ELL cut into blocks of
  ``ROW_BLOCK`` rows; within a block every valid slot (an id in [0, d)) is
  one entry (column, slot, value), sorted stably by column, so a column's
  entries are one run whose rows keep their order, and in-row duplicates
  stay separate entries; each block padded at its tail with column ``d``
  to whole tiles of ``TILE`` entries. An entry's slot is counted from its
  block's first slot (int32 at any n), and its row follows from it: the
  block's first row + slot // k. A new values table over the same indices
  is laid out with one gather per block (:meth:`DesignColumns.layout`);
  ``chains`` are the columns whose run crosses a tile edge within a block.
  A design of at most ``ROW_BLOCK`` rows is one block.
- :func:`column_reduce`: ``g_j = sum over column j's entries of f(v_e) *
  a[row_e]``, ``f(v) = v`` (``"linear"``), ``v^2`` (``"square"``) or both
  (``"pair"``: the two sums in float64 in every compute type, each rounded
  once). On CUDA tensors one C call clears the outputs and launches, block
  after block, the tiles and the chains, the first block storing its sums
  and each later one adding to them, with no atomics and every sum in a
  fixed order, so the outputs have the same bits from call to call; on CPU
  tensors it runs :func:`column_reduce_reference`, the plain PyTorch
  version, whose order may differ.

The lab's layout (``kernels/lab.py``) is the same order cut into blocks
of 512 columns, made by one sort (:func:`sorted_slots`); it builds its
chains with :func:`run_chains` too.
"""

from __future__ import annotations

import ctypes
import dataclasses
import itertools
import weakref
from typing import Dict, Tuple

import torch

from photon_ml_tpu_torch.kernels import dispatch, launch

__all__ = [
    "TILE",
    "DesignColumns",
    "build_design_columns",
    "design_columns",
    "column_values",
    "sorted_slots",
    "run_chains",
    "column_reduce",
    "column_reduce_reference",
    "REDUCE_MODES",
]

TILE = 1024  # entries per tile (csrc/colsort.cuh kTile)
# slots that the copy's build sorts at a time: its memory beyond the copy
# is a few tens of bytes times this, whatever the design's size
BUILD_CHUNK = 1 << 24
# rows of a block of the copy: the reduce's a[row] gathers of one block
# fall in a window of this many rows (16 MB of an f64 vector), which stays
# in the card's L2 while the block's entries stream past; of 2^19, 2^20
# and 2^21 the fastest on the H100 (PERF.md)
ROW_BLOCK = 1 << 21
# a line of DesignColumns.blocks: first row, first tile, end tile, first
# chain, end chain (the five that csrc/colsort.cuh reads), entries, columns
# named
BLOCK_FIELDS = 7

# mode -> (sums per entry, the C entry's name part)
REDUCE_MODES = {"linear": 1, "square": 1, "pair": 2}

# (values dtype, compute dtype) -> C entry-point suffix
_REDUCE_TYPES = {
    (torch.float64, torch.float64): "f64",
    (torch.float32, torch.float32): "f32",
    (torch.bfloat16, torch.float32): "bf16_f32",
}

_tokens = itertools.count(1)


class _KeptBeside:
    """Values kept beside tensor objects for as long as each lives: keyed
    by the object's id, checked by a weak reference, dropped when it is
    freed."""

    def __init__(self):
        self._items: Dict[int, tuple] = {}

    def get(self, t: torch.Tensor):
        item = self._items.get(id(t))
        return None if item is None or item[0]() is not t else item[1]

    def put(self, t: torch.Tensor, value) -> None:
        key = id(t)
        item = self._items.get(key)
        if item is None or item[0]() is not t:
            weakref.finalize(t, self._items.pop, key, None)
        self._items[key] = (weakref.ref(t), value)


# the copy of each indices tensor, and the layout of each values tensor
_copies = _KeptBeside()
_layouts = _KeptBeside()


@dataclasses.dataclass(frozen=True)
class DesignColumns:
    """The column-sorted copy of an (n, k) padded ELL of width ``d``, in
    blocks of rows.

    ``cols``, ``perm``: (ntiles * TILE,) int32, each entry's column (``d``
    in a block's tail padding) and its slot counted from its block's first
    slot (local row * k + slot in the row; 0 in the padding); within a
    block and a column the entries keep the ELL's slot order. ``chains``:
    (nchains, 3) int32, one line per column whose run crosses a tile edge
    within a block: the column, its first tile, its last tile, ordered by
    first tile. ``blocks``: (nblocks, BLOCK_FIELDS) int64 on the host, one
    line per block of rows: first row, first tile, end tile, first chain,
    end chain, entries, columns named. ``row_block`` is the ``ROW_BLOCK``
    of the build; ``token`` names this build (a values layout is valid for
    the build that made it)."""

    cols: torch.Tensor
    perm: torch.Tensor
    chains: torch.Tensor
    blocks: torch.Tensor
    n: int
    k: int
    d: int
    nvalid: int
    row_block: int
    token: int

    @property
    def ntiles(self) -> int:
        return self.cols.shape[0] // TILE

    @property
    def nblocks(self) -> int:
        return self.blocks.shape[0]

    def _spans(self):
        """(first row, first entry, entries) of each block."""
        return [(r0, t0 * TILE, nv) for r0, t0, _, _, _, nv, _ in self.blocks.tolist()]

    def entry_rows(self) -> torch.Tensor:
        """(ntiles * TILE,) int64: each entry's row, the block's first row
        + slot // k, as the kernel derives it (0 in the padding)."""
        rows = torch.zeros(self.cols.shape[0], dtype=torch.int64, device=self.cols.device)
        for r0, e0, nv in self._spans():
            rows[e0:e0 + nv] = torch.div(self.perm[e0:e0 + nv], self.k,
                                         rounding_mode="floor") + r0
        return rows

    def layout(self, values: torch.Tensor) -> torch.Tensor:
        """(ntiles * TILE,) ``values`` (n, k) in the copy's order, 0 in the
        tail padding: one gather per block."""
        out = torch.zeros(self.cols.shape[0], dtype=values.dtype, device=values.device)
        flat = values.reshape(-1)
        for r0, e0, nv in self._spans():
            torch.index_select(flat[r0 * self.k:], 0, self.perm[e0:e0 + nv],
                               out=out[e0:e0 + nv])
        return out

    def nbytes(self, values_itemsize: int = 0) -> int:
        """Device bytes of the copy (columns, slots, chains), plus one
        values layout of ``values_itemsize`` bytes an entry."""
        return (sum(t.numel() * t.element_size() for t in (self.cols, self.perm, self.chains))
                + self.cols.shape[0] * values_itemsize)


def sorted_slots(ids: torch.Tensor, d: int) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """(sorted ids, permutation, nvalid) of the flat ids, the valid ones (in
    [0, d)) first, sorted stably by id so that equal ids keep their slot
    order; every other id sorts after them as ``d``. One host read (the
    count). The mask is freed before the sort, whose own buffers set the
    peak memory."""
    valid = (ids >= 0) & (ids < d)
    nvalid = int(valid.sum())
    key = torch.where(valid, ids, d)
    del valid
    sorted_ids, perm = torch.sort(key, stable=True)
    return sorted_ids, perm, nvalid


def run_chains(head: torch.Tensor, tail: torch.Tensor, open_head: torch.Tensor) -> torch.Tensor:
    """(nchains, 3) int32: column, first tile, last tile of every run that
    crosses a tile edge, from each tile's first column ``head``, last
    column ``tail`` and whether its head is a column (not padding),
    ``open_head``. Edge t (between tiles t - 1 and t) is crossed when tile
    t's head continues tile t - 1's tail; a run crosses the next edge too
    when it fills its tile. The chain's column is the tail's value."""
    ntiles = head.shape[0]
    dev = head.device
    if ntiles < 2:
        return torch.zeros((0, 3), dtype=torch.int32, device=dev)
    cross = torch.zeros(ntiles + 1, dtype=torch.bool, device=dev)
    cross[1:ntiles] = (head[1:] == tail[:-1]) & open_head[1:]
    whole = head == tail
    # edge t continues the chain of edge t - 1 when tile t - 1 is one run
    cont = torch.zeros_like(cross)
    cont[1:ntiles] = cross[1:ntiles] & cross[:ntiles - 1] & whole[:-1]
    starts = torch.nonzero(cross & ~cont).flatten()
    ends = torch.nonzero(cross[:ntiles] & ~cont[1:]).flatten()
    first = starts - 1
    return torch.stack([tail[first].long(), first, ends], dim=1).to(torch.int32)


def _chunk_spans(lo: int, hi: int):
    return [(s, min(s + BUILD_CHUNK, hi)) for s in range(lo, hi, BUILD_CHUNK)]


def rows_per_block(k: int) -> int:
    """Rows of a block of the copy: ``ROW_BLOCK``, or fewer where the rows
    are so wide that a block's slots would leave int32."""
    return max(1, min(ROW_BLOCK, (2**31 - 1) // max(k, 1)))


def build_design_columns(indices: torch.Tensor, d: int) -> DesignColumns:
    """The column-sorted copy of ``indices`` (n, k) int, built on its
    device block by block, in the order of a stable sort by column within
    each block (the same layout on every build). Ids outside [0, d) are
    the ELL's padding (or ids the kernels ignore) and are left out.

    Each block is a counting sort in chunks of ``BUILD_CHUNK`` slots over
    its own rows, so the build holds the copy and one chunk's sort at a
    time, not a sort of every slot: the block's column counts give each
    column's first position; each chunk, sorted stably on its own, places
    its entries after those of the chunks before it. Positions are unique
    and integer sums exact, so the layout does not depend on the device's
    order. One host read for the blocks' sizes, one per chunk (its count
    of valid slots), one for the chains and the columns each block
    names."""
    if indices.dim() != 2:
        raise ValueError(f"build_design_columns: indices must be (n, k), got "
                         f"{tuple(indices.shape)}")
    if not 0 <= d <= 2**31 - 2:
        raise ValueError(f"build_design_columns: d={d} outside int32")
    n, k = indices.shape
    dev = indices.device
    flat = indices.reshape(-1)
    per = rows_per_block(k)
    spans = [(r0, min(r0 + per, n)) for r0 in range(0, n, per)]

    def keys(lo, hi):
        ids = flat[lo:hi]
        return torch.where((ids >= 0) & (ids < d), ids, d)

    counted = torch.zeros(len(spans), dtype=torch.int64, device=dev)
    for b, (r0, r1) in enumerate(spans):
        for lo, hi in _chunk_spans(r0 * k, r1 * k):
            ids = flat[lo:hi]
            counted[b] += ((ids >= 0) & (ids < d)).sum()
    entries = counted.tolist()
    ends = list(itertools.accumulate(-(-v // TILE) for v in entries))
    firsts = [0] + ends[:-1]
    total = (ends[-1] if ends else 0) * TILE
    cols = torch.full((total,), d, dtype=torch.int32, device=dev)
    perm = torch.zeros(total, dtype=torch.int32, device=dev)
    named = torch.zeros(len(spans), dtype=torch.int64, device=dev)
    for b, (r0, r1) in enumerate(spans):
        chunks = _chunk_spans(r0 * k, r1 * k)
        counts = torch.zeros(d + 1, dtype=torch.int64, device=dev)
        for lo, hi in chunks:
            counts += torch.bincount(keys(lo, hi), minlength=d + 1)
        named[b] = (counts[:d] > 0).sum()
        # each column's next free position in the copy
        nxt = torch.cumsum(counts, 0) - counts + firsts[b] * TILE
        for lo, hi in chunks:
            key = keys(lo, hi)
            chunk = torch.bincount(key, minlength=d + 1)
            valid = int(chunk[:d].sum())
            sorted_key, order = torch.sort(key, stable=True)
            col = sorted_key[:valid].long()
            # the entry's rank in its column's run within the chunk, after
            # the chunks before
            pos = (nxt - (torch.cumsum(chunk, 0) - chunk))[col]
            pos += torch.arange(valid, device=dev)
            cols[pos] = col.to(torch.int32)
            perm[pos] = (order[:valid] + (lo - r0 * k)).to(torch.int32)
            nxt += chunk
            del key, sorted_key, order, col, pos
    tiles = cols.view(-1, TILE)
    head, tail = tiles[:, 0], tiles[:, -1]
    # a run never crosses into the next block
    open_head = head < d
    open_head[torch.tensor([t for t in firsts if t < tiles.shape[0]], dtype=torch.int64,
                           device=dev)] = False
    chains = run_chains(head, tail, open_head)
    # each block's chains: the run of those whose first tile is its own
    edges = torch.searchsorted(chains[:, 1].long().contiguous(),
                               torch.tensor(firsts + ends[-1:], dtype=torch.int64, device=dev))
    read = torch.cat([named, edges]).tolist()
    named_b, edges = read[:len(spans)], read[len(spans):]
    blocks = torch.tensor(
        [[r0, t0, t1, c0, c1, nv, m] for (r0, _), t0, t1, c0, c1, nv, m in
         zip(spans, firsts, ends, edges, edges[1:], entries, named_b)],
        dtype=torch.int64).reshape(-1, BLOCK_FIELDS)
    return DesignColumns(
        cols=cols, perm=perm, chains=chains, blocks=blocks, n=n, k=k, d=int(d),
        nvalid=sum(entries), row_block=ROW_BLOCK, token=next(_tokens),
    )


def design_columns(indices: torch.Tensor, d: int) -> DesignColumns:
    """The copy of ``indices``, built at the first call and kept beside the
    tensor object for as long as it lives: every later call on the same
    tensor, at the same width, with its contents unchanged (``_version``)
    and the same ``ROW_BLOCK``, returns it without a sort."""
    kept = _copies.get(indices)
    if (kept is not None and kept[0] == indices._version and kept[1].d == d
            and kept[1].row_block == ROW_BLOCK):
        return kept[1]
    copy = build_design_columns(indices, d)
    _copies.put(indices, (indices._version, copy))
    return copy


def column_values(copy: DesignColumns, values: torch.Tensor) -> torch.Tensor:
    """``values`` laid out in the copy's order, made (and checked for the
    CUDA reduce) at the first call and kept with the values tensor for that
    copy while its contents are unchanged."""
    kept = _layouts.get(values)
    if kept is not None and kept[0] == copy.token and kept[1] == values._version:
        return kept[2]
    laid = copy.layout(values)
    check_copy("column_values", copy, laid)
    _layouts.put(values, (copy.token, values._version, laid))
    return laid


def reduce_dtypes(values_dtype: torch.dtype, a_dtype: torch.dtype):
    """(values dtype the reduce reads, compute dtype) for values of
    ``values_dtype`` and a vector of ``a_dtype``: the compute dtype is
    ``promote_types``; values outside the kernel's pairs are cast to it."""
    cd = torch.promote_types(values_dtype, a_dtype)
    if (values_dtype, cd) in _REDUCE_TYPES:
        return values_dtype, cd
    if (cd, cd) in _REDUCE_TYPES:
        return cd, cd
    raise TypeError(f"column_reduce takes (values, a) dtypes with a float64 or float32 "
                    f"result, got ({values_dtype}, {a_dtype})")


def column_reduce_reference(copy: DesignColumns, vals: torch.Tensor, a: torch.Tensor,
                            mode: str = "linear"):
    """Plain PyTorch version of :func:`column_reduce`: each entry's update
    in the compute type (``"pair"``: widened to float64), with its row
    derived from its block's first row and its slot, added into a (d + 1,)
    buffer whose last entry takes the padding, by ``index_add_``."""
    _, cd = reduce_dtypes(vals.dtype, a.dtype)
    v = vals.to(cd)
    s = a.to(cd)[copy.entry_rows()]
    ids = copy.cols.long()

    def colsum(upd):
        out = upd.new_zeros(copy.d + 1)
        return out.index_add_(0, ids, upd)[:copy.d]

    if mode == "linear":
        return colsum(v * s)
    if mode == "square":
        return colsum(v * v * s)
    if mode == "pair":
        return (colsum((v * v * s).double()).to(cd), colsum((v * s).double()).to(cd))
    raise ValueError(f"column_reduce: mode {mode!r} not in {sorted(REDUCE_MODES)}")


def check_copy(kernel: str, copy: DesignColumns, vals: torch.Tensor) -> None:
    """Raise on what the CUDA reduce does not take: a layout of the wrong
    size, non-contiguous or misaligned tensors (it loads 4 entries at a
    time), a block table that is not on the host."""
    if vals.shape != copy.cols.shape:
        raise ValueError(f"{kernel}: values laid out as {tuple(vals.shape)}, the copy "
                         f"holds {tuple(copy.cols.shape)}")
    for name, t in (("cols", copy.cols), ("perm", copy.perm), ("vals", vals),
                    ("chains", copy.chains)):
        if not t.is_contiguous():
            raise ValueError(f"{kernel}: the copy's {name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{kernel}: the copy's {name} must start on a 16-byte boundary")
    blocks = copy.blocks
    if blocks.device.type != "cpu" or blocks.dtype != torch.int64 or not blocks.is_contiguous():
        raise ValueError(f"{kernel}: the copy's blocks must be contiguous int64 on the host")


def wide_sums(copy: DesignColumns, mode: str, cd: torch.dtype) -> bool:
    """Whether the reduce keeps the pair mode's sums in float64 across
    blocks and rounds each column once at the end (csrc/colsort.cuh)."""
    return mode == "pair" and cd != torch.float64 and copy.nblocks > 1


def block_bytes(copy: DesignColumns, mode: str, cd: torch.dtype) -> int:
    """Bytes the reduce moves for its blocks of rows beyond what one block
    moves: each later block's second read and write of the columns it
    names, and for :func:`wide_sums` the float64 sums written and read
    again by the narrowing pass."""
    sums = REDUCE_MODES[mode]
    wide = wide_sums(copy, mode, cd)
    named_later = int(copy.blocks[1:, 6].sum())
    return (2 * sums * (8 if wide else cd.itemsize) * named_later
            + (2 * sums * copy.d * 8 if wide else 0))


def scratch_size(copy: DesignColumns, mode: str, cd: torch.dtype) -> int:
    """Float64 entries of the reduce's scratch: its sums at each side of
    each tile, then, for :func:`wide_sums`, the (2, d) float64 sums."""
    sums = REDUCE_MODES[mode]
    return max(1, 2 * copy.ntiles * sums + (2 * copy.d if wide_sums(copy, mode, cd) else 0))


def reduce_scratch(copy: DesignColumns, mode: str, cd: torch.dtype, device) -> torch.Tensor:
    """The reduce's float64 scratch (:func:`scratch_size`)."""
    return torch.empty((scratch_size(copy, mode, cd),), dtype=torch.float64, device=device)


_REDUCE_ENTRIES = {
    (mode, vdt, cd): launch.Entry(
        "colsort_reduce", "colsort", f"photon_colsort_reduce_{mode}_{suffix}",
        [ctypes.c_void_p] * 9 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int])
    for mode in REDUCE_MODES for (vdt, cd), suffix in _REDUCE_TYPES.items()
}
# key -> plan
_reduce_plans: dict = {}


def _reduce_plan(key, copy: DesignColumns, vals: torch.Tensor, a: torch.Tensor, mode: str):
    """(device index, values dtype, compute dtype, sums, scratch size,
    entry) of a CUDA key, ``launch.PLAIN`` of a CPU one."""
    if mode not in REDUCE_MODES:
        raise ValueError(f"column_reduce: mode {mode!r} not in {sorted(REDUCE_MODES)}")
    vdt, cd = reduce_dtypes(vals.dtype, a.dtype)
    if a.dim() != 1 or a.shape[0] != copy.n:
        raise ValueError(f"column_reduce: a must be ({copy.n},), got {tuple(a.shape)}")
    sums = REDUCE_MODES[mode]
    # the roofline: each entry's column id and value read once, a read, g
    # written; beyond it the copy's slots, its tiles' padding and what its
    # blocks of rows add
    pad = copy.cols.shape[0] - copy.nvalid
    dispatch.record_kernel_cost(
        "colsort_reduce", copy.nvalid, 1, copy.d, vals.element_size(),
        flops_per_slot=sums + (mode != "linear"),
        extra_bytes=(4 * copy.nvalid + pad * (8 + vals.element_size())
                     + copy.n * cd.itemsize + sums * copy.d * cd.itemsize
                     + block_bytes(copy, mode, cd)),
    )
    if not dispatch.use_kernel("colsort_reduce", copy.cols, vals, a):
        return launch.keep("colsort_reduce", _reduce_plans, key, launch.PLAIN)
    check_copy("colsort_reduce", copy, vals.to(vdt))
    entry = _REDUCE_ENTRIES[(mode, vdt, cd)]
    entry.load()
    scratch = scratch_size(copy, mode, cd)
    return launch.keep("colsort_reduce", _reduce_plans, key,
                       (a.device.index, vdt, cd, sums, scratch, entry))


def column_reduce(copy: DesignColumns, vals: torch.Tensor, a: torch.Tensor,
                  mode: str = "linear"):
    """The (d,) column sums of ``f(v_e) * a[row_e]`` over the copy, in
    ``promote_types(vals, a)`` (a tuple of two for ``"pair"``): ``vals``
    laid out by :func:`column_values`, ``a`` (n,). CUDA tensors: one C
    call (outputs cleared, then each block's tiles and chains in block
    order) or an exception; CPU tensors: :func:`column_reduce_reference`.
    A call is checked in full once per key of the copy, dtypes, shapes,
    devices and mode (``kernels/launch.py``); later calls check the
    tensors' contiguity and 16-byte alignment and launch."""
    key = (copy.token, vals.dtype, vals.shape, vals.device, a.dtype, a.shape, a.device, mode)
    plan = _reduce_plans.get(key) or _reduce_plan(key, copy, vals, a, mode)
    if plan is launch.PLAIN:
        return column_reduce_reference(copy, vals, a, mode)
    device, vdt, cd, sums, scratch_size, entry = plan
    vals = vals.to(vdt)
    a = a.to(cd).contiguous()
    ptrs = launch.pointers("colsort_reduce", ("the copy's cols", "the copy's perm",
                                              "the copy's vals", "the copy's chains"),
                           copy.cols, copy.perm, vals, copy.chains)
    out = torch.empty((sums, copy.d), dtype=cd, device=a.device)
    scratch = torch.empty((scratch_size,), dtype=torch.float64, device=a.device)
    entry.launch(device, *ptrs, copy.blocks.data_ptr(), a.data_ptr(), out[0].data_ptr(),
                 out[sums - 1].data_ptr(), scratch.data_ptr(), copy.nblocks, copy.k, copy.d)
    dispatch.check_outputs("colsort_reduce", out)
    return (out[0], out[1]) if mode == "pair" else out[0]
