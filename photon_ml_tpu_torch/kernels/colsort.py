"""A design's column-sorted copy and the fixed-order column reduce over it
(``csrc/colsort.cuh``, ``csrc/colsort.cu``): the X^T side of the fused
passes, ``ell_rmatvec`` and ``ell_colsum`` on CUDA tensors.

- :class:`DesignColumns` (built by :func:`build_design_columns`, kept with
  the design by :func:`design_columns`): every valid slot of a padded ELL
  (an id in [0, d)) as one entry (column, row, value), sorted stably by
  column, so a column's entries are one run whose rows keep their order,
  and in-row duplicates stay separate entries; padded at the tail with
  column ``d`` to whole tiles of ``TILE`` entries. It keeps the sort's
  permutation, so a new values table over the same indices is laid out
  with one gather (:meth:`DesignColumns.layout`), and ``chains``, the
  columns whose run crosses a tile edge.
- :func:`column_reduce`: ``g_j = sum over column j's entries of f(v_e) *
  a[row_e]``, ``f(v) = v`` (``"linear"``), ``v^2`` (``"square"``) or both
  (``"pair"``: the two sums in float64 in every compute type, each rounded
  once). On CUDA tensors one C call clears the outputs and launches the
  tiles and the chains, with no atomics and every sum in a fixed order,
  so the outputs have the same bits from call to call; on CPU tensors it
  runs :func:`column_reduce_reference`, the plain PyTorch version, whose
  order may differ.

The lab's layout (``kernels/lab.py``) is the same order cut into blocks
of 512 columns, made by one sort (:func:`sorted_slots`); it builds its
chains with :func:`run_chains` too.
"""

from __future__ import annotations

import dataclasses
import itertools
import weakref
from typing import Dict, Tuple

import torch

from photon_ml_tpu_torch.kernels import dispatch

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
    """The column-sorted copy of an (n, k) padded ELL of width ``d``.

    ``cols``, ``rows``: (ntiles * TILE,) int32, each entry's column (``d``
    in the tail padding) and row (0 there); within a column the entries
    keep the ELL's slot order. ``perm``: (nvalid,) int64 or int32, each
    entry's flat slot in the ELL (row * k + slot). ``chains``: (nchains,
    3) int32, one line per column whose run crosses a tile edge: the
    column, its first tile, its last tile. ``token`` names this build (a
    values layout is valid for the build that made it)."""

    cols: torch.Tensor
    rows: torch.Tensor
    perm: torch.Tensor
    chains: torch.Tensor
    n: int
    k: int
    d: int
    nvalid: int
    token: int

    @property
    def ntiles(self) -> int:
        return self.cols.shape[0] // TILE

    def layout(self, values: torch.Tensor) -> torch.Tensor:
        """(ntiles * TILE,) ``values`` (n, k) in the copy's order, 0 in the
        tail padding: one gather."""
        out = torch.zeros(self.cols.shape[0], dtype=values.dtype, device=values.device)
        torch.index_select(values.reshape(-1), 0, self.perm, out=out[:self.nvalid])
        return out

    def nbytes(self, values_itemsize: int = 0) -> int:
        """Device bytes of the copy (columns, rows, permutation, chains),
        plus one values layout of ``values_itemsize`` bytes an entry."""
        return (sum(t.numel() * t.element_size()
                    for t in (self.cols, self.rows, self.perm, self.chains))
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


def _chunk_spans(total: int):
    return [(s, min(s + BUILD_CHUNK, total)) for s in range(0, total, BUILD_CHUNK)]


def build_design_columns(indices: torch.Tensor, d: int) -> DesignColumns:
    """The column-sorted copy of ``indices`` (n, k) int, built on its
    device in the order of a stable sort by column (the same layout on
    every build). Ids outside [0, d) are the ELL's padding (or ids the
    kernels ignore) and are left out.

    A counting sort in chunks of ``BUILD_CHUNK`` slots, so the build holds
    the copy and one chunk's sort at a time, not a sort of every slot:
    the columns' counts give each column's first position; each chunk,
    sorted stably on its own, places its entries after those of the
    chunks before it. Positions are unique and integer sums exact, so the
    layout does not depend on the device's order. One host read per chunk
    (its count of valid slots), one for the total, one for the chains."""
    if indices.dim() != 2:
        raise ValueError(f"build_design_columns: indices must be (n, k), got "
                         f"{tuple(indices.shape)}")
    if not 0 <= d <= 2**31 - 2:
        raise ValueError(f"build_design_columns: d={d} outside int32")
    n, k = indices.shape
    dev = indices.device
    flat = indices.reshape(-1)
    spans = _chunk_spans(flat.numel())

    def keys(lo, hi):
        ids = flat[lo:hi]
        return torch.where((ids >= 0) & (ids < d), ids, d)

    counts = torch.zeros(d + 1, dtype=torch.int64, device=dev)
    for lo, hi in spans:
        counts += torch.bincount(keys(lo, hi), minlength=d + 1)
    nvalid = int(counts[:d].sum())
    total = -(-nvalid // TILE) * TILE
    cols = torch.full((total,), d, dtype=torch.int32, device=dev)
    rows = torch.zeros(total, dtype=torch.int32, device=dev)
    perm = torch.empty(nvalid, dtype=torch.int32 if n * k <= 2**31 - 1 else torch.int64,
                       device=dev)
    # each column's next free position in the copy
    nxt = torch.cumsum(counts, 0) - counts
    for lo, hi in spans:
        key = keys(lo, hi)
        chunk = torch.bincount(key, minlength=d + 1)
        valid = int(chunk[:d].sum())
        sorted_key, order = torch.sort(key, stable=True)
        col = sorted_key[:valid].long()
        # the entry's rank in its column's run within the chunk, after the
        # chunks before
        pos = (nxt - (torch.cumsum(chunk, 0) - chunk))[col]
        pos += torch.arange(valid, device=dev)
        slot = order[:valid] + lo
        cols[pos] = col.to(torch.int32)
        perm[pos] = slot.to(perm.dtype)
        rows[pos] = torch.div(slot, max(k, 1), rounding_mode="floor").to(torch.int32)
        nxt += chunk
        del key, sorted_key, order, col, pos, slot
    tiles = cols.view(-1, TILE)
    head, tail = tiles[:, 0], tiles[:, -1]
    return DesignColumns(
        cols=cols, rows=rows, perm=perm, chains=run_chains(head, tail, head < d),
        n=n, k=k, d=int(d), nvalid=nvalid, token=next(_tokens),
    )


def design_columns(indices: torch.Tensor, d: int) -> DesignColumns:
    """The copy of ``indices``, built at the first call and kept beside the
    tensor object for as long as it lives: every later call on the same
    tensor, at the same width and with its contents unchanged
    (``_version``), returns it without a sort."""
    kept = _copies.get(indices)
    if kept is not None and kept[0] == indices._version and kept[1].d == d:
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
    in the compute type (``"pair"``: widened to float64) added into a
    (d + 1,) buffer whose last entry takes the padding, by ``index_add_``."""
    _, cd = reduce_dtypes(vals.dtype, a.dtype)
    v = vals.to(cd)
    s = a.to(cd)[copy.rows.long()]
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
    time)."""
    if vals.shape != copy.cols.shape:
        raise ValueError(f"{kernel}: values laid out as {tuple(vals.shape)}, the copy "
                         f"holds {tuple(copy.cols.shape)}")
    for name, t in (("cols", copy.cols), ("rows", copy.rows), ("vals", vals),
                    ("chains", copy.chains)):
        if not t.is_contiguous():
            raise ValueError(f"{kernel}: the copy's {name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{kernel}: the copy's {name} must start on a 16-byte boundary")


def column_reduce(copy: DesignColumns, vals: torch.Tensor, a: torch.Tensor,
                  mode: str = "linear"):
    """The (d,) column sums of ``f(v_e) * a[row_e]`` over the copy, in
    ``promote_types(vals, a)`` (a tuple of two for ``"pair"``): ``vals``
    laid out by :func:`column_values`, ``a`` (n,). CUDA tensors: one C
    call (outputs cleared, the tiles, the chains) or an exception; CPU
    tensors: :func:`column_reduce_reference`."""
    if mode not in REDUCE_MODES:
        raise ValueError(f"column_reduce: mode {mode!r} not in {sorted(REDUCE_MODES)}")
    vdt, cd = reduce_dtypes(vals.dtype, a.dtype)
    if a.dim() != 1 or a.shape[0] != copy.n:
        raise ValueError(f"column_reduce: a must be ({copy.n},), got {tuple(a.shape)}")
    sums = REDUCE_MODES[mode]
    # the roofline: each entry's column id and value read once; beyond it
    # the copy's row ids, its tail padding, a and the outputs
    pad = copy.cols.shape[0] - copy.nvalid
    dispatch.record_kernel_cost(
        "colsort_reduce", copy.nvalid, 1, copy.d, vals.element_size(),
        flops_per_slot=sums + (mode != "linear"),
        extra_bytes=(4 * copy.nvalid + pad * (8 + vals.element_size())
                     + copy.n * cd.itemsize + sums * copy.d * cd.itemsize),
    )
    if not dispatch.use_kernel("colsort_reduce", copy.cols, vals, a):
        return column_reduce_reference(copy, vals, a, mode)
    vals = vals.to(vdt)
    a = a.to(cd).contiguous()
    check_copy("colsort_reduce", copy, vals)
    out = torch.empty((sums, copy.d), dtype=cd, device=a.device)
    edge = torch.empty((max(1, 2 * copy.ntiles * sums),), dtype=torch.float64, device=a.device)
    import ctypes

    from photon_ml_tpu_torch.kernels.ell import device_scope, load_entry, stream_of

    lib, entry = load_entry(
        "colsort", f"photon_colsort_reduce_{mode}_{_REDUCE_TYPES[(vdt, cd)]}",
        [ctypes.c_void_p] * 8 + [ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
                                 ctypes.c_void_p],
    )
    with device_scope(a.device):
        code = entry(copy.cols.data_ptr(), copy.rows.data_ptr(), vals.data_ptr(),
                     copy.chains.data_ptr(), a.data_ptr(), out[0].data_ptr(),
                     out[sums - 1].data_ptr(), edge.data_ptr(), copy.ntiles,
                     copy.chains.shape[0], copy.d, stream_of(a))
    from photon_ml_tpu_torch.kernels import build

    build.check(lib, code, "colsort_reduce launch")
    dispatch.count_launch("colsort_reduce")
    return (out[0], out[1]) if mode == "pair" else out[0]
