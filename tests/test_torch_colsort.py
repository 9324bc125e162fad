"""The port's column-sorted design copy and its column reduce
(``photon_ml_tpu_torch/kernels/colsort.py``) on the CPU: the copy's layout
in blocks of rows, and the reduce's plain version (the CUDA kernel's
reference) held to the JAX package's Pallas ``ell_rmatvec`` /
``ell_colsum`` in interpret mode and to their XLA lowering
(``ops.sparse.rmatvec`` / ``colsum``), on the same seeded inputs. The
copy's tests run at ``ROW_BLOCK`` 1, 7 and 64 (many blocks, a block of one
row among them) and at its default, which holds every design here in one
block.

Tolerances (``tests/test_kernels.py``): f64 1e-12, f32 1e-6, bf16 values x
f32 1e-2 of each column's sum of |terms| — a bound on any summation order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_ml_tpu.kernels import ell as jax_ell
from photon_ml_tpu.ops import sparse as jax_sparse
from photon_ml_tpu_torch.kernels import colsort, dispatch
from photon_ml_tpu_torch.kernels.colsort import (
    BLOCK_FIELDS,
    TILE,
    block_bytes,
    build_design_columns,
    column_reduce,
    column_reduce_reference,
    column_values,
    design_columns,
    reduce_scratch,
    rows_per_block,
    run_chains,
    wide_sums,
)
from photon_ml_tpu_torch.kernels.ell import ell_colsum_reference, ell_rmatvec_reference

RTOL = {"float64": 1e-12, "float32": 1e-6, "bfloat16": 1e-2}
TORCH = {"float64": torch.float64, "float32": torch.float32, "bfloat16": torch.bfloat16}
# (values dtype in jax, the vector's dtype)
JAX = {"float64": (jnp.float64, np.float64), "float32": (jnp.float32, np.float32),
       "bfloat16": (jnp.bfloat16, np.float32)}

# (n, k, d, padded slots per row, duplicate ids, hot columns): several
# tiles with runs that cross them, padding, in-row duplicates, one column
CASES = [
    (37, 5, 300, 2, True, 0),
    (1500, 8, 50, 1, True, 0),  # about 240 entries a column: runs cross tiles
    (700, 40, 1 << 12, 3, True, 14),  # the Criteo layout's hot columns
    (300, 4, 1, 0, False, 0),  # one column: one chain over every tile
    (9, 3, 17, 3, False, 0),  # every slot is padding
]
# ROW_BLOCK: many blocks (one row each, an odd count, 64 rows), and the
# default (None), above every n here: one block
ROW_BLOCKS = [1, 7, 64, None]


@pytest.fixture
def row_block(request, monkeypatch):
    """``colsort.ROW_BLOCK`` set to the test's parameter (None: left at
    its default); the rows of a block."""
    if request.param is not None:
        monkeypatch.setattr(colsort, "ROW_BLOCK", request.param)
    return colsort.ROW_BLOCK


def _blocked(idx, d, rows):
    """The copy the build must make, from numpy: per block of ``rows`` rows,
    the stable sort of its slots by column, the valid ones padded with
    column d to whole tiles. (cols, local slots, block lines (first row,
    first tile, end tile, entries))."""
    n, k = idx.shape
    cols, slots, lines, tile = [], [], [], 0
    for r0 in range(0, n, rows):
        key = idx[r0:r0 + rows].reshape(-1)
        key = np.where((key >= 0) & (key < d), key, d)
        order = np.argsort(key, kind="stable")
        nv = int((key < d).sum())
        size = -(-nv // TILE) * TILE
        c = np.full(size, d, np.int64)
        c[:nv] = key[order[:nv]]
        sl = np.zeros(size, np.int64)
        sl[:nv] = order[:nv]
        cols.append(c)
        slots.append(sl)
        lines.append((r0, tile, tile + size // TILE, nv))
        tile += size // TILE
    if not cols:
        return np.zeros(0, np.int64), np.zeros(0, np.int64), lines
    return np.concatenate(cols), np.concatenate(slots), lines


def _ell(rng, n, k, d, pad, dup, hot, dtype):
    idx = rng.integers(0, d, size=(n, k)).astype(np.int32)
    if hot:
        idx[:, :hot] = rng.permutation(d)[:hot]
    val = rng.standard_normal((n, k))
    if pad:
        idx[:, k - pad:] = d
        val[:, k - pad:] = 0.0
    if dup and k - pad >= 2:
        idx[::2, 1] = idx[::2, 0]
    if dtype == "bfloat16":
        val = np.array(jnp.asarray(val, jnp.bfloat16).astype(jnp.float32))
    return idx, val


def _col_abs(idx, terms, d):
    ids = np.where((idx >= 0) & (idx < d), idx, d)
    out = np.zeros(d + 1)
    np.add.at(out, ids.reshape(-1), np.abs(np.asarray(terms, np.float64)).reshape(-1))
    return out[:d]


def _close(got, ref, rtol, scale):
    err = np.abs(np.asarray(got, np.float64) - np.asarray(ref, np.float64))
    assert np.all(err <= rtol * scale), (err.max(), scale.max())


# -- the copy -------------------------------------------------------------------


@pytest.mark.parametrize("row_block", ROW_BLOCKS, indirect=True)
@pytest.mark.parametrize("n,k,d,pad,dup,hot", CASES)
def test_copy_is_built_the_same_way_twice(rng, row_block, n, k, d, pad, dup, hot):
    idx, _ = _ell(rng, n, k, d, pad, dup, hot, "float64")
    a = build_design_columns(torch.from_numpy(idx), d)
    b = build_design_columns(torch.from_numpy(idx.copy()), d)
    for name in ("cols", "perm", "chains", "blocks"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name
    assert (a.nvalid, a.n, a.k, a.d, a.row_block) == (b.nvalid, n, k, d, row_block)
    assert a.nblocks == -(-n // row_block) and a.blocks.shape[1] == BLOCK_FIELDS


@pytest.mark.parametrize("row_block", ROW_BLOCKS, indirect=True)
@pytest.mark.parametrize("n,k,d,pad,dup,hot", CASES)
def test_copy_keeps_rows_in_order_and_drops_padding(rng, row_block, n, k, d, pad, dup, hot):
    idx, val = _ell(rng, n, k, d, pad, dup, hot, "float64")
    copy = build_design_columns(torch.from_numpy(idx), d)
    cols, perm = copy.cols.numpy(), copy.perm.numpy()
    rows = copy.entry_rows().numpy()
    valid = (idx >= 0) & (idx < d)
    assert copy.nvalid == valid.sum() and perm.dtype == np.int32
    assert cols.shape == perm.shape and cols.shape[0] % TILE == 0
    flat_val = val.reshape(-1)
    lay = copy.layout(torch.from_numpy(val)).numpy()
    seen = 0
    for r0, t0, t1, c0, c1, nv, named in copy.blocks.tolist():
        r1 = min(r0 + row_block, n)
        e0, e1 = t0 * TILE, t1 * TILE
        # each block padded to whole tiles, and only at its tail
        assert e1 - e0 - nv < TILE or (nv == 0 and e1 == e0)
        assert np.all(cols[e0 + nv:e1] == d) and np.all(cols[e0:e0 + nv] < d)
        assert not perm[e0 + nv:e1].any() and not lay[e0 + nv:e1].any()
        c, sl, r = cols[e0:e0 + nv], perm[e0:e0 + nv].astype(np.int64), rows[e0:e0 + nv]
        # sorted by column; within a column by row, then by slot
        assert np.all(np.diff(c) >= 0)
        assert np.all(np.diff(sl)[np.diff(c) == 0] > 0)
        # the local slot + the block's first slot is the flat slot, and the
        # row follows from it
        flat = r0 * k + sl
        assert np.all((sl >= 0) & (sl < (r1 - r0) * k))
        assert np.array_equal(r, flat // k) and np.array_equal(c, idx.reshape(-1)[flat])
        assert nv == valid[r0:r1].sum() and named == np.unique(c).size
        assert np.array_equal(lay[e0:e0 + nv], flat_val[flat])
        seen += nv
        # an in-row duplicate stays two entries
        if dup and k - pad >= 2 and nv:
            assert len(set(zip(r.tolist(), c.tolist()))) <= nv
    assert seen == copy.nvalid
    if dup and k - pad >= 2:
        pairs = set(zip(rows[cols < d].tolist(), cols[cols < d].tolist()))
        assert len(pairs) < copy.nvalid


@pytest.mark.parametrize("row_block", ROW_BLOCKS, indirect=True)
@pytest.mark.parametrize("chunk", [7, 64, 1000, 1 << 24])
@pytest.mark.parametrize("n,k,d,pad,dup,hot", CASES)
def test_copy_in_chunks_is_the_stable_sort_of_every_slot(rng, monkeypatch, row_block, n, k, d,
                                                         pad, dup, hot, chunk):
    idx, _ = _ell(rng, n, k, d, pad, dup, hot, "float64")
    cols, slots, lines = _blocked(idx, d, row_block)
    monkeypatch.setattr(colsort, "BUILD_CHUNK", chunk)
    copy = build_design_columns(torch.from_numpy(idx), d)
    assert np.array_equal(copy.cols.numpy(), cols)
    assert np.array_equal(copy.perm.numpy(), slots)
    assert [(r0, t0, t1, nv) for r0, t0, t1, _, _, nv, _ in copy.blocks.tolist()] == lines
    assert copy.nvalid == sum(nv for *_, nv in lines)


@pytest.mark.parametrize("n,k,d,pad,dup,hot", CASES)
def test_one_block_is_the_stable_sort_of_the_whole_design(rng, n, k, d, pad, dup, hot):
    # a design of at most ROW_BLOCK rows keeps the single sort's layout:
    # every slot sorted stably by column, padded at the tail
    idx, _ = _ell(rng, n, k, d, pad, dup, hot, "float64")
    flat = idx.reshape(-1)
    key = np.where((flat >= 0) & (flat < d), flat, d)
    order = np.argsort(key, kind="stable")
    nvalid = int((key < d).sum())
    assert n <= colsort.ROW_BLOCK
    copy = build_design_columns(torch.from_numpy(idx), d)
    assert copy.nblocks == 1 and copy.nvalid == nvalid
    assert copy.blocks.tolist()[0][:3] == [0, 0, -(-nvalid // TILE)]
    assert np.array_equal(copy.perm[:nvalid].numpy(), order[:nvalid])
    assert np.array_equal(copy.cols[:nvalid].numpy(), key[order[:nvalid]])
    assert np.array_equal(copy.entry_rows()[:nvalid].numpy(), order[:nvalid] // k)
    assert not copy.perm[nvalid:].any() and np.all(copy.cols[nvalid:].numpy() == d)


def test_copy_drops_every_id_outside_the_table():
    idx = torch.tensor([[0, 3, 3], [-1, 1, 5], [2**31 - 1, 1, 2]], dtype=torch.int32)
    copy = build_design_columns(idx, 3)
    assert copy.nvalid == 4
    assert copy.cols[:4].tolist() == [0, 1, 1, 2]
    assert copy.entry_rows()[:4].tolist() == [0, 1, 2, 2]


def test_blocks_of_wide_rows_keep_their_slots_in_int32(monkeypatch):
    # ROW_BLOCK * k at most 2^31 - 1, so a block's slot is int32 at any n
    assert rows_per_block(40) == colsort.ROW_BLOCK
    assert rows_per_block(1 << 12) == (2**31 - 1) >> 12
    assert rows_per_block(2**31) == 1 and rows_per_block(0) == colsort.ROW_BLOCK
    monkeypatch.setattr(colsort, "ROW_BLOCK", 2**40)
    assert rows_per_block(40) * 40 <= 2**31 - 1


@pytest.mark.parametrize("row_block", ROW_BLOCKS, indirect=True)
@pytest.mark.parametrize("n,k,d,pad,dup,hot", CASES)
def test_chains_cover_every_run_that_crosses_a_tile(rng, row_block, n, k, d, pad, dup, hot):
    idx, _ = _ell(rng, n, k, d, pad, dup, hot, "float64")
    copy = build_design_columns(torch.from_numpy(idx), d)
    tiles = copy.cols.view(-1, TILE).numpy()
    want, spans = [], []
    for _, t0, t1, _, _, _, _ in copy.blocks.tolist():
        spans.append((len(want), t0, t1))
        block = tiles[t0:t1]
        for col in np.unique(block[block < d]):
            where = np.nonzero((block == col).any(1))[0]
            if where.size > 1:
                want.append([int(col), t0 + int(where[0]), t0 + int(where[-1])])
    assert copy.chains.tolist() == want
    # each block's chains are its own run of lines, within its tiles
    for (c0, t0, t1), (_, _, _, b0, b1, _, _) in zip(spans, copy.blocks.tolist()):
        assert b0 == c0
        assert all(t0 <= first < last < t1 for _, first, last in want[b0:b1])
    assert copy.blocks[-1, 4] == len(want) if copy.nblocks else not want


def test_run_chains_on_hand_made_tiles():
    head = torch.tensor([1, 1, 1, 4, 4])
    tail = torch.tensor([1, 1, 3, 4, 6])
    assert run_chains(head, tail, head < 9).tolist() == [[1, 0, 2], [4, 3, 4]]
    assert run_chains(head[:1], tail[:1], head[:1] < 9).tolist() == []


def test_copy_is_kept_with_its_indices_tensor(rng):
    idx, val = _ell(rng, 200, 6, 90, 1, True, 0, "float64")
    t_idx, t_val = torch.from_numpy(idx), torch.from_numpy(val)
    copy = design_columns(t_idx, 90)
    assert design_columns(t_idx, 90) is copy
    laid = column_values(copy, t_val)
    assert column_values(copy, t_val) is laid
    # a new values table over the same indices: the same copy, a new layout
    other = t_val * 2.0
    assert column_values(copy, other) is not laid
    # another width, or the indices changed in place, build anew
    assert design_columns(t_idx, 91) is not copy
    again = design_columns(t_idx, 90)
    t_idx[0, 0] = (t_idx[0, 0] + 1) % 90
    rebuilt = design_columns(t_idx, 90)
    assert rebuilt is not again and rebuilt.token != again.token
    assert column_values(rebuilt, t_val) is not laid


def test_copy_is_built_anew_for_another_row_block(rng, monkeypatch):
    idx, _ = _ell(rng, 200, 6, 90, 1, True, 0, "float64")
    t_idx = torch.from_numpy(idx)
    copy = design_columns(t_idx, 90)
    assert copy.nblocks == 1 and design_columns(t_idx, 90) is copy
    monkeypatch.setattr(colsort, "ROW_BLOCK", 64)
    blocked = design_columns(t_idx, 90)
    assert blocked is not copy and blocked.row_block == 64 and blocked.nblocks == 4
    assert design_columns(t_idx, 90) is blocked


def test_copy_is_dropped_with_its_tensor(rng):
    idx, _ = _ell(rng, 50, 4, 30, 0, False, 0, "float64")
    t_idx = torch.from_numpy(idx.copy())
    design_columns(t_idx, 30)
    held = len(colsort._copies._items)
    del t_idx
    assert len(colsort._copies._items) == held - 1


@pytest.mark.parametrize("row_block", [1, None], indirect=True)
def test_nbytes_counts_the_copy(row_block):
    idx = torch.zeros((3, 2), dtype=torch.int32)
    copy = build_design_columns(idx, 4)
    # per block one tile of int32 columns and slots (8 bytes an entry), no
    # chains; the block table lives on the host
    tiles = 3 if row_block == 1 else 1
    assert copy.ntiles == tiles and copy.blocks.device.type == "cpu"
    assert copy.nbytes() == tiles * TILE * 8
    assert copy.nbytes(8) == copy.nbytes() + tiles * TILE * 8


@pytest.mark.parametrize("row_block", [7, None], indirect=True)
def test_reduce_scratch_holds_the_edges_and_the_wide_sums(rng, row_block):
    idx, _ = _ell(rng, 1500, 8, 50, 1, True, 0, "float64")
    copy = build_design_columns(torch.from_numpy(idx), 50)
    many = copy.nblocks > 1
    for mode, cd, size in (("linear", torch.float32, 2 * copy.ntiles),
                           ("pair", torch.float64, 4 * copy.ntiles),
                           ("pair", torch.float32, 4 * copy.ntiles + (100 if many else 0))):
        wide = many and mode == "pair" and cd == torch.float32
        assert wide_sums(copy, mode, cd) == wide
        scratch = reduce_scratch(copy, mode, cd, "cpu")
        assert scratch.dtype == torch.float64 and scratch.numel() == size
        # the wide sums: f64 reads and writes of the later blocks' columns,
        # and the (2, d) sums written and read again
        named_later = int(copy.blocks[1:, 6].sum())
        assert block_bytes(copy, mode, cd) == (
            2 * colsort.REDUCE_MODES[mode] * (8 if wide else cd.itemsize) * named_later
            + (2 * 2 * 50 * 8 if wide else 0))


# -- the reduce's plain version against the JAX kernels --------------------------


@pytest.mark.parametrize("row_block", ROW_BLOCKS, indirect=True)
@pytest.mark.parametrize("dtype", ["float64", "float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["linear", "square", "pair"])
@pytest.mark.parametrize("n,k,d,pad,dup,hot", CASES)
def test_reduce_matches_jax_pallas_and_xla(rng, row_block, n, k, d, pad, dup, hot, mode,
                                           dtype):
    idx, val = _ell(rng, n, k, d, pad, dup, hot, dtype)
    a = np.abs(rng.standard_normal(n)).astype(JAX[dtype][1]) + 0.1
    t_val = torch.from_numpy(val).to(TORCH[dtype])
    copy = build_design_columns(torch.from_numpy(idx), d)
    before = dispatch.launch_counts()["colsort_reduce"]
    got = column_reduce(copy, copy.layout(t_val), torch.from_numpy(a), mode)
    assert dispatch.launch_counts()["colsort_reduce"] == before  # CPU: no launch
    wants = _jax_sums(idx, val, a, d, dtype, mode)
    outs = got if mode == "pair" else (got,)
    assert len(outs) == len(wants)
    for out, (pallas, xla, terms) in zip(outs, wants):
        assert out.dtype == (torch.float64 if dtype == "float64" else torch.float32)
        assert out.shape == (d,)
        scale = _col_abs(idx, terms, d)
        _close(out.double().numpy(), pallas, RTOL[dtype], scale)
        _close(out.double().numpy(), xla, RTOL[dtype], scale)


# the JAX package's sums of one input, kept by its bytes: every ROW_BLOCK
# of a case is held to the same Pallas and XLA outputs
_JAX_SUMS = {}


def _jax_sums(idx, val, a, d, dtype, mode):
    """[(Pallas sums, XLA sums, terms)] of ``mode``: ``ell_rmatvec`` /
    ``rmatvec`` (linear), ``ell_colsum`` / ``colsum`` squared (square),
    squared then plain (pair)."""
    key = (idx.tobytes(), np.asarray(val).tobytes(), a.tobytes(), d, dtype, mode)
    if key not in _JAX_SUMS:
        j_idx, j_val, j_a = jnp.asarray(idx), jnp.asarray(val, JAX[dtype][0]), jnp.asarray(a)
        sf = jax_sparse.SparseFeatures(j_idx, j_val, d)
        v64 = np.asarray(val, np.float64)
        if mode == "linear":
            calls = [(lambda: jax_ell.ell_rmatvec(j_idx, j_val, j_a, d),
                      lambda: jax_sparse.rmatvec(sf, j_a), v64 * a[:, None])]
        else:
            calls = [(lambda: jax_ell.ell_colsum(j_idx, j_val, j_a, d, square=True),
                      lambda: jax_sparse.colsum(sf, j_a, square=True), v64 * v64 * a[:, None])]
        if mode == "pair":
            calls.append((lambda: jax_ell.ell_colsum(j_idx, j_val, j_a, d),
                          lambda: jax_sparse.colsum(sf, j_a), v64 * a[:, None]))
        _JAX_SUMS[key] = [(np.asarray(pallas(), np.float64), np.asarray(xla(), np.float64),
                           terms) for pallas, xla, terms in calls]
    return _JAX_SUMS[key]


@pytest.mark.parametrize("row_block", ROW_BLOCKS, indirect=True)
@pytest.mark.parametrize("n,k,d,pad,dup,hot", CASES)
def test_reduce_equals_the_scatter_in_slot_order(rng, row_block, n, k, d, pad, dup, hot):
    # in f64 the column-sorted order adds each column's slots in the ELL's
    # slot order (block after block, each in slot order), as the CPU
    # scatter does: the same bits
    idx, val = _ell(rng, n, k, d, pad, dup, hot, "float64")
    a = rng.standard_normal(n)
    t_idx, t_val, t_a = torch.from_numpy(idx), torch.from_numpy(val), torch.from_numpy(a)
    copy = build_design_columns(t_idx, d)
    lay = copy.layout(t_val)
    assert torch.equal(column_reduce_reference(copy, lay, t_a, "linear"),
                       ell_rmatvec_reference(t_idx, t_val, t_a, d))
    assert torch.equal(column_reduce_reference(copy, lay, t_a, "square"),
                       ell_colsum_reference(t_idx, t_val, t_a, d, square=True))


def test_reduce_takes_values_outside_the_kernel_pairs_in_the_compute_type(rng):
    idx, val = _ell(rng, 60, 5, 40, 1, False, 0, "float32")
    copy = build_design_columns(torch.from_numpy(idx), 40)
    a = torch.from_numpy(rng.standard_normal(60))  # f64
    lay = copy.layout(torch.from_numpy(val.astype(np.float32)))
    got = column_reduce(copy, lay, a, "linear")
    assert got.dtype == torch.float64
    want = column_reduce_reference(copy, lay.double(), a, "linear")
    assert torch.equal(got, want)


def test_reduce_raises_on_other_modes_and_shapes(rng):
    idx, val = _ell(rng, 20, 3, 10, 0, False, 0, "float64")
    copy = build_design_columns(torch.from_numpy(idx), 10)
    lay = copy.layout(torch.from_numpy(val))
    with pytest.raises(ValueError, match="mode"):
        column_reduce(copy, lay, torch.ones(20, dtype=torch.float64), "cube")
    with pytest.raises(ValueError, match=r"\(20,\)"):
        column_reduce(copy, lay, torch.ones(19, dtype=torch.float64))
    with pytest.raises(TypeError, match="column_reduce"):
        column_reduce(copy, lay.to(torch.bfloat16), torch.ones(20, dtype=torch.bfloat16))


@pytest.mark.parametrize("row_block,d", [(None, 43), (7, 47)], indirect=["row_block"])
def test_reduce_cost_counts_the_least_traffic_as_its_roofline(rng, row_block, d):
    n, k = 300, 5  # widths no other test records
    idx, val = _ell(rng, n, k, d, 2, False, 0, "float64")
    copy = build_design_columns(torch.from_numpy(idx), d)
    lay = copy.layout(torch.from_numpy(val))
    column_reduce(copy, lay, torch.ones(n, dtype=torch.float64))
    cost = dispatch.kernel_costs()[("colsort_reduce", copy.nvalid, 1, d, 8)]
    # the least traffic: each entry's column id and value once; beyond it
    # the slots, the tiles' padding's three words, a and g, and each later
    # block's second read and write of the columns it names
    pad = copy.cols.shape[0] - copy.nvalid
    named_later = int(copy.blocks[1:, 6].sum())
    assert (named_later > 0) == (copy.nblocks > 1)
    assert block_bytes(copy, "linear", torch.float64) == 2 * 8 * named_later
    assert cost["roofline_bytes"] == copy.nvalid * (4 + 8)
    assert cost["analytic_bytes"] == (cost["roofline_bytes"] + 4 * copy.nvalid + pad * 16
                                      + n * 8 + d * 8 + 2 * 8 * named_later)
