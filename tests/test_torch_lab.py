"""The port's sparse kernel lab on the CPU against the JAX lab's own Pallas
kernels (``benchmarks/sparse_kernel_lab.py``, unchanged).

A module fixture runs the JAX lab's ``main()`` once per shape under
``jax.disable_jit()``, with ``pl.pallas_call`` patched to add
``interpret=True`` and record each call's kernel, inputs and output. The
port's layout and its kernels' plain versions (which the wrappers take for
CPU tensors) are held to those records:

- ``column_sorted_tiles`` equals the lab's ``psc``, ``psv``,
  ``tile_block`` and ``first_of_block`` exactly, and its rows give C2's
  update bit for bit;
- ``lane_gather`` and ``onehot_gather`` equal the Pallas outputs bit for
  bit (NaN bits too, for ids outside the row);
- ``onehot_reduce`` is within 1e-6 of each column's sum of |upd| of the
  f64 sum, and within 2e-6 of it from the Pallas output, on every block
  that has tiles.
"""

import contextlib
import dataclasses
import io
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import benchmarks.sparse_kernel_lab as jax_lab
from photon_ml_tpu_torch.benchmarks import sparse_kernel_lab as lab
from photon_ml_tpu_torch.interop import lab_tiles_from_numpy
from photon_ml_tpu_torch.kernels import dispatch
from photon_ml_tpu_torch.kernels import launch
from photon_ml_tpu_torch.kernels import lab as kernels_lab
from photon_ml_tpu_torch.kernels.lab import (
    LAB_BLOCK,
    LAB_CHUNK,
    ColumnTiles,
    column_sorted_tiles,
    lane_gather,
    lane_gather_reference,
    onehot_gather,
    onehot_reduce,
    onehot_reduce_reference,
    tile_chains,
)

# (n, k, d): a small shape with 6 tiles, and one with 24 tiles whose head
# column spans three of them; neither d is a multiple of 512
SHAPES = [(600, 8, 1500), (3000, 8, 1100)]
LINES = ("A1", "A2", "B ", "C  prep", "C1", "C2")


class Recorder:
    """Stands in for ``pl.pallas_call``: the real one with
    ``interpret=True``, keeping the first and last two calls of each
    kernel (name -> [(inputs, output)]) and each kernel's callable."""

    def __init__(self, real):
        self.real = real
        self.calls = {}
        self.fns = {}

    def __call__(self, kernel, **kw):
        fn = self.real(kernel, interpret=True, **kw)
        name = kernel.__name__

        def call(*args):
            out = fn(*args)
            calls = self.calls.setdefault(name, [])
            calls.append(([np.asarray(a) for a in args], np.asarray(out)))
            if len(calls) > 3:
                del calls[1]
            self.fns[name] = fn
            return out

        return call


@pytest.fixture(scope="module")
def jax_runs():
    runs = {}
    for shape in SHAPES:
        rec = Recorder(pl.pallas_call)
        argv = sys.argv
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(pl, "pallas_call", rec)
            sys.argv = ["lab", *map(str, shape)]
            try:
                with jax.disable_jit(), contextlib.redirect_stdout(io.StringIO()) as out:
                    jax_lab.main()
            finally:
                sys.argv = argv
        assert set(rec.calls) == {"lane_gather_kernel", "onehot_gather_kernel",
                                  "onehot_reduce_kernel"}, out.getvalue()
        runs[shape] = rec
    return runs


def _tiles(shape) -> ColumnTiles:
    n, k, d = shape
    cols, vals = lab.make_data(n, k, d)
    return column_sorted_tiles(torch.from_numpy(cols), torch.from_numpy(vals), d)


def _lab_shaped(t: torch.Tensor) -> np.ndarray:
    return t.numpy().reshape(t.shape[0], 8, 128)


def _bits(x) -> np.ndarray:
    return np.asarray(x, np.float32).view(np.int32)


@pytest.mark.parametrize("shape", SHAPES)
def test_make_data_is_the_labs(shape):
    for ours, theirs in zip(lab.make_data(*shape), jax_lab.make_data(*shape)):
        assert ours.dtype == theirs.dtype and np.array_equal(ours, theirs)


@pytest.mark.parametrize("shape", SHAPES)
def test_layout_equals_the_labs(jax_runs, shape):
    n, _, d = shape
    tiles = _tiles(shape)
    (tb, psc, psv, w_blk), _ = jax_runs[shape].calls["onehot_gather_kernel"][-1]
    (_, fb, _, upd), _ = jax_runs[shape].calls["onehot_reduce_kernel"][-1]
    assert tiles.nblocks * LAB_BLOCK == w_blk.size and tiles.d == d
    assert np.array_equal(_lab_shaped(tiles.cols), psc)
    assert np.array_equal(tiles.vals.numpy().view(np.int32), psv.reshape(-1, 1024).view(np.int32))
    assert np.array_equal(tiles.tile_block.numpy(), tb)
    assert np.array_equal(tiles.first_of_block.numpy(), fb)
    # the last reduce call takes the unperturbed a: upd = psv * a[psr]
    a0 = torch.from_numpy(np.random.default_rng(2).standard_normal(n).astype(np.float32))
    assert np.array_equal(_bits(lab.row_gather(tiles, a0)), _bits(upd.reshape(-1, 1024)))


def test_lane_gather_equals_the_pallas_kernel(jax_runs):
    """Every recorded call (the same at both shapes: B does not depend on
    the shape), bit for bit."""
    for (idx, tbl), out in jax_runs[SHAPES[0]].calls["lane_gather_kernel"]:
        got = lane_gather(torch.from_numpy(np.array(tbl)), torch.from_numpy(np.array(idx)))
        assert np.array_equal(_bits(got), _bits(out))


def test_lane_gather_ids_outside_the_row_follow_the_pallas_kernel(jax_runs):
    """take_along_axis's contract, from the lab's kernel in interpret mode:
    ids in [-128, 0) count from the row's end, others read NaN."""
    rng = np.random.default_rng(11)
    tbl = rng.standard_normal((8192, 128)).astype(np.float32)
    idx = rng.integers(-300, 300, size=(8192, 128)).astype(np.int32)
    out = np.asarray(jax_runs[SHAPES[0]].fns["lane_gather_kernel"](idx, tbl))
    got = lane_gather_reference(torch.from_numpy(tbl), torch.from_numpy(idx))
    assert np.isnan(out).any() and np.array_equal(_bits(got), _bits(out))


@pytest.mark.parametrize("shape", SHAPES)
def test_onehot_gather_equals_the_pallas_kernel(jax_runs, shape):
    """On the lab's arrays carried across, for each recorded call, and on
    the port's own layout with the lab's w: bit for bit."""
    d = shape[2]
    for (tb, psc, psv, w_blk), out in jax_runs[shape].calls["onehot_gather_kernel"]:
        _, fb, _, _ = jax_runs[shape].calls["onehot_reduce_kernel"][-1][0]
        tiles, w_pad = lab_tiles_from_numpy(psc, psc * 0, psv, tb, fb, w_blk)
        got = onehot_gather(tiles, w_pad)
        assert np.array_equal(_bits(got), _bits(out.reshape(-1, 1024)))
        ours = onehot_gather(_tiles(shape), w_pad[:d])
        assert np.array_equal(_bits(ours), _bits(out.reshape(-1, 1024)))


@pytest.mark.parametrize("shape", SHAPES)
def test_onehot_reduce_is_within_1e6_of_the_f64_sum_and_the_pallas_kernel(jax_runs, shape):
    tiles = _tiles(shape)
    blocks_with_tiles = np.unique(tiles.tile_block.numpy())
    for (tb, fb, psc, upd), out in jax_runs[shape].calls["onehot_reduce_kernel"]:
        u = torch.from_numpy(upd.reshape(-1, 1024))
        got = onehot_reduce(tiles, u)
        ref64 = onehot_reduce_reference(tiles, u.double())
        scale = onehot_reduce_reference(tiles, u.abs().double())
        assert got.dtype == torch.float32 and got.shape == (tiles.nblocks * LAB_BLOCK,)
        err = (got.double() - ref64).abs()
        assert torch.all(err <= 1e-6 * scale)
        jax_err = np.abs(out.reshape(-1, LAB_BLOCK)[blocks_with_tiles].astype(np.float64)
                         - ref64.numpy().reshape(-1, LAB_BLOCK)[blocks_with_tiles])
        assert np.all(jax_err <= 2e-6 * scale.numpy().reshape(-1, LAB_BLOCK)[blocks_with_tiles])
    # every block has tiles at these shapes: the TPU kernel's unwritten
    # blocks do not arise
    assert len(blocks_with_tiles) == tiles.nblocks


@pytest.mark.parametrize("shape", SHAPES)
def test_lab_tiles_from_numpy_round_trips(jax_runs, shape):
    tiles = _tiles(shape)
    w = torch.from_numpy(np.random.default_rng(1).standard_normal(shape[2]).astype(np.float32))
    w_pad = torch.zeros(tiles.nblocks * LAB_BLOCK)
    w_pad[:tiles.d] = w
    back, w_back = lab_tiles_from_numpy(
        _lab_shaped(tiles.cols), _lab_shaped(tiles.rows), _lab_shaped(tiles.vals),
        tiles.tile_block.numpy(), tiles.first_of_block.numpy(), w_pad.numpy().reshape(-1, 64))
    for name in ("cols", "rows", "vals", "tile_block", "first_of_block", "chains"):
        assert torch.equal(getattr(back, name), getattr(tiles, name)), name
    assert back.nblocks == tiles.nblocks and back.cols.shape == tiles.cols.shape
    assert back.d == tiles.nblocks * LAB_BLOCK and torch.equal(w_back, w_pad)
    # and the lab's own arrays carried across give the port's layout
    (tb, psc, psv, w_blk), _ = jax_runs[shape].calls["onehot_gather_kernel"][-1]
    theirs, _ = lab_tiles_from_numpy(psc, _lab_shaped(tiles.rows), psv, tb,
                                     tiles.first_of_block.numpy(), w_blk)
    assert torch.equal(theirs.chains, tiles.chains)


@pytest.mark.parametrize("shape", SHAPES)
def test_port_lab_prints_the_labs_lines_on_the_cpu(shape, capsys):
    out = lab.main([str(v) for v in shape], device="cpu")
    lines = capsys.readouterr().out.splitlines()
    assert [next((ln for ln in lines if ln.startswith(label)), None) is not None
            for label in LINES] == [True] * len(LINES)
    records = {r["line"]: r for r in out["records"]}
    assert set(records) == {"A1", "A2", "B", "C prep", "C1", "C2"}
    assert all(r["clock"] == "host clock" for r in records.values())
    assert records["C1"]["max_err_share"] <= 1e-5 and records["C2"]["max_err_share"] <= 1e-5
    assert records["C prep"]["tiles"] == out["inputs"].tiles.ntiles


def test_port_lab_entry_point_runs_on_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        lab.main(["600", "8", "1500"])


# -- the layout and the reduce's decomposition, beyond the lab's data --------


def _lab_layout(cols, vals, n, k, d):
    """The lab's layout code (its section C), for designs the lab never
    draws: returns (psc, psr, psv, tile_block, first_of_block)."""
    block, tile = LAB_BLOCK, 1024
    flat_cols = cols.reshape(-1)
    flat_rows = np.repeat(np.arange(n, dtype=np.int32), k)
    flat_vals = vals.reshape(-1)
    order = np.argsort(flat_cols, kind="stable")
    sc, sr, sv = flat_cols[order], flat_rows[order], flat_vals[order]
    blk = sc // block
    nblocks = (d + block - 1) // block
    counts = np.bincount(blk, minlength=nblocks)
    padded = ((counts + tile - 1) // tile) * tile
    starts = np.concatenate([[0], np.cumsum(padded)])[:-1]
    src_starts = np.concatenate([[0], np.cumsum(counts)])[:-1]
    psc = np.full(int(padded.sum()), block, np.int32)
    psr = np.zeros(int(padded.sum()), np.int32)
    psv = np.zeros(int(padded.sum()), np.float32)
    for b in range(nblocks):
        s, c = src_starts[b], counts[b]
        psc[starts[b]:starts[b] + c] = sc[s:s + c] - b * block
        psr[starts[b]:starts[b] + c] = sr[s:s + c]
        psv[starts[b]:starts[b] + c] = sv[s:s + c]
    tile_block = np.repeat(np.arange(nblocks, dtype=np.int32), padded // tile)
    first = np.zeros(len(tile_block), np.int32)
    first[np.concatenate([[0], np.cumsum(padded // tile)])[:-1][padded // tile > 0]] = 1
    return psc, psr, psv, tile_block, first


def _design(case):
    """(indices, values, d) of a named design, with padding slots (id d)."""
    rng = np.random.default_rng(5)
    if case == "empty_block":  # blocks 1 and 3 named by no entry
        d, n, k = 2500, 700, 6
        idx = rng.choice(np.r_[0:512, 1024:1536, 2048:2500], size=(n, k))
    elif case == "one_column_many_tiles":  # column 700 in 4 tiles, then others
        d, n, k = 1800, 900, 5
        idx = rng.integers(0, d, size=(n, k))
        idx[:, :4] = 700
    elif case == "whole_tiles":  # exactly 1024 entries in block 0
        d, n, k = 1500, 512, 3
        idx = np.concatenate([rng.integers(0, 512, (n, 2)), rng.integers(512, d, (n, 1))], 1)
    elif case == "d_one":
        d, n, k = 1, 2100, 1
        idx = np.zeros((n, k))
    else:
        raise KeyError(case)
    idx = idx.astype(np.int32)
    vals = rng.standard_normal((n, k)).astype(np.float32)
    idx[::7, -1] = d  # padding slots
    vals[::7, -1] = 0.0
    return idx, vals, d


DESIGNS = ["empty_block", "one_column_many_tiles", "whole_tiles", "d_one"]


def _emulate_reduce(tiles: ColumnTiles, upd: np.ndarray, chunk: int = LAB_CHUNK) -> np.ndarray:
    """The CUDA kernel's decomposition, in numpy, in chunks of ``chunk``
    tiles walked in order: each run of a column in a tile is summed; a
    run the next tile of the chunk continues is carried, and the next
    tile adds its part; a run that began and ends in the chunk goes to g,
    the chunk's first run to its left partial when the previous chunk
    continues it, its last run to its right partial when the next chunk
    does; each tile writes 0 to the columns no entry names in its range
    (from where the previous tile's range ended to the next tile's first
    column, block or ``width``). Then each chain that crosses a chunk
    edge adds its first chunk's right partial and the later chunks' left
    partials. Asserts that every column of g is written exactly once."""
    cols = tiles.cols.numpy()
    tb = tiles.tile_block.numpy()
    ntiles = cols.shape[0]
    width = tiles.nblocks * LAB_BLOCK
    g = np.full(width, np.nan)
    writes = np.zeros(width, np.int64)

    def put(lo, hi, value):
        g[lo:hi] = value
        writes[lo:hi] += 1

    nchunks = -(-ntiles // chunk)
    edge = np.full((nchunks, 2), np.nan)
    for c in range(nchunks):
        t0, t1 = c * chunk, min((c + 1) * chunk, ntiles)
        carry, carry_open = np.nan, False
        for t in range(t0, t1):
            row, col0 = cols[t], tb[t] * LAB_BLOCK
            first, last = row[0], row[-1]
            prev_same = t > 0 and tb[t - 1] == tb[t]
            next_same = t + 1 < ntiles and tb[t + 1] == tb[t]
            next_first = cols[t + 1, 0] if next_same else LAB_BLOCK
            cont_in = first != LAB_BLOCK and prev_same and cols[t - 1, -1] == first
            cont_out = last != LAB_BLOCK and next_first == last
            lo = 0 if t == 0 else col0 if not prev_same else col0 + first
            hi = (width if t + 1 == ntiles else tb[t + 1] * LAB_BLOCK if not next_same
                  else col0 + next_first)
            named = [x for x in np.unique(row) if x != LAB_BLOCK]
            for i, x in enumerate(named):
                s = upd[t][row == x].astype(np.float64).sum()
                is_open = False
                if cont_in and x == first:
                    if t == t0:
                        is_open = True
                    else:
                        s, is_open = carry + s, carry_open
                if cont_out and x == last:
                    if t + 1 < t1:
                        carry, carry_open = s, is_open
                    else:
                        edge[c, 0 if is_open else 1] = s
                elif is_open:
                    edge[c, 0] = s
                else:
                    put(col0 + x, col0 + x + 1, s)
                if i + 1 < len(named):
                    put(col0 + x + 1, col0 + named[i + 1], 0.0)
            if named:
                put(lo, col0 + named[0], 0.0)
                put(col0 + named[-1] + 1, hi, 0.0)
            else:
                put(lo, hi, 0.0)
    for col, first, last in tiles.chains.numpy():
        cf, cl = first // chunk, last // chunk
        if cf == cl:
            continue
        parts = [edge[cf, 1]] + [edge[k, 0] for k in range(cf + 1, cl + 1)]
        assert not np.isnan(parts).any()
        put(col, col + 1, np.sum(parts))
    assert (writes == 1).all(), np.flatnonzero(writes != 1)[:10]
    return g


@pytest.mark.parametrize("case", DESIGNS)
def test_layout_of_other_designs_equals_the_labs_code(case):
    idx, vals, d = _design(case)
    n, k = idx.shape
    keep = idx.reshape(-1) < d
    rows_kept = np.repeat(np.arange(n), k)[keep]
    tiles = column_sorted_tiles(torch.from_numpy(idx), torch.from_numpy(vals), d)
    # the lab's code on the same entries without the padding slots, as
    # one column of (rows, ids)
    psc, psr, psv, tb, fb = _lab_layout(idx.reshape(-1)[keep][:, None],
                                        vals.reshape(-1)[keep][:, None], keep.sum(), 1, d)
    assert np.array_equal(tiles.cols.numpy().reshape(-1), psc)
    assert np.array_equal(tiles.rows.numpy().reshape(-1), np.where(psc < 512, rows_kept[psr], 0))
    assert np.array_equal(tiles.vals.numpy().reshape(-1), psv)
    assert np.array_equal(tiles.tile_block.numpy(), tb)
    assert np.array_equal(tiles.first_of_block.numpy(), fb)


@pytest.mark.parametrize("case", DESIGNS)
def test_reduce_decomposition_gives_the_column_sums(case):
    """The partials and chains the CUDA kernel writes sum to g, and every
    chain is a column that crosses at least one tile edge."""
    idx, vals, d = _design(case)
    tiles = column_sorted_tiles(torch.from_numpy(idx), torch.from_numpy(vals), d)
    a = torch.from_numpy(np.random.default_rng(9).standard_normal(idx.shape[0]).astype(np.float32))
    upd = lab.row_gather(tiles, a)
    ref64 = onehot_reduce_reference(tiles, upd.double()).numpy()
    scale = onehot_reduce_reference(tiles, upd.abs().double()).numpy()
    for chunk in (1, 3, LAB_CHUNK):
        assert np.all(np.abs(_emulate_reduce(tiles, upd.numpy(), chunk) - ref64)
                      <= 1e-12 * scale)
    got = onehot_reduce(tiles, upd)
    assert torch.all((got.double() - torch.from_numpy(ref64)).abs()
                     <= 1e-6 * torch.from_numpy(scale))
    assert torch.all(tiles.chains[:, 2] > tiles.chains[:, 1])
    if case == "one_column_many_tiles":  # 3000-odd entries of column 700
        assert (tiles.chains[:, 0] == 700).sum() == 1
        (first, last), = tiles.chains[tiles.chains[:, 0] == 700, 1:].tolist()
        assert last - first >= 3
    if case == "empty_block":
        assert set(tiles.tile_block.tolist()) == {0, 2, 4}
        assert float(got.view(-1, 512)[[1, 3]].abs().max()) == 0.0


def test_tile_chains_split_where_the_column_changes():
    """Tiles [5 5 | 5 5 | 5 7 | 7 7 | 7 9], one block: column 5 crosses
    edges 1 and 2, column 7 edges 3 and 4 — two chains, though the four
    crossed edges are consecutive."""
    cols = torch.tensor([[5, 5], [5, 5], [5, 7], [7, 7], [7, 9]], dtype=torch.int32)
    tb = torch.zeros(5, dtype=torch.int32)
    assert tile_chains(cols, tb).tolist() == [[5, 0, 2], [7, 2, 4]]
    # a block edge and the miss never continue a run
    tb2 = torch.tensor([0, 0, 1, 1, 1], dtype=torch.int32)
    assert tile_chains(cols, tb2).tolist() == [[5, 0, 1], [519, 2, 4]]
    miss = torch.tensor([[3, 512], [512, 512]], dtype=torch.int32)
    assert tile_chains(miss, torch.zeros(2, dtype=torch.int32)).tolist() == []


def test_cpu_wrappers_launch_nothing_and_check_their_inputs():
    tiles = _tiles(SHAPES[0])
    w = torch.ones(tiles.d)
    before = dispatch.launch_counts()
    onehot_gather(tiles, w)
    onehot_reduce(tiles, tiles.vals)
    lane_gather(torch.ones((4, 128)), torch.zeros((4, 128), dtype=torch.int32))
    assert dispatch.launch_counts() == before
    assert {"lane_gather", "onehot_gather", "onehot_reduce"} <= set(dispatch.KERNELS)
    with pytest.raises(TypeError, match="float32"):
        onehot_gather(tiles, w.double())
    with pytest.raises(ValueError, match=r"\(1500,\)"):
        onehot_gather(tiles, w[:-1])
    with pytest.raises(ValueError, match="upd"):
        onehot_reduce(tiles, tiles.vals[:-1])
    with pytest.raises(TypeError, match="int32"):
        lane_gather(torch.ones((4, 128)), torch.zeros((4, 128), dtype=torch.int64))
    with pytest.raises(ValueError, match="128"):
        lane_gather(torch.ones((4, 64)), torch.zeros((4, 64), dtype=torch.int32))


@pytest.mark.parametrize("bad", [-1, 1501])
def test_column_sorted_tiles_raises_on_ids_outside_the_table(bad):
    idx = torch.zeros((3, 2), dtype=torch.int32)
    idx[1, 1] = bad
    with pytest.raises(ValueError, match="outside"):
        column_sorted_tiles(idx, torch.ones((3, 2)), 1500)


def test_lab_tiles_from_numpy_raises_on_unsorted_columns():
    psc = np.zeros((1, 8, 128), np.int32)
    psc[0, 0, 1] = 9  # column 9 before column 0 in one block
    with pytest.raises(ValueError, match="sorted"):
        lab_tiles_from_numpy(psc, psc, psc.astype(np.float32), np.zeros(1, np.int32),
                             np.ones(1, np.int32), np.zeros((8, 64), np.float32))


@pytest.mark.parametrize("psc_shape,w_shape", [((1, 4, 256), (8, 64)), ((1, 8, 128), (8, 32)),
                                               ((1, 1024), (8, 64))])
def test_lab_tiles_from_numpy_raises_on_other_shapes(psc_shape, w_shape):
    """The lab's tiles are (ntiles, 8, 128) and its weights (nblocks * 8,
    64): 512-column blocks of 1024-entry tiles, the only layout the port's
    kernels take."""
    psc = np.zeros(psc_shape, np.int32)
    with pytest.raises(ValueError, match="must be"):
        lab_tiles_from_numpy(psc, psc, psc.astype(np.float32), np.zeros(1, np.int32),
                             np.ones(1, np.int32), np.zeros(w_shape, np.float32))


def test_design_of_only_padding_has_no_tiles_and_zero_sums():
    idx = torch.full((5, 3), 700, dtype=torch.int32)
    tiles = column_sorted_tiles(idx, torch.zeros((5, 3)), 700)
    assert tiles.ntiles == 0 and tiles.nblocks == 2 and tiles.chains.shape == (0, 3)
    g = onehot_reduce(tiles, tiles.vals)
    assert g.shape == (2 * LAB_BLOCK,) and not g.any()
    assert onehot_gather(tiles, torch.ones(700)).shape == (0, 1024)


# -- the chunked reduce on more layouts, and the launch path's plans --------


def _with_padding_tile(tiles: ColumnTiles, t: int, block: int) -> ColumnTiles:
    """The same tiles with a tile of only misses after tile ``t``, its block
    ``block``: a valid layout when ``block`` is tile ``t``'s (misses end a
    block) or a block between ``t``'s and the next tile's (a block of only
    padding)."""
    cat = lambda a, b: torch.cat([a[:t + 1], b, a[t + 1:]])  # noqa: E731
    cols = cat(tiles.cols, torch.full_like(tiles.cols[:1], LAB_BLOCK))
    tb = cat(tiles.tile_block, torch.full_like(tiles.tile_block[:1], block))
    first = cat(tiles.first_of_block,
                torch.full_like(tiles.first_of_block[:1], int(block != tiles.tile_block[t])))
    return ColumnTiles(
        cols=cols, rows=cat(tiles.rows, torch.zeros_like(tiles.rows[:1])),
        vals=cat(tiles.vals, torch.zeros_like(tiles.vals[:1])), tile_block=tb,
        first_of_block=first, chains=tile_chains(cols, tb), d=tiles.d, nblocks=tiles.nblocks)


def _layout(case) -> ColumnTiles:
    if case == "zipf":  # 24 tiles, the head column across three
        return _tiles(SHAPES[1])
    if case == "leading_and_trailing_empty_blocks":  # blocks 2 and 3 of 10
        rng = np.random.default_rng(3)
        idx = rng.integers(1024, 2048, size=(900, 4)).astype(np.int32)
        return column_sorted_tiles(torch.from_numpy(idx),
                                   torch.from_numpy(rng.standard_normal((900, 4), np.float32)),
                                   5000)
    idx, vals, d = _design("empty_block")
    tiles = column_sorted_tiles(torch.from_numpy(idx), torch.from_numpy(vals), d)
    last0 = int((tiles.tile_block == 0).sum()) - 1
    if case == "tile_of_only_padding":
        return _with_padding_tile(tiles, last0, 0)
    if case == "block_of_only_padding":  # block 1 holds one tile of misses
        return _with_padding_tile(tiles, last0, 1)
    raise KeyError(case)


@pytest.mark.parametrize("chunk", [1, 2, 5, LAB_CHUNK, 16])
@pytest.mark.parametrize("case", ["zipf", "leading_and_trailing_empty_blocks",
                                  "tile_of_only_padding", "block_of_only_padding"])
def test_chunked_reduce_writes_every_column_once(case, chunk):
    """The chunked decomposition sums to g and writes each column once,
    zeros included, whatever the chunk (a tile count that is no multiple
    of it, runs across several chunks, blocks no tile names, tiles and
    blocks of only padding); on CPU tensors the wrapper is the plain
    version at any chunk."""
    tiles = _layout(case)
    rng = np.random.default_rng(chunk)
    upd = tiles.vals * torch.from_numpy(rng.standard_normal(tiles.cols.shape, np.float32))
    ref64 = onehot_reduce_reference(tiles, upd.double()).numpy()
    scale = onehot_reduce_reference(tiles, upd.abs().double()).numpy()
    got = _emulate_reduce(tiles, upd.numpy(), chunk)
    assert np.all(np.abs(got - ref64) <= 1e-12 * scale)
    assert not got[scale == 0].any()
    assert torch.equal(onehot_reduce(tiles, upd, chunk=chunk), onehot_reduce_reference(tiles, upd))
    if case == "zipf":
        assert tiles.ntiles % chunk if chunk in (5, 16) else True
        assert int((tiles.chains[:, 2] - tiles.chains[:, 1]).max()) >= 2


def test_lab_plans_refuse_what_was_refused_after_a_good_call():
    """A call whose dtype, shape or device differs from a good call's is
    checked in full and refused as before: the per-key plans let nothing
    through."""
    tbl, idx = torch.ones((4, 128)), torch.zeros((4, 128), dtype=torch.int32)
    lane_gather(tbl, idx)
    with pytest.raises(TypeError, match="int32"):
        lane_gather(tbl, idx.long())
    with pytest.raises(TypeError, match="float32"):
        lane_gather(tbl.double(), idx)
    with pytest.raises(ValueError, match="128"):
        lane_gather(tbl[:, :64], idx[:, :64])
    with pytest.raises(ValueError, match="more than one device"):
        lane_gather(tbl, idx.to("meta"))
    with pytest.raises(ValueError, match="no route"):
        lane_gather(tbl.to("meta"), idx.to("meta"))
    tiles = _tiles(SHAPES[0])
    w, upd = torch.ones(tiles.d), tiles.vals
    onehot_gather(tiles, w)
    onehot_reduce(tiles, upd)
    with pytest.raises(TypeError, match="float32"):
        onehot_gather(tiles, w.double())
    with pytest.raises(ValueError, match=r"\(1500,\)"):
        onehot_gather(tiles, w[:-1])
    with pytest.raises(ValueError, match="more than one device"):
        onehot_gather(tiles, w.to("meta"))
    with pytest.raises(TypeError, match="float32"):
        onehot_reduce(tiles, upd.double())
    with pytest.raises(ValueError, match="upd"):
        onehot_reduce(tiles, upd[:-1])
    with pytest.raises(ValueError, match="more than one device"):
        onehot_reduce(tiles, upd.to("meta"))
    with pytest.raises(TypeError, match="int32"):
        onehot_reduce(dataclasses.replace(tiles, cols=tiles.cols.long()), upd)
    for chunk in (0, kernels_lab.MAX_CHUNK + 1, 2.0):
        with pytest.raises(ValueError, match="chunk"):
            onehot_reduce(tiles, upd, chunk=chunk)


def test_lab_plans_check_a_key_once(monkeypatch):
    """The full checks and the cost record run once per key, and again
    for a new key; past ``MAX_PLANS`` keys the dict starts anew."""
    recorded = []
    monkeypatch.setattr(dispatch, "record_kernel_cost", lambda *a, **kw: recorded.append(a[0]))
    monkeypatch.setattr(kernels_lab, "_lane_plans", {})
    monkeypatch.setattr(launch, "MAX_PLANS", 2)
    idx = torch.zeros((4, 128), dtype=torch.int32)
    for _ in range(3):
        lane_gather(torch.ones((4, 128)), idx)
    assert recorded == ["lane_gather"]
    assert list(kernels_lab._lane_plans.values()) == [launch.PLAIN]
    lane_gather(torch.ones((5, 128)), torch.zeros((5, 128), dtype=torch.int32))
    lane_gather(torch.ones((6, 128)), torch.zeros((6, 128), dtype=torch.int32))
    assert recorded == ["lane_gather"] * 3
    assert len(kernels_lab._lane_plans) == 1


def test_importing_the_lab_and_its_cpu_calls_build_and_load_nothing():
    """No library is built or loaded, and no entry point resolved, by the
    import or by calls on CPU tensors."""
    code = (
        "import torch\n"
        "from photon_ml_tpu_torch.kernels import build, ell\n"
        "from photon_ml_tpu_torch.kernels import lab\n"
        "assert not build._loaded and not ell._entries\n"
        "build.build = build.load = None\n"
        "lab.lane_gather(torch.ones((4, 128)), torch.zeros((4, 128), dtype=torch.int32))\n"
        "t = lab.column_sorted_tiles(torch.zeros((9, 2), dtype=torch.int32), torch.ones((9, 2)), 5)\n"
        "lab.onehot_gather(t, torch.ones(5))\n"
        "lab.onehot_reduce(t, t.vals)\n"
        "assert not build._loaded and not ell._entries\n"
        "assert all(e._fn is None for e in (lab._LANE_GATHER, lab._ONEHOT_GATHER, "
        "lab._ONEHOT_REDUCE))\n"
    )
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    subprocess.run([sys.executable, "-c", code], check=True, cwd=root, timeout=300)
