"""The port's column-sorted design copy and its column reduce
(``photon_ml_tpu_torch/kernels/colsort.py``) on the CPU: the copy's layout,
and the reduce's plain version (the CUDA kernel's reference) held to the
JAX package's Pallas ``ell_rmatvec`` / ``ell_colsum`` in interpret mode
and to their XLA lowering (``ops.sparse.rmatvec`` / ``colsum``), on the
same seeded inputs.

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
    TILE,
    build_design_columns,
    column_reduce,
    column_reduce_reference,
    column_values,
    design_columns,
    run_chains,
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


@pytest.mark.parametrize("n,k,d,pad,dup,hot", CASES)
def test_copy_is_built_the_same_way_twice(rng, n, k, d, pad, dup, hot):
    idx, _ = _ell(rng, n, k, d, pad, dup, hot, "float64")
    a = build_design_columns(torch.from_numpy(idx), d)
    b = build_design_columns(torch.from_numpy(idx.copy()), d)
    for name in ("cols", "rows", "perm", "chains"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name
    assert (a.nvalid, a.n, a.k, a.d) == (b.nvalid, n, k, d)


@pytest.mark.parametrize("n,k,d,pad,dup,hot", CASES)
def test_copy_keeps_rows_in_order_and_drops_padding(rng, n, k, d, pad, dup, hot):
    idx, val = _ell(rng, n, k, d, pad, dup, hot, "float64")
    copy = build_design_columns(torch.from_numpy(idx), d)
    cols, rows = copy.cols.numpy(), copy.rows.numpy()
    valid = (idx >= 0) & (idx < d)
    assert copy.nvalid == valid.sum()
    assert cols.shape[0] % TILE == 0 and cols.shape[0] - copy.nvalid < TILE
    # the tail is padding, and only the tail
    assert np.all(cols[copy.nvalid:] == d) and np.all(cols[:copy.nvalid] < d)
    c, r = cols[:copy.nvalid], rows[:copy.nvalid]
    # sorted by column; within a column by row, then by slot
    assert np.all(np.diff(c) >= 0)
    perm = copy.perm.long().numpy()
    same = np.diff(c) == 0
    assert np.all(np.diff(perm)[same] > 0)
    assert np.array_equal(r, perm // k) and np.array_equal(c, idx.reshape(-1)[perm])
    # an in-row duplicate stays two entries
    if dup and k - pad >= 2:
        pairs = set(zip(r.tolist(), c.tolist()))
        assert len(pairs) < copy.nvalid
    lay = copy.layout(torch.from_numpy(val)).numpy()
    assert np.array_equal(lay[:copy.nvalid], val.reshape(-1)[perm])
    assert not lay[copy.nvalid:].any()


@pytest.mark.parametrize("chunk", [7, 64, 1000, 1 << 24])
@pytest.mark.parametrize("n,k,d,pad,dup,hot", CASES)
def test_copy_in_chunks_is_the_stable_sort_of_every_slot(rng, monkeypatch, n, k, d, pad,
                                                         dup, hot, chunk):
    idx, _ = _ell(rng, n, k, d, pad, dup, hot, "float64")
    flat = idx.reshape(-1)
    key = np.where((flat >= 0) & (flat < d), flat, d)
    order = np.argsort(key, kind="stable")
    nvalid = int((key < d).sum())
    monkeypatch.setattr(colsort, "BUILD_CHUNK", chunk)
    copy = build_design_columns(torch.from_numpy(idx), d)
    assert copy.nvalid == nvalid
    assert np.array_equal(copy.perm.long().numpy(), order[:nvalid])
    assert np.array_equal(copy.cols[:nvalid].numpy(), key[order[:nvalid]])
    assert np.array_equal(copy.rows[:nvalid].numpy(), order[:nvalid] // k)
    assert not copy.rows[nvalid:].any() and np.all(copy.cols[nvalid:].numpy() == d)


def test_copy_drops_every_id_outside_the_table():
    idx = torch.tensor([[0, 3, 3], [-1, 1, 5], [2**31 - 1, 1, 2]], dtype=torch.int32)
    copy = build_design_columns(idx, 3)
    assert copy.nvalid == 4
    assert copy.cols[:4].tolist() == [0, 1, 1, 2]
    assert copy.rows[:4].tolist() == [0, 1, 2, 2]


@pytest.mark.parametrize("n,k,d,pad,dup,hot", CASES)
def test_chains_cover_every_run_that_crosses_a_tile(rng, n, k, d, pad, dup, hot):
    idx, _ = _ell(rng, n, k, d, pad, dup, hot, "float64")
    copy = build_design_columns(torch.from_numpy(idx), d)
    tiles = copy.cols.view(-1, TILE).numpy()
    want = []
    for col in np.unique(tiles[tiles < d]):
        where = np.nonzero((tiles == col).any(1))[0]
        if where.size > 1:
            want.append([int(col), int(where[0]), int(where[-1])])
    assert copy.chains.tolist() == want


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


def test_copy_is_dropped_with_its_tensor(rng):
    idx, _ = _ell(rng, 50, 4, 30, 0, False, 0, "float64")
    t_idx = torch.from_numpy(idx.copy())
    design_columns(t_idx, 30)
    held = len(colsort._copies._items)
    del t_idx
    assert len(colsort._copies._items) == held - 1


def test_nbytes_counts_the_copy():
    idx = torch.zeros((3, 2), dtype=torch.int32)
    copy = build_design_columns(idx, 4)
    # one tile of int32 columns and rows, six int32 slots, no chains
    assert copy.nbytes() == 2 * TILE * 4 + 6 * 4
    assert copy.nbytes(8) == copy.nbytes() + TILE * 8


# -- the reduce's plain version against the JAX kernels --------------------------


@pytest.mark.parametrize("dtype", ["float64", "float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["linear", "square", "pair"])
@pytest.mark.parametrize("n,k,d,pad,dup,hot", CASES)
def test_reduce_matches_jax_pallas_and_xla(rng, n, k, d, pad, dup, hot, mode, dtype):
    idx, val = _ell(rng, n, k, d, pad, dup, hot, dtype)
    jv, ja = JAX[dtype]
    a = np.abs(rng.standard_normal(n)).astype(ja) + 0.1
    j_idx, j_val, j_a = jnp.asarray(idx), jnp.asarray(val, jv), jnp.asarray(a)
    sf = jax_sparse.SparseFeatures(j_idx, j_val, d)
    t_val = torch.from_numpy(val).to(TORCH[dtype])
    copy = build_design_columns(torch.from_numpy(idx), d)
    before = dispatch.launch_counts()["colsort_reduce"]
    got = column_reduce(copy, copy.layout(t_val), torch.from_numpy(a), mode)
    assert dispatch.launch_counts()["colsort_reduce"] == before  # CPU: no launch
    v64 = np.asarray(val, np.float64)
    wants = {
        "linear": [(jax_ell.ell_rmatvec(j_idx, j_val, j_a, d),
                    jax_sparse.rmatvec(sf, j_a), v64 * a[:, None])],
        "square": [(jax_ell.ell_colsum(j_idx, j_val, j_a, d, square=True),
                    jax_sparse.colsum(sf, j_a, square=True), v64 * v64 * a[:, None])],
    }
    wants["pair"] = wants["square"] + [
        (jax_ell.ell_colsum(j_idx, j_val, j_a, d), jax_sparse.colsum(sf, j_a),
         v64 * a[:, None])]
    outs = got if mode == "pair" else (got,)
    assert len(outs) == len(wants[mode])
    for out, (pallas, xla, terms) in zip(outs, wants[mode]):
        assert out.dtype == (torch.float64 if dtype == "float64" else torch.float32)
        assert out.shape == (d,)
        scale = _col_abs(idx, terms, d)
        _close(out.double().numpy(), np.asarray(pallas, np.float64), RTOL[dtype], scale)
        _close(out.double().numpy(), np.asarray(xla, np.float64), RTOL[dtype], scale)


@pytest.mark.parametrize("n,k,d,pad,dup,hot", CASES)
def test_reduce_equals_the_scatter_in_slot_order(rng, n, k, d, pad, dup, hot):
    # in f64 the column-sorted order adds each column's slots in the ELL's
    # slot order, as the CPU scatter does: the same bits
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


def test_reduce_cost_counts_the_least_traffic_as_its_roofline(rng):
    n, k, d = 300, 5, 43  # a width no other test records
    idx, val = _ell(rng, n, k, d, 2, False, 0, "float64")
    copy = build_design_columns(torch.from_numpy(idx), d)
    lay = copy.layout(torch.from_numpy(val))
    column_reduce(copy, lay, torch.ones(n, dtype=torch.float64))
    cost = dispatch.kernel_costs()[("colsort_reduce", copy.nvalid, 1, d, 8)]
    # the least traffic: each entry's column id and value once; beyond it
    # the row ids, the tail padding's three words, a and g
    pad = copy.cols.shape[0] - copy.nvalid
    assert cost["roofline_bytes"] == copy.nvalid * (4 + 8)
    assert cost["analytic_bytes"] == (cost["roofline_bytes"] + 4 * copy.nvalid + pad * 16
                                      + n * 8 + d * 8)
