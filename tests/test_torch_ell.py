"""The port's ``ell_matvec`` on the CPU (its plain PyTorch version, which
the wrapper takes for CPU tensors) against the JAX package's Pallas
``ell_matvec`` in interpret mode and its XLA ``ops.sparse.matvec``, on the
same seeded inputs.

Tolerances (``tests/test_kernels.py``): f32 1e-6, bf16 values x f32 w
1e-2 of the output scale, f64 rtol 1e-12 — the f64 bound covers the
summation order only.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_ml_tpu.kernels import ell as jax_ell
from photon_ml_tpu.ops import sparse as jax_sparse
from photon_ml_tpu_torch.kernels import dispatch
from photon_ml_tpu_torch.kernels.ell import (
    compute_dtype,
    ell_matvec,
    ell_matvec_reference,
)

# (n, k, d, padded slots per row, duplicate ids)
CASES = [
    (37, 5, 300, 0, False),
    (37, 5, 300, 2, False),  # trailing padding slots
    (16, 4, 300, 4, False),  # every slot is padding
    (23, 1, 157, 0, False),  # k = 1
    (12, 6, 157, 0, True),  # duplicate (row, col) pairs
    (101, 40, 1000, 3, True),  # Criteo width, n not a multiple of a block
    (9, 3, 1, 0, False),  # single column
]

RTOL = {"float64": 1e-12, "float32": 1e-6, "bfloat16": 1e-2}


def _ell(rng, n, k, d, pad, dup, dtype):
    idx = rng.integers(0, d, size=(n, k)).astype(np.int32)
    val = rng.standard_normal((n, k))
    if pad:
        idx[:, k - pad:] = d
        val[:, k - pad:] = 0.0
    if dup and k >= 2:
        idx[::2, 1] = idx[::2, 0]
    if dtype == "bfloat16":
        val = np.array(jnp.asarray(val, jnp.bfloat16).astype(jnp.float32))
    return idx, val


def _np_dtypes(dtype):
    # (values dtype in jax, w dtype)
    return {
        "float64": (jnp.float64, np.float64),
        "float32": (jnp.float32, np.float32),
        "bfloat16": (jnp.bfloat16, np.float32),
    }[dtype]


def _torch_dtype(dtype):
    return {"float64": torch.float64, "float32": torch.float32,
            "bfloat16": torch.bfloat16}[dtype]


def _row_abs(idx, val, w, d):
    """sum_k |v_ik * w[c_ik]| per row: the scale of a row's rounding error
    under any summation order."""
    w_pad = np.append(np.abs(np.asarray(w, np.float64)), 0.0)
    ids = np.where((idx >= 0) & (idx < d), idx, d)
    return (np.abs(np.asarray(val, np.float64)) * w_pad[ids]).sum(-1)


def _close(got, ref, rtol, row_abs):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    err = np.abs(got - ref)
    assert np.all(err <= rtol * row_abs), (err.max(), row_abs.max())


@pytest.mark.parametrize("dtype", ["float64", "float32", "bfloat16"])
@pytest.mark.parametrize("n,k,d,pad,dup", CASES)
def test_matches_jax_pallas_and_xla(rng, n, k, d, pad, dup, dtype):
    idx, val = _ell(rng, n, k, d, pad, dup, dtype)
    w = rng.standard_normal(d)
    jv, jw = _np_dtypes(dtype)
    j_idx = jnp.asarray(idx)
    j_val = jnp.asarray(val, jv)
    j_w = jnp.asarray(w.astype(jw))
    pallas = np.asarray(jax_ell.ell_matvec(j_idx, j_val, j_w, d), np.float64)
    xla = np.asarray(
        jax_sparse.matvec(jax_sparse.SparseFeatures(j_idx, j_val, d), j_w),
        np.float64,
    )
    t_val = torch.from_numpy(val).to(_torch_dtype(dtype))
    t_w = torch.from_numpy(w.astype(jw))
    before = dispatch.launch_counts()["ell_matvec"]
    got = ell_matvec(torch.from_numpy(idx), t_val, t_w, d)
    assert dispatch.launch_counts()["ell_matvec"] == before  # CPU: no launch
    assert got.dtype == compute_dtype(t_val.dtype, t_w.dtype)
    assert got.shape == (n,)
    row_abs = _row_abs(idx, val, w.astype(jw), d)
    out = got.to(torch.float64).numpy()
    _close(out, pallas, RTOL[dtype], row_abs)
    _close(out, xla, RTOL[dtype], row_abs)


def test_padding_reads_zero_and_out_of_range_ids():
    idx = torch.tensor([[0, 3, 3], [-1, 1, 5]], dtype=torch.int32)
    val = torch.tensor([[1.0, 9.0, 9.0], [7.0, 2.0, 4.0]], dtype=torch.float64)
    w = torch.tensor([10.0, 20.0, 30.0], dtype=torch.float64)
    # ids >= d (3, 5) and negative ids read 0
    assert ell_matvec(idx, val, w, 3).tolist() == [10.0, 40.0]


@pytest.mark.parametrize(
    "vdt,wdt",
    [(torch.float32, torch.float64), (torch.float64, torch.float32),
     (torch.bfloat16, torch.bfloat16), (torch.float16, torch.float32)],
)
def test_unsupported_dtype_pairs_raise(vdt, wdt):
    idx = torch.zeros((2, 2), dtype=torch.int32)
    with pytest.raises(TypeError, match="ell_matvec"):
        ell_matvec(idx, torch.ones((2, 2), dtype=vdt), torch.ones(3, dtype=wdt), 3)


def test_non_cpu_non_cuda_device_raises():
    idx = torch.zeros((2, 2), dtype=torch.int32, device="meta")
    val = torch.ones((2, 2), dtype=torch.float64, device="meta")
    w = torch.ones(3, dtype=torch.float64, device="meta")
    with pytest.raises(ValueError, match="no route"):
        ell_matvec(idx, val, w, 3)


def test_mixed_devices_raise():
    idx = torch.zeros((2, 2), dtype=torch.int32)
    val = torch.ones((2, 2), dtype=torch.float64)
    w = torch.ones(3, dtype=torch.float64, device="meta")
    with pytest.raises(ValueError, match="more than one device"):
        ell_matvec(idx, val, w, 3)


def test_reference_is_the_cpu_route(rng):
    idx, val = _ell(rng, 20, 7, 50, 1, True, "float64")
    w = torch.from_numpy(rng.standard_normal(50))
    a = ell_matvec(torch.from_numpy(idx), torch.from_numpy(val), w, 50)
    b = ell_matvec_reference(torch.from_numpy(idx), torch.from_numpy(val), w, 50)
    assert torch.equal(a, b)


def test_cost_record_has_one_design_read(rng):
    n, k, d = 13, 6, 77
    idx, val = _ell(rng, n, k, d, 1, False, "float32")
    ell_matvec(torch.from_numpy(idx), torch.from_numpy(val).float(),
               torch.zeros(d), d)
    cost = dispatch.kernel_costs()[("ell_matvec", n, k, d, 4)]
    assert dispatch.design_reads("ell_matvec") == 1
    assert cost["roofline_bytes"] == n * k * (4 + 4)
    assert cost["analytic_bytes"] == n * k * 8 + d * 4 + n * 4
    assert cost["analytic_flops"] == 2 * n * k


# -- ell_scatter_add, ell_rmatvec, ell_colsum ---------------------------------

from photon_ml_tpu_torch.kernels.ell import (  # noqa: E402
    ell_colsum,
    ell_rmatvec,
    ell_scatter_add,
    ell_scatter_add_reference,
)


def _col_abs(idx, terms, d):
    """sum over slots of |term| per column: the scale of a column's rounding
    error under any summation order."""
    ids = np.where((idx >= 0) & (idx < d), idx, d)
    out = np.zeros(d + 1)
    np.add.at(out, ids.reshape(-1), np.abs(np.asarray(terms, np.float64)).reshape(-1))
    return out[:d]


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("n,k,d,pad,dup", CASES)
def test_scatter_add_matches_jax_pallas_and_xla(rng, n, k, d, pad, dup, dtype):
    idx, val = _ell(rng, n, k, d, pad, dup, dtype)
    upd = val.astype(dtype)
    pallas = np.asarray(jax_ell.ell_scatter_add(jnp.asarray(idx), jnp.asarray(upd), d),
                        np.float64)
    # the XLA route: rmatvec with a = 1
    xla = np.asarray(jax_sparse.rmatvec(
        jax_sparse.SparseFeatures(jnp.asarray(idx), jnp.asarray(upd), d),
        jnp.ones(n, dtype)), np.float64)
    before = dispatch.launch_counts()["ell_scatter_add"]
    got = ell_scatter_add(torch.from_numpy(idx), torch.from_numpy(upd), d)
    assert dispatch.launch_counts()["ell_scatter_add"] == before  # CPU: no launch
    assert got.dtype == _torch_dtype(dtype) and got.shape == (d,)
    scale = _col_abs(idx, upd, d)
    _close(got.double().numpy(), pallas, RTOL[dtype], scale)
    _close(got.double().numpy(), xla, RTOL[dtype], scale)


@pytest.mark.parametrize("dtype", ["float64", "float32", "bfloat16"])
@pytest.mark.parametrize("square", [False, True])
@pytest.mark.parametrize("n,k,d,pad,dup", CASES[:6])
def test_rmatvec_and_colsum_match_jax(rng, n, k, d, pad, dup, square, dtype):
    idx, val = _ell(rng, n, k, d, pad, dup, dtype)
    jv, ja = _np_dtypes(dtype)
    a = rng.standard_normal(n).astype(ja)
    c = np.abs(a)
    j_idx, j_val = jnp.asarray(idx), jnp.asarray(val, jv)
    sf = jax_sparse.SparseFeatures(j_idx, j_val, d)
    t_idx, t_val = torch.from_numpy(idx), torch.from_numpy(val).to(_torch_dtype(dtype))
    v64 = np.asarray(val, np.float64)
    for name, pallas, xla, got, terms in (
        ("rmatvec",
         jax_ell.ell_rmatvec(j_idx, j_val, jnp.asarray(a), d),
         jax_sparse.rmatvec(sf, jnp.asarray(a)),
         ell_rmatvec(t_idx, t_val, torch.from_numpy(a), d),
         v64 * a[:, None]),
        ("colsum",
         jax_ell.ell_colsum(j_idx, j_val, jnp.asarray(c), d, square=square),
         jax_sparse.colsum(sf, jnp.asarray(c), square=square),
         ell_colsum(t_idx, t_val, torch.from_numpy(c), d, square=square),
         (v64 * v64 if square else v64) * c[:, None]),
    ):
        assert got.dtype == (torch.float64 if dtype == "float64" else torch.float32), name
        scale = _col_abs(idx, terms, d)
        _close(got.double().numpy(), np.asarray(pallas, np.float64), RTOL[dtype], scale)
        _close(got.double().numpy(), np.asarray(xla, np.float64), RTOL[dtype], scale)


def test_scatter_drops_padding_and_out_of_range_ids():
    idx = torch.tensor([[0, 3, 3], [-1, 1, 5], [1, 1, 2]], dtype=torch.int32)
    upd = torch.tensor([[1.0, 9.0, 9.0], [7.0, 2.0, 4.0], [0.5, 0.25, 3.0]],
                       dtype=torch.float64)
    # ids >= d (3, 5) and negative ids add nothing; duplicate ids sum
    assert ell_scatter_add(idx, upd, 3).tolist() == [1.0, 2.75, 3.0]
    assert torch.equal(ell_scatter_add(idx, upd, 3), ell_scatter_add_reference(idx, upd, 3))


@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float16, torch.int32])
def test_scatter_rejects_other_update_dtypes(dt):
    idx = torch.zeros((2, 2), dtype=torch.int32)
    with pytest.raises(TypeError, match="ell_scatter_add"):
        ell_scatter_add(idx, torch.ones((2, 2), dtype=dt), 3)


def test_scatter_cost_records_one_design_read(rng):
    n, k, d = 13, 6, 77
    idx, val = _ell(rng, n, k, d, 1, False, "float64")
    ell_colsum(torch.from_numpy(idx), torch.from_numpy(val), torch.ones(n, dtype=torch.float64), d)
    costs = dispatch.kernel_costs()
    for kernel in ("ell_scatter_add", "ell_colsum"):
        assert dispatch.design_reads(kernel) == 1
        assert costs[(kernel, n, k, d, 8)]["roofline_bytes"] == n * k * 12
    assert costs[("ell_scatter_add", n, k, d, 8)]["analytic_flops"] == n * k


# -- a hot-column design in the Criteo layout ---------------------------------


def _criteo_like(rng, n, d, dtype):
    """(indices, values) in the Criteo layout over d columns: 13 integer
    fields on fixed columns and the intercept (column d - 1), all named by
    every row, 26 categorical fields with Zipf(1.2) categories hashed into
    [0, d - 1) (the head categories are named by many rows, and two fields
    may share a column), and a trailing padding slot in every third row."""
    int_cols = rng.choice(d - 1, 13, replace=False)
    cats = rng.zipf(1.2, size=(n, 26)) % 1_000_003
    cat_cols = (cats * 2_654_435_761 + np.arange(26) * 7919) % (d - 1)
    idx = np.concatenate(
        [np.broadcast_to(int_cols, (n, 13)), cat_cols, np.full((n, 1), d - 1),
         np.full((n, 1), d)], axis=1).astype(np.int32)
    counts = rng.geometric(0.05, size=(n, 13)) - 1
    val = np.concatenate(
        [np.log1p(counts), np.ones((n, 26)), np.ones((n, 1)), np.zeros((n, 1))], axis=1)
    idx[1::3, -1] = idx[1::3, 20]  # no padding there: a duplicate of a category
    val[1::3, -1] = 0.5
    if dtype == "bfloat16":
        val = np.array(jnp.asarray(val, jnp.bfloat16).astype(jnp.float32))
    return idx, val


@pytest.mark.parametrize("n", [96, 301])
@pytest.mark.parametrize("dtype", ["float64", "float32", "bfloat16"])
def test_matvec_hot_columns_match_jax(rng, n, dtype):
    d = 513
    idx, val = _criteo_like(rng, n, d, dtype)
    w = rng.standard_normal(d)
    jv, jw = _np_dtypes(dtype)
    j_idx, j_val, j_w = jnp.asarray(idx), jnp.asarray(val, jv), jnp.asarray(w.astype(jw))
    pallas = np.asarray(jax_ell.ell_matvec(j_idx, j_val, j_w, d), np.float64)
    xla = np.asarray(jax_sparse.matvec(jax_sparse.SparseFeatures(j_idx, j_val, d), j_w),
                     np.float64)
    got = ell_matvec(torch.from_numpy(idx), torch.from_numpy(val).to(_torch_dtype(dtype)),
                     torch.from_numpy(w.astype(jw)), d)
    row_abs = _row_abs(idx, val, w.astype(jw), d)
    out = got.to(torch.float64).numpy()
    _close(out, pallas, RTOL[dtype], row_abs)
    _close(out, xla, RTOL[dtype], row_abs)


@pytest.mark.parametrize("n", [96, 301])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_scatter_add_hot_columns_match_jax(rng, n, dtype):
    d = 513
    idx, val = _criteo_like(rng, n, d, dtype)
    upd = (val * rng.standard_normal((n, 1))).astype(dtype)
    pallas = np.asarray(jax_ell.ell_scatter_add(jnp.asarray(idx), jnp.asarray(upd), d),
                        np.float64)
    xla = np.asarray(jax_sparse.rmatvec(
        jax_sparse.SparseFeatures(jnp.asarray(idx), jnp.asarray(upd), d),
        jnp.ones(n, dtype)), np.float64)
    got = ell_scatter_add(torch.from_numpy(idx), torch.from_numpy(upd), d)
    assert got.dtype == _torch_dtype(dtype) and got.shape == (d,)
    # the intercept and the integer fields sum every row
    assert np.count_nonzero(np.bincount(idx[idx < d], minlength=d) >= n) >= 14
    scale = _col_abs(idx, upd, d)
    _close(got.double().numpy(), pallas, RTOL[dtype], scale)
    _close(got.double().numpy(), xla, RTOL[dtype], scale)
