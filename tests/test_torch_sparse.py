"""The port's ``ops.sparse`` against the JAX package's on the same seeded
inputs: ``from_coo`` dedup-sum, row width, padding and ``nnz_per_row``
rules; ``from_dense``/``to_dense``; ``matvec`` on dense and ELL designs
(f64, rtol 1e-12: summation order only)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_ml_tpu.ops import sparse as jsp
from photon_ml_tpu_torch import interop
from photon_ml_tpu_torch.ops import sparse as tsp


def _coo(rng, n, d, nnz, dup_frac=0.3):
    rows = rng.integers(0, n, size=nnz)
    cols = rng.integers(0, d, size=nnz)
    vals = rng.standard_normal(nnz)
    n_dup = int(nnz * dup_frac)
    # re-emit some (row, col) pairs so dedup-sum has work to do
    rows = np.concatenate([rows, rows[:n_dup]])
    cols = np.concatenate([cols, cols[:n_dup]])
    vals = np.concatenate([vals, rng.standard_normal(n_dup)])
    return rows, cols, vals


@pytest.mark.parametrize("n,d,nnz", [(30, 17, 90), (7, 300, 40), (50, 3, 20)])
@pytest.mark.parametrize("nnz_per_row", [0, 12])
def test_from_coo_matches_jax(rng, n, d, nnz, nnz_per_row):
    rows, cols, vals = _coo(rng, n, d, nnz)
    j = jsp.from_coo(rows, cols, vals, n, d, nnz_per_row=nnz_per_row,
                     dtype=jnp.float64)
    t = tsp.from_coo(rows, cols, vals, n, d, nnz_per_row=nnz_per_row,
                     dtype=torch.float64)
    assert t.indices.dtype == torch.int32 and t.values.dtype == torch.float64
    assert t.nnz_per_row == j.nnz_per_row
    assert t.shape == j.shape
    np.testing.assert_array_equal(t.indices.numpy(), np.asarray(j.indices))
    np.testing.assert_allclose(t.values.numpy(), np.asarray(j.values), rtol=1e-15)
    np.testing.assert_allclose(tsp.to_dense(t), jsp.to_dense(j), rtol=1e-15)
    # padding slots: id d, value 0
    pad = t.indices.numpy() == d
    assert (t.values.numpy()[pad] == 0.0).all()


def test_from_coo_rejects_rows_over_nnz_per_row(rng):
    rows = np.array([0, 0, 0, 1])
    cols = np.array([0, 1, 2, 0])
    vals = np.ones(4)
    with pytest.raises(ValueError, match="nnz_per_row=2"):
        tsp.from_coo(rows, cols, vals, 2, 3, nnz_per_row=2)
    with pytest.raises(ValueError, match="nnz_per_row=2"):
        jsp.from_coo(rows, cols, vals, 2, 3, nnz_per_row=2)


def test_from_coo_empty_rows_get_one_padding_slot():
    t = tsp.from_coo(np.array([], np.int64), np.array([], np.int64),
                     np.array([]), 3, 5)
    j = jsp.from_coo(np.array([], np.int64), np.array([], np.int64),
                     np.array([]), 3, 5)
    assert t.indices.shape == tuple(j.indices.shape) == (3, 1)
    assert (t.indices.numpy() == 5).all()


def test_from_dense_round_trips(rng):
    x = rng.standard_normal((12, 9)) * (rng.uniform(size=(12, 9)) < 0.4)
    t = tsp.from_dense(x, dtype=torch.float64)
    j = jsp.from_dense(x, dtype=jnp.float64)
    np.testing.assert_array_equal(tsp.to_dense(t), x)
    np.testing.assert_array_equal(tsp.to_dense(t), jsp.to_dense(j))


def test_matvec_ell_and_dense_match_jax(rng):
    n, d = 40, 25
    rows, cols, vals = _coo(rng, n, d, 150)
    w = rng.standard_normal(d)
    j = jsp.from_coo(rows, cols, vals, n, d, dtype=jnp.float64)
    t = interop.sparse_from_numpy(np.asarray(j.indices), np.asarray(j.values), d)
    ref = np.asarray(jsp.matvec(j, jnp.asarray(w)))
    got = tsp.matvec(t, torch.from_numpy(w)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-12, atol=1e-12)
    x = jsp.to_dense(j)
    dense_ref = np.asarray(jsp.matvec(jnp.asarray(x), jnp.asarray(w)))
    dense_got = tsp.matvec(torch.from_numpy(x), torch.from_numpy(w)).numpy()
    np.testing.assert_allclose(dense_got, dense_ref, rtol=1e-12, atol=1e-12)
    # the ``@`` operator is matvec
    np.testing.assert_array_equal((t @ torch.from_numpy(w)).numpy(), got)


def test_cast_values_keeps_int32_ids(rng):
    sf = tsp.from_coo(np.array([0, 1]), np.array([2, 0]), np.array([1.5, -2.0]), 2, 3)
    cast = tsp.cast_values(sf, torch.float64, "cpu")
    assert cast.indices.dtype == torch.int32
    assert cast.values.dtype == torch.float64
    assert tsp.is_sparse(cast) and not tsp.is_sparse(cast.values)
    dense = tsp.cast_values(np.eye(2), torch.float32)
    assert dense.dtype == torch.float32 and dense.shape == (2, 2)
