"""The port's variance pass on the CPU against the JAX package's, on the
same seeded inputs: ``fused_hessian_diagonal`` (its plain PyTorch
version, which the wrapper takes for CPU tensors) against the Pallas
kernel in interpret mode and against the XLA route (``ops.sparse``
matvec + colsum), in the four losses and three dtype pairs, with padding
slots, a duplicate row and an empty batch; then
``GLMObjective.hessian_diagonal`` (sparse and dense, with and without
normalization factors and shifts) and ``hessian_full``.

Tolerances (``tests/test_kernels.py``): every output element within rtol
x the sum of the absolute terms it adds up (plus 1e-300), rtol f64 1e-12
(summation order only), f32 1e-6, bf16 values x f32 1e-2; the objective's
diagonal and full Hessian in f64 within 1e-12 of that scale.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_ml_tpu.core.normalization import NormalizationContext as JNorm
from photon_ml_tpu.core.types import LabeledBatch as JBatch
from photon_ml_tpu.kernels import fused as jax_fused
from photon_ml_tpu.ops import losses as jax_losses
from photon_ml_tpu.ops import sparse as jax_sparse
from photon_ml_tpu.ops.objective import GLMObjective as JObjective
from photon_ml_tpu_torch.interop import (
    labeled_batch_from_numpy,
    normalization_from_numpy,
    sparse_from_numpy,
)
from photon_ml_tpu_torch.kernels import dispatch
from photon_ml_tpu_torch.kernels.fused import fused_hessian_diagonal
from photon_ml_tpu_torch.ops import losses as port_losses
from photon_ml_tpu_torch.ops.objective import GLMObjective

LOSSES = ["logistic", "squared", "poisson", "smoothed_hinge"]
JAX_LOSS = {
    "logistic": jax_losses.LOGISTIC_LOSS,
    "squared": jax_losses.SQUARED_LOSS,
    "poisson": jax_losses.POISSON_LOSS,
    "smoothed_hinge": jax_losses.SMOOTHED_HINGE_LOSS,
}
PORT_LOSS = {
    "logistic": port_losses.LOGISTIC_LOSS,
    "squared": port_losses.SQUARED_LOSS,
    "poisson": port_losses.POISSON_LOSS,
    "smoothed_hinge": port_losses.SMOOTHED_HINGE_LOSS,
}
RTOL = {"float64": 1e-12, "float32": 1e-6, "bfloat16": 1e-2}
DTYPES = {  # values (jax, torch), compute (numpy, torch)
    "float64": ((jnp.float64, torch.float64), (np.float64, torch.float64)),
    "float32": ((jnp.float32, torch.float32), (np.float32, torch.float32)),
    "bfloat16": ((jnp.bfloat16, torch.bfloat16), (np.float32, torch.float32)),
}

# (n, k, d, trailing padding slots, all-padding rows, duplicate ids,
#  columns named by every row)
MIXED = (157, 12, 300, 3, 5, True, 0)
EDGES = {
    "k1": (64, 1, 157, 0, 0, False, 0),
    "all_padding": (40, 6, 90, 6, 0, False, 0),
    "duplicates": (33, 8, 7, 0, 3, True, 0),  # 8 slots over 7 columns
    "criteo_width": (300, 40, 1000, 2, 4, True, 0),
    # the Criteo layout's intercept and 13 integer fields in every row
    "criteo_hot": (300, 40, 1000, 2, 4, True, 14),
}


def _inputs(rng, n, k, d, pad, pad_rows, dup, hot, dtype):
    (jv, tv), (nc, tc) = DTYPES[dtype]
    idx = rng.integers(0, d, size=(n, k)).astype(np.int32)
    if hot:
        idx[:, :hot] = rng.permutation(d)[:hot]
    val = rng.standard_normal((n, k))
    if pad:
        idx[:, k - pad:] = d
        val[:, k - pad:] = 0.0
    if pad_rows:
        idx[:pad_rows] = d
        val[:pad_rows] = 0.0
    if dup and k >= 2:
        idx[::2, 1] = idx[::2, 0]
    if dtype == "bfloat16":
        val = np.array(jnp.asarray(val, jnp.bfloat16).astype(jnp.float32))
    y = (rng.uniform(size=n) < 0.5).astype(np.float64)
    off = 0.2 * rng.standard_normal(n)
    ew = rng.uniform(0.5, 2.0, size=n)
    ew[::9] = 0.0
    w = 0.3 * rng.standard_normal(d)
    rows = tuple(a.astype(nc) for a in (y, off, ew, w))
    jax_in = (jnp.asarray(idx), jnp.asarray(val, jv)) + tuple(jnp.asarray(a) for a in rows)
    torch_in = (torch.from_numpy(idx), torch.from_numpy(val).to(tv)) + tuple(
        torch.from_numpy(a) for a in rows
    )
    return idx, val, rows, jax_in, torch_in


def _close(got, ref, scale, rtol):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    err = np.abs(got - ref)
    assert np.all(err <= rtol * np.asarray(scale, np.float64) + 1e-300), (
        float(err.max()), float(np.max(scale)))


def _scales(idx, val, rows, d, loss):
    """Per-output sums of |terms| in f64: a margin rounds by up to rtol *
    row_abs (|v w| and |offset| summed), which moves c = ew l'' by
    ew |l'''| row_abs (|l'''| <= 0.1 + l'' for these losses)."""
    y, off, ew, w = (a.astype(np.float64) for a in rows)
    ids = np.where((idx >= 0) & (idx < d), idx, d)
    wp = np.append(w, 0.0)
    z = (val * wp[ids]).sum(-1) + off
    row_abs = (np.abs(val) * np.abs(wp[ids])).sum(-1) + np.abs(off)
    d2 = np.abs(np.asarray(JAX_LOSS[loss].d2(jnp.asarray(z), jnp.asarray(y))))
    c = ew * (d2 + (0.1 + d2) * row_abs)
    dx2 = np.zeros(d + 1)
    dx = np.zeros(d + 1)
    np.add.at(dx2, ids.reshape(-1), (val * val * c[:, None]).reshape(-1))
    np.add.at(dx, ids.reshape(-1), (np.abs(val) * c[:, None]).reshape(-1))
    return dx2[:d], dx[:d], c.sum()


def _run(rng, case, loss, dtype):
    idx, val, rows, jax_in, torch_in = _inputs(rng, *case, dtype)
    d = case[2]
    jl = JAX_LOSS[loss]
    pallas = jax_fused.fused_hessian_diagonal(*jax_in, d, jl)  # interpret mode
    # the XLA route: margins by gather, the column sums by scatter-add
    sf = jax_sparse.SparseFeatures(jax_in[0], jax_in[1], d)
    jy, joff, jew, jw = jax_in[2:]
    c = jew * jl.d2(jax_sparse.matvec(sf, jw) + joff, jy)
    xla = (jax_sparse.colsum(sf, c, square=True), jax_sparse.colsum(sf, c), jnp.sum(c))
    before = dispatch.launch_counts()["fused_hdiag"]
    got = fused_hessian_diagonal(*torch_in, d, PORT_LOSS[loss])
    assert dispatch.launch_counts()["fused_hdiag"] == before  # CPU: plain version
    cd = DTYPES[dtype][1][1]
    assert all(t.dtype == cd for t in got)
    assert got[0].shape == (d,) and got[1].shape == (d,) and got[2].shape == ()
    for i, scale in enumerate(_scales(idx, val, rows, d, loss)):
        out = got[i].to(torch.float64).numpy()
        _close(out, np.asarray(pallas[i], np.float64), scale, RTOL[dtype])
        _close(out, np.asarray(xla[i], np.float64), scale, RTOL[dtype])


@pytest.mark.parametrize("dtype", ["float64", "float32", "bfloat16"])
@pytest.mark.parametrize("loss", LOSSES)
def test_hdiag_matches_jax_pallas_and_xla(rng, loss, dtype):
    _run(rng, MIXED, loss, dtype)


@pytest.mark.parametrize("dtype", ["float64", "float32", "bfloat16"])
@pytest.mark.parametrize("case", list(EDGES))
def test_hdiag_edge_shapes_match_jax(rng, case, dtype):
    _run(rng, EDGES[case], "logistic", dtype)


def test_hdiag_squares_each_duplicate_slot_like_jax():
    # one row, two slots on column 2: v^2 per slot (2.5), not (sum v)^2 (1.0)
    idx = np.array([[2, 2, 5]], np.int32)
    val = np.array([[1.5, -0.5, 0.0]])
    one, zero = np.ones(1), np.zeros(1)
    ref = jax_fused.fused_hessian_diagonal(
        jnp.asarray(idx), jnp.asarray(val), jnp.asarray(one), jnp.asarray(zero),
        jnp.asarray(one), jnp.zeros(5), 5, jax_losses.SQUARED_LOSS)
    got = fused_hessian_diagonal(
        torch.from_numpy(idx), torch.from_numpy(val), torch.from_numpy(one),
        torch.from_numpy(zero), torch.from_numpy(one), torch.zeros(5, dtype=torch.float64),
        5, port_losses.SQUARED_LOSS)
    assert got[0].tolist() == np.asarray(ref[0]).tolist() == [0.0, 0.0, 2.5, 0.0, 0.0]
    assert got[1].tolist() == np.asarray(ref[1]).tolist()
    assert float(got[2]) == float(ref[2]) == 1.0


def test_hdiag_of_an_empty_batch():
    z = torch.zeros(0, dtype=torch.float64)
    dx2, dx, csum = fused_hessian_diagonal(
        torch.zeros((0, 4), dtype=torch.int32), torch.zeros((0, 4), dtype=torch.float64),
        z, z, z, torch.ones(9, dtype=torch.float64), 9, port_losses.LOGISTIC_LOSS)
    assert dx2.shape == dx.shape == (9,) and not dx2.any() and not dx.any()
    assert csum.shape == () and float(csum) == 0.0


def test_hdiag_cost_record_is_one_design_read(rng):
    n, k, d = 21, 5, 50
    *_, t = _inputs(rng, n, k, d, 1, 0, False, 0, "float32")
    fused_hessian_diagonal(*t, d, port_losses.LOGISTIC_LOSS)
    assert dispatch.design_reads("fused_hdiag") == 1
    cost = dispatch.kernel_costs()[("fused_hdiag", n, k, d, 4)]
    assert cost["roofline_bytes"] == n * k * 8
    assert cost["analytic_flops"] == 5.0 * n * k


# -- GLMObjective.hessian_diagonal / hessian_full ----------------------------

N, D = 120, 16


def _batches(rng, sparse, loss="logistic"):
    x = rng.standard_normal((N, D)) * (rng.uniform(size=(N, D)) < 0.5)
    x[:, D - 1] = 1.0  # intercept column
    if loss == "poisson":
        y = rng.poisson(1.5, size=N).astype(np.float64)
    else:
        y = (rng.uniform(size=N) < 0.5).astype(np.float64)
    off = 0.1 * rng.standard_normal(N)
    wts = rng.uniform(0.5, 2.0, size=N)
    mask = np.ones(N)
    mask[-7:] = 0.0
    if sparse:
        jf = jax_sparse.from_dense(x, dtype=jnp.float64)
        pf = sparse_from_numpy(np.asarray(jf.indices), np.asarray(jf.values), jf.d)
    else:
        jf, pf = jnp.asarray(x), x
    jb = JBatch(jf, jnp.asarray(y), jnp.asarray(off), jnp.asarray(wts), jnp.asarray(mask))
    return x, jb, labeled_batch_from_numpy(pf, y, off, wts, mask)


def _norm(rng, kind):
    if kind == "none":
        return None, None
    factors = rng.uniform(0.5, 2.0, size=D)
    factors[D - 1] = 1.0
    if kind == "scale":
        return factors, None
    shifts = 0.3 * rng.standard_normal(D)
    shifts[D - 1] = 0.0
    return factors, shifts


@pytest.mark.parametrize("norm", ["none", "scale", "standardize"])
@pytest.mark.parametrize("sparse", [True, False], ids=["ell", "dense"])
@pytest.mark.parametrize("loss", ["logistic", "poisson"])
def test_objective_hessian_diagonal_matches_jax(rng, sparse, norm, loss):
    x, jb, pb = _batches(rng, sparse, loss)
    factors, shifts = _norm(rng, norm)
    jn = JNorm(None if factors is None else jnp.asarray(factors),
               None if shifts is None else jnp.asarray(shifts))
    pn = normalization_from_numpy(factors, shifts)
    l2 = 0.7
    jo = JObjective(loss=JAX_LOSS[loss], normalization=jn, l2_weight=l2)
    po = GLMObjective(loss=PORT_LOSS[loss], normalization=pn, l2_weight=l2)
    w = 0.2 * rng.standard_normal(D)
    ref = np.asarray(jo.hessian_diagonal(jnp.asarray(w), jb))
    got = po.hessian_diagonal(torch.from_numpy(w), pb).numpy()
    # scale: the diagonal's terms (x'_ij)^2 c_i summed in absolute value
    f = np.ones(D) if factors is None else factors
    s = np.zeros(D) if shifts is None else shifts
    xn = (x - s) * f
    c = np.abs(np.asarray(jo.hessian_coefficients(jnp.asarray(w), jb)))
    scale = (xn * xn * c[:, None]).sum(0) + (x * x * f * f * c[:, None]).sum(0) + l2
    _close(got, ref, scale, 1e-12)


@pytest.mark.parametrize("norm", ["none", "scale"])
def test_objective_hessian_full_matches_jax(rng, norm):
    x, jb, pb = _batches(rng, False)
    factors, _ = _norm(rng, norm)
    jn = JNorm(None if factors is None else jnp.asarray(factors), None)
    pn = normalization_from_numpy(factors, None)
    jo = JObjective(loss=jax_losses.LOGISTIC_LOSS, normalization=jn, l2_weight=0.3)
    po = GLMObjective(loss=port_losses.LOGISTIC_LOSS, normalization=pn, l2_weight=0.3)
    w = 0.2 * rng.standard_normal(D)
    ref = np.asarray(jo.hessian_full(jnp.asarray(w), jb))
    got = po.hessian_full(torch.from_numpy(w), pb).numpy()
    f = np.ones(D) if factors is None else factors
    c = np.abs(np.asarray(jo.hessian_coefficients(jnp.asarray(w), jb)))
    xa = np.abs(x) * f
    _close(got, ref, xa.T @ (c[:, None] * xa) + 0.3, 1e-12)
    # its diagonal is hessian_diagonal's
    _close(np.diag(got), po.hessian_diagonal(torch.from_numpy(w), pb).numpy(),
           np.diag(xa.T @ (c[:, None] * xa)) + 0.3, 1e-12)


def test_hessian_full_refuses_shifts_and_sparse_designs(rng):
    _, _, pb = _batches(rng, True)
    po = GLMObjective(loss=port_losses.LOGISTIC_LOSS)
    with pytest.raises(ValueError, match="dense"):
        po.hessian_full(torch.zeros(D, dtype=torch.float64), pb)
    _, _, pb = _batches(rng, False)
    shifted = GLMObjective(loss=port_losses.LOGISTIC_LOSS,
                           normalization=normalization_from_numpy(np.ones(D), np.ones(D)))
    with pytest.raises(ValueError, match="scale-only"):
        shifted.hessian_full(torch.zeros(D, dtype=torch.float64), pb)
