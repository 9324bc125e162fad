"""The port's fused objective passes on the CPU (their plain PyTorch
versions, which the wrappers take for CPU tensors) against the JAX
package's Pallas ``fused_value_grad_curvature`` / ``fused_hessian_vector``
in interpret mode and against its XLA route (``ops.sparse`` matvec and
rmatvec), on the same seeded inputs.

Tolerances (``tests/test_kernels.py``): every output element within
rtol x the sum of the absolute terms it adds up (plus 1e-300), rtol f64
1e-12 (summation order only), f32 1e-6, bf16 values x f32 1e-2.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_ml_tpu.kernels import fused as jax_fused
from photon_ml_tpu.ops import losses as jax_losses
from photon_ml_tpu.ops import sparse as jax_sparse
from photon_ml_tpu_torch.kernels import dispatch
from photon_ml_tpu_torch.kernels.fused import (
    fused_compute_dtype,
    fused_hessian_vector,
    fused_value_grad_curvature,
)
from photon_ml_tpu_torch.ops import losses as port_losses

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

# (n, k, d, trailing padding slots, all-padding rows, duplicate ids)
MIXED = (157, 12, 300, 3, 5, True)
EDGES = [
    (64, 1, 157, 0, 0, False),  # k = 1
    (40, 6, 90, 6, 0, False),  # every slot padding
    (33, 8, 7, 0, 3, True),  # duplicate-heavy: 8 slots over 7 columns
    (300, 40, 1000, 2, 4, True),  # Criteo width
]


def _inputs(rng, n, k, d, pad, pad_rows, dup, dtype):
    idx = rng.integers(0, d, size=(n, k)).astype(np.int32)
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
    return _with_rows(rng, idx, val, d, dtype)


def _with_rows(rng, idx, val, d, dtype):
    """Seeded labels, offsets, weights and coefficients for a design, and
    every input as JAX and as torch arrays."""
    (jv, tv), (nc, tc) = DTYPES[dtype]
    n = idx.shape[0]
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
    """Per-output sums of absolute terms, in f64 with numpy. A margin z_i
    rounds by up to rtol * row_abs_i (the sum of |v w| and |offset|); that
    moves l by |l'| of it, a = ew l' by ew |l''| and c = ew l'' by
    ew |l'''| (<= 0.1 + l'' for these losses), so those moves join the
    terms each output adds up."""
    y, off, ew, w = (a.astype(np.float64) for a in rows)
    ids = np.where((idx >= 0) & (idx < d), idx, d)
    wp = np.append(w, 0.0)
    z = (val * wp[ids]).sum(-1) + off
    row_abs = (np.abs(val) * np.abs(wp[ids])).sum(-1) + np.abs(off)
    jl = JAX_LOSS[loss]
    jz, jy = jnp.asarray(z), jnp.asarray(y)
    a = np.abs(ew * np.asarray(jl.d1(jz, jy)))
    d2 = np.abs(np.asarray(jl.d2(jz, jy)))
    a_move = ew * d2 * row_abs
    grad = np.zeros(d + 1)
    np.add.at(grad, ids.reshape(-1), (np.abs(val) * (a + a_move)[:, None]).reshape(-1))
    val_scale = np.sum(np.abs(ew * np.asarray(jl.value(jz, jy))) + a * row_abs)
    c_scale = ew * (d2 + (0.25 + d2) * row_abs)
    return val_scale, grad[:d], np.sum(a + a_move), c_scale


@pytest.mark.parametrize("dtype", ["float64", "float32", "bfloat16"])
@pytest.mark.parametrize("loss", LOSSES)
def test_vgc_matches_jax_pallas_and_xla(rng, loss, dtype):
    _run_vgc(rng, MIXED, loss, dtype)


@pytest.mark.parametrize("dtype", ["float64", "float32", "bfloat16"])
@pytest.mark.parametrize("case", EDGES, ids=["k1", "all_padding", "duplicates", "criteo_width"])
def test_vgc_edge_shapes_match_jax(rng, case, dtype):
    _run_vgc(rng, case, "logistic", dtype)


def _run_vgc(rng, case, loss, dtype):
    n, k, d, pad, pad_rows, dup = case
    _vgc_against_jax(*_inputs(rng, n, k, d, pad, pad_rows, dup, dtype), d, loss, dtype)


def _vgc_against_jax(idx, val, rows, jax_in, torch_in, d, loss, dtype):
    n = idx.shape[0]
    pallas = jax_fused.fused_value_grad_curvature(*jax_in, d, JAX_LOSS[loss])
    # the XLA route: margins by gather, the gradient by scatter-add
    sf = jax_sparse.SparseFeatures(jax_in[0], jax_in[1], d)
    jy, joff, jew, jw = jax_in[2:]
    z = jax_sparse.matvec(sf, jw) + joff
    jl = JAX_LOSS[loss]
    a = jew * jl.d1(z, jy)
    xla = (jnp.sum(jew * jl.value(z, jy)), jax_sparse.rmatvec(sf, a), jnp.sum(a),
           jew * jl.d2(z, jy))
    before = dispatch.launch_counts()["fused_vgc"]
    got = fused_value_grad_curvature(*torch_in, d, PORT_LOSS[loss])
    assert dispatch.launch_counts()["fused_vgc"] == before  # CPU: plain version
    cd = DTYPES[dtype][1][1]
    assert all(t.dtype == cd for t in got)
    assert got[1].shape == (d,) and got[3].shape == (n,)
    scales = _scales(idx, val, rows, d, loss)
    for i, scale in enumerate(scales):
        if loss == "smoothed_hinge" and i == 3 and dtype != "float64":
            continue  # l'' is a step in the margin: rounding may cross it
        out = got[i].to(torch.float64).numpy()
        _close(out, np.asarray(pallas[i], np.float64), scale, RTOL[dtype])
        _close(out, np.asarray(xla[i], np.float64), scale, RTOL[dtype])


HVP_CASES = [MIXED] + EDGES


@pytest.mark.parametrize("dtype", ["float64", "float32", "bfloat16"])
@pytest.mark.parametrize("case", HVP_CASES,
                         ids=["mixed", "k1", "all_padding", "duplicates", "criteo_width"])
def test_hvp_matches_jax_pallas_and_xla(rng, case, dtype):
    n, k, d, pad, pad_rows, dup = case
    _hvp_against_jax(*_inputs(rng, n, k, d, pad, pad_rows, dup, dtype), d, dtype)


def _hvp_against_jax(idx, val, rows, jax_in, torch_in, d, dtype):
    _, _, ew, v = rows  # curvature weights c >= 0 and the CG direction
    shift = 0.25
    j_c, j_v = jnp.asarray(ew), jnp.asarray(v)
    pallas = jax_fused.fused_hessian_vector(jax_in[0], jax_in[1], j_c, j_v, shift, d)
    sf = jax_sparse.SparseFeatures(jax_in[0], jax_in[1], d)
    u = j_c * (jax_sparse.matvec(sf, j_v) + shift)
    xla = (jax_sparse.rmatvec(sf, u), jnp.sum(u))
    before = dispatch.launch_counts()["fused_hvp"]
    got = fused_hessian_vector(torch_in[0], torch_in[1], torch.from_numpy(ew),
                               torch.from_numpy(v), shift, d)
    assert dispatch.launch_counts()["fused_hvp"] == before
    ids = np.where(idx < d, idx, d)
    vp = np.append(np.abs(v.astype(np.float64)), 0.0)
    u_abs = np.abs(ew) * ((np.abs(val) * vp[ids]).sum(-1) + shift)
    hv_scale = np.zeros(d + 1)
    np.add.at(hv_scale, ids.reshape(-1), (np.abs(val) * u_abs[:, None]).reshape(-1))
    for i, scale in enumerate((hv_scale[:d], u_abs.sum())):
        out = got[i].to(torch.float64).numpy()
        _close(out, np.asarray(pallas[i], np.float64), scale, RTOL[dtype])
        _close(out, np.asarray(xla[i], np.float64), scale, RTOL[dtype])


# -- a hot-column design in the Criteo layout ---------------------------------


def _criteo_like(rng, n, d, dtype):
    """(indices, values) in the Criteo layout over d columns: 13 integer
    fields on fixed columns and the intercept (column d - 1), all named by
    every row, 26 categorical fields with Zipf(1.2) categories hashed into
    [0, d - 1) (the head categories are named by many rows, and two fields
    may share a column), and a trailing padding slot in every third row
    (the others hold a duplicate of a category). As in test_torch_ell.py."""
    int_cols = rng.choice(d - 1, 13, replace=False)
    cats = rng.zipf(1.2, size=(n, 26)) % 1_000_003
    cat_cols = (cats * 2_654_435_761 + np.arange(26) * 7919) % (d - 1)
    idx = np.concatenate(
        [np.broadcast_to(int_cols, (n, 13)), cat_cols, np.full((n, 1), d - 1),
         np.full((n, 1), d)], axis=1).astype(np.int32)
    counts = rng.geometric(0.05, size=(n, 13)) - 1
    val = np.concatenate(
        [np.log1p(counts), np.ones((n, 26)), np.ones((n, 1)), np.zeros((n, 1))], axis=1)
    idx[1::3, -1] = idx[1::3, 20]
    val[1::3, -1] = 0.5
    if dtype == "bfloat16":
        val = np.array(jnp.asarray(val, jnp.bfloat16).astype(jnp.float32))
    return idx, val


HOT_VGC_CASES = [(96, "logistic")] + [(301, loss) for loss in LOSSES]


@pytest.mark.parametrize("dtype", ["float64", "float32", "bfloat16"])
@pytest.mark.parametrize("n,loss", HOT_VGC_CASES)
def test_vgc_hot_columns_match_jax(rng, n, loss, dtype):
    d = 513
    idx, val = _criteo_like(rng, n, d, dtype)
    # the intercept and the integer fields are named by every row
    assert np.count_nonzero(np.bincount(idx[idx < d], minlength=d) >= n) >= 14
    _vgc_against_jax(*_with_rows(rng, idx, val, d, dtype), d, loss, dtype)


@pytest.mark.parametrize("dtype", ["float64", "float32", "bfloat16"])
@pytest.mark.parametrize("n", [96, 301])
def test_hvp_hot_columns_match_jax(rng, n, dtype):
    d = 513
    idx, val = _criteo_like(rng, n, d, dtype)
    _hvp_against_jax(*_with_rows(rng, idx, val, d, dtype), d, dtype)


def test_vgc_of_an_empty_batch(rng):
    idx = torch.zeros((0, 4), dtype=torch.int32)
    z = torch.zeros(0, dtype=torch.float64)
    val, grad, asum, c = fused_value_grad_curvature(
        idx, torch.zeros((0, 4), dtype=torch.float64), z, z, z,
        torch.ones(9, dtype=torch.float64), 9, port_losses.LOGISTIC_LOSS,
    )
    assert float(val) == 0.0 and float(asum) == 0.0
    assert grad.shape == (9,) and not grad.any() and c.shape == (0,)


@pytest.mark.parametrize(
    "vdt,odt",
    [(torch.float32, torch.float64), (torch.bfloat16, torch.float64),
     (torch.float16, torch.float32)],
)
def test_unsupported_dtype_pairs_raise(vdt, odt):
    with pytest.raises(TypeError, match="fused passes"):
        fused_compute_dtype(vdt, odt)


def test_unknown_loss_raises():
    loss = port_losses.PointwiseLoss("cubic", *(lambda z, y: z,) * 3)
    idx = torch.zeros((2, 2), dtype=torch.int32)
    one = torch.ones(2, dtype=torch.float64)
    with pytest.raises(ValueError, match="cubic"):
        fused_value_grad_curvature(idx, torch.ones((2, 2), dtype=torch.float64),
                                   one, one, one, one, 2, loss)


def test_cost_records_one_design_read(rng):
    n, k, d = 21, 5, 50
    _, _, _, _, t = _inputs(rng, n, k, d, 1, 0, False, "float32")
    fused_value_grad_curvature(*t, d, port_losses.LOGISTIC_LOSS)
    fused_hessian_vector(t[0], t[1], t[4], t[5], 0.0, d)
    costs = dispatch.kernel_costs()
    for kernel in ("fused_vgc", "fused_hvp"):
        assert dispatch.design_reads(kernel) == 1
        assert costs[(kernel, n, k, d, 4)]["roofline_bytes"] == n * k * 8
