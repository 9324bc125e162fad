"""The port's CUDA kernels on the card, against their plain PyTorch
versions. Marked ``cuda``: they skip on a machine without a CUDA device.
This file imports neither jax nor the JAX package, so it also runs where
JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import pytest
import torch

from photon_ml_tpu_torch.kernels import dispatch
from photon_ml_tpu_torch.kernels.ell import ell_matvec, ell_matvec_reference

pytestmark = pytest.mark.cuda

# (values dtype, w dtype, rtol against sum_k |v w| per row)
DTYPES = [
    (torch.float64, torch.float64, 1e-12),
    (torch.float32, torch.float32, 1e-5),
    (torch.bfloat16, torch.float32, 1e-2),
]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _ell(n, k, d, device, seed=7):
    g = torch.Generator(device=device).manual_seed(seed)
    idx = torch.randint(0, d, (n, k), generator=g, device=device, dtype=torch.int32)
    val = torch.randn((n, k), generator=g, device=device, dtype=torch.float64)
    if k > 1:
        idx[::3, -1] = d  # padding slot
        val[::3, -1] = 0.0
        idx[1::5, 1] = idx[1::5, 0]  # duplicate ids
    return idx, val


@pytest.mark.parametrize("vdt,wdt,rtol", DTYPES)
@pytest.mark.parametrize("n,k", [(10007, 40), (999, 1), (4097, 5), (513, 17), (33, 64)])
def test_kernel_matches_plain_version(cuda, n, k, vdt, wdt, rtol):
    d = 3001
    idx, val64 = _ell(n, k, d, cuda)
    val = val64.to(vdt)
    w = torch.randn(d, device=cuda, dtype=torch.float64).to(wdt)
    before = dispatch.launch_counts()["ell_matvec"]
    got = ell_matvec(idx, val, w, d)
    torch.cuda.synchronize()
    assert dispatch.launch_counts()["ell_matvec"] == before + 1
    ref = ell_matvec_reference(idx, val, w, d)
    row_abs = ell_matvec_reference(idx, val.abs().double(), w.abs().double(), d)
    assert got.dtype == ref.dtype and got.shape == (n,)
    assert torch.all((got.double() - ref.double()).abs() <= rtol * row_abs)


def test_empty_batch_launches_nothing(cuda):
    before = dispatch.launch_counts()["ell_matvec"]
    out = ell_matvec(
        torch.zeros((0, 4), dtype=torch.int32, device=cuda),
        torch.zeros((0, 4), dtype=torch.float64, device=cuda),
        torch.zeros(9, dtype=torch.float64, device=cuda), 9,
    )
    assert out.shape == (0,)
    assert dispatch.launch_counts()["ell_matvec"] == before


def test_wrapper_raises_on_what_the_kernel_does_not_take(cuda):
    idx, val = _ell(64, 8, 100, cuda)
    w = torch.randn(100, device=cuda, dtype=torch.float64)
    with pytest.raises(TypeError, match="int32"):
        ell_matvec(idx.long(), val, w, 100)
    with pytest.raises(ValueError, match="contiguous"):
        ell_matvec(idx.t().contiguous().t(), val.t().contiguous().t(), w, 100)
    with pytest.raises(ValueError, match=r"\(100,\)"):
        ell_matvec(idx, val, w[:50], 100)
    with pytest.raises(ValueError, match="more than one device"):
        ell_matvec(idx, val, w.cpu(), 100)


# -- ell_scatter_add, ell_rmatvec, ell_colsum ---------------------------------

from photon_ml_tpu_torch.kernels.ell import (  # noqa: E402
    ell_colsum,
    ell_colsum_reference,
    ell_rmatvec,
    ell_rmatvec_reference,
    ell_scatter_add,
    ell_scatter_add_reference,
)
from photon_ml_tpu_torch.kernels.fused import (  # noqa: E402
    fused_hessian_vector,
    fused_hessian_vector_reference,
    fused_value_grad_curvature,
    fused_value_grad_curvature_reference,
)
from photon_ml_tpu_torch.ops.losses import (  # noqa: E402
    LOGISTIC_LOSS,
    POISSON_LOSS,
    SMOOTHED_HINGE_LOSS,
    SQUARED_LOSS,
)

# (update / compute dtype, rtol against the column or row sum of |terms|)
SCATTER_DTYPES = [(torch.float64, 1e-12), (torch.float32, 1e-5)]
LOSSES = [LOGISTIC_LOSS, SQUARED_LOSS, POISSON_LOSS, SMOOTHED_HINGE_LOSS]
SHAPES = [(10007, 40), (999, 1), (4097, 5), (513, 17), (33, 64)]


def _within(got, ref, scale, rtol):
    return bool(torch.all((got.double() - ref.double()).abs() <= rtol * scale + 1e-300))


@pytest.mark.parametrize("dt,rtol", SCATTER_DTYPES)
@pytest.mark.parametrize("n,k", SHAPES)
def test_scatter_add_matches_plain_version(cuda, n, k, dt, rtol):
    d = 3001
    idx, val64 = _ell(n, k, d, cuda)
    upd = val64.to(dt)
    before = dispatch.launch_counts()["ell_scatter_add"]
    got = ell_scatter_add(idx, upd, d)
    torch.cuda.synchronize()
    assert dispatch.launch_counts()["ell_scatter_add"] == before + 1
    ref = ell_scatter_add_reference(idx, upd, d)
    col_abs = ell_scatter_add_reference(idx, upd.abs().double(), d)
    assert got.dtype == dt and got.shape == (d,)
    assert _within(got, ref, col_abs, rtol)


def test_rmatvec_and_colsum_count_their_scatter(cuda):
    d = 500
    idx, val = _ell(2000, 9, d, cuda)
    a = torch.randn(2000, device=cuda, dtype=torch.float64)
    before = dispatch.launch_counts()
    g = ell_rmatvec(idx, val, a, d)
    s = ell_colsum(idx, val, a.abs(), d, square=True)
    after = dispatch.launch_counts()
    assert after["ell_scatter_add"] == before["ell_scatter_add"] + 2
    assert after["ell_rmatvec"] == before["ell_rmatvec"] + 1
    assert after["ell_colsum"] == before["ell_colsum"] + 1
    ref_g = ell_rmatvec_reference(idx, val, a, d)
    ref_s = ell_colsum_reference(idx, val, a.abs(), d, square=True)
    scale_g = ell_scatter_add_reference(idx, (val * a[:, None]).abs(), d)
    assert _within(g, ref_g, scale_g, 1e-12)
    assert _within(s, ref_s, ref_s.abs(), 1e-12)


def _fused_inputs(n, k, d, dt, device, seed=11):
    g = torch.Generator(device=device).manual_seed(seed)
    labels = torch.randint(0, 2, (n,), generator=g, device=device).double()
    offsets = 0.1 * torch.randn(n, generator=g, device=device, dtype=torch.float64)
    ew = torch.rand(n, generator=g, device=device, dtype=torch.float64) + 0.5
    ew[::7] = 0.0  # padding rows
    w = 0.2 * torch.randn(d, generator=g, device=device, dtype=torch.float64)
    cd = torch.float64 if dt == torch.float64 else torch.float32
    return labels.to(cd), offsets.to(cd), ew.to(cd), w.to(cd)


@pytest.mark.parametrize("loss", LOSSES, ids=lambda l: l.name)
@pytest.mark.parametrize("vdt,wdt,rtol", DTYPES)
@pytest.mark.parametrize("n,k", SHAPES)
def test_fused_vgc_matches_plain_version(cuda, n, k, vdt, wdt, rtol, loss):
    d = 3001
    idx, val64 = _ell(n, k, d, cuda)
    val = val64.to(vdt)
    y, off, ew, w = _fused_inputs(n, k, d, vdt, cuda)
    before = dispatch.launch_counts()["fused_vgc"]
    got = fused_value_grad_curvature(idx, val, y, off, ew, w, d, loss)
    torch.cuda.synchronize()
    assert dispatch.launch_counts()["fused_vgc"] == before + 1
    ref = fused_value_grad_curvature_reference(idx, val, y, off, ew, w, d, loss)
    # scales: the sums of |terms| each output element adds up
    cd = ref[1].dtype
    z = ell_matvec_reference(idx, val, w, d) + off
    a = ew * loss.d1(z, y)
    val_scale = (ew * loss.value(z, y)).abs().sum()
    grad_scale = ell_scatter_add_reference(idx, (val.to(cd) * a[:, None]).abs().double(), d)
    row_abs = ell_matvec_reference(idx, val.abs().double(), w.abs().double(), d) + off.abs()
    c_scale = (ew * loss.d2(z + row_abs.to(cd), y)).abs() + (ew * loss.d2(z, y)).abs()
    assert _within(got[0], ref[0], val_scale, rtol)
    assert _within(got[1], ref[1], grad_scale, rtol)
    assert _within(got[2], ref[2], a.abs().sum(), rtol)
    assert got[3].shape == (n,) and bool(torch.isfinite(got[3]).all())
    if loss is not SMOOTHED_HINGE_LOSS:  # its l'' is a step in the margin
        assert _within(got[3], ref[3], c_scale, max(rtol, 1e-10) * 10)


def test_fused_vgc_scalars_are_run_to_run_stable(cuda):
    d = 3001
    idx, val = _ell(20011, 40, d, cuda)
    y, off, ew, w = _fused_inputs(20011, 40, d, torch.float64, cuda)
    first = fused_value_grad_curvature(idx, val, y, off, ew, w, d, LOGISTIC_LOSS)
    for _ in range(3):
        again = fused_value_grad_curvature(idx, val, y, off, ew, w, d, LOGISTIC_LOSS)
        assert torch.equal(first[0], again[0]) and torch.equal(first[2], again[2])


@pytest.mark.parametrize("vdt,wdt,rtol", DTYPES)
@pytest.mark.parametrize("n,k", SHAPES)
def test_fused_hvp_matches_plain_version(cuda, n, k, vdt, wdt, rtol):
    d = 3001
    idx, val64 = _ell(n, k, d, cuda)
    val = val64.to(vdt)
    _, _, c, v = _fused_inputs(n, k, d, vdt, cuda, seed=5)
    shift = torch.tensor(0.3, device=cuda, dtype=c.dtype)
    before = dispatch.launch_counts()["fused_hvp"]
    hv, usum = fused_hessian_vector(idx, val, c, v, shift, d)
    torch.cuda.synchronize()
    assert dispatch.launch_counts()["fused_hvp"] == before + 1
    ref_hv, ref_usum = fused_hessian_vector_reference(idx, val, c, v, shift, d)
    zv_abs = ell_matvec_reference(idx, val.abs().double(), v.abs().double(), d) + 0.3
    u_abs = c.abs().double() * zv_abs
    hv_scale = ell_scatter_add_reference(idx, val.abs().double() * u_abs[:, None], d)
    assert _within(hv, ref_hv, hv_scale, rtol)
    assert _within(usum, ref_usum, u_abs.sum(), rtol)


from photon_ml_tpu_torch.kernels.fused import (  # noqa: E402
    fused_hessian_diagonal,
    fused_hessian_diagonal_reference,
)


@pytest.mark.parametrize("loss", LOSSES, ids=lambda l: l.name)
@pytest.mark.parametrize("vdt,wdt,rtol", DTYPES)
@pytest.mark.parametrize("n,k", SHAPES)
def test_fused_hdiag_matches_plain_version(cuda, n, k, vdt, wdt, rtol, loss):
    d = 3001
    idx, val64 = _ell(n, k, d, cuda)
    val = val64.to(vdt)
    y, off, ew, w = _fused_inputs(n, k, d, vdt, cuda, seed=13)
    before = dispatch.launch_counts()["fused_hdiag"]
    got = fused_hessian_diagonal(idx, val, y, off, ew, w, d, loss)
    torch.cuda.synchronize()
    assert dispatch.launch_counts()["fused_hdiag"] == before + 1
    ref = fused_hessian_diagonal_reference(idx, val, y, off, ew, w, d, loss)
    cd = ref[0].dtype
    assert all(t.dtype == cd for t in got)
    assert got[0].shape == (d,) and got[1].shape == (d,) and got[2].shape == ()
    # scales: each output's sum of |terms|, where c_i may move by the
    # margin's rounding (|l'''| bounded as for fused_vgc's curvature)
    v = val.to(cd)
    z = ell_matvec_reference(idx, v, w, d) + off
    row_abs = ell_matvec_reference(idx, v.abs().double(), w.abs().double(), d) + off.abs()
    c_abs = (ew * loss.d2(z, y)).abs().double() + ew.double() * row_abs * 0.25
    if loss is POISSON_LOSS:
        c_abs = c_abs + (ew * loss.d2(z, y)).abs().double() * row_abs
    if loss is SMOOTHED_HINGE_LOSS:  # its l'' is a step in the margin
        c_abs = ew.double().abs()
    scale2 = ell_scatter_add_reference(idx, (v.double() ** 2) * c_abs[:, None], d)
    scale1 = ell_scatter_add_reference(idx, v.double().abs() * c_abs[:, None], d)
    tol = max(rtol, 1e-10)
    assert _within(got[0], ref[0], scale2, tol)
    assert _within(got[1], ref[1], scale1, tol)
    assert _within(got[2], ref[2], c_abs.sum(), tol)


def test_fused_hdiag_squares_each_duplicate_slot(cuda):
    # two slots of one row on one column: v^2 per slot, as the JAX kernel
    idx = torch.tensor([[2, 2, 5]], dtype=torch.int32, device=cuda)
    val = torch.tensor([[1.5, -0.5, 0.0]], dtype=torch.float64, device=cuda)
    one = torch.ones(1, dtype=torch.float64, device=cuda)
    w = torch.zeros(5, dtype=torch.float64, device=cuda)
    dx2, dx, csum = fused_hessian_diagonal(idx, val, one, 0 * one, one, w, 5, SQUARED_LOSS)
    assert dx2.tolist() == [0.0, 0.0, 2.5, 0.0, 0.0]
    assert dx.tolist() == [0.0, 0.0, 1.0, 0.0, 0.0] and float(csum) == 1.0


def test_fused_hdiag_scalar_is_run_to_run_stable_and_empty_launches_nothing(cuda):
    d = 3001
    idx, val = _ell(20011, 40, d, cuda)
    y, off, ew, w = _fused_inputs(20011, 40, d, torch.float64, cuda)
    first = fused_hessian_diagonal(idx, val, y, off, ew, w, d, LOGISTIC_LOSS)[2]
    for _ in range(3):
        assert torch.equal(first, fused_hessian_diagonal(
            idx, val, y, off, ew, w, d, LOGISTIC_LOSS)[2])
    before = dispatch.launch_counts()["fused_hdiag"]
    z = torch.zeros(0, dtype=torch.float64, device=cuda)
    dx2, dx, csum = fused_hessian_diagonal(
        torch.zeros((0, 4), dtype=torch.int32, device=cuda),
        torch.zeros((0, 4), dtype=torch.float64, device=cuda), z, z, z,
        torch.ones(9, dtype=torch.float64, device=cuda), 9, LOGISTIC_LOSS)
    assert dispatch.launch_counts()["fused_hdiag"] == before
    assert not dx2.any() and not dx.any() and float(csum) == 0.0


def test_fused_wrappers_raise_on_what_the_kernels_do_not_take(cuda):
    d = 100
    idx, val = _ell(64, 8, d, cuda)
    y, off, ew, w = _fused_inputs(64, 8, d, torch.float64, cuda)
    with pytest.raises(TypeError, match="int32"):
        fused_value_grad_curvature(idx.long(), val, y, off, ew, w, d, LOGISTIC_LOSS)
    with pytest.raises(ValueError, match=r"\(100,\)"):
        fused_value_grad_curvature(idx, val, y, off, ew, w[:50], d, LOGISTIC_LOSS)
    with pytest.raises(ValueError, match="more than one device"):
        fused_hessian_vector(idx, val, ew.cpu(), w, torch.tensor(0.0), d)
    with pytest.raises(TypeError, match="fused passes"):
        fused_value_grad_curvature(idx, val.float(), y, off, ew, w, d, LOGISTIC_LOSS)
    with pytest.raises(TypeError, match="int32"):
        fused_hessian_diagonal(idx.long(), val, y, off, ew, w, d, LOGISTIC_LOSS)
    with pytest.raises(ValueError, match=r"\(64,\)"):
        fused_hessian_diagonal(idx, val, y[:10], off, ew, w, d, LOGISTIC_LOSS)
    with pytest.raises(ValueError, match="more than one device"):
        fused_hessian_diagonal(idx, val, y, off, ew.cpu(), w, d, LOGISTIC_LOSS)
