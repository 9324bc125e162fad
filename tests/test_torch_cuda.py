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
    # on the card both go through the column-sorted reduce, not the scatter
    d = 500
    idx, val = _ell(2000, 9, d, cuda)
    a = torch.randn(2000, device=cuda, dtype=torch.float64)
    before = dispatch.launch_counts()
    g = ell_rmatvec(idx, val, a, d)
    s = ell_colsum(idx, val, a.abs(), d, square=True)
    after = dispatch.launch_counts()
    assert after["ell_scatter_add"] == before["ell_scatter_add"]
    assert after["colsort_reduce"] == before["colsort_reduce"] + 2
    assert after["ell_rmatvec"] == before["ell_rmatvec"] + 1
    assert after["ell_colsum"] == before["ell_colsum"] + 1
    for _ in range(2):
        assert torch.equal(g, ell_rmatvec(idx, val, a, d))
        assert torch.equal(s, ell_colsum(idx, val, a.abs(), d, square=True))
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


# the fused passes also take k = 0 (row terms from the offsets alone) and
# rows longer than one 1024-slot round, in 4-slot granules (k = 2500) and
# 1-slot ones (k = 4099)
FUSED_SHAPES = SHAPES + [(300, 0), (5, 2500), (3, 4099)]


def _vgc_on_margins(idx, val, y, ew, z, d, loss):
    """The plain version of fused_vgc on the margins z: the row terms in
    the compute type, as the kernel computes them, every sum in f64."""
    a = ew * loss.d1(z, y)
    upd = (val.to(a.dtype) * a[:, None]).double()
    return ((ew * loss.value(z, y)).double().sum(), ell_scatter_add_reference(idx, upd, d),
            a.double().sum(), ew * loss.d2(z, y))


def _check_vgc(idx, val, y, off, ew, w, d, loss, rtol):
    """The four outputs against the plain version on the kernel's own
    margins. ``ell_matvec`` sums each row in the fused pass's granule
    order, and its margins are first held to the plain version's. Where l'
    cancels (z - y, e^z - y, m - 1) a margin summed in another order moves
    a by more than a's own size, and a long row's e^z by more than rtol:
    so the plain version's row terms are taken on those margins, in the
    compute type as the kernel takes them, and summed in f64."""
    before = dispatch.launch_counts()["fused_vgc"]
    got = fused_value_grad_curvature(idx, val, y, off, ew, w, d, loss)
    torch.cuda.synchronize()
    assert dispatch.launch_counts()["fused_vgc"] == before + 1
    cd = got[1].dtype
    z = ell_matvec(idx, val, w, d) + off
    row_abs = ell_matvec_reference(idx, val.abs().double(), w.abs().double(), d) + off.abs()
    assert _within(z, ell_matvec_reference(idx, val, w, d) + off, row_abs, rtol)
    ref = _vgc_on_margins(idx, val, y, ew, z, d, loss)
    # scales: the sums of |terms| each output element adds up
    a = ew * loss.d1(z, y)
    val_scale = (ew * loss.value(z, y)).abs().sum()
    grad_scale = ell_scatter_add_reference(idx, (val.to(cd) * a[:, None]).abs().double(), d)
    # in f64: a long Poisson row's e^(z + row_abs) passes the f32 range
    c_scale = ((ew.double() * loss.d2(z.double() + row_abs, y.double())).abs()
               + (ew * loss.d2(z, y)).abs().double())
    assert _within(got[0], ref[0], val_scale, rtol)
    assert _within(got[1], ref[1], grad_scale, rtol)
    assert _within(got[2], ref[2], a.abs().sum(), rtol)
    assert got[3].shape == (idx.shape[0],) and bool(torch.isfinite(got[3]).all())
    # the smoothed hinge's l'' is a step in the margin: the same margins
    # take the same step
    assert _within(got[3], ref[3], c_scale, max(rtol, 1e-10) * 10)
    return got


@pytest.mark.parametrize("loss", LOSSES, ids=lambda l: l.name)
@pytest.mark.parametrize("vdt,wdt,rtol", DTYPES)
@pytest.mark.parametrize("n,k", FUSED_SHAPES)
def test_fused_vgc_matches_plain_version(cuda, n, k, vdt, wdt, rtol, loss):
    d = 3001
    idx, val64 = _ell(n, k, d, cuda)
    y, off, ew, w = _fused_inputs(n, k, d, vdt, cuda)
    _check_vgc(idx, val64.to(vdt), y, off, ew, w, d, loss, rtol)


def test_fused_vgc_scalars_are_run_to_run_stable(cuda):
    d = 3001
    idx, val = _ell(20011, 40, d, cuda)
    y, off, ew, w = _fused_inputs(20011, 40, d, torch.float64, cuda)
    first = fused_value_grad_curvature(idx, val, y, off, ew, w, d, LOGISTIC_LOSS)
    for _ in range(3):
        again = fused_value_grad_curvature(idx, val, y, off, ew, w, d, LOGISTIC_LOSS)
        assert torch.equal(first[0], again[0]) and torch.equal(first[2], again[2])


def _check_hvp(idx, val, c, v, shift, d, rtol):
    before = dispatch.launch_counts()["fused_hvp"]
    hv, usum = fused_hessian_vector(idx, val, c, v, shift, d)
    torch.cuda.synchronize()
    assert dispatch.launch_counts()["fused_hvp"] == before + 1
    ref_hv, ref_usum = fused_hessian_vector_reference(idx, val, c, v, shift, d)
    zv_abs = ell_matvec_reference(idx, val.abs().double(), v.abs().double(), d) + shift.abs()
    u_abs = c.abs().double() * zv_abs
    hv_scale = ell_scatter_add_reference(idx, val.abs().double() * u_abs[:, None], d)
    assert hv.dtype == ref_hv.dtype and hv.shape == (d,) and usum.shape == ()
    assert _within(hv, ref_hv, hv_scale, rtol)
    assert _within(usum, ref_usum, u_abs.sum(), rtol)
    return hv, usum


@pytest.mark.parametrize("vdt,wdt,rtol", DTYPES)
@pytest.mark.parametrize("n,k", FUSED_SHAPES)
def test_fused_hvp_matches_plain_version(cuda, n, k, vdt, wdt, rtol):
    d = 3001
    idx, val64 = _ell(n, k, d, cuda)
    _, _, c, v = _fused_inputs(n, k, d, vdt, cuda, seed=5)
    shift = torch.tensor(0.3, device=cuda, dtype=c.dtype)
    _check_hvp(idx, val64.to(vdt), c, v, shift, d, rtol)


from photon_ml_tpu_torch.kernels.fused import (  # noqa: E402
    fused_hessian_diagonal,
    fused_hessian_diagonal_reference,
)


@pytest.mark.parametrize("loss", LOSSES, ids=lambda l: l.name)
@pytest.mark.parametrize("vdt,wdt,rtol", DTYPES)
@pytest.mark.parametrize("n,k", FUSED_SHAPES)
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


def _check_hdiag(idx, val, y, off, ew, w, d, loss, rtol):
    """The three outputs against the plain version on the kernel's own
    margins, as ``_check_vgc``: where l'' is a step (smoothed hinge) or
    grows with e^z (Poisson), a margin summed in another order moves c past
    its scale. The margins are first held to the plain version's; c and
    each slot's v^2 c and v c are taken on them in the compute type, as the
    kernel takes them, and summed in f64."""
    before = dispatch.launch_counts()["fused_hdiag"]
    got = fused_hessian_diagonal(idx, val, y, off, ew, w, d, loss)
    torch.cuda.synchronize()
    assert dispatch.launch_counts()["fused_hdiag"] == before + 1
    cd = got[0].dtype
    assert all(t.dtype == cd for t in got)
    assert got[0].shape == (d,) and got[1].shape == (d,) and got[2].shape == ()
    z = ell_matvec(idx, val, w, d) + off
    row_abs = ell_matvec_reference(idx, val.abs().double(), w.abs().double(), d) + off.abs()
    assert _within(z, ell_matvec_reference(idx, val, w, d) + off, row_abs, rtol)
    c = ew * loss.d2(z, y)
    v = val.to(cd)
    upd2, upd1 = v * v * c[:, None], v * c[:, None]
    # scales: the sums of |terms| each output element adds up
    for out, upd in ((got[0], upd2), (got[1], upd1)):
        assert _within(out, ell_scatter_add_reference(idx, upd.double(), d),
                       ell_scatter_add_reference(idx, upd.abs().double(), d), rtol)
    assert _within(got[2], c.double().sum(), c.abs().double().sum(), rtol)
    return got


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


# -- the tile combiner of ell_scatter_add and the granules of ell_matvec -------


def _criteo_like(n, d, device, seed=17):
    """The Criteo layout's hot pattern over d columns: 14 columns (13
    integer fields and the intercept) named by every row, then 26
    categorical fields with Zipf(1.2) categories hashed into [0, d)."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    hot = torch.randperm(d, generator=g)[:14]
    u = torch.rand((n, 26), generator=g, dtype=torch.float64)
    cats = torch.floor(u.pow(-1.0 / 0.2)).clamp(max=1e9).long()  # Pareto tail, Zipf-like
    cat_cols = (cats * 2_654_435_761 + torch.arange(26) * 7919) % d
    idx = torch.cat([hot.expand(n, 14), cat_cols], 1).to(torch.int32)
    val = torch.randn((n, 40), generator=g, dtype=torch.float64)
    return idx.to(device), val.to(device)


def _one_column(n, k, d, device):
    idx = torch.full((n, k), d // 2, dtype=torch.int32, device=device)
    val = torch.randn((n, k), device=device, dtype=torch.float64)
    return idx, val


def _colliding(n, k, d, device):
    """Distinct ids 65536 apart: every one falls on one slot of any table
    of 65536 entries or fewer, so most take the direct atomic path."""
    ids = (torch.arange(n * k, device=device) % 300) * 65536 + 7
    idx = (ids % d).to(torch.int32).reshape(n, k)
    val = torch.randn((n, k), device=device, dtype=torch.float64)
    return idx, val


def _out_of_range(n, k, d, device):
    idx, val = _ell(n, k, d, device, seed=3)
    idx[::2, 0] = -1
    idx[1::4, 2] = -(2**31)
    idx[2::4, 3] = d + 1
    idx[3::4, 1] = 2**31 - 1
    return idx, val


def _misaligned(t):
    """The same rows one slot further on in a larger buffer: contiguous,
    but not aligned for vector loads."""
    n, k = t.shape
    flat = torch.empty(n * k + 1, dtype=t.dtype, device=t.device)
    flat[1:] = t.reshape(-1)
    return flat[1:].view(n, k)


DESIGNS = {
    "criteo_hot": lambda dev: (*_criteo_like(20011, 1 << 20, dev), 1 << 20),
    "one_column": lambda dev: (*_one_column(5003, 40, 3001, dev), 3001),
    "colliding": lambda dev: (*_colliding(6007, 40, 1 << 26, dev), 1 << 26),
    "out_of_range": lambda dev: (*_out_of_range(4099, 40, 3001, dev), 3001),
    "misaligned": lambda dev: (*(_misaligned(t) for t in _ell(4099, 40, 3001, dev)), 3001),
    "misaligned_k5": lambda dev: (*(_misaligned(t) for t in _ell(999, 5, 3001, dev)), 3001),
}


@pytest.mark.parametrize("dt,rtol", SCATTER_DTYPES)
@pytest.mark.parametrize("design", sorted(DESIGNS))
def test_scatter_add_designs_match_plain_version(cuda, design, dt, rtol):
    idx, val64, d = DESIGNS[design](cuda)
    upd = val64.to(dt)
    got = ell_scatter_add(idx, upd, d)
    torch.cuda.synchronize()
    ref = ell_scatter_add_reference(idx, upd, d)
    col_abs = ell_scatter_add_reference(idx, upd.abs().double(), d)
    assert got.dtype == dt and got.shape == (d,)
    assert _within(got, ref, col_abs, rtol)


@pytest.mark.parametrize("vdt,wdt,rtol", DTYPES)
@pytest.mark.parametrize("design", sorted(DESIGNS))
def test_matvec_designs_match_plain_version(cuda, design, vdt, wdt, rtol):
    idx, val64, d = DESIGNS[design](cuda)
    val = val64.to(vdt)
    w = torch.randn(d, device=cuda, dtype=torch.float64).to(wdt)
    got = ell_matvec(idx, val, w, d)
    torch.cuda.synchronize()
    ref = ell_matvec_reference(idx, val, w, d)
    row_abs = ell_matvec_reference(idx, val.abs().double(), w.abs().double(), d)
    assert torch.all((got.double() - ref.double()).abs() <= rtol * row_abs)


@pytest.mark.parametrize("vdt,wdt,rtol", DTYPES)
@pytest.mark.parametrize("n,k", SHAPES + [(3, 5000), (70001, 4)])
def test_matvec_has_the_same_bits_from_run_to_run(cuda, n, k, vdt, wdt, rtol):
    d = 3001
    idx, val64 = _ell(n, k, d, cuda)
    val = val64.to(vdt)
    w = torch.randn(d, device=cuda, dtype=torch.float64).to(wdt)
    first = ell_matvec(idx, val, w, d)
    for _ in range(2):
        assert torch.equal(first, ell_matvec(idx, val, w, d))
    ref = ell_matvec_reference(idx, val, w, d)
    row_abs = ell_matvec_reference(idx, val.abs().double(), w.abs().double(), d)
    assert torch.all((first.double() - ref.double()).abs() <= rtol * row_abs)


def test_scatter_add_one_column_sums_every_slot(cuda):
    # 2^17 slots on one column: one global atomic per tile
    idx = torch.full((4096, 32), 7, dtype=torch.int32, device=cuda)
    upd = torch.full((4096, 32), 0.5, dtype=torch.float64, device=cuda)
    got = ell_scatter_add(idx, upd, 9)
    assert got.tolist() == [0.0] * 7 + [65536.0, 0.0]


def test_matvec_of_zero_slots_is_zero(cuda):
    idx = torch.zeros((300, 0), dtype=torch.int32, device=cuda)
    val = torch.zeros((300, 0), dtype=torch.float64, device=cuda)
    got = ell_matvec(idx, val, torch.ones(5, dtype=torch.float64, device=cuda), 5)
    assert got.shape == (300,) and not got.any()


# -- the fused passes' tiles: the combiner, the granules, the scalars' bits ---


@pytest.mark.parametrize("loss", LOSSES, ids=lambda l: l.name)
@pytest.mark.parametrize("vdt,wdt,rtol", DTYPES)
@pytest.mark.parametrize("design", sorted(DESIGNS))
def test_fused_vgc_designs_match_plain_version(cuda, design, vdt, wdt, rtol, loss):
    idx, val64, d = DESIGNS[design](cuda)
    y, off, ew, w = _fused_inputs(idx.shape[0], idx.shape[1], d, vdt, cuda)
    _check_vgc(idx, val64.to(vdt), y, off, ew, w, d, loss, rtol)


@pytest.mark.parametrize("vdt,wdt,rtol", DTYPES)
@pytest.mark.parametrize("design", sorted(DESIGNS))
def test_fused_hvp_designs_match_plain_version(cuda, design, vdt, wdt, rtol):
    idx, val64, d = DESIGNS[design](cuda)
    _, _, c, v = _fused_inputs(idx.shape[0], idx.shape[1], d, vdt, cuda, seed=5)
    shift = torch.tensor(-0.2, device=cuda, dtype=c.dtype)
    _check_hvp(idx, val64.to(vdt), c, v, shift, d, rtol)


@pytest.mark.parametrize("vdt,wdt,rtol", DTYPES)
@pytest.mark.parametrize("design", ["criteo_hot", "uniform", "long_rows", "misaligned"])
def test_fused_scalars_have_the_same_bits_from_run_to_run(cuda, design, vdt, wdt, rtol):
    if design == "uniform":
        idx, val64, d = (*_ell(20011, 40, 3001, cuda), 3001)
    elif design == "long_rows":
        idx, val64, d = (*_ell(7, 4099, 3001, cuda), 3001)
    else:
        idx, val64, d = DESIGNS[design](cuda)
    n, k = idx.shape
    val = val64.to(vdt)
    y, off, ew, w = _fused_inputs(n, k, d, vdt, cuda)
    shift = torch.tensor(0.1, device=cuda, dtype=w.dtype)
    first = _check_vgc(idx, val, y, off, ew, w, d, LOGISTIC_LOSS, rtol)
    hv, usum = _check_hvp(idx, val, ew, w, shift, d, rtol)
    hdiag = fused_hessian_diagonal(idx, val, y, off, ew, w, d, LOGISTIC_LOSS)
    for _ in range(3):
        again = fused_value_grad_curvature(idx, val, y, off, ew, w, d, LOGISTIC_LOSS)
        # every output, the (d,) gradient too: no atomics anywhere
        assert all(torch.equal(f, g) for f, g in zip(first, again))
        assert all(torch.equal(f, g) for f, g in zip(
            (hv, usum), fused_hessian_vector(idx, val, ew, w, shift, d)))
        assert all(torch.equal(f, g) for f, g in zip(
            hdiag, fused_hessian_diagonal(idx, val, y, off, ew, w, d, LOGISTIC_LOSS)))


@pytest.mark.parametrize("loss", LOSSES, ids=lambda l: l.name)
@pytest.mark.parametrize("vdt,wdt,rtol", DTYPES)
@pytest.mark.parametrize("design", sorted(DESIGNS))
def test_fused_hdiag_designs_match_plain_version(cuda, design, vdt, wdt, rtol, loss):
    idx, val64, d = DESIGNS[design](cuda)
    y, off, ew, w = _fused_inputs(idx.shape[0], idx.shape[1], d, vdt, cuda, seed=13)
    _check_hdiag(idx, val64.to(vdt), y, off, ew, w, d, loss, rtol)


@pytest.mark.parametrize("vdt,wdt,rtol", DTYPES)
def test_fused_hdiag_hot_column_twice_squares_each_slot(cuda, vdt, wdt, rtol):
    # column 7 in two slots of every row (1.5 and -0.5), columns 8-37 once
    # (0.25), over 128 tiles of 32 rows; c = 1 (squared loss, ew 1), so
    # every sum is exact: dx2_7 adds 1.5^2 + 0.5^2 = 2.5 a row, not
    # (1.5 - 0.5)^2 = 1, through the table slot that carries both sums
    n, k, d = 4096, 32, 41
    idx = torch.arange(6, 6 + k, dtype=torch.int32, device=cuda).repeat(n, 1)
    idx[:, :2] = 7
    val = torch.full((n, k), 0.25, dtype=torch.float64, device=cuda)
    val[:, 0], val[:, 1] = 1.5, -0.5
    cd = torch.float64 if vdt == torch.float64 else torch.float32
    one = torch.ones(n, dtype=cd, device=cuda)
    dx2, dx, csum = fused_hessian_diagonal(idx, val.to(vdt), one, 0 * one, one,
                                           torch.zeros(d, dtype=cd, device=cuda), d,
                                           SQUARED_LOSS)
    want2, want1 = [0.0] * d, [0.0] * d
    want2[7], want1[7] = 2.5 * n, 1.0 * n
    want2[8:38], want1[8:38] = [0.0625 * n] * 30, [0.25 * n] * 30
    assert dx2.tolist() == want2 and dx.tolist() == want1 and float(csum) == n


@pytest.mark.parametrize("vdt,wdt,rtol", DTYPES)
def test_fused_hdiag_column_sums_accumulate_in_f64(cuda, vdt, wdt, rtol):
    # column 7 in every row of 4097 tiles of 256 rows: tile 0 adds 2^24
    # (one row of 2^12), every other tile 256 * (1/16)^2 = 1. A float32
    # running sum past 2^24 drops each later 1 (2^24 + 1 rounds to 2^24),
    # so only sums kept in f64 and rounded once give 2^24 + 4096 exactly
    tiles, rows, k, d = 4097, 256, 4, 9
    n = tiles * rows
    idx = torch.full((n, k), d, dtype=torch.int32, device=cuda)
    idx[:, 0] = 7
    val = torch.zeros((n, k), dtype=torch.float64, device=cuda)
    val[rows:, 0] = 1.0 / 16
    val[0, 0] = 2.0 ** 12
    cd = torch.float64 if vdt == torch.float64 else torch.float32
    one = torch.ones(n, dtype=cd, device=cuda)
    dx2, dx, csum = fused_hessian_diagonal(idx, val.to(vdt), one, 0 * one, one,
                                           torch.zeros(d, dtype=cd, device=cuda), d,
                                           SQUARED_LOSS)
    assert dx2.tolist() == [0.0] * 7 + [2.0 ** 24 + 4096, 0.0]
    assert dx.tolist() == [0.0] * 7 + [2.0 ** 12 + (tiles - 1) * rows / 16, 0.0]
    assert float(csum) == n


def test_fused_hvp_one_column_sums_every_slot(cuda):
    # 2^17 slots on one column, every sum exact in f64: one global atomic
    # per tile, the rest in shared memory
    n, k = 4096, 32
    idx = torch.full((n, k), 7, dtype=torch.int32, device=cuda)
    val = torch.full((n, k), 0.5, dtype=torch.float64, device=cuda)
    c = torch.ones(n, dtype=torch.float64, device=cuda)
    v = torch.zeros(9, dtype=torch.float64, device=cuda)
    v[7] = 1.0
    hv, usum = fused_hessian_vector(idx, val, c, v, torch.tensor(0.0, device=cuda), 9)
    # zv_i = 32 * 0.5 = 16 = u_i; hv_7 = n * 32 * 0.5 * 16
    assert hv.tolist() == [0.0] * 7 + [256.0 * n, 0.0] and float(usum) == 16.0 * n


def test_fused_passes_of_zero_slots_give_the_row_terms(cuda):
    n, d = 2000, 5
    idx = torch.zeros((n, 0), dtype=torch.int32, device=cuda)
    val = torch.zeros((n, 0), dtype=torch.float64, device=cuda)
    y, off, ew, w = _fused_inputs(n, 0, d, torch.float64, cuda)
    val_, grad, asum, curv = fused_value_grad_curvature(idx, val, y, off, ew, w, d,
                                                        LOGISTIC_LOSS)
    ref = fused_value_grad_curvature_reference(idx, val, y, off, ew, w, d, LOGISTIC_LOSS)
    assert not grad.any() and _within(curv, ref[3], ref[3].abs(), 1e-12)
    assert _within(val_, ref[0], (ew * LOGISTIC_LOSS.value(off, y)).abs().sum(), 1e-12)
    assert _within(asum, ref[2], (ew * LOGISTIC_LOSS.d1(off, y)).abs().sum(), 1e-12)
    hv, usum = fused_hessian_vector(idx, val, ew, w, torch.tensor(0.5, device=cuda), d)
    assert not hv.any() and _within(usum, 0.5 * ew.sum(), ew.sum(), 1e-12)


# -- the column-sorted reduce (kernels/colsort.py) -----------------------------

from photon_ml_tpu_torch.kernels import colsort  # noqa: E402
from photon_ml_tpu_torch.kernels.colsort import (  # noqa: E402
    build_design_columns,
    column_reduce,
    column_reduce_reference,
    column_values,
    design_columns,
)

REDUCE_DESIGNS = ["criteo_hot", "one_column", "out_of_range", "misaligned", "uniform"]


def _reduce_design(name, device):
    if name == "uniform":
        return (*_ell(20011, 40, 3001, device), 3001)
    return DESIGNS[name](device)


# ROW_BLOCK: the default (every design here one block), and blocks of 997
# rows (5 to 21 blocks, the last one short)
ROW_BLOCKS = [None, 997]


@pytest.fixture
def row_block(request, monkeypatch):
    if request.param is not None:
        monkeypatch.setattr(colsort, "ROW_BLOCK", request.param)
    return colsort.ROW_BLOCK


@pytest.mark.parametrize("row_block", ROW_BLOCKS, indirect=True)
@pytest.mark.parametrize("mode", ["linear", "square", "pair"])
@pytest.mark.parametrize("vdt,wdt,rtol", DTYPES)
@pytest.mark.parametrize("design", REDUCE_DESIGNS)
def test_column_reduce_matches_plain_version_and_repeats_its_bits(cuda, design, vdt, wdt,
                                                                  rtol, mode, row_block):
    idx, val64, d = _reduce_design(design, cuda)
    n = idx.shape[0]
    copy = design_columns(idx, d)
    vals = column_values(copy, val64.to(vdt))
    a = torch.rand(n, device=cuda, dtype=torch.float64).to(wdt) + 0.1
    before = dispatch.launch_counts()["colsort_reduce"]
    got = column_reduce(copy, vals, a, mode)
    torch.cuda.synchronize()
    assert dispatch.launch_counts()["colsort_reduce"] == before + 1
    # the plain version summed in f64 from the same inputs: in f32 its own
    # index_add_ (200,000 adds into one column) drifts past the tolerance
    v = vals.double()
    ref = column_reduce_reference(copy, v, a.double(), mode)
    outs, refs = (got, ref) if mode == "pair" else ((got,), (ref,))
    cd = torch.float64 if vdt == torch.float64 else torch.float32
    terms = {"linear": [v], "square": [v * v], "pair": [v * v, v]}[mode]
    for out, want, t in zip(outs, refs, terms):
        assert out.dtype == cd and out.shape == (d,)
        scale = column_reduce_reference(copy, t.abs(), a.double(), "linear")
        assert _within(out, want, scale, rtol)
    for _ in range(2):
        again = column_reduce(copy, vals, a, mode)
        again = again if mode == "pair" else (again,)
        assert all(torch.equal(x, y) for x, y in zip(outs, again))


@pytest.mark.parametrize("row_block", ROW_BLOCKS, indirect=True)
def test_column_copy_on_the_card_equals_the_cpus(cuda, row_block):
    idx, _, d = DESIGNS["criteo_hot"](cuda)
    card = build_design_columns(idx, d)
    cpu = build_design_columns(idx.cpu(), d)
    assert card.nblocks == -(-idx.shape[0] // row_block)
    for name in ("cols", "perm", "chains", "blocks"):
        assert torch.equal(getattr(card, name).cpu(), getattr(cpu, name)), name


@pytest.mark.parametrize("mode", ["linear", "square", "pair"])
@pytest.mark.parametrize("vdt,wdt,rtol", DTYPES)
def test_column_reduce_in_row_blocks_agrees_with_one_block(cuda, monkeypatch, vdt, wdt, rtol,
                                                           mode):
    # the same sums cut into 21 blocks of rows and added in block order,
    # within the tolerance of the one-block sums
    idx, val64 = _ell(20011, 40, 3001, cuda)
    a = torch.rand(20011, device=cuda, dtype=torch.float64).to(wdt) + 0.1
    outs = []
    for rows in (None, 997):
        if rows is not None:
            monkeypatch.setattr(colsort, "ROW_BLOCK", rows)
        copy = build_design_columns(idx, 3001)
        got = column_reduce(copy, column_values(copy, val64.to(vdt)), a, mode)
        outs.append(got if mode == "pair" else (got,))
        v = column_values(copy, val64.to(vdt)).double()
        terms = {"linear": [v], "square": [v * v], "pair": [v * v, v]}[mode]
        scales = [column_reduce_reference(copy, t.abs(), a.double(), "linear") for t in terms]
    assert copy.nblocks == 21
    assert all(_within(x, y, sc, rtol) for x, y, sc in zip(*outs, scales))


@pytest.mark.parametrize("vdt,wdt,rtol", DTYPES)
def test_fused_passes_in_row_blocks_match_plain_versions_and_repeat_their_bits(
        cuda, monkeypatch, vdt, wdt, rtol):
    monkeypatch.setattr(colsort, "ROW_BLOCK", 997)
    n, k, d = 10007, 40, 3001
    idx, val64 = _ell(n, k, d, cuda)
    val = val64.to(vdt)
    y, off, ew, w = _fused_inputs(n, k, d, vdt, cuda)
    shift = torch.tensor(0.3, device=cuda, dtype=w.dtype)
    vgc = _check_vgc(idx, val, y, off, ew, w, d, LOGISTIC_LOSS, rtol)
    assert design_columns(idx, d).nblocks == 11
    _check_hvp(idx, val, vgc[3], w, shift, d, rtol)
    _check_hdiag(idx, val, y, off, ew, w, d, LOGISTIC_LOSS, rtol)
    calls = [lambda: fused_value_grad_curvature(idx, val, y, off, ew, w, d, LOGISTIC_LOSS),
             lambda: fused_hessian_vector(idx, val, vgc[3], w, shift, d),
             lambda: fused_hessian_diagonal(idx, val, y, off, ew, w, d, LOGISTIC_LOSS)]
    for fn in calls:
        first = fn()
        for _ in range(2):
            assert all(torch.equal(x, y_) for x, y_ in zip(first, fn()))


@pytest.mark.parametrize("vdt,wdt,rtol", DTYPES)
def test_fused_hdiag_column_sums_accumulate_in_f64_across_row_blocks(cuda, monkeypatch, vdt,
                                                                      wdt, rtol):
    # as test_fused_hdiag_column_sums_accumulate_in_f64, in blocks of 1000
    # rows: a float32 sum of the blocks' rounded sums drops each later
    # block's 1000 / 256 (2^24 + 3.90625 rounds to 2^24 + 4); the f64 sums
    # kept across blocks and rounded once give 2^24 + 4096 exactly
    monkeypatch.setattr(colsort, "ROW_BLOCK", 1000)
    tiles, rows, k, d = 4097, 256, 4, 9
    n = tiles * rows
    idx = torch.full((n, k), d, dtype=torch.int32, device=cuda)
    idx[:, 0] = 7
    val = torch.zeros((n, k), dtype=torch.float64, device=cuda)
    val[rows:, 0] = 1.0 / 16
    val[0, 0] = 2.0 ** 12
    cd = torch.float64 if vdt == torch.float64 else torch.float32
    one = torch.ones(n, dtype=cd, device=cuda)
    dx2, dx, csum = fused_hessian_diagonal(idx, val.to(vdt), one, 0 * one, one,
                                           torch.zeros(d, dtype=cd, device=cuda), d,
                                           SQUARED_LOSS)
    assert design_columns(idx, d).nblocks == -(-n // 1000)
    assert dx2.tolist() == [0.0] * 7 + [2.0 ** 24 + 4096, 0.0]
    assert dx.tolist() == [0.0] * 7 + [2.0 ** 12 + (tiles - 1) * rows / 16, 0.0]
    assert float(csum) == n


def test_fused_passes_build_the_copy_once_per_design(cuda):
    d = 3001
    idx, val = _ell(4099, 40, d, cuda)
    y, off, ew, w = _fused_inputs(4099, 40, d, torch.float64, cuda)
    fused_value_grad_curvature(idx, val, y, off, ew, w, d, LOGISTIC_LOSS)
    copy = design_columns(idx, d)
    fused_hessian_vector(idx, val, ew, w, torch.tensor(0.0, device=cuda), d)
    fused_hessian_diagonal(idx, val, y, off, ew, w, d, LOGISTIC_LOSS)
    assert design_columns(idx, d) is copy


# -- the sparse kernel lab: lane_gather, onehot_gather, onehot_reduce ---------

import numpy as np  # noqa: E402

from photon_ml_tpu_torch.benchmarks.sparse_kernel_lab import make_data  # noqa: E402
from photon_ml_tpu_torch.kernels.lab import (  # noqa: E402
    LAB_BLOCK,
    ColumnTiles,
    column_sorted_tiles,
    lane_gather,
    lane_gather_reference,
    onehot_gather,
    onehot_gather_reference,
    onehot_reduce,
    onehot_reduce_reference,
    tile_chains,
)


def _bits(t):
    return t.contiguous().view(torch.int32)


@pytest.mark.parametrize("rows,lo,hi", [(8192, 0, 128), (8192, -300, 300), (1, -128, 128),
                                        (37, 0, 128)])
def test_lane_gather_matches_plain_version_bit_for_bit(cuda, rows, lo, hi):
    g = torch.Generator(device=cuda).manual_seed(rows + hi)
    tbl = torch.randn((rows, 128), generator=g, device=cuda)
    idx = torch.randint(lo, hi, (rows, 128), generator=g, device=cuda, dtype=torch.int32)
    before = dispatch.launch_counts()["lane_gather"]
    got = lane_gather(tbl, idx)
    torch.cuda.synchronize()
    assert dispatch.launch_counts()["lane_gather"] == before + 1
    assert torch.equal(_bits(got), _bits(lane_gather_reference(tbl, idx)))


def _lab_design(n, k, d, seed=0):
    cols, vals = make_data(n, k, d, seed)
    return torch.from_numpy(cols), torch.from_numpy(vals), d


def _with_padding(idx, val, d, every=7):
    idx, val = idx.clone(), val.clone()
    idx[::every, -1] = d
    val[::every, -1] = 0.0
    return idx, val, d


def _lab_case(name):
    """(indices, values, d) on the CPU; each an edge of onehot_reduce."""
    rng = np.random.default_rng(5)
    if name == "zipf_d_not_multiple":  # the lab's data, d = 1100
        return _lab_design(30000, 8, 1100)
    if name == "zipf_wide":  # many blocks, most with one tile
        return _lab_design(20000, 32, 120000)
    if name == "empty_blocks":  # blocks 1 and 3 named by no entry
        idx = rng.choice(np.r_[0:512, 1024:1536, 2048:2500], size=(7000, 6))
        return _with_padding(torch.from_numpy(idx.astype(np.int32)),
                             torch.from_numpy(rng.standard_normal((7000, 6)).astype(np.float32)),
                             2500)
    if name == "block_of_exactly_1024":
        idx = np.concatenate([rng.integers(0, 512, (512, 2)),
                              rng.integers(512, 1500, (512, 1))], 1).astype(np.int32)
        val = rng.standard_normal((512, 3)).astype(np.float32)
        idx[::7, -1] = 1500
        val[::7, -1] = 0.0
        return torch.from_numpy(idx), torch.from_numpy(val), 1500
    if name == "one_column_many_tiles":  # column 700 spans about 40 tiles
        idx = rng.integers(0, 1800, size=(10000, 5)).astype(np.int32)
        idx[:, :4] = 700
        return _with_padding(torch.from_numpy(idx),
                             torch.from_numpy(rng.standard_normal((10000, 5)).astype(np.float32)),
                             1800)
    if name == "d_one":
        return _with_padding(torch.zeros((5000, 1), dtype=torch.int32),
                             torch.from_numpy(rng.standard_normal((5000, 1)).astype(np.float32)),
                             1)
    if name == "leading_and_trailing_empty_blocks":  # blocks 4-5 of 20 only
        idx = rng.integers(2048, 3072, size=(6000, 3)).astype(np.int32)
        return _with_padding(torch.from_numpy(idx),
                             torch.from_numpy(rng.standard_normal((6000, 3)).astype(np.float32)),
                             10000)
    raise KeyError(name)


# one-tile blocks (zipf_wide), blocks no tile names (empty_blocks, the
# leading and trailing ones), d not a multiple of 512, tile counts that are
# no multiple of the chunk, a column across several chunks (column 700
# across about 40 tiles), tiles and a block of only padding
LAB_CASES = ["zipf_d_not_multiple", "zipf_wide", "empty_blocks", "block_of_exactly_1024",
             "one_column_many_tiles", "d_one", "tile_of_only_padding",
             "leading_and_trailing_empty_blocks", "block_of_only_padding"]


def _padding_tile_after(tiles: ColumnTiles, t: int, block=None) -> ColumnTiles:
    """The same tiles with a tile of only misses after tile ``t``, in its
    block (a valid layout: misses end a block), or in ``block``, one that
    no tile names between tile ``t``'s and the next tile's."""
    cat = lambda a, b: torch.cat([a[:t + 1], b, a[t + 1:]])  # noqa: E731
    cols = cat(tiles.cols, torch.full_like(tiles.cols[:1], LAB_BLOCK))
    new_block = block is not None and block != int(tiles.tile_block[t])
    tb = cat(tiles.tile_block, tiles.tile_block[t:t + 1] if block is None
             else torch.full_like(tiles.tile_block[:1], block))
    return ColumnTiles(
        cols=cols, rows=cat(tiles.rows, torch.zeros_like(tiles.rows[:1])),
        vals=cat(tiles.vals, torch.zeros_like(tiles.vals[:1])), tile_block=tb,
        first_of_block=cat(tiles.first_of_block,
                           torch.full_like(tiles.first_of_block[:1], int(new_block))),
        chains=tile_chains(cols, tb), d=tiles.d, nblocks=tiles.nblocks)


def _lab_tiles(name, device):
    """(tiles, w, upd) of a case on ``device``, the layout built there."""
    if name == "tile_of_only_padding":
        idx, val, d = _lab_case("zipf_d_not_multiple")
    elif name == "block_of_only_padding":
        idx, val, d = _lab_case("empty_blocks")
    else:
        idx, val, d = _lab_case(name)
    tiles = column_sorted_tiles(idx.to(device), val.to(device), d)
    if name == "tile_of_only_padding":
        last_of_block0 = int((tiles.tile_block == 0).sum()) - 1
        tiles = _padding_tile_after(tiles, last_of_block0)
    if name == "block_of_only_padding":  # block 1 holds one tile of misses
        last_of_block0 = int((tiles.tile_block == 0).sum()) - 1
        tiles = _padding_tile_after(tiles, last_of_block0, block=1)
    g = torch.Generator(device=device).manual_seed(17)
    w = torch.randn(d, generator=g, device=device)
    a = torch.randn(idx.shape[0], generator=g, device=device)
    upd = tiles.vals * a[tiles.rows.long()]
    return tiles, w, upd


@pytest.mark.parametrize("name", LAB_CASES)
def test_onehot_gather_matches_plain_version_bit_for_bit(cuda, name):
    tiles, w, _ = _lab_tiles(name, cuda)
    before = dispatch.launch_counts()["onehot_gather"]
    got = onehot_gather(tiles, w)
    torch.cuda.synchronize()
    assert dispatch.launch_counts()["onehot_gather"] == before + 1
    assert torch.equal(_bits(got), _bits(onehot_gather_reference(tiles, w)))


@pytest.mark.parametrize("name", LAB_CASES)
def test_onehot_reduce_matches_plain_version_in_f64(cuda, name):
    """Within 1e-6 of each column's sum of |upd| of the plain version
    summed in f64 from the same updates; 0 where no entry names a column."""
    tiles, _, upd = _lab_tiles(name, cuda)
    before = dispatch.launch_counts()["onehot_reduce"]
    got = onehot_reduce(tiles, upd)
    torch.cuda.synchronize()
    assert dispatch.launch_counts()["onehot_reduce"] == before + 1
    ref = onehot_reduce_reference(tiles, upd.double())
    scale = onehot_reduce_reference(tiles, upd.abs().double())
    assert got.shape == (tiles.nblocks * 512,) and got.dtype == torch.float32
    assert _within(got, ref, scale, 1e-6)
    assert not got[scale == 0].any()
    if name == "one_column_many_tiles":
        (first, last), = tiles.chains[tiles.chains[:, 0] == 700, 1:].tolist()
        assert last - first >= 30
    if name == "empty_blocks":
        assert set(tiles.tile_block.tolist()) == {0, 2, 4}


def test_lab_kernels_on_empty_input_launch_nothing(cuda):
    """A design of only padding has no tiles: g is 0 and no count moves
    (the reduce clears nothing on the card either)."""
    idx = torch.full((5, 3), 700, dtype=torch.int32, device=cuda)
    tiles = column_sorted_tiles(idx, torch.zeros((5, 3), device=cuda), 700)
    assert tiles.ntiles == 0
    before = dispatch.launch_counts()
    g = onehot_reduce(tiles, tiles.vals)
    e = onehot_gather(tiles, torch.ones(700, device=cuda))
    out = lane_gather(torch.ones((0, 128), device=cuda),
                      torch.zeros((0, 128), dtype=torch.int32, device=cuda))
    torch.cuda.synchronize()
    assert dispatch.launch_counts() == before
    assert g.shape == (2 * LAB_BLOCK,) and g.is_cuda and not g.any()
    assert e.shape == (0, 1024) and out.shape == (0, 128)


@pytest.mark.parametrize("name", LAB_CASES)
def test_onehot_reduce_has_the_same_bits_over_three_calls(cuda, name):
    tiles, _, upd = _lab_tiles(name, cuda)
    first = onehot_reduce(tiles, upd)
    for _ in range(2):
        assert torch.equal(_bits(onehot_reduce(tiles, upd)), _bits(first))


@pytest.mark.parametrize("chunk", [1, 2, 5, 16, 64])
@pytest.mark.parametrize("name", ["zipf_d_not_multiple", "one_column_many_tiles",
                                  "block_of_only_padding"])
def test_onehot_reduce_at_other_chunks(cuda, name, chunk):
    """Any chunk of tiles per block (a tile count no multiple of it, a
    column across several chunks): within 1e-6 of the plain version in
    f64, 0 where no entry names a column, the same bits over 3 calls."""
    tiles, _, upd = _lab_tiles(name, cuda)
    got = onehot_reduce(tiles, upd, chunk=chunk)
    ref = onehot_reduce_reference(tiles, upd.double())
    scale = onehot_reduce_reference(tiles, upd.abs().double())
    assert _within(got, ref, scale, 1e-6)
    assert not got[scale == 0].any()
    for _ in range(2):
        assert torch.equal(_bits(onehot_reduce(tiles, upd, chunk=chunk)), _bits(got))
    if name == "one_column_many_tiles" and chunk < 16:
        (first, last), = tiles.chains[tiles.chains[:, 0] == 700, 1:].tolist()
        assert last // chunk - first // chunk >= 2


@pytest.mark.parametrize("name", ["zipf_d_not_multiple", "leading_and_trailing_empty_blocks",
                                  "block_of_only_padding"])
def test_onehot_reduce_writes_zeros_into_recycled_memory(cuda, name):
    """The reduce clears nothing: its output's buffer, freed, filled with
    NaN in a tensor of its size and freed again, is handed to the next
    call, and every column no entry names reads exactly 0.0."""
    tiles, _, upd = _lab_tiles(name, cuda)
    width = tiles.nblocks * LAB_BLOCK
    named = torch.bincount(tiles.global_cols().reshape(-1), minlength=width + 1)[:width] > 0
    g = onehot_reduce(tiles, upd)
    floats = g.untyped_storage().nbytes() // 4
    del g
    nan = torch.full((floats,), float("nan"), device=cuda)
    nan_ptr = nan.data_ptr()
    del nan
    g = onehot_reduce(tiles, upd)
    torch.cuda.synchronize()
    assert g.data_ptr() == nan_ptr
    assert (~named).any() and bool((g[~named] == 0).all()) and not g.isnan().any()
    ref = onehot_reduce_reference(tiles, upd.double())
    assert _within(g, ref, onehot_reduce_reference(tiles, upd.abs().double()), 1e-6)


def test_lane_gather_launches_on_the_current_stream(cuda):
    """Inside ``torch.cuda.stream(s)``, after the card sleeps and ``tbl`` is
    written in place on ``s``, the gather sees the write: it ran on ``s``."""
    g = torch.Generator(device=cuda).manual_seed(3)
    tbl = torch.randn((8192, 128), generator=g, device=cuda)
    idx = torch.randint(-128, 128, (8192, 128), generator=g, device=cuda, dtype=torch.int32)
    lane_gather(tbl, idx)
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        torch.cuda._sleep(100_000_000)
        tbl.mul_(-3.0)
        got = lane_gather(tbl, idx)
    torch.cuda.current_stream().wait_stream(s)
    assert torch.equal(_bits(got), _bits(lane_gather_reference(tbl, idx)))


def test_lab_wrappers_refuse_after_a_good_call_of_the_same_shape(cuda):
    """The per-key plans skip no per-call check: a wrong dtype, a
    non-contiguous or misaligned tensor of the shape a good call had, or a
    tensor on another device, still raises."""
    tbl = torch.randn((128, 128), device=cuda)
    idx = torch.zeros((128, 128), dtype=torch.int32, device=cuda)
    lane_gather(tbl, idx)
    with pytest.raises(TypeError, match="int32"):
        lane_gather(tbl, idx.long())
    with pytest.raises(TypeError, match="float32"):
        lane_gather(tbl.double(), idx)
    with pytest.raises(ValueError, match="contiguous"):
        lane_gather(tbl.t(), idx)
    with pytest.raises(ValueError, match="contiguous"):
        lane_gather(tbl, idx.t())
    flat = torch.empty(128 * 128 + 1, device=cuda)
    with pytest.raises(ValueError, match="16-byte"):
        lane_gather(flat[1:].view(128, 128), idx)
    with pytest.raises(ValueError, match="more than one device"):
        lane_gather(tbl, idx.cpu())
    tiles, w, upd = _lab_tiles("zipf_d_not_multiple", cuda)
    onehot_reduce(tiles, upd)
    onehot_gather(tiles, w)
    with pytest.raises(TypeError, match="float32"):
        onehot_reduce(tiles, upd.double())
    with pytest.raises(ValueError, match="contiguous"):
        onehot_reduce(tiles, upd.t().contiguous().t())
    with pytest.raises(ValueError, match="more than one device"):
        onehot_reduce(tiles, upd.cpu())
    with pytest.raises(TypeError, match="float32"):
        onehot_gather(tiles, w.double())
    with pytest.raises(ValueError, match="16-byte"):
        onehot_gather(tiles, torch.empty(tiles.d + 1, device=cuda)[1:])


@pytest.mark.parametrize("name", ["zipf_wide", "empty_blocks", "d_one"])
def test_column_sorted_tiles_on_the_card_equal_the_cpus(cuda, name):
    idx, val, d = _lab_case(name)
    on_card = column_sorted_tiles(idx.to(cuda), val.to(cuda), d)
    on_cpu = column_sorted_tiles(idx, val, d)
    for field in ("cols", "rows", "vals", "tile_block", "first_of_block", "chains"):
        assert torch.equal(getattr(on_card, field).cpu(), getattr(on_cpu, field)), field


def test_lab_wrappers_raise_on_ids_outside_the_table_and_other_inputs(cuda):
    idx, val, d = _lab_case("empty_blocks")
    bad = idx.to(cuda)
    bad[3, 2] = d + 1
    with pytest.raises(ValueError, match="outside"):
        column_sorted_tiles(bad, val.to(cuda), d)
    bad[3, 2] = -5
    with pytest.raises(ValueError, match="outside"):
        column_sorted_tiles(bad, val.to(cuda), d)
    tiles, w, upd = _lab_tiles("empty_blocks", cuda)
    with pytest.raises(ValueError, match=r"\(2500,\)"):
        onehot_gather(tiles, w[:-1])
    with pytest.raises(TypeError, match="float32"):
        onehot_reduce(tiles, upd.double())
    with pytest.raises(ValueError, match="more than one device"):
        onehot_gather(tiles, w.cpu())
    tbl = torch.randn((64, 128), device=cuda)
    ids = torch.zeros((64, 128), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        lane_gather(tbl.t().contiguous().t(), ids.t().contiguous().t())
    flat = torch.empty(64 * 128 + 1, device=cuda)
    with pytest.raises(ValueError, match="16-byte"):
        lane_gather(flat[1:].view(64, 128), ids)


# -- GAME scoring -------------------------------------------------------------

import os  # noqa: E402

from photon_ml_tpu_torch.cli.score import run_scoring  # noqa: E402
from photon_ml_tpu_torch.game.data import GameData  # noqa: E402
from photon_ml_tpu_torch.game.factored import FactoredParams  # noqa: E402
from photon_ml_tpu_torch.game.scoring import score_game_data  # noqa: E402
from photon_ml_tpu_torch.io.avro import write_avro_file  # noqa: E402
from photon_ml_tpu_torch.io.models import save_game_model  # noqa: E402
from photon_ml_tpu_torch.io.schemas import TRAINING_EXAMPLE_SCHEMA  # noqa: E402
from photon_ml_tpu_torch.io.vocab import FeatureVocabulary, feature_key  # noqa: E402
from photon_ml_tpu_torch.ops.sparse import from_coo  # noqa: E402


def _game(n=3001, seed=23):
    """Two fixed effects on ELL shards and one on a dense shard, a random
    effect on a wide ELL shard (the compact join), a dense one and a
    factored one; entity -1 on some rows."""
    rng = np.random.default_rng(seed)

    def ell(d, k):
        rows = np.repeat(np.arange(n), k)
        return from_coo(rows, rng.integers(0, d, n * k), rng.normal(size=n * k), n, d,
                        dtype=torch.float64)

    users = rng.integers(-1, 50, n)
    data = GameData.create(
        {"a": ell(5000, 12), "b": ell(300, 3), "c": rng.normal(size=(n, 6)),
         "w": ell(2000, 4), "f": rng.normal(size=(n, 5))},
        rng.integers(0, 2, n).astype(np.float64),
        entity_ids={"userId": users, "adId": rng.integers(-1, 20, n)},
    )
    wide = np.zeros((50, 2000))
    wide[np.arange(50)[:, None], rng.integers(0, 2000, (50, 30))] = rng.normal(size=(50, 30))
    params = {"fa": rng.normal(size=5000), "fb": rng.normal(size=300),
              "fc": rng.normal(size=6), "re-wide": wide, "re-ad": rng.normal(size=(20, 6)),
              "re-latent": FactoredParams(torch.from_numpy(rng.normal(size=(50, 2))),
                                          torch.from_numpy(rng.normal(size=(5, 2))))}
    shards = {"fa": "a", "fb": "b", "fc": "c", "re-wide": "w", "re-ad": "c", "re-latent": "f"}
    res = {"fa": None, "fb": None, "fc": None, "re-wide": "userId", "re-ad": "adId",
           "re-latent": "userId"}
    return params, shards, res, data


def test_game_scoring_launches_ell_matvec_once_per_ell_fixed_effect(cuda):
    params, shards, res, data = _game()
    dispatch.reset_launch_counts()
    got = score_game_data(params, shards, res, data, device=cuda)
    torch.cuda.synchronize()
    launches = dispatch.launch_counts()
    assert launches == {k: (2 if k == "ell_matvec" else 0) for k in launches}
    ref = score_game_data(params, shards, res, data, device="cpu")
    assert got.device.type == "cuda" and got.dtype == torch.float64
    scale = ref.abs().clamp(min=1.0)
    assert torch.all((got.cpu() - ref).abs() <= 1e-12 * scale)


def test_game_scoring_does_not_fall_back_to_the_cpu(cuda, monkeypatch):
    """A kernel that cannot launch fails the call: nothing rescores on the
    CPU."""
    from photon_ml_tpu_torch.kernels import ell as ell_module
    from photon_ml_tpu_torch.kernels import launch as launch_module

    def no_kernel(*args, **kwargs):
        raise RuntimeError("ell_matvec kernel unavailable")

    params, shards, res, data = _game(n=257)
    monkeypatch.setattr(ell_module, "load_entry", no_kernel)
    # an entry loaded by an earlier call launches through its plan
    monkeypatch.setattr(launch_module.Entry, "launch", no_kernel)
    with pytest.raises(RuntimeError, match="kernel unavailable"):
        score_game_data(params, shards, res, data, device=cuda)


def _game_files(root):
    gvocab = FeatureVocabulary([feature_key("g", str(j)) for j in range(40)],
                               add_intercept=True)
    uvocab = FeatureVocabulary([feature_key("u", str(j)) for j in range(8)])
    rng = np.random.default_rng(29)
    save_game_model(
        os.path.join(root, "model"),
        params={"global": rng.normal(size=41), "per-user": rng.normal(size=(6, 8))},
        shards={"global": "g", "per-user": "u"}, vocabs={"global": gvocab, "per-user": uvocab},
        entity_vocabs={"per-user": {f"user{i}": i for i in range(6)}},
        random_effects={"global": None, "per-user": "userId"},
    )
    gvocab.save(os.path.join(root, "model", "feature-index-g.txt"))
    uvocab.save(os.path.join(root, "model", "feature-index-u.txt"))
    recs = [{"uid": f"r{i}", "label": float(i % 2),
             "features": [{"name": "g", "term": str(j), "value": float(rng.normal())}
                          for j in rng.choice(40, 5, replace=False)]
             + [{"name": "u", "term": str(i % 8), "value": 1.0}],
             "metadataMap": {"userId": f"user{i % 8}"}, "weight": None, "offset": 0.5}
            for i in range(300)]
    write_avro_file(os.path.join(root, "data.avro"), TRAINING_EXAMPLE_SCHEMA, recs)
    return {"input": [os.path.join(root, "data.avro")], "model_dir": os.path.join(root, "model"),
            "model_kind": "game", "sparse_shards": ["g", "u"], "evaluate": True}


def test_game_driver_on_the_card_matches_the_cpu_with_one_launch(cuda, tmp_path):
    params = _game_files(str(tmp_path))
    dispatch.reset_launch_counts()
    run = run_scoring({**params, "output_dir": str(tmp_path / "card")})
    launches = dispatch.launch_counts()
    assert run.device.startswith("cuda")
    assert launches == {k: (1 if k == "ell_matvec" else 0) for k in launches}
    cpu = run_scoring({**params, "output_dir": str(tmp_path / "cpu")}, device="cpu")
    assert np.all(np.abs(run.scores - cpu.scores) <= 1e-10 * np.maximum(1, np.abs(cpu.scores)))
    for k, v in cpu.metrics.items():
        assert abs(run.metrics[k] - v) <= 1e-10, k


def test_game_driver_does_not_fall_back_to_the_cpu(cuda, tmp_path, monkeypatch):
    from photon_ml_tpu_torch.kernels import ell as ell_module
    from photon_ml_tpu_torch.kernels import launch as launch_module

    def no_kernel(*args, **kwargs):
        raise RuntimeError("ell_matvec kernel unavailable")

    params = _game_files(str(tmp_path))
    monkeypatch.setattr(ell_module, "load_entry", no_kernel)
    monkeypatch.setattr(launch_module.Entry, "launch", no_kernel)
    with pytest.raises(RuntimeError, match="kernel unavailable"):
        run_scoring({**params, "output_dir": str(tmp_path / "card")})
    assert not os.path.exists(tmp_path / "card" / "scores")


# -- GAME training -----------------------------------------------------------

from photon_ml_tpu_torch.cli.game_train import run_game_training  # noqa: E402
from photon_ml_tpu_torch.game.coordinates import (  # noqa: E402
    CoordinateConfig,
    _make_batched_solve,
)
from photon_ml_tpu_torch.game.data import RandomEffectDesign  # noqa: E402
from photon_ml_tpu_torch.models.training import OptimizerType  # noqa: E402


@pytest.mark.parametrize("optimizer", ["TRON", "LBFGS", "OWLQN", "NEWTON"])
def test_batched_solve_on_the_card_matches_the_cpu(cuda, optimizer):
    """Per entity the same reason and iterations as on the CPU, and w
    within 1e-10 (plain tensor products: no kernel of the port) — except
    where the card's other summation order flips a stopping test at its
    threshold (chip_smoke.py phase 5c on an H100: 20 of 24,546 entity updates): at
    most 1% of the lanes, and those within 1e-6 of the table's scale.
    NEWTON's lanes within 1e-8: its Cholesky solve carries the card's
    rounding times the Hessian's condition, which lanes with fewer rows
    than the 14 columns reach at lambda 0.1 (5.7e-9 on an H100)."""
    rng = np.random.default_rng(31)
    e, r, d = 512, 24, 14
    counts = rng.integers(1, r + 1, e)
    mask = (np.arange(r)[None, :] < counts[:, None]).astype(float)
    x = rng.normal(size=(e, r, d)) * mask[:, :, None]
    y = (rng.uniform(size=(e, r)) < 0.4).astype(float) * mask
    parts = [x, y, rng.uniform(0.5, 2.0, (e, r)) * mask, mask]
    off = rng.normal(size=(e, r)) * 0.3 * mask
    lam = rng.choice([0.1, 1.0, 10.0], e).astype(np.float32)
    cfg = CoordinateConfig(shard="u", random_effect="uid",
                           optimizer=OptimizerType["LBFGS" if optimizer == "OWLQN" else optimizer],
                           l1_ratio=0.5 if optimizer == "OWLQN" else 0.0,
                           max_iters=20, tolerance=1e-8)
    solve = _make_batched_solve(cfg)
    out = {}
    for dev in (cuda, torch.device("cpu")):
        t = lambda a: torch.from_numpy(np.array(a)).to(dev)  # noqa: E731
        design = RandomEffectDesign(*(t(a) for a in parts),
                                    torch.zeros((e, r), dtype=torch.int32, device=dev))
        out[dev.type] = solve(t(np.zeros((e, d))), t(lam), design, t(off))
    got, ref = out["cuda"], out["cpu"]
    same = (got.reason.cpu() == ref.reason) & (got.iterations.cpu() == ref.iterations)
    assert int((~same).sum()) <= e // 100
    dw = (got.w.cpu() - ref.w).abs()
    assert float(dw[same].max()) <= (1e-8 if optimizer == "NEWTON" else 1e-10)
    assert float(dw.max()) <= 1e-6 * max(1.0, float(ref.w.abs().max()))


def _game_training_files(root, n=3000, n_users=60):
    """Avro inputs for GAME training: a wide global shard (ELL on the
    card) and a per-user shard, with a held-out set."""
    rng = np.random.default_rng(37)
    gvocab = FeatureVocabulary([feature_key("g", str(j)) for j in range(500)],
                               add_intercept=True)
    uvocab = FeatureVocabulary([feature_key("u", str(j)) for j in range(4)], add_intercept=True)
    gvocab.save(os.path.join(root, "g.txt"))
    uvocab.save(os.path.join(root, "u.txt"))
    w_g = rng.normal(size=500) * 0.5
    w_u = rng.normal(size=(n_users, 4))
    paths = []
    for name, count in (("train", n), ("heldout", n // 3)):
        recs = []
        for i in range(count):
            cols = rng.choice(500, 8, replace=False)
            xg = rng.normal(size=8)
            xu = rng.normal(size=4)
            user = int((rng.zipf(1.3) - 1) % n_users)
            margin = xg @ w_g[cols] + xu @ w_u[user]
            recs.append({
                "uid": f"{name}{i}", "label": float(rng.uniform() < 1 / (1 + np.exp(-margin))),
                "features": [{"name": "g", "term": str(c), "value": float(v)}
                             for c, v in zip(cols, xg)]
                + [{"name": "u", "term": str(j), "value": float(xu[j])} for j in range(4)],
                "metadataMap": {"userId": f"user{user}"}, "weight": None,
                "offset": float(rng.normal() * 0.1)})
        paths.append(os.path.join(root, f"{name}.avro"))
        write_avro_file(paths[-1], TRAINING_EXAMPLE_SCHEMA, recs)
    coord = {"optimizer": "TRON", "max_iters": 50}
    return {
        "train_input": [paths[0]], "validate_input": [paths[1]], "num_iterations": 2,
        "updating_sequence": ["global", "per-user"],
        "feature_shards": {"gshard": os.path.join(root, "g.txt"),
                           "ushard": os.path.join(root, "u.txt")},
        "coordinates": {
            "global": {"shard": "gshard", "reg_weights": [1.0], "tolerance": 1e-15, **coord},
            "per-user": {"shard": "ushard", "random_effect": "userId",
                         "reg_weights": [5.0, 0.5], "tolerance": 1e-8, "num_buckets": 2,
                         **coord},
        },
        "sparse_shards": ["gshard"], "model_output_mode": "BEST",
    }


def test_game_training_on_the_card_matches_the_cpu(cuda, tmp_path):
    """The driver on the card: the fused passes and ell_matvec launched as
    often as the trainer counts, the card's run held to the CPU's with
    chip_smoke.py phase 5c's gates (the fixed effect at 1e-15: the card's
    sums, in another order than the CPU's, split its TRON from the CPU's
    in the last bits)."""
    params = _game_training_files(str(tmp_path))
    dispatch.reset_launch_counts()
    run = run_game_training({**params, "output_dir": str(tmp_path / "card")})
    launches = dispatch.launch_counts()
    history = [h for s in run.sweep for h in s["history"]]
    fixed = [h for h in history if h.coordinate == "global"]
    # ell_matvec: each combo's initial score, each fixed-effect rescore,
    # each validation, and the quality fingerprint's margin pass (the ELL
    # fixed effect of the best combo, once)
    want = {"fused_vgc": sum(int(h.solver_iterations) + 1 for h in fixed),
            "fused_hvp": sum(h.cg_iterations for h in fixed),
            "ell_matvec": len(run.sweep) + len(fixed) + len(history) + 1}
    # each fused pass's X^T side is one launch of the column-sorted reduce
    want["colsort_reduce"] = want["fused_vgc"] + want["fused_hvp"]
    assert launches == {k: want.get(k, 0) for k in launches}
    cpu = run_game_training({**params, "output_dir": str(tmp_path / "cpu")}, device="cpu")
    cpu_history = [h for s in cpu.sweep for h in s["history"]]
    assert run.best_index == cpu.best_index and len(history) == len(cpu_history)
    for a, b in zip(history, cpu_history):
        assert abs(a.objective - b.objective) <= 1e-7 * abs(b.objective)
        assert abs(a.validation_metric - b.validation_metric) <= 1e-6
    for g, c in zip(run.sweep, cpu.sweep):
        for name, p in c["model"].params.items():
            scale = max(1.0, float(p.abs().max()))
            assert float((g["model"].params[name].cpu() - p).abs().max()) <= 1e-6 * scale


def test_game_fingerprint_margins_on_the_card_equal_the_cpus(cuda, tmp_path):
    """The quality fingerprint's margin pass over a CUDA ELL design (one
    ell_matvec per ELL fixed effect) against the same model's on the CPU:
    the same rows, label, feature and entity sketches; the margins within
    1e-10, the margin sketch's moments within 1e-9 relative (phase 5g's
    gate)."""
    import json

    params = {**_game_training_files(str(tmp_path)), "output_dir": str(tmp_path / "card")}
    run = run_game_training(params)
    with open(os.path.join(run.output_dirs[0], "quality-fingerprint.json")) as f:
        card = json.load(f)
    from photon_ml_tpu_torch.game.scoring import score_game_data
    from photon_ml_tpu_torch.io.ingest import IngestSource
    from photon_ml_tpu_torch.obs import quality

    fp = quality.install_fingerprint_collector()
    try:
        data, _, _, _ = IngestSource(params["train_input"]).game_data(
            run.shard_vocabs, ["userId"], sparse_shards={"gshard"})
    finally:
        quality.uninstall_fingerprint_collector()
    shards = {"global": "gshard", "per-user": "ushard"}
    res = {"global": None, "per-user": "userId"}
    model = {n: (p.cpu() if torch.is_tensor(p) else p)
             for n, p in run.sweep[run.best_index]["model"].params.items()}
    before = dispatch.launch_counts()["ell_matvec"]
    card_margins = score_game_data(model, shards, res, data, device=cuda)
    assert dispatch.launch_counts()["ell_matvec"] == before + 1
    cpu_margins = score_game_data(model, shards, res, data, device="cpu")
    fp.observe_margins(cpu_margins.numpy() + data.offsets, np.asarray(data.weights))
    cpu = fp.to_dict()
    assert float((card_margins.cpu() - cpu_margins).abs().max()) <= 1e-10
    for key in ("rows", "label", "shards", "categoricals"):
        assert card[key] == cpu[key], key
    for key in ("count", "weight", "mean", "m2"):
        a, b = card["margin"]["moments"][key], cpu["margin"]["moments"][key]
        assert a == b or abs(a - b) <= 1e-9 * abs(b), key


from photon_ml_tpu_torch.game.data import build_bucketed_random_effect_design  # noqa: E402
from photon_ml_tpu_torch.game.factored import (  # noqa: E402
    FactoredConfig,
    FactoredRandomEffectCoordinate,
)
from photon_ml_tpu_torch.game.projected import ProjectedRandomEffectCoordinate  # noqa: E402
from photon_ml_tpu_torch.game.projectors import build_random_projection  # noqa: E402
from photon_ml_tpu_torch.ops.sparse import SparseFeatures  # noqa: E402


def _per_user_data(n=4000, e=300, seed=43):
    """A dense per-user shard (d = 8, intercept last) and a wide ELL one
    (2,000 columns, a pool of 20 per user, 5 slots a row)."""
    rng = np.random.default_rng(seed)
    ents = ((rng.zipf(1.3, n) - 1) % e).astype(np.int64)
    x = rng.normal(size=(n, 8))
    x[:, -1] = 1.0
    pools = rng.choice(2000, size=(e, 20))
    cols = pools[ents[:, None], rng.integers(0, 20, (n, 5))].astype(np.int32)
    vals = rng.normal(size=cols.shape)
    y = (rng.uniform(size=n) < 1 / (1 + np.exp(-x @ rng.normal(size=8)))).astype(float)
    wide = SparseFeatures(torch.from_numpy(cols), torch.from_numpy(vals), 2000)
    data = GameData.create({"u": x, "w": wide}, y, rng.normal(size=n) * 0.1, np.ones(n),
                           {"uid": ents})
    return data, rng.normal(size=n) * 0.3


def _same_update(got, ref, summary_got, summary_ref):
    """The card's table against the CPU's: the same reason and iterations
    per entity (at most 1% of entities may flip a stopping test at its
    threshold), those within 1e-10, all within 1e-6 of the scale."""
    same = ((summary_got.reason == summary_ref.reason)
            & (summary_got.iterations == summary_ref.iterations))
    assert int((~same).sum()) <= max(1, same.size // 100)
    rows = summary_ref.entity_ids[same]
    d = (got.cpu() - ref).abs()
    assert float(d[rows].max()) <= 1e-10
    assert float(d.max()) <= 1e-6 * max(1.0, float(ref.abs().max()))


@pytest.mark.parametrize("kind", ["RANDOM", "INDEX_MAP"])
def test_projected_update_on_the_card_matches_the_cpu(cuda, kind):
    """One update of a RANDOM=4 coordinate on the dense shard (NEWTON) and
    of an INDEX_MAP coordinate on the wide ELL shard (TRON), built and
    solved on each device (plain tensor products: no kernel of the port,
    and no launch)."""
    data, partial = _per_user_data()
    e = int(data.entity_ids["uid"].max()) + 1
    out = {}
    dispatch.reset_launch_counts()
    for key, dev in (("cuda", cuda), ("cpu", torch.device("cpu"))):
        if kind == "RANDOM":
            cfg = CoordinateConfig(shard="u", random_effect="uid", optimizer=OptimizerType.NEWTON,
                          reg_weight=1.0, max_iters=20, tolerance=1e-8)
            design = build_bucketed_random_effect_design(data, "uid", "u", e, num_buckets=2,
                                                         dtype=torch.float64, device=dev)
            coord = ProjectedRandomEffectCoordinate(
                design, torch.from_numpy(data.features["u"]).to(dev),
                torch.from_numpy(data.entity_ids["uid"]).to(dev),
                torch.from_numpy(data.offsets).to(dev), cfg,
                build_random_projection(8, 4, intercept_index=7, dtype=torch.float64,
                                        device=dev), 8)
        else:
            cfg = CoordinateConfig(shard="w", random_effect="uid", reg_weight=1.0, max_iters=30,
                          tolerance=1e-8)
            coord = ProjectedRandomEffectCoordinate.from_sparse_shard(
                data, "uid", "w", e, cfg, num_buckets=2, dtype=torch.float64,
                min_support=1, device=dev)
        table, summary, scores = coord.update_and_score(
            coord.initial_params(), torch.from_numpy(partial).to(dev))
        assert table.device.type == dev.type and scores.device.type == dev.type
        out[key] = (coord.back_project(table), summary)
    assert all(v == 0 for v in dispatch.launch_counts().values())
    (got, sg), (ref, sr) = out["cuda"], out["cpu"]
    _same_update(got, ref, sg, sr)


def test_factored_update_on_the_card_matches_the_cpu(cuda):
    """One update of a factored coordinate (latent 3; OWL-QN for gamma,
    TRON for B) on each device: gamma and B within 1e-8 of their scales
    (B's TRON sums over every entity, in the card's order)."""
    data, partial = _per_user_data()
    e = int(data.entity_ids["uid"].max()) + 1
    cfg = CoordinateConfig(shard="u", random_effect="uid", optimizer=OptimizerType.LBFGS, l1_ratio=0.5,
                  reg_weight=1.0, max_iters=20, tolerance=1e-7)
    latent = CoordinateConfig(shard="u", random_effect="uid", reg_weight=2.0, max_iters=20,
                     tolerance=1e-7)
    out = {}
    for key, dev in (("cuda", cuda), ("cpu", torch.device("cpu"))):
        design = build_bucketed_random_effect_design(data, "uid", "u", e, num_buckets=2,
                                                     dtype=torch.float64, device=dev)
        coord = FactoredRandomEffectCoordinate(
            design, torch.from_numpy(data.features["u"]).to(dev),
            torch.from_numpy(data.entity_ids["uid"]).to(dev),
            torch.from_numpy(data.offsets).to(dev), cfg,
            FactoredConfig(latent_dim=3, latent_factor_config=latent))
        params, _, scores = coord.update_and_score(coord.initial_params(),
                                                   torch.from_numpy(partial).to(dev))
        out[key] = (params, scores)
    (got, sg), (ref, sr) = out["cuda"], out["cpu"]
    for a, b in ((got.gamma, ref.gamma), (got.projection, ref.projection), (sg, sr)):
        assert float((a.cpu() - b).abs().max()) <= 1e-8 * max(1.0, float(b.abs().max()))


@pytest.mark.parametrize("n", [1, 1000, 1 << 20])
def test_fixed_order_cumsum_keeps_its_bits_on_the_card(cuda, n):
    from photon_ml_tpu_torch.ops.metrics import fixed_order_cumsum

    g = torch.Generator(device="cuda").manual_seed(n)
    x = torch.rand(n, generator=g, device="cuda", dtype=torch.float64)
    first = fixed_order_cumsum(x)
    assert first.device == x.device
    for _ in range(3):
        assert torch.equal(fixed_order_cumsum(x), first)
    assert torch.allclose(first.cpu(), torch.cumsum(x.cpu(), 0), rtol=1e-12, atol=0)


# -- the online serving engine on the card -----------------------------------


def _serving_model(seed=3, n_users=40, d_g=300, d_u=50, k=4):
    import numpy as np

    from photon_ml_tpu_torch.game.factored import FactoredParams

    rng = np.random.default_rng(seed)
    user = rng.normal(size=(n_users, d_u)) * (rng.uniform(size=(n_users, d_u)) < 0.2)
    params = {"global": rng.normal(size=d_g), "per-user": user,
              "fact": FactoredParams(torch.from_numpy(rng.normal(size=(n_users, k))),
                                     torch.from_numpy(rng.normal(size=(d_u, k))))}
    shards = {"global": "g", "per-user": "u", "fact": "u"}
    res = {"global": None, "per-user": "userId", "fact": "userId"}
    pool = ({"g": rng.normal(size=(64, d_g)), "u": rng.normal(size=(64, d_u))},
            rng.integers(-1, n_users, size=64).astype(np.int32))
    return params, shards, res, pool


def test_serving_engine_on_the_card_matches_the_cpu_without_new_segments(cuda):
    import numpy as np

    from photon_ml_tpu_torch.serving import ScoringEngine, bucket_builds

    params, shards, res, (feats, ents) = _serving_model()
    card = ScoringEngine(params, shards, res)
    cpu = ScoringEngine(params, shards, res, device="cpu")
    assert card.device.type == "cuda"
    card.warmup(max_batch=64, include_degraded=True)
    cpu.warmup(max_batch=64, include_degraded=True)
    assert card.compile_count == 8 == cpu.compile_count
    torch.cuda.synchronize()
    segments = torch.cuda.memory_stats()["segment.all.allocated"]
    builds = bucket_builds()
    for i in range(200):
        n = 1 + (i * 37) % 64
        got = card.score_arrays({s: f[:n] for s, f in feats.items()}, {"userId": ents[:n]},
                                fixed_only=i % 5 == 0)
        want = cpu.score_arrays({s: f[:n] for s, f in feats.items()}, {"userId": ents[:n]},
                                fixed_only=i % 5 == 0)
        assert np.all(np.abs(got - want) <= 1e-10 * np.maximum(1.0, np.abs(want)))
    assert card.compile_count == 8 and bucket_builds() == builds
    assert torch.cuda.memory_stats()["segment.all.allocated"] == segments


def test_drift_monitor_on_the_card(cuda):
    """A CUDA engine with a baseline observes the unpadded host rows and
    scores of each batch that is not fixed-effect-only: its reports equal a
    CPU engine's after the same batches, and warmup leaves no build and no
    new CUDA segment to the monitored traffic."""
    import numpy as np

    from photon_ml_tpu_torch.obs import quality
    from photon_ml_tpu_torch.serving import ScoringEngine, bucket_builds

    params, shards, res, (feats, ents) = _serving_model()
    engines = []
    for device in (None, "cpu"):
        base = quality.BaselineFingerprint(max_features=16)
        base.observe_rows("g", np.random.default_rng(1).normal(size=(2000, 300)))
        base.observe_margins(np.random.default_rng(2).normal(size=2000) * 8.0)
        engine = ScoringEngine(params, shards, res, baseline=base, device=device)
        engine.drift.check_every_rows, engine.drift.min_rows = 128, 32
        engine.drift.sample_every = 1
        engine.warmup(max_batch=64, include_degraded=True)
        engines.append(engine)
    card, cpu = engines
    torch.cuda.synchronize()
    segments = torch.cuda.memory_stats()["segment.all.allocated"]
    builds = bucket_builds()
    for i in range(40):
        n = 1 + (i * 29) % 64
        shift = 3.0 if i >= 24 else 0.0
        f = {"g": feats["g"][:n] + shift, "u": feats["u"][:n]}
        e = {"userId": ents[:n]}
        for engine in engines:
            engine.score_arrays(f, e, fixed_only=i % 7 == 3)
        assert card.drift.last_report == cpu.drift.last_report or all(
            abs(card.drift.last_report[k] - cpu.drift.last_report[k]) <= 1e-9
            for k in ("psi_max", "js_max"))
    assert card.drift.checks == cpu.drift.checks >= 3
    assert card.drift.alarms == cpu.drift.alarms >= 1
    assert bucket_builds() == builds
    assert torch.cuda.memory_stats()["segment.all.allocated"] == segments


def test_tiered_cache_on_the_card(cuda):
    import numpy as np

    from photon_ml_tpu_torch.serving import ScoringEngine

    params, shards, res, (feats, ents) = _serving_model()
    plain = ScoringEngine(params, shards, res)
    cached = ScoringEngine(params, shards, res, hbm_cache_entities=8)
    cache = cached._caches["userId"]
    cache.close()
    got = cached.score_arrays(feats, {"userId": ents})
    hit = np.isin(ents, np.flatnonzero(cache.slot_of >= 0))
    full = plain.score_arrays(feats, {"userId": ents})
    cold = plain.score_arrays(feats, {"userId": np.full_like(ents, -1)})
    assert hit.any() and (~hit).any()
    assert np.all(np.abs(got[hit] - full[hit]) <= 1e-10 * np.maximum(1.0, np.abs(full[hit])))
    assert np.all(np.abs(got[~hit] - cold[~hit]) <= 1e-10 * np.maximum(1.0, np.abs(cold[~hit])))
    assert cache.promote_pending() > 0
    assert cache.device_tables()[("per-user", "values")].device.type == "cuda"


def test_hbm_watermark_on_the_card(cuda):
    from photon_ml_tpu_torch import obs
    from photon_ml_tpu_torch.obs.metrics import MetricsRegistry

    reg = MetricsRegistry()
    with obs.hbm_watermark("phase", registry=reg, device=cuda) as wm:
        x = torch.empty(1 << 20, device=cuda)
        del x
    assert wm.supported and wm.peak_bytes >= wm.before_bytes + (4 << 20)
    assert reg.gauge("hbm.phase.peak_bytes").value == wm.peak_bytes
    assert reg.gauge("hbm.phase.delta_bytes").value == wm.delta_bytes


# -- hybrid designs: the slab a plain product, each cold segment on the
# kernels -------------------------------------------------------------------

import dataclasses  # noqa: E402

from photon_ml_tpu_torch.ops import sparse as sparse_ops  # noqa: E402


def _hybrid(n=3000, d=5000, hot=12, seed=29):
    """A hybrid on the CPU whose first cold segment is all padding (the
    rows that name hot columns only), and whose last holds one row (the
    one row with 40 cold entries), among 8 row buckets."""
    rng = np.random.default_rng(seed)
    rows, cols = [], []
    for i in range(n):
        c = rng.choice(hot, size=3, replace=False).tolist()
        if i % 7:
            c += (hot + rng.choice(d - hot, size=40 if i == n // 2 else 1 + i % 6,
                                   replace=False)).tolist()
        rows += [i] * len(c)
        cols += c
    vals = rng.normal(size=len(cols))
    sf = from_coo(np.asarray(rows), np.asarray(cols), vals, n, d, dtype=torch.float64)
    hf = sparse_ops.to_hybrid(sf, hot_columns=hot)
    widths = [s.nnz_per_row for s in hf.cold_segments]
    assert not bool((hf.cold_segments[0].indices < d).any()) and widths[0] == 1
    assert hf.segment_bounds()[-1][1] - hf.segment_bounds()[-1][0] == 1 and widths[-1] == 40
    return hf


def _abs_hybrid(hf):
    return dataclasses.replace(
        hf, dense=hf.dense.abs().double(),
        cold_segments=tuple(dataclasses.replace(s, values=s.values.abs().double())
                            for s in hf.cold_segments))


@pytest.mark.parametrize("vdt,wdt,rtol", DTYPES, ids=["f64", "f32", "bf16-f32"])
def test_hybrid_contractions_match_plain_versions(cuda, vdt, wdt, rtol):
    """matvec, rmatvec and colsum of a hybrid on the card against the same
    calls on the CPU (each segment's plain versions), with one ell_matvec
    per segment and one reduce per segment that holds an entry."""
    cpu = sparse_ops.cast_values(_hybrid(), vdt, "cpu")
    card = sparse_ops.cast_values(cpu, vdt, cuda)
    n, d = cpu.shape
    segs = len(cpu.cold_segments)
    g = torch.Generator().manual_seed(31)
    w = torch.randn(d, generator=g, dtype=torch.float64).to(wdt)
    a = torch.randn(n, generator=g, dtype=torch.float64).to(wdt)
    absx = _abs_hybrid(cpu)
    before = dispatch.launch_counts()
    z = sparse_ops.matvec(card, w.to(cuda))
    gr = sparse_ops.rmatvec(card, a.to(cuda))
    sums = [sparse_ops.colsum(card, a.to(cuda), square=sq) for sq in (False, True)]
    torch.cuda.synchronize()
    after = dispatch.launch_counts()
    assert after["ell_matvec"] - before["ell_matvec"] == segs
    assert after["colsort_reduce"] - before["colsort_reduce"] == 3 * (segs - 1)
    assert after["ell_rmatvec"] - before["ell_rmatvec"] == segs - 1
    assert after["ell_colsum"] - before["ell_colsum"] == 2 * (segs - 1)
    pairs = [(z, sparse_ops.matvec(cpu, w), sparse_ops.matvec(absx, w.abs().double())),
             (gr, sparse_ops.rmatvec(cpu, a), sparse_ops.rmatvec(absx, a.abs().double()))]
    for sq, got in zip((False, True), sums):
        pairs.append((got, sparse_ops.colsum(cpu, a, square=sq),
                      sparse_ops.colsum(absx, a.abs().double(), square=sq)))
    for got, ref, scale in pairs:
        assert got.dtype == ref.dtype and got.shape == ref.shape
        assert torch.all((got.cpu().double() - ref.double()).abs() <= rtol * scale + 1e-300)


def test_hybrid_empty_segment_launches_nothing_and_is_zero(cuda):
    hf = sparse_ops.cast_values(_hybrid(), torch.float64, cuda)
    first = hf.cold_segments[0]
    lo, hi = hf.segment_bounds()[0]
    a = torch.randn(hf.shape[0], dtype=torch.float64, device=cuda)[lo:hi]
    before = dispatch.launch_counts()
    g = sparse_ops.rmatvec(first, a)
    s = sparse_ops.colsum(first, a, square=True)
    assert dispatch.launch_counts() == before
    assert g.device.type == "cuda" and not g.any() and not s.any()


def test_hybrid_does_not_fall_back_to_the_cpu(cuda, monkeypatch):
    """A hybrid whose kernels cannot launch fails the call."""
    from photon_ml_tpu_torch.kernels import ell as ell_module
    from photon_ml_tpu_torch.kernels import launch as launch_module

    hf = sparse_ops.cast_values(_hybrid(), torch.float64, cuda)

    def no_kernel(*args, **kwargs):
        raise RuntimeError("kernel unavailable")

    monkeypatch.setattr(ell_module, "load_entry", no_kernel)
    monkeypatch.setattr(launch_module.Entry, "launch", no_kernel)
    n, d = hf.shape
    with pytest.raises(RuntimeError, match="kernel unavailable"):
        sparse_ops.matvec(hf, torch.ones(d, dtype=torch.float64, device=cuda))
    with pytest.raises(RuntimeError, match="kernel unavailable"):
        sparse_ops.rmatvec(hf, torch.ones(n, dtype=torch.float64, device=cuda))


# -- the I/O runtime: the pinned staging ring, the copy stream, the
# out-of-core double buffer -------------------------------------------------

from photon_ml_tpu_torch.io import pipeline as pipeline_mod  # noqa: E402
from photon_ml_tpu_torch.io.avro import write_avro_file  # noqa: E402
from photon_ml_tpu_torch.io.ingest import IngestSource, make_training_example  # noqa: E402
from photon_ml_tpu_torch.io.schemas import TRAINING_EXAMPLE_SCHEMA  # noqa: E402
from photon_ml_tpu_torch.io.vocab import FeatureVocabulary  # noqa: E402
from photon_ml_tpu_torch.resilience.faults import FaultSpec, inject  # noqa: E402

PIPE_D = 48


def _pipe_parts(tmp_path, sizes=(700, 311, 923, 402)):
    rng = np.random.default_rng(41)
    paths = []
    for i, n in enumerate(sizes):
        recs = [make_training_example(
            label=float(rng.integers(0, 2)),
            features={(f"f{j}", "t"): float(rng.standard_normal())
                      for j in rng.choice(PIPE_D, 9, replace=False)},
            uid=f"u{i}-{r}", offset=float(rng.standard_normal()),
            weight=float(rng.uniform(0.5, 2.0)) if r % 3 else None) for r in range(n)]
        p = str(tmp_path / f"part-{i}.avro")
        write_avro_file(p, TRAINING_EXAMPLE_SCHEMA, recs)
        paths.append(p)
    return paths, FeatureVocabulary([f"f{j}\x01t" for j in range(PIPE_D)], add_intercept=True)


def _same_batch(a, b):
    for f in pipeline_mod.COLUMNS:
        x, y = getattr(a, f), getattr(b, f)
        assert x.shape == y.shape and torch.equal(x.cpu(), y.cpu()), f


@pytest.mark.parametrize("depth", [1, 2, 4])
def test_streamed_batch_on_the_card_is_the_one_shot_read(cuda, tmp_path, depth):
    paths, vocab = _pipe_parts(tmp_path)
    whole, uids_w, _ = IngestSource(paths).labeled_batch(vocab, dtype=torch.float64)
    with pipeline_mod.IngestPipeline(paths, [vocab], config=pipeline_mod.PipelineConfig(
            chunk_mb=0.02, prefetch_depth=depth)) as pipe:
        batch, uids, _ = pipe.labeled_batch(dtype=torch.float64, device=cuda)
        wm = pipe.assemble_watermark
        assert pipe.stats.chunks > 4 * depth
    assert batch.features.device.type == "cuda"
    _same_batch(batch, whole)
    assert list(uids) == list(uids_w)
    # the dataset and the one chunk in flight on the card, each of their
    # five tensors rounded up to the allocator's 512-byte granule
    rows = pipeline_mod.rows_per_chunk_for(0.02, len(vocab))

    def granules(n):
        return -(-n * 8 // 512) * 512

    dataset = sum(granules(getattr(batch, f).numel()) for f in pipeline_mod.COLUMNS)
    chunk = granules(rows * len(vocab)) + 4 * granules(rows)
    assert wm.supported and wm.peak_bytes - wm.before_bytes <= dataset + chunk


def test_slot_reuse_race_keeps_the_exact_batch(cuda, tmp_path, monkeypatch):
    """Prefetch depth 1 (a ring of two pinned slots), the first group's
    decode delayed, and every chunk's copy held back on the copy stream by
    a 5 ms device sleep queued before it: each slot is refilled while the
    copy issued from it two chunks back is still pending, unless the ring
    waits on that copy's event. With the events dropped the batch is
    corrupted (the race is planted); with them it is the one-shot read."""
    paths, vocab = _pipe_parts(tmp_path, sizes=(2000, 1500, 2500, 1800))
    whole, _, _ = IngestSource(paths).labeled_batch(vocab, dtype=torch.float64)
    transfer = pipeline_mod.IngestPipeline._transfer

    def held_back(self, staged, ring, device, streams):
        with torch.cuda.stream(streams[0]):
            torch.cuda._sleep(10_000_000)  # about 5 ms of the card's cycles
        return transfer(self, staged, ring, device, streams)

    monkeypatch.setattr(pipeline_mod.IngestPipeline, "_transfer", held_back)

    def assemble():
        with inject(FaultSpec("pipeline.decode", "delay", nth=1, delay=0.05)):
            with pipeline_mod.IngestPipeline(paths, [vocab], config=pipeline_mod.PipelineConfig(
                    chunk_mb=0.01, prefetch_depth=1, decode_threads=2)) as pipe:
                batch, _, _ = pipe.labeled_batch(dtype=torch.float64, device=cuda)
                assert pipe.stats.chunks > 20
        return batch

    with monkeypatch.context() as m:
        m.setattr(pipeline_mod._StagingRing, "note_transfer", lambda self, slot, event: None)
        corrupted = assemble()
    assert not torch.equal(corrupted.features.cpu(), whole.features)
    _same_batch(assemble(), whole)


def test_stalled_transfer_on_the_card_is_harmless(cuda, tmp_path):
    """A copy attempt delayed past ``stage_timeout_s`` is abandoned and
    redone; the stray wakes after the batch is built and copies into
    device tensors of its own, so the batch stays the one-shot read."""
    paths, vocab = _pipe_parts(tmp_path)
    whole, _, _ = IngestSource(paths).labeled_batch(vocab, dtype=torch.float64)
    with inject(FaultSpec("pipeline.transfer", "delay", nth=1, delay=1.0)):
        with pipeline_mod.IngestPipeline(paths, [vocab], config=pipeline_mod.PipelineConfig(
                chunk_mb=0.02, prefetch_depth=1, stage_timeout_s=0.3)) as pipe:
            batch, _, _ = pipe.labeled_batch(dtype=torch.float64, device=cuda)
            _same_batch(batch, whole)
            assert pipe.stats.retries == 1
    # closing the pipeline joined the stray: its copy has run
    torch.cuda.synchronize()
    _same_batch(batch, whole)


def test_a_failed_copy_raises_and_does_not_fall_back(cuda, tmp_path, monkeypatch):
    from photon_ml_tpu_torch.resilience.retry import RetryBudgetExceeded

    paths, vocab = _pipe_parts(tmp_path, sizes=(300,))
    with inject(FaultSpec("pipeline.transfer", "raise", nth=1, count=-1)):
        with pipeline_mod.IngestPipeline(paths, [vocab]) as pipe:
            with pytest.raises(RetryBudgetExceeded):
                pipe.labeled_batch(dtype=torch.float64, device=cuda)

    def broken(*args, **kwargs):
        raise RuntimeError("CUDA error: an illegal memory access was encountered")

    monkeypatch.setattr(torch.cuda.Event, "record", broken)
    with pipeline_mod.IngestPipeline(paths, [vocab]) as pipe:
        with pytest.raises(RuntimeError, match="illegal memory access"):
            pipe.labeled_batch(dtype=torch.float64, device=cuda)


def test_out_of_core_objective_on_the_card(cuda):
    """The double-buffered sweep on the card equals the in-core objective
    on the CPU within 1e-12, pins its chunks, and holds two chunk slots."""
    from photon_ml_tpu_torch.core.types import LabeledBatch
    from photon_ml_tpu_torch.ops.losses import LOGISTIC_LOSS
    from photon_ml_tpu_torch.ops.objective import GLMObjective

    rng = np.random.default_rng(5)
    n, d = 5000, 33
    x = rng.standard_normal((n, d))
    batch = LabeledBatch.create(x, (rng.uniform(size=n) < 0.4).astype(float),
                                offsets=0.1 * rng.standard_normal(n),
                                weights=rng.uniform(0.5, 2.0, n), dtype=torch.float64)
    design = pipeline_mod.StreamedDesign.from_batch(batch, rows_per_chunk=700, device=cuda)
    assert design.num_chunks == 8 and all(
        t.is_pinned() for c in design.chunks for t in c.values())
    sobj = pipeline_mod.StreamingObjective(design, LOGISTIC_LOSS, l2_weight=0.3)
    obj = GLMObjective(loss=LOGISTIC_LOSS, l2_weight=0.3)
    w = torch.from_numpy(rng.standard_normal(d))
    v = torch.from_numpy(rng.standard_normal(d))
    # the compute stream's cuBLAS workspace is allocated once, at its first
    # product, and is no part of the design's footprint
    torch.mv(torch.ones((2, 2), dtype=torch.float64, device=cuda),
             torch.ones(2, dtype=torch.float64, device=cuda))
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated(cuda)
    torch.cuda.reset_peak_memory_stats(cuda)
    val, grad = sobj.value_and_grad(w.to(cuda))
    hv = sobj.hessian_vector(w.to(cuda), v.to(cuda))
    diag = sobj.hessian_diagonal(w.to(cuda))
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(cuda) - before
    # the two slots, the diagonal's x * x of one chunk, and row vectors
    assert 2 * design.chunk_bytes <= peak <= 4 * design.chunk_bytes
    val_i, grad_i = obj.value_and_grad(w, batch)
    assert abs(float(val) - float(val_i)) <= 1e-12 * abs(float(val_i))
    for got, want in ((grad, grad_i), (hv, obj.hessian_vector(w, v, batch)),
                      (diag, obj.hessian_diagonal(w, batch))):
        assert got.device.type == "cuda"
        assert float((got.cpu() - want).abs().max()) <= 1e-12 * max(1.0, float(want.abs().max()))
    # the sweeps' device times, read from their events
    sobj.flush_timing()
    assert sobj.stats.bytes_to_device == 3 * design.bytes_per_epoch
    assert len(sobj.stats._intervals) == 3 * 2 * design.num_chunks
    assert 0.0 < sobj.stats.transfer_s < sobj.stats.wall_s
    assert 0.0 < sobj.stats.consume_s < sobj.stats.wall_s
    assert 0.0 <= sobj.stats.overlap_frac() <= 1.0


# -- the main path's launch plans (kernels/launch.py) ------------------------

from photon_ml_tpu_torch.kernels import colsort as colsort_module  # noqa: E402
from photon_ml_tpu_torch.kernels import ell as ell_plans  # noqa: E402
from photon_ml_tpu_torch.kernels import fused as fused_plans  # noqa: E402


def _same_bits(a, b):
    return a.dtype == b.dtype and torch.equal(a.reshape(-1).view(torch.uint8),
                                              b.reshape(-1).view(torch.uint8))


def _main_path_calls(idx, val, d, dt, device):
    """name -> (a call of the wrapper, the launches it counts)."""
    y, off, ew, w = _fused_inputs(idx.shape[0], idx.shape[1], d, dt, device)
    v = val.to(dt)
    copy = colsort_module.design_columns(idx, d)
    cvals = colsort_module.column_values(copy, v)
    return {
        "ell_matvec": (lambda: ell_matvec(idx, v, w, d), {"ell_matvec": 1}),
        "ell_scatter_add": (lambda: ell_scatter_add(idx, v * ew[:, None], d),
                            {"ell_scatter_add": 1}),
        "ell_rmatvec": (lambda: ell_rmatvec(idx, v, ew, d),
                        {"ell_rmatvec": 1, "colsort_reduce": 1}),
        "ell_colsum": (lambda: ell_colsum(idx, v, ew, d, square=True),
                       {"ell_colsum": 1, "colsort_reduce": 1}),
        "fused_vgc": (lambda: fused_value_grad_curvature(idx, v, y, off, ew, w, d, LOGISTIC_LOSS),
                      {"fused_vgc": 1, "colsort_reduce": 1}),
        "fused_hvp": (lambda: fused_hessian_vector(idx, v, ew, w, torch.tensor(
            0.3, dtype=dt, device=device), d), {"fused_hvp": 1, "colsort_reduce": 1}),
        "fused_hdiag": (lambda: fused_hessian_diagonal(idx, v, y, off, ew, w, d, LOGISTIC_LOSS),
                        {"fused_hdiag": 1, "colsort_reduce": 1}),
        "colsort_reduce": (lambda: colsort_module.column_reduce(copy, cvals, ew, "pair"),
                           {"colsort_reduce": 1}),
    }


@pytest.mark.parametrize("dt", [torch.float64, torch.float32])
def test_main_path_plans_keep_the_bits_and_the_launch_counts(cuda, dt):
    """A first call (which builds its plan) and later calls of the same key
    give the same bits (``ell_scatter_add``, whose hot columns take
    atomics, off the training paths: within 1e-12 of its largest sum in
    f64, 1e-5 in f32), and each
    call counts exactly its launches."""
    d = 3001
    idx, val = _ell(4099, 40, d, cuda)
    for name, (call, launches) in _main_path_calls(idx, val, d, dt, cuda).items():
        tol = 1e-12 if dt == torch.float64 else 1e-5
        same = _same_bits if name != "ell_scatter_add" else (
            lambda a, b: bool(((a - b).abs() <= tol * a.abs().max()).all()))
        before = dispatch.launch_counts()
        first = call()
        torch.cuda.synchronize()
        after = dispatch.launch_counts()
        assert {k: after[k] - before[k] for k in after if after[k] != before[k]} == launches, name
        for _ in range(3):
            again = call()
            for a, b in zip(*(o if isinstance(o, tuple) else (o,) for o in (first, again))):
                assert same(a, b), name
        final = dispatch.launch_counts()
        assert all(final[k] - after[k] == 3 * v for k, v in launches.items()), name


def test_main_path_plans_are_built_per_key(cuda, monkeypatch):
    """A changed dtype or width builds a new plan; the same key reuses its
    plan; the plan of a CUDA key holds its entry point, loaded."""
    monkeypatch.setattr(ell_plans, "_matvec_plans", {})
    monkeypatch.setattr(fused_plans, "_vgc_plans", {})
    d = 3001
    idx, val = _ell(999, 5, d, cuda)
    w = torch.randn(d, device=cuda, dtype=torch.float64)
    ell_matvec(idx, val, w, d)
    count = len(ell_plans._matvec_plans)
    ell_matvec(idx, val, w, d)
    assert len(ell_plans._matvec_plans) == count
    ell_matvec(idx, val.float(), w.float(), d)
    assert len(ell_plans._matvec_plans) == count + 1
    idx2 = idx.clone()
    idx2[idx2 == d] = d + 1
    ell_matvec(idx2, val, torch.randn(d + 1, device=cuda, dtype=torch.float64), d + 1)
    assert len(ell_plans._matvec_plans) == count + 2
    plans = [p for p in ell_plans._matvec_plans.values() if p != "plain"]
    assert plans and all(p[-1]._fn is not None for p in plans)
    y, off, ew, wf = _fused_inputs(999, 5, d, torch.float64, cuda)
    fused_value_grad_curvature(idx, val, y, off, ew, wf, d, LOGISTIC_LOSS)
    count = len(fused_plans._vgc_plans)
    fused_value_grad_curvature(idx, val, y, off, ew, wf, d, SQUARED_LOSS)
    assert len(fused_plans._vgc_plans) == count + 1


def test_main_path_wrappers_refuse_after_a_good_call_of_the_same_key(cuda):
    """A non-contiguous tensor of a good call's shape still raises, and a
    misaligned copy's values are refused by the reduce."""
    d = 100
    idx, val = _ell(64, 8, d, cuda)
    y, off, ew, w = _fused_inputs(64, 8, d, torch.float64, cuda)
    ell_matvec(idx, val, w, d)
    fused_value_grad_curvature(idx, val, y, off, ew, w, d, LOGISTIC_LOSS)
    ell_rmatvec(idx, val, ew, d)
    with pytest.raises(ValueError, match="contiguous"):
        ell_matvec(idx.t().contiguous().t(), val, w, d)
    with pytest.raises(ValueError, match="contiguous"):
        fused_value_grad_curvature(idx, val.t().contiguous().t(), y, off, ew, w, d,
                                   LOGISTIC_LOSS)
    with pytest.raises(ValueError, match="contiguous"):
        ell_rmatvec(idx, val.t().contiguous().t(), ew, d)
    copy = colsort_module.design_columns(idx, d)
    cvals = colsort_module.column_values(copy, val)
    colsort_module.column_reduce(copy, cvals, ew)
    flat = torch.empty(cvals.numel() + 1, dtype=cvals.dtype, device=cuda)
    flat[1:] = cvals
    with pytest.raises(ValueError, match="16-byte"):
        colsort_module.column_reduce(copy, flat[1:], ew)


@pytest.mark.parametrize("name", ["ell_matvec", "ell_scatter_add", "ell_rmatvec", "fused_vgc",
                                  "fused_hvp", "fused_hdiag", "colsort_reduce"])
def test_main_path_wrappers_launch_on_the_current_stream(cuda, name):
    """Inside ``torch.cuda.stream(s)``, after the card sleeps and the
    weights are written in place on ``s``, the wrapper sees the write: it
    ran on ``s``."""
    d = 3001
    idx, val = _ell(20011, 40, d, cuda)
    calls = _main_path_calls(idx, val, d, torch.float64, cuda)
    call = calls[name][0]
    ref = call()
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    # every call reads the values; scaling them by -3 on s after the sleep
    # changes every output
    with torch.cuda.stream(s):
        torch.cuda._sleep(100_000_000)
        val.mul_(-3.0)
        got = _main_path_calls(idx, val, d, torch.float64, cuda)[name][0]()
    torch.cuda.current_stream().wait_stream(s)
    want = _main_path_calls(idx, val, d, torch.float64, cuda)[name][0]()
    outs = [o if isinstance(o, tuple) else (o,) for o in (got, want, ref)]
    # the scatter's hot columns take atomics: its sums within 1e-12 of the
    # largest, every other output's bits
    same = _same_bits if name != "ell_scatter_add" else (
        lambda a, b: bool(((a - b).abs() <= 1e-12 * a.abs().max()).all()))
    for a, b in zip(outs[0], outs[1]):
        assert same(a, b), name
    assert not all(same(a, b) for a, b in zip(outs[0], outs[2]))


# -- the observability layer on the card -------------------------------------


def test_debug_nans_checks_each_kernel_launch(cuda, tmp_path):
    """``ctypes`` launches are invisible to dispatch: under ``debug_nans``
    the wrapper checks its kernel's output and names the kernel; outside
    it the same launch returns the NaN. A profile window on the card lists
    the kernel by its CUDA symbol, and the cost book gives the H100's
    shares only on an H100."""
    import glob
    import json

    from photon_ml_tpu_torch.obs import cost
    from photon_ml_tpu_torch.utils.debug import debug_nans, profile_trace

    d = 257
    idx, val = _ell(1000, 8, d, cuda)
    w = torch.randn(d, device=cuda, dtype=torch.float64)
    w[idx[0, 0]] = float("nan")
    before = dispatch.launch_counts()["ell_matvec"]
    with debug_nans(True):
        with pytest.raises(FloatingPointError, match="ell_matvec kernel"):
            ell_matvec(idx, val, w, d)
    assert dispatch.launch_counts()["ell_matvec"] == before + 1
    assert bool(torch.isnan(ell_matvec(idx, val, w, d)).any())
    with profile_trace(str(tmp_path), device=cuda):
        ell_matvec(idx, val, torch.ones(d, device=cuda, dtype=torch.float64), d)
        torch.cuda.synchronize()
    (path,) = glob.glob(str(tmp_path / "*.pt.trace.json"))
    with open(path) as f:
        names = {e.get("name", "") for e in json.load(f)["traceEvents"]
                 if e.get("cat") == "kernel"}
    assert any("ell_matvec_kernel" in n for n in names), sorted(names)[:20]
    peaks = cost.peaks_for(cuda, torch.float64)
    if "H100" in torch.cuda.get_device_name(cuda):
        assert peaks == (34e12, 3.35e12)
    else:
        assert peaks == (None, None)
