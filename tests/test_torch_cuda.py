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
    for _ in range(3):
        again = fused_value_grad_curvature(idx, val, y, off, ew, w, d, LOGISTIC_LOSS)
        assert torch.equal(first[0], again[0]) and torch.equal(first[2], again[2])
        assert torch.equal(first[3], again[3])  # per row, no atomics
        assert torch.equal(usum, fused_hessian_vector(idx, val, ew, w, shift, d)[1])


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
