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
