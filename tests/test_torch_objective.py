"""The port's ``GLMObjective`` on the CPU against the JAX package's, on the
same seeded batch, normalization arrays and coefficients: value, gradient,
curvature weights and Hessian-vector products, under NONE,
SCALE_WITH_STANDARD_DEVIATION and STANDARDIZATION normalization, with and
without L2, for dense and padded-ELL designs. The JAX objective runs its
default route (XLA on the CPU) and, for ELL designs, its fused Pallas
kernels in interpret mode (``PHOTON_SPARSE_KERNEL=pallas``).

Tolerance: float64 throughout; every output within 1e-10 x (1 + the
largest magnitude of the JAX output) — summation order only.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_ml_tpu.core.normalization import (
    NormalizationType as JNormType,
    build_normalization_context as j_build_norm,
)
from photon_ml_tpu.core.types import LabeledBatch as JBatch
from photon_ml_tpu.kernels import dispatch as jax_dispatch
from photon_ml_tpu.ops import losses as jax_losses
from photon_ml_tpu.ops.objective import GLMObjective as JObjective
from photon_ml_tpu.ops.sparse import from_dense as j_from_dense
from photon_ml_tpu.ops.stats import summarize_features as j_summarize
from photon_ml_tpu_torch.core.normalization import (
    NormalizationType,
    build_normalization_context,
)
from photon_ml_tpu_torch.interop import (
    labeled_batch_from_numpy,
    normalization_from_numpy,
    sparse_from_numpy,
)
from photon_ml_tpu_torch.ops import losses as port_losses
from photon_ml_tpu_torch.ops.objective import GLMObjective, RegularizationContext
from photon_ml_tpu_torch.ops.stats import summarize_features

N, D = 120, 30
NORMS = ["NONE", "SCALE_WITH_STANDARD_DEVIATION", "STANDARDIZATION"]
LOSSES = {
    "logistic": (jax_losses.LOGISTIC_LOSS, port_losses.LOGISTIC_LOSS),
    "poisson": (jax_losses.POISSON_LOSS, port_losses.POISSON_LOSS),
    "squared": (jax_losses.SQUARED_LOSS, port_losses.SQUARED_LOSS),
}


def _data(rng, loss):
    x = rng.standard_normal((N, D)) * (rng.uniform(size=(N, D)) < 0.3)
    x[:, D - 1] = 1.0  # intercept column
    x[:, 3] = 2.5 * x[:, 3] + 1.0 * (x[:, 3] != 0)  # a shifted, scaled column
    w_true = 0.3 * rng.standard_normal(D)
    z = x @ w_true
    if loss == "logistic":
        y = (rng.uniform(size=N) < 1 / (1 + np.exp(-z))).astype(np.float64)
    elif loss == "poisson":
        y = rng.poisson(np.exp(0.3 * z)).astype(np.float64)
    else:
        y = z + 0.1 * rng.standard_normal(N)
    off = 0.1 * rng.standard_normal(N)
    wts = rng.uniform(0.5, 2.0, size=N)
    mask = np.ones(N)
    mask[-5:] = 0.0  # padding rows
    return x, y, off, wts, mask


def _batches(x, y, off, wts, mask, sparse):
    if sparse:
        jf = j_from_dense(x, dtype=jnp.float64)
        pf = sparse_from_numpy(np.asarray(jf.indices), np.asarray(jf.values), jf.d)
    else:
        jf = jnp.asarray(x)
        pf = x
    jb = JBatch(jf, jnp.asarray(y), jnp.asarray(off), jnp.asarray(wts), jnp.asarray(mask))
    pb = labeled_batch_from_numpy(pf, y, off, wts, mask)
    return jb, pb


def _norms(jb, pb, norm):
    jn = j_build_norm(JNormType[norm], j_summarize(jb), D - 1)
    pn = normalization_from_numpy(
        None if jn.factors is None else np.asarray(jn.factors),
        None if jn.shifts is None else np.asarray(jn.shifts),
    )
    # the port's own summary gives the same context
    own = build_normalization_context(NormalizationType[norm], summarize_features(pb), D - 1)
    for a, b in ((pn.factors, own.factors), (pn.shifts, own.shifts)):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-12, atol=1e-14)
    return jn, pn


def _close(got, ref):
    ref = np.asarray(ref, np.float64)
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    tol = 1e-10 * (1.0 + np.max(np.abs(ref)))
    assert np.max(np.abs(got - ref), initial=0.0) <= tol


@pytest.mark.parametrize("loss", sorted(LOSSES))
@pytest.mark.parametrize("l2", [0.0, 0.7])
@pytest.mark.parametrize("norm", NORMS)
@pytest.mark.parametrize("sparse", [True, False], ids=["ell", "dense"])
def test_objective_matches_jax(rng, sparse, norm, l2, loss):
    x, y, off, wts, mask = _data(rng, loss)
    jb, pb = _batches(x, y, off, wts, mask, sparse)
    jn, pn = _norms(jb, pb, norm)
    jl, pl_ = LOSSES[loss]
    jo = JObjective(loss=jl, normalization=jn, l2_weight=l2)
    po = GLMObjective(loss=pl_, normalization=pn, l2_weight=l2)
    w = 0.2 * rng.standard_normal(D)
    v = rng.standard_normal(D)
    jw, pw = jnp.asarray(w), torch.from_numpy(w)
    jv, pv = jnp.asarray(v), torch.from_numpy(v)

    for got, ref in zip(po.value_grad_curvature(pw, pb), jo.value_grad_curvature(jw, jb)):
        _close(got, ref)
    for got, ref in zip(po.value_and_grad(pw, pb), jo.value_and_grad(jw, jb)):
        _close(got, ref)
    _close(po.margins(pw, pb), jo.margins(jw, jb))
    _close(po.hessian_coefficients(pw, pb), jo.hessian_coefficients(jw, jb))
    _close(po.hessian_vector(pw, pv, pb), jo.hessian_vector(jw, jv, jb))
    c = po.value_grad_curvature(pw, pb)[2]
    _close(po.hessian_vector_at(c, pv, pb),
           jo.hessian_vector_at(jnp.asarray(c.numpy()), jv, jb))


@pytest.mark.parametrize("norm", NORMS)
def test_ell_objective_matches_jax_fused_pallas(rng, norm, monkeypatch):
    monkeypatch.setenv(jax_dispatch.ENV_VAR, "pallas")
    jax_dispatch.reset_probe_cache()
    try:
        x, y, off, wts, mask = _data(rng, "logistic")
        jb, pb = _batches(x, y, off, wts, mask, True)
        jn, pn = _norms(jb, pb, norm)
        jo = JObjective(loss=jax_losses.LOGISTIC_LOSS, normalization=jn, l2_weight=0.5)
        po = GLMObjective(loss=port_losses.LOGISTIC_LOSS, normalization=pn, l2_weight=0.5)
        assert jo._use_fused_kernel(jb.features, jnp.float64)
        w = 0.2 * rng.standard_normal(D)
        v = rng.standard_normal(D)
        for got, ref in zip(po.value_grad_curvature(torch.from_numpy(w), pb),
                            jo.value_grad_curvature(jnp.asarray(w), jb)):
            _close(got, ref)
        c = po.hessian_coefficients(torch.from_numpy(w), pb)
        _close(po.hessian_vector_at(c, torch.from_numpy(v), pb),
               jo.hessian_vector_at(jnp.asarray(c.numpy()), jnp.asarray(v), jb))
    finally:
        monkeypatch.delenv(jax_dispatch.ENV_VAR)
        jax_dispatch.reset_probe_cache()


def test_regularization_context_and_variations():
    reg = RegularizationContext("ELASTIC_NET", alpha=0.25)
    assert reg.l1_weight(2.0) == 0.5 and reg.l2_weight(2.0) == 1.5
    assert RegularizationContext("L2").l1_weight(3.0) == 0.0
    assert RegularizationContext("L1").l2_weight(3.0) == 0.0
    with pytest.raises(ValueError, match="reg_type"):
        RegularizationContext("L3")
    with pytest.raises(ValueError, match="alpha"):
        RegularizationContext("ELASTIC_NET", alpha=1.5)
    obj = GLMObjective(loss=port_losses.LOGISTIC_LOSS)
    assert obj.with_l2(2.0).l2_weight == 2.0
    both = obj.with_regularization(reg, 2.0)
    assert (both.l1_weight, both.l2_weight) == (0.5, 1.5)


def test_the_port_has_no_kernel_mode_knob(monkeypatch):
    # the port routes by device only: the JAX package's mode knob set to
    # "xla" leaves the port's ELL objective on its fused route
    import photon_ml_tpu_torch.kernels.dispatch as port_dispatch

    assert not hasattr(port_dispatch, "ENV_VAR")
    monkeypatch.setenv(jax_dispatch.ENV_VAR, "xla")
    idx = torch.tensor([[0, 1]], dtype=torch.int32)
    from photon_ml_tpu_torch.core.types import LabeledBatch
    from photon_ml_tpu_torch.ops.sparse import SparseFeatures

    batch = LabeledBatch.create(
        SparseFeatures(idx, torch.ones((1, 2), dtype=torch.float64), 2), [1.0],
        dtype=torch.float64,
    )
    GLMObjective(loss=port_losses.LOGISTIC_LOSS).value_grad_curvature(
        torch.zeros(2, dtype=torch.float64), batch)
    assert ("fused_vgc", 1, 2, 2, 8) in port_dispatch.kernel_costs()
    assert os.environ[jax_dispatch.ENV_VAR] == "xla"
