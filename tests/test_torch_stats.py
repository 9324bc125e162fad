"""The port's feature summary, normalization contexts and data validators
on the CPU against the JAX package's, on the same seeded batches.

Tolerances: float64; the moments (sums over rows in another order)
within rtol 1e-12 and atol 1e-12; the extremes, counts and validation
outcomes exactly; normalization factors and shifts within 1e-12.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_ml_tpu.core.normalization import (
    NormalizationType as JNormType,
    build_normalization_context as j_build,
)
from photon_ml_tpu.core.tasks import TaskType as JTask
from photon_ml_tpu.core.types import Coefficients as JCoef
from photon_ml_tpu.core.types import LabeledBatch as JBatch
from photon_ml_tpu.core.validators import DataValidationType as JValidation
from photon_ml_tpu.core.validators import sanity_check_data as j_check
from photon_ml_tpu.ops.sparse import from_dense as j_from_dense
from photon_ml_tpu.ops.stats import summarize_features as j_summarize
from photon_ml_tpu_torch.core.normalization import (
    NormalizationType,
    build_normalization_context,
    no_normalization,
)
from photon_ml_tpu_torch.core.tasks import TaskType
from photon_ml_tpu_torch.core.types import Coefficients
from photon_ml_tpu_torch.core.validators import DataValidationType, sanity_check_data
from photon_ml_tpu_torch.interop import labeled_batch_from_numpy, sparse_from_numpy
from photon_ml_tpu_torch.kernels import dispatch
from photon_ml_tpu_torch.ops.stats import summarize_features

FIELDS = ("mean", "variance", "min", "max", "norm_l1", "norm_l2", "mean_abs",
          "num_nonzeros", "max_abs")


def _design(rng, n=90, d=25):
    x = rng.standard_normal((n, d)) * (rng.uniform(size=(n, d)) < 0.35)
    x[:, 0] = np.abs(x[:, 0]) + 0.5  # dense, all-positive column
    x[:, 1] = -np.abs(x[:, 1])  # non-positive column
    x[:, 2] = 0.0  # empty column
    x[:, d - 1] = 1.0  # intercept
    x[::7, 3] = 3.0  # duplicate-valued column
    return x


def _pair(x, mask, sparse):
    n = x.shape[0]
    y, off, w = np.zeros(n), np.zeros(n), np.ones(n)
    if sparse:
        jf = j_from_dense(x, dtype=jnp.float64)
        pf = sparse_from_numpy(np.asarray(jf.indices), np.asarray(jf.values), jf.d)
    else:
        jf, pf = jnp.asarray(x), x
    jb = JBatch(jf, jnp.asarray(y), jnp.asarray(off), jnp.asarray(w), jnp.asarray(mask))
    return jb, labeled_batch_from_numpy(pf, y, off, w, mask)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("sparse", [True, False], ids=["ell", "dense"])
def test_summary_matches_jax(rng, sparse, masked):
    x = _design(rng)
    mask = np.ones(x.shape[0])
    if masked:
        mask[-9:] = 0.0
        x[-1, 4] = np.nan  # a padding row may hold anything
        if sparse:
            x[-1, 4] = 5.0
    jb, pb = _pair(x, mask, sparse)
    before = dispatch.launch_counts()["ell_scatter_add"]
    got = summarize_features(pb)
    assert dispatch.launch_counts()["ell_scatter_add"] == before  # CPU
    ref = j_summarize(jb)
    assert float(got.count) == float(ref.count)
    for f in FIELDS:
        np.testing.assert_allclose(
            getattr(got, f).numpy(), np.asarray(getattr(ref, f)), rtol=1e-12,
            atol=1e-12, err_msg=f)


def test_sparse_summary_counts_implicit_zeros(rng):
    # column 0 stored in every row (min/max from stored values), column 1 in
    # one row (the implicit zeros enter min and max)
    x = np.zeros((4, 3))
    x[:, 0] = [1.0, 2.0, 3.0, 4.0]
    x[2, 1] = 5.0
    _, pb = _pair(x, np.ones(4), True)
    s = summarize_features(pb)
    assert s.min.tolist() == [1.0, 0.0, 0.0] and s.max.tolist() == [4.0, 5.0, 0.0]
    assert s.num_nonzeros.tolist() == [4.0, 1.0, 0.0]


@pytest.mark.parametrize("norm", ["SCALE_WITH_STANDARD_DEVIATION",
                                  "SCALE_WITH_MAX_MAGNITUDE", "STANDARDIZATION"])
@pytest.mark.parametrize("sparse", [True, False], ids=["ell", "dense"])
def test_normalization_context_matches_jax(rng, sparse, norm):
    x = _design(rng)
    jb, pb = _pair(x, np.ones(x.shape[0]), sparse)
    icpt = x.shape[1] - 1
    jn = j_build(JNormType[norm], j_summarize(jb), icpt)
    pn = build_normalization_context(NormalizationType[norm], summarize_features(pb), icpt)
    for a, b in ((jn.factors, pn.factors), (jn.shifts, pn.shifts)):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-12, atol=1e-14)
    assert float(pn.factors[icpt]) == 1.0
    # coefficient transforms, forward and back
    w = rng.standard_normal(x.shape[1])
    v = np.abs(rng.standard_normal(x.shape[1]))
    jraw = jn.transform_model_coefficients(JCoef(jnp.asarray(w), jnp.asarray(v)), icpt)
    praw = pn.transform_model_coefficients(
        Coefficients(torch.from_numpy(w), torch.from_numpy(v)), icpt)
    np.testing.assert_allclose(praw.means.numpy(), np.asarray(jraw.means), rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(praw.variances.numpy(), np.asarray(jraw.variances), rtol=1e-12)
    back = pn.inverse_transform_model_coefficients(praw, icpt)
    np.testing.assert_allclose(back.means.numpy(), w, rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(back.variances.numpy(), v, rtol=1e-10)
    np.testing.assert_allclose(
        float(pn.margin_shift(torch.from_numpy(w))),
        float(jn.margin_shift(jnp.asarray(w))), rtol=1e-12, atol=1e-14)


def test_standardization_needs_an_intercept(rng):
    x = _design(rng)
    _, pb = _pair(x, np.ones(x.shape[0]), False)
    with pytest.raises(ValueError, match="intercept"):
        build_normalization_context(NormalizationType.STANDARDIZATION,
                                    summarize_features(pb), None)
    assert no_normalization().margin_shift(torch.ones(3)).item() == 0.0


VALIDATION_CASES = {
    "clean": (lambda x, y, o, w: None, True),
    "nan_feature": (lambda x, y, o, w: x.__setitem__((3, 4), np.nan), False),
    "inf_offset": (lambda x, y, o, w: o.__setitem__(5, np.inf), False),
    "nan_weight": (lambda x, y, o, w: w.__setitem__(2, np.nan), False),
    "label_two": (lambda x, y, o, w: y.__setitem__(1, 2.0), False),
    "negative_label": (lambda x, y, o, w: y.__setitem__(1, -1.0), False),
}


@pytest.mark.parametrize("task", ["LOGISTIC_REGRESSION", "POISSON_REGRESSION",
                                  "LINEAR_REGRESSION"])
@pytest.mark.parametrize("case", sorted(VALIDATION_CASES))
@pytest.mark.parametrize("sparse", [True, False], ids=["ell", "dense"])
def test_validators_match_jax(rng, sparse, case, task):
    x = _design(rng, n=30, d=8)
    n = x.shape[0]
    y = (rng.uniform(size=n) < 0.5).astype(np.float64)
    off, w = np.zeros(n), np.ones(n)
    VALIDATION_CASES[case][0](x, y, off, w)
    if sparse:
        jf = j_from_dense(np.nan_to_num(x, nan=7.0), dtype=jnp.float64)
        vals = np.asarray(jf.values).copy()
        if case == "nan_feature":
            vals[vals == 7.0] = np.nan
        jf = type(jf)(jf.indices, jnp.asarray(vals), jf.d)
        pf = sparse_from_numpy(np.asarray(jf.indices), vals, jf.d)
    else:
        jf, pf = jnp.asarray(x), x
    mask = np.ones(n)
    jb = JBatch(jf, jnp.asarray(y), jnp.asarray(off), jnp.asarray(w), jnp.asarray(mask))
    pb = labeled_batch_from_numpy(pf, y, off, w, mask)

    def outcome(fn, *args):
        try:
            return fn(*args)
        except ValueError as e:
            return str(e)

    ref = outcome(j_check, jb, JTask[task], JValidation.VALIDATE_FULL)
    got = outcome(sanity_check_data, pb, TaskType[task], DataValidationType.VALIDATE_FULL)
    assert got == ref
    assert sanity_check_data(pb, TaskType[task], DataValidationType.VALIDATE_DISABLED) == {}


def test_sample_validation_is_seeded_and_ignores_padding_rows(rng):
    x = _design(rng, n=40, d=6)
    n = x.shape[0]
    y = np.zeros(n)
    y[0] = 5.0  # a bad label on a padding row
    mask = np.ones(n)
    mask[0] = 0.0
    pb = labeled_batch_from_numpy(x, y, np.zeros(n), np.ones(n), mask)
    counts = sanity_check_data(pb, TaskType.LOGISTIC_REGRESSION,
                               DataValidationType.VALIDATE_SAMPLE, sample_fraction=1.0, seed=3)
    assert counts and all(v == 0 for v in counts.values())
