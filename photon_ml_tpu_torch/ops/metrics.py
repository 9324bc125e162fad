"""Evaluation metrics on tensors (counterpart of
``photon_ml_tpu/ops/metrics.py``; the reference's
``Evaluation.scala:30-140`` and the exact weighted AUC of
``AreaUnderROCCurveLocalEvaluator.scala``).

Everything is weighted and mask-aware (weight 0 = padding), O(n log n) in
the sort, on whatever device the inputs live. Sorts are stable, as
``jnp.argsort`` is, so ties break the same way as in the JAX package. The
running sums of the curves are a fixed tree of adds on every device
(:func:`fixed_order_cumsum`), so a metric has the same bits from run to
run.
"""

from __future__ import annotations

import torch

from photon_ml_tpu_torch.ops.losses import softplus


def fixed_order_cumsum(x: torch.Tensor) -> torch.Tensor:
    """``torch.cumsum(x, 0)`` of a 1-D ``x`` as a doubling scan: step s
    adds to every entry the one s places before it, for s = 1, 2, 4, ...
    Each entry is the same tree of elementwise adds on every device and in
    every run, whatever order a library scan would combine its blocks in
    (log2 n passes over the vector, all on its device)."""
    out = x.clone()
    step = 1
    while step < out.shape[0]:
        out[step:] = out[step:] + out[:-step]
        step *= 2
    return out


def _weighted(values, weights):
    w = torch.sum(weights)
    return torch.sum(values * weights) / torch.clamp(w, min=1e-30)


# -- regression metrics (``Evaluation.scala:75-96``) ------------------------


def mean_squared_error(labels, predictions, weights):
    return _weighted((predictions - labels) ** 2, weights)


def root_mean_squared_error(labels, predictions, weights):
    return torch.sqrt(mean_squared_error(labels, predictions, weights))


def mean_absolute_error(labels, predictions, weights):
    return _weighted(torch.abs(predictions - labels), weights)


# -- total-loss evaluators (GAME ``evaluation/{Logistic,Squared}LossEvaluator``)


def total_logistic_loss(labels, margins, weights):
    s = 2.0 * labels - 1.0
    return torch.sum(weights * softplus(-s * margins))


def total_squared_loss(labels, margins, weights):
    return torch.sum(weights * 0.5 * (margins - labels) ** 2)


def total_poisson_loss(labels, margins, weights):
    return torch.sum(weights * (torch.exp(margins) - labels * margins))


# -- binary classification --------------------------------------------------


def area_under_roc_curve(labels, scores, weights):
    """Exact weighted, tie-aware AUROC: P(score+ > score-) + 0.5
    P(score+ = score-), pair-weighted
    (``AreaUnderROCCurveLocalEvaluator.scala:33-85``). 0.5 when either
    class is empty."""
    order = torch.argsort(scores, stable=True)
    s = scores[order]
    y = labels[order]
    w = weights[order]
    zero = torch.zeros_like(w)
    pos_w = torch.where(y > 0.5, w, zero)
    neg_w = torch.where(y > 0.5, zero, w)
    cum_neg = fixed_order_cumsum(neg_w)
    total_neg = cum_neg[-1]
    total_pos = torch.sum(pos_w)

    # for each row: negative weight at strictly smaller scores, and at ties
    left = torch.searchsorted(s, s, side="left")
    right = torch.searchsorted(s, s, side="right")
    cum0 = torch.cat([cum_neg.new_zeros(1), cum_neg])
    neg_below = cum0[left]
    neg_equal = cum0[right] - neg_below

    pairs = torch.sum(pos_w * (neg_below + 0.5 * neg_equal))
    denom = total_pos * total_neg
    return torch.where(
        denom > 0.0,
        pairs / torch.clamp(denom, min=1e-30),
        torch.full_like(denom, 0.5),
    )


def _pr_curve(labels, scores, weights):
    """Sorted-descending cumulative TP/FP weights + tie-group boundary mask."""
    order = torch.argsort(-scores, stable=True)
    s = scores[order]
    y = labels[order]
    w = weights[order]
    zero = torch.zeros_like(w)
    tp = fixed_order_cumsum(torch.where(y > 0.5, w, zero))
    fp = fixed_order_cumsum(torch.where(y > 0.5, zero, w))
    # a row is an operating point iff it is the last of its tie group
    is_boundary = torch.cat(
        [s[1:] != s[:-1], torch.ones(1, dtype=torch.bool, device=s.device)]
    )
    return tp, fp, is_boundary


def _prev_boundary(values, boundary):
    """For each boundary row, the value at the previous boundary (0 before
    the first). Non-boundary rows return garbage (masked by the caller)."""
    idx = torch.arange(values.shape[0], device=values.device)
    bidx = torch.where(boundary, idx, torch.full_like(idx, -1))
    prev_idx = torch.cummax(bidx, 0).values  # inclusive
    prev_before = torch.cat([prev_idx.new_full((1,), -1), prev_idx[:-1]])
    safe = torch.clamp(prev_before, min=0)
    return torch.where(prev_before >= 0, values[safe], torch.zeros_like(values))


def average_precision(labels, scores, weights):
    """AUPR by step interpolation (sklearn's average_precision convention;
    the JAX package's documented divergence from Spark's trapezoids)."""
    tp, fp, boundary = _pr_curve(labels, scores, weights)
    total_pos = tp[-1]
    precision = tp / torch.clamp(tp + fp, min=1e-30)
    recall = tp / torch.clamp(total_pos, min=1e-30)
    d_recall = torch.where(
        boundary,
        recall - _prev_boundary(recall, boundary),
        torch.zeros_like(recall),
    )
    return torch.sum(d_recall * precision)


def peak_f1(labels, scores, weights):
    """max_t F1(t) over all thresholds (``Evaluation.scala`` F-measure)."""
    tp, fp, boundary = _pr_curve(labels, scores, weights)
    total_pos = tp[-1]
    precision = tp / torch.clamp(tp + fp, min=1e-30)
    recall = tp / torch.clamp(total_pos, min=1e-30)
    f1 = 2.0 * precision * recall / torch.clamp(precision + recall, min=1e-30)
    return torch.max(torch.where(boundary, f1, torch.zeros_like(f1)))


# -- information criteria (``Evaluation.scala:98-140``) ---------------------


def akaike_information_criterion(total_loss_value, num_effective_params, n=None):
    """AICc = 2k + 2 * negative-log-likelihood, plus 2k(k+1)/(n-k-1) when
    n is given and n > k + 1 (``Evaluation.scala:103-105``)."""
    k = num_effective_params
    base = 2.0 * k + 2.0 * total_loss_value
    if n is None or n <= k + 1:
        return base
    return base + 2.0 * k * (k + 1) / (n - k - 1.0)


def per_datum_log_likelihood(task, labels, margins, weights):
    """(n,) weighted per-example log-likelihood (the negative pointwise
    loss)."""
    from photon_ml_tpu_torch.ops.losses import loss_for_task

    return -weights * loss_for_task(task).value(margins, labels)


# reference metric names (``Evaluation.scala:30-48``)
ROOT_MEAN_SQUARED_ERROR = "ROOT_MEAN_SQUARED_ERROR"
MEAN_SQUARED_ERROR = "MEAN_SQUARED_ERROR"
MEAN_ABSOLUTE_ERROR = "MEAN_ABSOLUTE_ERROR"
AREA_UNDER_RECEIVER_OPERATOR_CHARACTERISTICS = (
    "AREA_UNDER_RECEIVER_OPERATOR_CHARACTERISTICS"
)
AREA_UNDER_PRECISION_RECALL = "AREA_UNDER_PRECISION_RECALL"
PEAK_F1_SCORE = "PEAK_F1_SCORE"
DATA_LOG_LIKELIHOOD = "DATA_LOG_LIKELIHOOD"
AKAIKE_INFORMATION_CRITERION = "AKAIKE_INFORMATION_CRITERION"


def evaluate(task, labels, margins, weights, num_effective_params=None):
    """Named-metric map for one model on one dataset
    (``Evaluation.scala:50-140``). Inputs are raw margins (w.x + offset);
    the mean link is applied here. Returns {metric name: float}."""
    from photon_ml_tpu_torch.ops.losses import loss_for_task

    loss = loss_for_task(task)
    means = loss.mean(margins)
    out = {}
    if task.is_classifier:
        out[AREA_UNDER_RECEIVER_OPERATOR_CHARACTERISTICS] = float(
            area_under_roc_curve(labels, margins, weights)
        )
        out[AREA_UNDER_PRECISION_RECALL] = float(
            average_precision(labels, margins, weights)
        )
        out[PEAK_F1_SCORE] = float(peak_f1(labels, margins, weights))
    else:
        out[ROOT_MEAN_SQUARED_ERROR] = float(
            root_mean_squared_error(labels, means, weights)
        )
        out[MEAN_SQUARED_ERROR] = float(mean_squared_error(labels, means, weights))
        out[MEAN_ABSOLUTE_ERROR] = float(
            mean_absolute_error(labels, means, weights)
        )
    # DATA_LOG_LIKELIHOOD is the UNWEIGHTED per-datum mean over rows with
    # weight > 0 (``Evaluation.scala:91-105``); AIC is AICc over mean * n
    present = weights > 0
    n = float(torch.sum(present))
    unweighted_ll = per_datum_log_likelihood(
        task, labels, margins, present.to(margins.dtype)
    )
    mean_ll = float(torch.sum(unweighted_ll)) / n if n else 0.0
    out[DATA_LOG_LIKELIHOOD] = mean_ll
    if num_effective_params is not None:
        out[AKAIKE_INFORMATION_CRITERION] = float(
            akaike_information_criterion(-mean_ll * n, num_effective_params, n=n)
        )
    return out
