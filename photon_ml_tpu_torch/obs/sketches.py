"""Streaming data sketches: small, mergeable, O(1)-update summaries (a copy of
``photon_ml_tpu/obs/sketches.py``).

The obs stack measures *how* the system runs (spans, cost book, SLOs);
nothing records *what the data looked like* — which is the signal the
ROADMAP-4 retrain loop needs to notice that serving traffic has walked
away from the training distribution. These sketches are the primitive:

- :class:`MomentSketch` — weighted Welford mean/variance plus min/max,
  combined across chunks with Chan's parallel update.
- :class:`HistogramSketch` — FIXED-bin quantile histograms; bin edges
  are a function of the configuration alone (never the data), so two
  sketches built over different chunkings of the same rows hold
  *identical* counts. ``linear`` scale for bounded values (scores,
  probabilities); ``symlog`` (signed log-modulus) for features of
  unknown magnitude — ±1e6 at default config, ~12% relative resolution.
- :class:`TopKSketch` — weighted counters for categorical keys with a
  bounded heavy-hitters readout.

The contract every consumer (baseline fingerprints, the serving
DriftMonitor, ``photon-obs merge``) relies on: **merge() is exact** —
folding per-chunk / per-host sketches in any grouping or order yields
bit-identical state to one single-pass sketch over the concatenated
rows (floating-point summation order aside, drilled to 1e-12 in
tests/test_quality.py). TopK exactness holds while distinct-key
cardinality stays within ``max_keys`` (feature vocabularies and entity
types are bounded, so in practice always); past it the readout truncates
deterministically and the spilled mass stays accounted in ``other``.

Distribution distances (:func:`psi`, :func:`js_divergence`) operate on
two same-config histogram sketches — the drift math of
:mod:`photon_ml_tpu_torch.obs.quality`.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "MomentSketch",
    "HistogramSketch",
    "TopKSketch",
    "coarsen_counts",
    "histogram_add_matrix",
    "moments_add_matrix",
    "psi",
    "js_divergence",
    "psi_and_js",
]


class MomentSketch:
    """Weighted running mean/variance/min/max (Welford, mergeable).

    ``add`` consumes a vector of values (+ optional weights) in one
    numpy pass; ``merge`` combines two sketches exactly (Chan's
    parallel variance update), so per-chunk accumulation commutes with
    single-pass accumulation.
    """

    __slots__ = ("count", "weight", "mean", "m2", "min", "max")

    def __init__(self):
        self.count = 0  # rows observed (unweighted)
        self.weight = 0.0  # total weight
        self.mean = 0.0  # weighted mean
        self.m2 = 0.0  # weighted sum of squared deviations
        self.min = math.inf
        self.max = -math.inf

    def add(self, values, weights=None) -> "MomentSketch":
        v = np.asarray(values, np.float64).ravel()
        if v.size == 0:
            return self
        if weights is None:
            w_sum = float(v.size)
            mean_b = float(v.mean())
            m2_b = float(((v - mean_b) ** 2).sum())
            vmin, vmax = float(v.min()), float(v.max())
            count_b = int(v.size)
        else:
            w = np.asarray(weights, np.float64).ravel()
            live = w > 0.0
            if not live.all():
                # zero-weight rows are padding: invisible to every
                # statistic, min/max included
                v = v[live]
                w = w[live]
            if v.size == 0:
                return self
            w_sum = float(w.sum())
            mean_b = float((v * w).sum() / w_sum)
            m2_b = float((w * (v - mean_b) ** 2).sum())
            vmin, vmax = float(v.min()), float(v.max())
            count_b = int(v.size)
        delta = mean_b - self.mean
        total = self.weight + w_sum
        self.m2 += m2_b + delta * delta * self.weight * w_sum / total
        self.mean += delta * w_sum / total
        self.weight = total
        self.count += count_b
        self.min = min(self.min, vmin)
        self.max = max(self.max, vmax)
        return self

    def merge(self, other: "MomentSketch") -> "MomentSketch":
        if other.weight == 0.0:
            self.count += other.count
            return self
        if self.weight == 0.0:
            self.count += other.count
            self.weight = other.weight
            self.mean = other.mean
            self.m2 = other.m2
            self.min = min(self.min, other.min)
            self.max = max(self.max, other.max)
            return self
        delta = other.mean - self.mean
        total = self.weight + other.weight
        self.m2 += other.m2 + delta * delta * self.weight * other.weight / total
        self.mean += delta * other.weight / total
        self.weight = total
        self.count += other.count
        self.min = min(self.min, other.min)
        self.max = max(self.max, other.max)
        return self

    @property
    def variance(self) -> float:
        return self.m2 / self.weight if self.weight > 0 else 0.0

    @property
    def std(self) -> float:
        return math.sqrt(max(self.variance, 0.0))

    def to_dict(self) -> dict:
        return {
            "count": self.count,
            "weight": self.weight,
            "mean": self.mean,
            "m2": self.m2,
            "min": self.min if self.count else None,
            "max": self.max if self.count else None,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "MomentSketch":
        out = cls()
        out.count = int(d["count"])
        out.weight = float(d["weight"])
        out.mean = float(d["mean"])
        out.m2 = float(d["m2"])
        out.min = math.inf if d.get("min") is None else float(d["min"])
        out.max = -math.inf if d.get("max") is None else float(d["max"])
        return out


# histogram scale configurations; edges depend ONLY on these constants,
# which is what makes per-chunk sketches exactly mergeable
SCALES = ("linear", "symlog")

# symlog default: sign(v) * log10(1 + |v|/x0) covers |v| in
# [0, ~x0*10^span] — x0=1e-3 and span=9 reach ±1e6 with sub-decade bins
DEFAULT_SYMLOG_X0 = 1e-3
DEFAULT_SYMLOG_SPAN = 9.0
DEFAULT_BINS = 64


class HistogramSketch:
    """Fixed-bin weighted histogram with quantile readout.

    ``scale="linear"`` bins ``[lo, hi]`` uniformly; ``scale="symlog"``
    bins the signed log-modulus transform ``sign(v)*log10(1+|v|/x0)``
    over ``[-span, span]`` — symmetric about zero, near-linear below
    ``x0``, logarithmic above, so one configuration covers raw features
    of any sign and magnitude. Two extra bins catch under/overflow.
    Configurations must match to merge (checked).
    """

    __slots__ = ("scale", "lo", "hi", "bins", "x0", "counts", "weight")

    def __init__(
        self,
        scale: str = "symlog",
        lo: float = -DEFAULT_SYMLOG_SPAN,
        hi: float = DEFAULT_SYMLOG_SPAN,
        bins: int = DEFAULT_BINS,
        x0: float = DEFAULT_SYMLOG_X0,
    ):
        if scale not in SCALES:
            raise ValueError(f"scale must be one of {SCALES}: {scale!r}")
        if not (hi > lo) or bins < 1:
            raise ValueError(
                f"need hi > lo and bins >= 1 (got lo={lo}, hi={hi}, "
                f"bins={bins})"
            )
        self.scale = scale
        self.lo = float(lo)
        self.hi = float(hi)
        self.bins = int(bins)
        self.x0 = float(x0)
        self.counts = np.zeros(self.bins + 2, np.float64)
        self.weight = 0.0

    def config(self) -> Tuple:
        return (self.scale, self.lo, self.hi, self.bins, self.x0)

    def _transform(self, v: np.ndarray) -> np.ndarray:
        if self.scale == "linear":
            return v
        return np.sign(v) * np.log10(1.0 + np.abs(v) / self.x0)

    def add(self, values, weights=None) -> "HistogramSketch":
        v = np.asarray(values).ravel()
        if v.dtype.kind != "f":
            v = v.astype(np.float64)
        if v.size == 0:
            return self
        w = (
            np.ones_like(v)
            if weights is None
            else np.asarray(weights, np.float64).ravel()
        )
        t = self._transform(v)
        # bin 0 = underflow, 1..bins = body, bins+1 = overflow; NaN
        # lands in overflow (it is "not where the baseline was") —
        # substituted BEFORE the int cast (NaN->int is undefined)
        t = np.where(np.isnan(t), np.inf, t)
        frac = (t - self.lo) / (self.hi - self.lo)
        idx = np.clip(frac * self.bins, -1.0, float(self.bins))
        idx = np.floor(idx).astype(np.int64) + 1
        np.add.at(self.counts, idx, w)
        self.weight += float(w.sum())
        return self

    def merge(self, other: "HistogramSketch") -> "HistogramSketch":
        if self.config() != other.config():
            raise ValueError(
                f"histogram configs differ: {self.config()} vs "
                f"{other.config()}"
            )
        self.counts += other.counts
        self.weight += other.weight
        return self

    def _edge(self, i: int) -> float:
        """Left edge of body bin ``i`` (0-based) in VALUE space."""
        t = self.lo + (self.hi - self.lo) * i / self.bins
        if self.scale == "linear":
            return t
        return math.copysign(self.x0 * (10.0 ** abs(t) - 1.0), t)

    def quantile(self, q: float) -> float:
        """Weighted quantile by linear interpolation within the winning
        bin (0.0 when empty; under/overflow clamp to the body edges)."""
        if self.weight <= 0.0:
            return 0.0
        target = q * self.weight
        seen = 0.0
        for b, c in enumerate(self.counts):
            if c <= 0.0:
                continue
            if seen + c >= target:
                if b == 0:
                    return self._edge(0)
                if b == self.bins + 1:
                    return self._edge(self.bins)
                f = (target - seen) / c
                left, right = self._edge(b - 1), self._edge(b)
                return left + f * (right - left)
            seen += c
        return self._edge(self.bins)

    def pdf(self) -> np.ndarray:
        """Normalized bin probabilities (uniform when empty — a distance
        against an empty sketch should read as 'no evidence', not inf)."""
        if self.weight <= 0.0:
            return np.full(self.counts.size, 1.0 / self.counts.size)
        return self.counts / self.weight

    def summary(self) -> dict:
        """Compact JSON-safe readout (the serving snapshot shape)."""
        return {
            "count": round(self.weight, 6),
            "p01": round(self.quantile(0.01), 6),
            "p50": round(self.quantile(0.50), 6),
            "p99": round(self.quantile(0.99), 6),
        }

    def to_dict(self) -> dict:
        return {
            "scale": self.scale,
            "lo": self.lo,
            "hi": self.hi,
            "bins": self.bins,
            "x0": self.x0,
            "weight": self.weight,
            "counts": [round(c, 9) for c in self.counts.tolist()],
        }

    @classmethod
    def from_dict(cls, d: dict) -> "HistogramSketch":
        out = cls(
            scale=d["scale"],
            lo=d["lo"],
            hi=d["hi"],
            bins=d["bins"],
            x0=d.get("x0", DEFAULT_SYMLOG_X0),
        )
        counts = np.asarray(d["counts"], np.float64)
        if counts.size != out.counts.size:
            raise ValueError(
                f"histogram counts length {counts.size} != "
                f"{out.counts.size} for bins={out.bins}"
            )
        out.counts = counts
        out.weight = float(d["weight"])
        return out

    # convenience constructors — the two configurations the quality
    # layer standardizes on, so baselines and live sketches always match
    @classmethod
    def for_features(cls) -> "HistogramSketch":
        return cls(scale="symlog")

    @classmethod
    def for_scores(cls) -> "HistogramSketch":
        """Margins/scores live in logit space: linear bins over ±20
        (sigmoid saturates well inside)."""
        return cls(scale="linear", lo=-20.0, hi=20.0)


class TopKSketch:
    """Weighted counters over categorical keys with a bounded readout.

    Counts are exact while distinct-key cardinality stays within
    ``max_keys`` (merges included). Past the cap, the LIGHTEST keys
    spill into an aggregate ``other`` mass deterministically (smallest
    weight first, ties by key), so the readout stays bounded and total
    mass stays conserved.
    """

    __slots__ = ("max_keys", "counts", "other", "weight")

    def __init__(self, max_keys: int = 512):
        if max_keys < 1:
            raise ValueError(f"max_keys must be >= 1, got {max_keys}")
        self.max_keys = int(max_keys)
        self.counts: Dict[str, float] = {}
        self.other = 0.0
        self.weight = 0.0

    def add(self, key, weight: float = 1.0) -> "TopKSketch":
        k = str(key)
        self.counts[k] = self.counts.get(k, 0.0) + float(weight)
        self.weight += float(weight)
        if len(self.counts) > 2 * self.max_keys:
            self._compact()
        return self

    def add_many(self, keys: Sequence, weights=None) -> "TopKSketch":
        if weights is None:
            for k in keys:
                self.add(k)
        else:
            for k, w in zip(keys, weights):
                self.add(k, w)
        return self

    def _compact(self) -> None:
        if len(self.counts) <= self.max_keys:
            return
        ranked = sorted(self.counts.items(), key=lambda kv: (-kv[1], kv[0]))
        for k, w in ranked[self.max_keys :]:
            self.other += w
            del self.counts[k]

    def merge(self, other: "TopKSketch") -> "TopKSketch":
        for k, w in other.counts.items():
            self.counts[k] = self.counts.get(k, 0.0) + w
        self.other += other.other
        self.weight += other.weight
        if len(self.counts) > 2 * self.max_keys:
            self._compact()
        return self

    def top(self, k: int = 10) -> List[Tuple[str, float]]:
        return sorted(
            self.counts.items(), key=lambda kv: (-kv[1], kv[0])
        )[:k]

    def to_dict(self) -> dict:
        self._compact()
        return {
            "max_keys": self.max_keys,
            "weight": self.weight,
            "other": self.other,
            "counts": {
                k: v
                for k, v in sorted(
                    self.counts.items(), key=lambda kv: (-kv[1], kv[0])
                )
            },
        }

    @classmethod
    def from_dict(cls, d: dict) -> "TopKSketch":
        out = cls(max_keys=int(d.get("max_keys", 512)))
        out.counts = {str(k): float(v) for k, v in d["counts"].items()}
        out.other = float(d.get("other", 0.0))
        out.weight = float(d["weight"])
        return out


# ---------------------------------------------------------------------------
# distribution distances over same-config histogram sketches
# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# vectorized whole-matrix accumulation (the ingest/serving hot path)
# ---------------------------------------------------------------------------


def histogram_add_matrix(
    hists: Sequence[HistogramSketch],
    matrix,
    weights=None,
    check_configs: bool = True,
) -> None:
    """Fold column ``j`` of a dense (n, d) matrix into ``hists[j]`` —
    ONE transform + ONE bincount for the whole matrix instead of d
    per-column passes (~d× cheaper; the fingerprint/drift hot path).
    Every sketch must share one configuration (checked); the resulting
    counts are bit-identical to d independent :meth:`HistogramSketch.
    add` calls (same floats summed by the same np machinery)."""
    m = np.asarray(matrix)
    if m.dtype.kind != "f":
        m = m.astype(np.float64)
    if m.ndim != 2 or m.shape[0] == 0 or not hists:
        return
    n, d = m.shape
    if d != len(hists):
        raise ValueError(f"{len(hists)} sketches for {d} columns")
    h0 = hists[0]
    if check_configs:
        # callers owning all the sketches (the DriftMonitor's window,
        # built from one config) skip this per-call tuple churn
        cfg = h0.config()
        for h in hists[1:]:
            if h.config() != cfg:
                raise ValueError(
                    f"histogram configs differ: {cfg} vs {h.config()}"
                )
    # transform in the input precision: bin RESOLUTION is ~12% — float32
    # bin assignment is identical except for values within float eps of
    # an edge, and the transform over a large matrix is the hot path
    t = h0._transform(m)
    t = np.where(np.isnan(t), np.inf, t)
    frac = (t - h0.lo) / (h0.hi - h0.lo)
    idx = np.clip(frac * h0.bins, -1.0, float(h0.bins))
    idx = np.floor(idx).astype(np.int64) + 1
    nb = h0.bins + 2
    flat = (idx + np.arange(d, dtype=np.int64)[None, :] * nb).ravel()
    if weights is None:
        counts = np.bincount(flat, minlength=d * nb).astype(np.float64)
        w_sum = float(n)
    else:
        w = np.asarray(weights, np.float64).ravel()
        counts = np.bincount(
            flat, weights=np.repeat(w, d), minlength=d * nb
        )
        w_sum = float(w.sum())
    per_col = counts.reshape(d, nb)
    for j, h in enumerate(hists):
        h.counts += per_col[j]
        h.weight += w_sum


def moments_add_matrix(
    moms: Sequence[MomentSketch], matrix, weights=None
) -> None:
    """Fold column ``j`` of a dense (n, d) matrix into ``moms[j]`` with
    axis-0 vectorized statistics plus a scalar Welford merge per column
    — same math as per-column :meth:`MomentSketch.add`."""
    m = np.asarray(matrix, np.float64)
    if m.ndim != 2 or m.shape[0] == 0 or not moms:
        return
    n, d = m.shape
    if d != len(moms):
        raise ValueError(f"{len(moms)} sketches for {d} columns")
    if weights is None:
        w_sum = float(n)
        means = m.mean(axis=0)
        m2s = ((m - means) ** 2).sum(axis=0)
        mins = m.min(axis=0)
        maxs = m.max(axis=0)
        count = n
    else:
        w = np.asarray(weights, np.float64).ravel()
        live = w > 0.0
        if not live.all():
            m = m[live]
            w = w[live]
        if m.shape[0] == 0:
            return
        w_sum = float(w.sum())
        means = (m * w[:, None]).sum(axis=0) / w_sum
        m2s = (w[:, None] * (m - means) ** 2).sum(axis=0)
        mins = m.min(axis=0)
        maxs = m.max(axis=0)
        count = m.shape[0]
    for j, mo in enumerate(moms):
        mean_b = float(means[j])
        m2_b = float(m2s[j])
        delta = mean_b - mo.mean
        total = mo.weight + w_sum
        mo.m2 += m2_b + delta * delta * mo.weight * w_sum / total
        mo.mean += delta * w_sum / total
        mo.weight = total
        mo.count += count
        mo.min = min(mo.min, float(mins[j]))
        mo.max = max(mo.max, float(maxs[j]))


# PSI/JS computed on the sketches' full bin resolution are dominated by
# sampling noise for small comparison windows (E[PSI] ≈ bins/N between
# two samples of the SAME distribution), so distances coarsen to this
# many body bins by default — the conventional 10–20-bin PSI regime,
# while the stored sketches keep full resolution for quantiles.
DEFAULT_DISTANCE_BINS = 16


def coarsen_counts(h: HistogramSketch, bins: int) -> np.ndarray:
    """The sketch's counts folded to ``bins`` body bins (+ the two
    under/overflow bins) by summing adjacent fine bins. ``bins`` must
    divide the sketch's body resolution — exact, no interpolation."""
    if bins >= h.bins:
        return h.counts
    if h.bins % bins:
        raise ValueError(
            f"cannot coarsen {h.bins} body bins to {bins} (must divide)"
        )
    factor = h.bins // bins
    body = h.counts[1:-1].reshape(bins, factor).sum(axis=1)
    return np.concatenate([h.counts[:1], body, h.counts[-1:]])


def _smoothed_pdfs(
    p: HistogramSketch,
    q: HistogramSketch,
    eps: float,
    bins: Optional[int],
) -> Tuple[np.ndarray, np.ndarray]:
    if p.config() != q.config():
        raise ValueError(
            f"histogram configs differ: {p.config()} vs {q.config()}"
        )
    bins = bins if bins is not None else DEFAULT_DISTANCE_BINS
    ca = coarsen_counts(p, bins)
    cb = coarsen_counts(q, bins)
    a = ca / p.weight if p.weight > 0 else np.full(ca.size, 1.0 / ca.size)
    b = cb / q.weight if q.weight > 0 else np.full(cb.size, 1.0 / cb.size)
    a = np.maximum(a, eps)
    b = np.maximum(b, eps)
    return a / a.sum(), b / b.sum()


def psi(
    p: HistogramSketch,
    q: HistogramSketch,
    eps: float = 1e-4,
    bins: Optional[int] = None,
) -> float:
    """Population stability index Σ (pᵢ−qᵢ)·ln(pᵢ/qᵢ) over ε-clamped,
    coarsened bins (an empty bin on one side must not read as infinite
    drift; fine-bin PSI on a small window is pure sampling noise).
    Conventional reading: <0.1 stable, 0.1–0.25 moderate shift, >0.25
    action-worthy — the default alarm threshold of the DriftMonitor."""
    a, b = _smoothed_pdfs(p, q, eps, bins)
    return float(np.sum((a - b) * np.log(a / b)))


def js_divergence(
    p: HistogramSketch,
    q: HistogramSketch,
    eps: float = 1e-4,
    bins: Optional[int] = None,
) -> float:
    """Jensen–Shannon divergence (base-2; bounded [0, 1]) — the
    symmetric, bounded companion to PSI for dashboards."""
    a, b = _smoothed_pdfs(p, q, eps, bins)
    m = 0.5 * (a + b)
    kl_am = float(np.sum(a * np.log2(a / m)))
    kl_bm = float(np.sum(b * np.log2(b / m)))
    return 0.5 * (kl_am + kl_bm)


def psi_and_js(
    p: HistogramSketch,
    q: HistogramSketch,
    eps: float = 1e-4,
    bins: Optional[int] = None,
) -> Tuple[float, float]:
    """(PSI, JS) in one pass over shared smoothed pdfs — the drift
    check computes both per feature, and the coarsen/normalize work is
    the expensive half."""
    a, b = _smoothed_pdfs(p, q, eps, bins)
    ratio = a / b
    psi_v = float(np.sum((a - b) * np.log(ratio)))
    m = 0.5 * (a + b)
    js_v = 0.5 * (
        float(np.sum(a * np.log2(a / m)))
        + float(np.sum(b * np.log2(b / m)))
    )
    return psi_v, js_v
