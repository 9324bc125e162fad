"""Cost book: hardware attribution of the port's device work (counterpart of
``photon_ml_tpu/obs/xla_cost.py``).

The JAX package asks XLA for an executable's cost analysis. The port runs
no XLA: its records come from the analytic costs the kernel wrappers
already keep (``kernels.dispatch.record_kernel_cost`` / ``kernel_costs``:
FLOPs, bytes, and the one-design-read roofline traffic of each (kernel,
shape)). :func:`pass_record` turns one objective pass over a design into
a :class:`CostRecord`:

- an ELL design: the ``fused_vgc`` record at the design's
  (n, k, d, itemsize) — 4 FLOPs per stored slot, and the ELL read once as
  the roofline traffic (the JAX package charges a sparse pass 4·n·d, the
  dense count: a known divergence);
- a dense design: 4·n·d FLOPs (two matrix-vector products) over the
  design read once.

A solve's numerator is ``solvers.common.design_passes(result)`` times that
record, over the solve's synchronized window (:func:`annotate_span`).

**Peaks.** The shares (``mfu``, ``hbm_util``) are against one NVIDIA H100
SXM5 80GB HBM3 at its 700 W power limit, from its data sheet: 3.35 TB/s
of HBM, 67 TFLOP/s in f32 and 34 TFLOP/s in f64 outside the tensor cores,
chosen by the pass's dtype. On any other device — a CPU, or a card whose
name is not an H100 — the book gives no share (None), never the H100's.
``flops``, ``achieved_tflops`` and ``bytes_per_s`` need no peak and are
always given. There is no collective parsing here: the port's collective
counts come from ``obs.collectives``.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Dict, Optional, Tuple

# symbol imports: the package rebinds its `trace` attribute to the
# context-manager function once __init__ runs
from photon_ml_tpu_torch.obs.metrics import MetricsRegistry
from photon_ml_tpu_torch.obs.metrics import registry as _registry
from photon_ml_tpu_torch.obs.trace import emit_event as _emit_event

__all__ = [
    "H100_PEAKS",
    "CostRecord",
    "CostBook",
    "annotate_span",
    "cost_book",
    "pass_record",
    "peaks_for",
    "set_cost_book",
]

# NVIDIA H100 SXM5 80GB HBM3 at its 700 W power limit (data sheet): HBM
# bytes per second, and FLOP/s outside the tensor cores per dtype. A card
# set below 700 W runs slower under load; the shares are then against
# this ceiling all the same.
H100_PEAKS = {"hbm_bps": 3.35e12, "float32": 67e12, "float64": 34e12}

_peaks_cache: Dict[int, Optional[dict]] = {}
_peaks_lock = threading.Lock()


def peaks_for(device, dtype) -> Tuple[Optional[float], Optional[float]]:
    """(peak FLOP/s for ``dtype``, peak HBM bytes/s) of ``device``: the
    H100's where ``device`` is a CUDA device whose name holds "H100", else
    (None, None)."""
    try:
        import torch

        device = torch.device(device)
        if device.type != "cuda" or not torch.cuda.is_available():
            return None, None
        index = torch.cuda.current_device() if device.index is None else device.index
        with _peaks_lock:
            if index not in _peaks_cache:
                name = torch.cuda.get_device_name(index)
                _peaks_cache[index] = H100_PEAKS if "H100" in name else None
            peaks = _peaks_cache[index]
    except Exception:  # noqa: BLE001 — attribution never fails the caller
        return None, None
    if peaks is None:
        return None, None
    return peaks.get(_dtype_name(dtype)), peaks["hbm_bps"]


def _dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


def _sig(x: float, digits: int = 4) -> float:
    """Round to significant digits (a tiny but real share must not read
    as 0)."""
    return float(f"{x:.{digits}g}")


@dataclasses.dataclass(frozen=True)
class CostRecord:
    """One unit of device work's static cost: ``flops`` and
    ``bytes_accessed`` of one execution (the analytic count), and
    ``roofline_bytes``, the least traffic (each input read once), which
    :meth:`achieved` prefers for the bandwidth share. ``source`` is
    ``"analytic"``: every record here is counted, not measured. ``dtype``
    (the port's addition) names the pass's compute dtype, which picks the
    FLOP peak."""

    name: str
    bucket: str
    flops: Optional[float] = None
    bytes_accessed: Optional[float] = None
    source: str = "analytic"
    roofline_bytes: Optional[float] = None
    dtype: Optional[str] = None

    def achieved(
        self,
        seconds: float,
        passes: float = 1.0,
        peak_flops: Optional[float] = None,
        peak_hbm_bps: Optional[float] = None,
    ) -> Dict[str, float]:
        """Attribution for ``passes`` executions over a measured
        ``seconds`` window: ``flops``, ``achieved_tflops``,
        ``bytes_per_s``, and — where a peak is given — ``mfu`` and
        ``hbm_util``."""
        out: Dict[str, float] = {}
        if seconds <= 0:
            return out
        if self.flops is not None:
            fl = self.flops * passes
            out["flops"] = fl
            out["achieved_tflops"] = _sig(fl / seconds / 1e12)
            if peak_flops:
                out["mfu"] = _sig(fl / seconds / peak_flops)
        hbm_bytes = (self.roofline_bytes if self.roofline_bytes is not None
                     else self.bytes_accessed)
        if hbm_bytes is not None:
            bps = hbm_bytes * passes / seconds
            out["bytes_per_s"] = _sig(bps)
            if peak_hbm_bps:
                out["hbm_util"] = _sig(bps / peak_hbm_bps)
        return out


class CostBook:
    """Thread-safe (name, bucket) -> :class:`CostRecord` map; one per
    process (:func:`cost_book`)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._records: Dict[Tuple[str, str], CostRecord] = {}

    def record(
        self,
        name: str,
        bucket: str = "",
        analytic_flops: Optional[float] = None,
        analytic_bytes: Optional[float] = None,
        roofline_bytes: Optional[float] = None,
        registry: Optional[MetricsRegistry] = None,
        dtype=None,
    ) -> CostRecord:
        """Store the record under ``(name, bucket)`` (a same-key record
        replaces the old one) and export it: ``kernels.cost.<key>.*``
        gauges and a ``kernels.cost_record`` instant event."""
        rec = CostRecord(name=name, bucket=str(bucket), flops=analytic_flops,
                         bytes_accessed=analytic_bytes, roofline_bytes=roofline_bytes,
                         dtype=None if dtype is None else _dtype_name(dtype))
        with self._lock:
            self._records[(name, rec.bucket)] = rec
        reg = registry if registry is not None else _registry()
        key = name + (f".{rec.bucket}" if rec.bucket else "")
        if rec.flops is not None:
            reg.set_gauge(f"kernels.cost.{key}.flops", rec.flops)
        if rec.bytes_accessed is not None:
            reg.set_gauge(f"kernels.cost.{key}.bytes_accessed", rec.bytes_accessed)
        if rec.roofline_bytes is not None:
            reg.set_gauge(f"kernels.cost.{key}.roofline_bytes", rec.roofline_bytes)
        _emit_event("kernels.cost_record", cat="kernels", executable=name, bucket=rec.bucket,
                    flops=rec.flops, bytes_accessed=rec.bytes_accessed,
                    roofline_bytes=rec.roofline_bytes, source=rec.source)
        return rec

    def lookup(self, name: str, bucket: str = "") -> Optional[CostRecord]:
        with self._lock:
            return self._records.get((name, str(bucket)))

    def names(self) -> list:
        with self._lock:
            return sorted(self._records)

    def reset(self) -> None:
        with self._lock:
            self._records.clear()

    def snapshot(self) -> dict:
        """Plain-JSON view keyed ``name[.bucket]``."""
        with self._lock:
            items = sorted(self._records.items())
        out = {}
        for (name, bucket), rec in items:
            key = name + (f".{bucket}" if bucket else "")
            out[key] = {"flops": rec.flops, "bytes_accessed": rec.bytes_accessed,
                        "source": rec.source}
            if rec.roofline_bytes is not None:
                out[key]["roofline_bytes"] = rec.roofline_bytes
        return out


_default = CostBook()


def cost_book() -> CostBook:
    """The process-global default cost book."""
    return _default


def set_cost_book(book: CostBook) -> CostBook:
    """Swap the process default (tests). Returns the previous one."""
    global _default
    prev = _default
    _default = book
    return prev


def pass_record(features, dtype) -> Optional[CostRecord]:
    """The cost record of ONE value/gradient pass over ``features`` (an ELL
    design: ``fused_vgc``'s kernel cost at its shape, recorded by the
    wrapper's first call; a dense (n, d) tensor: 4·n·d FLOPs over the
    design read once), booked under ``glm.objective_pass``. None where the
    design is of another kind or its pass recorded no cost: attribution is
    best-effort and never fails a solve."""
    try:
        import torch

        from photon_ml_tpu_torch.kernels import dispatch

        book = cost_book()
        if isinstance(features, torch.Tensor):
            if features.dim() != 2:
                return None
            n, d = features.shape
            bucket = f"{n}x{d}.{_dtype_name(dtype)}"
            rec = book.lookup("glm.objective_pass", bucket)
            if rec is not None:
                return rec
            nbytes = float(n) * float(d) * features.element_size()
            return book.record("glm.objective_pass", bucket,
                               analytic_flops=4.0 * n * d, analytic_bytes=2.0 * nbytes,
                               roofline_bytes=nbytes, dtype=dtype)
        if hasattr(features, "indices") and hasattr(features, "values"):
            n, k = features.indices.shape
            d = int(features.d)
            item = features.values.element_size()
            bucket = f"{n}x{k}x{d}.{_dtype_name(dtype)}"
            rec = book.lookup("glm.objective_pass", bucket)
            if rec is not None:
                return rec
            cost = dispatch.kernel_costs().get(("fused_vgc", n, k, d, item))
            if cost is None:
                return None
            return book.record("glm.objective_pass", bucket,
                               analytic_flops=cost["analytic_flops"],
                               analytic_bytes=cost["analytic_bytes"],
                               roofline_bytes=cost["roofline_bytes"], dtype=dtype)
    except Exception:  # noqa: BLE001
        return None
    return None


def annotate_span(sp, record: Optional[CostRecord], seconds: float, passes: float = 1.0,
                  device=None, dtype=None) -> None:
    """Attach attribution (``flops``/``achieved_tflops``/``bytes_per_s``,
    and ``mfu``/``hbm_util`` on an H100) to a live span from a record and
    a measured window of ``passes`` executions on ``device`` in ``dtype``
    (default: the record's). No-ops on a missing record, a non-positive
    window, or the disabled null span."""
    if record is None or seconds is None or seconds <= 0:
        return
    if dtype is None:
        dtype = record.dtype
    peak_flops, peak_hbm = (peaks_for(device, dtype) if device is not None
                            else (None, None))
    attrs = record.achieved(seconds, passes=passes, peak_flops=peak_flops,
                            peak_hbm_bps=peak_hbm)
    if attrs:
        sp.set(**attrs)
