"""Device memory watermarks (counterpart of ``hbm_watermark`` in
``photon_ml_tpu/obs/device.py``), rebuilt on the CUDA caching allocator's
counters: ``torch.cuda.memory_allocated`` for the bytes in use and
``torch.cuda.max_memory_allocated`` for the peak, the peak reset at the
phase's start (``torch.cuda.reset_peak_memory_stats``) so that it is the
phase's own. The gauge and event names are the JAX package's
(``hbm.<label>.peak_bytes``, ``hbm.<label>.delta_bytes``,
``hbm.watermark``). Off CUDA nothing is read and nothing is recorded. The
JAX package's sampler thread and per-device counter tracks are not ported.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Optional

from photon_ml_tpu_torch.obs.metrics import registry as _registry
from photon_ml_tpu_torch.obs.trace import emit_event as _emit_event

__all__ = ["HbmWatermark", "hbm_watermark", "read_memory_stats"]


def read_memory_stats(device=None) -> Optional[Dict[str, int]]:
    """``{"bytes_in_use", "peak_bytes_in_use"}`` of a CUDA device (default:
    the current one), or None off CUDA or without a card."""
    try:
        import torch

        if device is None:
            if not torch.cuda.is_available():
                return None
            device = torch.device("cuda", torch.cuda.current_device())
        device = torch.device(device)
        if device.type != "cuda":
            return None
        return {
            "bytes_in_use": int(torch.cuda.memory_allocated(device)),
            "peak_bytes_in_use": int(torch.cuda.max_memory_allocated(device)),
        }
    except Exception:  # noqa: BLE001 — telemetry never fails the caller
        return None


class HbmWatermark:
    """Result object of :func:`hbm_watermark`. ``supported`` is False off
    CUDA; every byte field is then None."""

    __slots__ = (
        "label", "supported", "before_bytes", "after_bytes",
        "peak_bytes", "delta_bytes",
    )

    def __init__(self, label: str):
        self.label = label
        self.supported = False
        self.before_bytes: Optional[int] = None
        self.after_bytes: Optional[int] = None
        self.peak_bytes: Optional[int] = None
        self.delta_bytes: Optional[int] = None


@contextlib.contextmanager
def hbm_watermark(label: str, registry=None, device=None):
    """Bracket a phase with device-memory readings on ``device`` (default:
    the current CUDA device).

    Yields an :class:`HbmWatermark`; on exit (CUDA only) fills
    ``before/after/peak/delta`` bytes, sets ``hbm.<label>.peak_bytes`` /
    ``hbm.<label>.delta_bytes`` gauges, and emits an ``hbm.watermark``
    instant event. The peak is the allocator's high-water mark within the
    phase: the counter is reset when the phase starts."""
    wm = HbmWatermark(label)
    before = read_memory_stats(device)
    if before is not None:
        import torch

        torch.cuda.reset_peak_memory_stats(device)
    try:
        yield wm
    finally:
        if before is not None:
            after = read_memory_stats(device)
            if after is not None:
                wm.supported = True
                wm.before_bytes = before["bytes_in_use"]
                wm.after_bytes = after["bytes_in_use"]
                wm.peak_bytes = after["peak_bytes_in_use"]
                wm.delta_bytes = wm.after_bytes - wm.before_bytes
                reg = registry if registry is not None else _registry()
                reg.set_gauge(f"hbm.{label}.peak_bytes", wm.peak_bytes)
                reg.set_gauge(f"hbm.{label}.delta_bytes", wm.delta_bytes)
                _emit_event(
                    "hbm.watermark",
                    cat="hbm",
                    label=label,
                    before_bytes=wm.before_bytes,
                    after_bytes=wm.after_bytes,
                    peak_bytes=wm.peak_bytes,
                    delta_bytes=wm.delta_bytes,
                )
