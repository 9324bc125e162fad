"""Live device-memory telemetry on the CUDA caching allocator (counterpart
of ``photon_ml_tpu/obs/device.py``), read from
``torch.cuda.memory_stats(device)``: ``allocated_bytes.all.current`` as the
bytes in use, ``allocated_bytes.all.peak`` as the peak and
``reserved_bytes.all.current`` as the bytes the allocator holds.

- :func:`sample_hbm` — one sample per device: ``hbm.d<i>.*`` registry
  gauges plus a Chrome counter-track event on the active tracer.
- :class:`HbmSampler` — a background thread sampling one device on an
  interval for the life of an ``obs.observe`` envelope. The device is
  passed to every read: a new thread's current CUDA device is device 0,
  not the run's.
- :func:`hbm_watermark` — brackets a phase: the peak is reset at the
  phase's start (``torch.cuda.reset_peak_memory_stats``) so that it is the
  phase's own.

The gauge and event names are the JAX package's (``hbm.d<i>.*``,
``hbm.<label>.peak_bytes``, ``hbm.<label>.delta_bytes``,
``hbm.watermark``). Off CUDA (a CPU device, or no card) nothing is read
and nothing is recorded: the JAX package's "unsupported platform" case.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Dict, List, Optional

from photon_ml_tpu_torch.obs.metrics import registry as _registry
from photon_ml_tpu_torch.obs.trace import emit_event as _emit_event
from photon_ml_tpu_torch.obs.trace import get_tracer as _get_tracer

__all__ = [
    "HbmSampler",
    "HbmWatermark",
    "hbm_supported",
    "hbm_watermark",
    "read_memory_stats",
    "sample_hbm",
]

# memory_stats() key -> the exported name (the JAX package's names where
# PJRT has the counter)
_STAT_KEYS = (
    ("allocated_bytes.all.current", "bytes_in_use"),
    ("allocated_bytes.all.peak", "peak_bytes_in_use"),
    ("reserved_bytes.all.current", "bytes_reserved"),
)


def _cuda_device(device=None):
    """``device`` as a CUDA ``torch.device`` with an index (default: the
    current one), or None off CUDA or without a card."""
    import torch

    if device is None:
        if not torch.cuda.is_available():
            return None
        return torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type != "cuda" or not torch.cuda.is_available():
        return None
    return torch.device("cuda", torch.cuda.current_device() if device.index is None
                        else device.index)


def read_memory_stats(device=None) -> Optional[Dict[str, int]]:
    """``{"bytes_in_use", "peak_bytes_in_use", "bytes_reserved"}`` of a CUDA
    device (default: the current one) from ``torch.cuda.memory_stats``, or
    None off CUDA or without a card. The one seam the rest of the module
    reads through."""
    try:
        import torch

        device = _cuda_device(device)
        if device is None:
            return None
        stats = torch.cuda.memory_stats(device)
        return {name: int(stats.get(key, 0)) for key, name in _STAT_KEYS}
    except Exception:  # noqa: BLE001 — telemetry never fails the caller
        return None


def _devices(device=None) -> List:
    """The CUDA devices a sample covers: ``device`` alone when given (none
    when it is not a CUDA device), else every visible card."""
    try:
        import torch

        if device is not None:
            dev = _cuda_device(device)
            return [] if dev is None else [dev]
        if not torch.cuda.is_available():
            return []
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    except Exception:  # noqa: BLE001
        return []


def hbm_supported(device=None) -> bool:
    """True when ``device`` (default: the current CUDA device) reports
    memory stats."""
    return read_memory_stats(device) is not None


def sample_hbm(registry=None, tracer=None, device=None) -> Dict[str, Dict[str, int]]:
    """Sample ``device`` (default: every visible card) once. Returns
    ``{"d<index>": stats}`` (empty off CUDA); side effects: ``hbm.d<i>.*``
    gauges and a counter-track event per device on the active tracer."""
    reg = registry if registry is not None else _registry()
    tr = tracer if tracer is not None else _get_tracer()
    out: Dict[str, Dict[str, int]] = {}
    for dev in _devices(device):
        stats = read_memory_stats(dev)
        if stats is None:
            continue
        label = f"d{dev.index}"
        out[label] = stats
        for k, v in stats.items():
            reg.set_gauge(f"hbm.{label}.{k}", v)
        if tr is not None:
            tr.add_counter(f"hbm.{label}", dict(stats))
    return out


class HbmSampler:
    """Background sampler of one device for the life of an observe()
    envelope. ``start()`` is a no-op off CUDA, so installing it
    unconditionally costs one probe. Event-driven stop (like
    ``MetricsDumper``), with a final sample on stop."""

    def __init__(self, every_s: float = 0.5, registry=None, device=None):
        self.every_s = every_s
        self._registry = registry
        self._device = device
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def _run(self) -> None:
        while not self._stop.wait(self.every_s):
            sample_hbm(registry=self._registry, device=self._device)

    def start(self) -> "HbmSampler":
        if self.every_s > 0 and self._thread is None and _devices(self._device):
            self._thread = threading.Thread(
                target=self._run, name="obs-hbm-sampler", daemon=True
            )
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
            sample_hbm(registry=self._registry, device=self._device)


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
