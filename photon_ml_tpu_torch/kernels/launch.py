"""A lean launch path for the kernels' C entry points.

A wrapper on this path checks a call in full once per key: the entry
point, the dtypes, shapes and devices of its tensors and its other
arguments. What the checks yield (the route, the launch's sizes) is kept
in the wrapper's dict of plans under that key, the kernel's cost is
recorded, and a CUDA route loads its library and sets its entry point's
signature there. A later call with the same key does only what can differ
between two calls of one key: the tensors' contiguity and 16-byte
alignment (``pointers``), the output's allocation, the raw pointers, and
``Entry.launch``: the current stream's raw handle, one ``ctypes`` call,
its return code and the launch count. A call with a new key is checked in
full, and refused where the checks refuse it; a refused call keeps no
plan. Every wrapper of ``kernels/{ell,fused,colsort,lab}.py`` launches
here.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Sequence

import torch

from photon_ml_tpu_torch.kernels import build, dispatch

__all__ = ["PLAIN", "MAX_PLANS", "Entry", "keep", "pointers"]

# the plan of a key whose tensors lie on the CPU: the plain version
PLAIN = "plain"
# plans kept per wrapper; more distinct keys than this start the dict anew
MAX_PLANS = 1024


def keep(kernel: str, plans: Dict[tuple, object], key: tuple, plan):
    """Store ``plan``, ``kernel``'s wrapper's plan of ``key``, and return
    it; counted as a new launch plan (``obs.build_events``)."""
    from photon_ml_tpu_torch.obs.build_events import note_launch_plan

    if len(plans) >= MAX_PLANS:
        plans.clear()
    plans[key] = plan
    note_launch_plan(kernel)
    return plan


def pointers(kernel: str, names: Sequence[str], *tensors: torch.Tensor,
             align: int = 16) -> list:
    """The tensors' data pointers, after the checks a CUDA kernel needs on
    every call: contiguous, and bases aligned to ``align`` bytes (16 for
    the kernels that load 4 entries at a time; 1, no check, for those that
    take any base). ``names`` name the tensors in the errors."""
    out = []
    for name, t in zip(names, tensors):
        if not t.is_contiguous():
            raise ValueError(f"{kernel}: {name} must be contiguous")
        ptr = t.data_ptr()
        if ptr % align:
            raise ValueError(f"{kernel}: {name} must start on a {align}-byte boundary")
        out.append(ptr)
    return out


class Entry:
    """One C entry point of a kernel library, whose last argument is the
    stream. ``load`` builds the library at first use and sets the
    signature, once per process; ``launch`` calls it."""

    __slots__ = ("kernel", "library", "name", "argtypes", "_lib", "_fn")

    def __init__(self, kernel: str, library: str, name: str, argtypes: Sequence):
        self.kernel, self.library, self.name = kernel, library, name
        self.argtypes = [*argtypes, ctypes.c_void_p]
        self._lib = self._fn = None

    def load(self) -> None:
        if self._fn is None:
            from photon_ml_tpu_torch.kernels import ell

            self._lib, self._fn = ell.load_entry(self.library, self.name, self.argtypes)

    def launch(self, device: int, *args) -> None:
        """Call the entry point with ``args`` and the raw handle of
        ``device``'s current stream, with ``device`` the current device;
        raise on a CUDA error, else count the launch."""
        if torch._C._cuda_getDevice() == device:
            code = self._fn(*args, torch._C._cuda_getCurrentRawStream(device))
        else:
            with torch.cuda.device(device):
                code = self._fn(*args, torch._C._cuda_getCurrentRawStream(device))
        if code:
            build.check(self._lib, code, f"{self.kernel} launch")
        dispatch.count_launch(self.kernel)
