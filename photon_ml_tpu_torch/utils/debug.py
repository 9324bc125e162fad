"""Profiling traces and numeric sanitizers (counterpart of
``photon_ml_tpu/utils/debug.py``).

  - :func:`profile_trace` — a ``torch.profiler`` window around a phase: CPU
    activity, and CUDA activity when the phase runs on a card (CUPTI lists
    every kernel launched in the process, the ``ctypes`` launches of the
    port's kernels included), written as a Chrome trace
    (``<name>.<pid>.pt.trace.json``, Perfetto- and TensorBoard-loadable)
    into the directory. The JAX package writes an XLA xplane there instead.
  - :func:`debug_nans` — the counterpart of scoped ``jax_debug_nans``: a
    ``TorchDispatchMode`` that checks every floating output of every op
    inside the block and raises ``FloatingPointError`` at the op that
    produced a NaN. The port's kernels launch through ``ctypes``, which
    dispatch does not see, so while the mode is on each kernel wrapper
    checks its own outputs (``kernels.dispatch.check_outputs``). Every
    check reads the device: a debugging tool, not a production setting.
  - :func:`assert_all_finite` — host-side finiteness check of nested
    tensors with a path-qualified error, for post-solve invariants.

The JAX package's ``assert_sharding`` has no counterpart: a rank's shard
lives on its own card as a plain tensor, with no layout to assert.
"""

from __future__ import annotations

import contextlib
import os
from typing import Optional

import numpy as np

__all__ = ["assert_all_finite", "debug_nans", "profile_trace", "profile_path"]


# whether a profile_trace window is open: the profiler runs one session per
# process (a nested session crashes it), as jax.profiler runs one trace
_window_open = False


def profile_path(output_dir: str, name: str = "photon_ml_tpu_torch") -> str:
    """Where :func:`profile_trace` writes its Chrome trace."""
    return os.path.join(output_dir, f"{name}.{os.getpid()}.pt.trace.json")


def _wants_cuda(device) -> bool:
    import torch

    if device is None:
        return torch.cuda.is_available()
    return torch.device(device).type == "cuda"


@contextlib.contextmanager
def profile_trace(output_dir: Optional[str], device=None, name: str = "photon_ml_tpu_torch"):
    """A ``torch.profiler`` window around the enclosed phase when
    ``output_dir`` is set (no-op otherwise), recording CPU activity and,
    where ``device`` is CUDA (default: when a card is present), CUDA
    activity; the Chrome trace lands at :func:`profile_path`. One window
    at a time: opening one inside another raises ``RuntimeError``, as
    ``jax.profiler.trace`` does."""
    global _window_open
    if not output_dir:
        yield
        return
    import torch

    if _window_open:
        raise RuntimeError("only one profile may run at a time (a profile window "
                           "is already open)")
    os.makedirs(output_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if _wants_cuda(device):
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    _window_open = True
    try:
        with torch.profiler.profile(activities=activities) as prof:
            yield
    finally:
        _window_open = False
    prof.export_chrome_trace(profile_path(output_dir, name))


# ops whose output is uninitialized memory by contract: their bits are
# whatever the allocator held, not a value any op produced
_UNINITIALIZED = frozenset({
    "empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided", "resize_",
})


def _nan_in(value) -> bool:
    import torch

    if isinstance(value, (list, tuple)):
        return any(_nan_in(v) for v in value)
    if (isinstance(value, torch.Tensor) and value.numel()
            and (value.is_floating_point() or value.is_complex())):
        return bool(torch.isnan(value).any())
    return False


def _nan_mode():
    from torch.utils._python_dispatch import TorchDispatchMode

    class NanCheckMode(TorchDispatchMode):
        """Raise ``FloatingPointError`` at the first op whose floating
        output holds a NaN. Views (which alias an input that was checked
        where it was produced) and uninitialized allocations are not
        checked; in-place ops are."""

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if (not func.is_view and func.overloadpacket.__name__ not in _UNINITIALIZED
                    and _nan_in(out)):
                raise FloatingPointError(f"debug_nans: {func} produced a NaN")
            return out

    return NanCheckMode()


@contextlib.contextmanager
def debug_nans(enabled: bool = True):
    """Scoped NaN checking: every op inside the block, and every kernel
    launch, raises ``FloatingPointError`` on the first NaN it produces.
    The previous state (the kernel wrappers' output check) is restored on
    exit; the dispatch mode is popped."""
    if not enabled:
        yield
        return
    from photon_ml_tpu_torch.kernels import dispatch

    prev = dispatch.set_output_check(True)
    try:
        with _nan_mode():
            yield
    finally:
        dispatch.set_output_check(prev)


def _leaves(tree, path: str):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}[{i}]")
    elif hasattr(tree, "__dataclass_fields__"):
        for k in tree.__dataclass_fields__:
            yield from _leaves(getattr(tree, k), f"{path}.{k}")
    else:
        yield path, tree


def assert_all_finite(tree, name: str = "tree") -> None:
    """Host-side finiteness assertion over nested tensors and arrays
    (lists, tuples, dicts, dataclasses) with a path-qualified message."""
    for path, leaf in _leaves(tree, ""):
        if leaf is None or isinstance(leaf, (str, bytes)):
            continue
        if hasattr(leaf, "detach"):
            leaf = leaf.detach().cpu().numpy()
        arr = np.asarray(leaf)
        if not (np.issubdtype(arr.dtype, np.floating)
                or np.issubdtype(arr.dtype, np.complexfloating)):
            continue
        if not np.isfinite(arr).all():
            bad = int((~np.isfinite(arr)).sum())
            raise FloatingPointError(
                f"{name}{path}: {bad} non-finite values (shape {arr.shape})"
            )
