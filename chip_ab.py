#!/usr/bin/env python3
"""Time the port's kernels of several checkouts on one card, in turns.

    python3 chip_ab.py DIR [DIR ...]

Each DIR is the root of a checkout of this repository (``.`` for this
one). Each runs in a process of its own, in the order given, which builds
that checkout's kernels and times them on the same seeded inputs; to
compare two, give them as ``A B B A``. The timers, the inputs and the
shapes are this checkout's ``chip_smoke.py``'s:

- ``uniform``: n = 2^22 rows, k = 40, d = 2^20, uniform random columns
  (the kernel phase);
- ``hot``: the same design with 14 columns named by every row;
- ``driver``: the training driver's batch, 2^16 Criteo-layout records
  over d = 2^20 + 1 columns (the intercept last).

Per (checkout, shape, kernel, dtype): the CUDA-event median of 25 calls
(``ms``) and the card's and the host's time per call with 20 calls queued
(``device_ms``, ``host_ms``). Every kernel in f64 (the main path's type),
``fused_hdiag`` also in f32 and bf16 x f32. Prints one JSON line per
checkout. Needs one CUDA device and ``nvcc``.
"""

from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
SHAPES = ("uniform", "hot", "driver")


def _smoke():
    """This checkout's chip_smoke.py, whose imports of the port resolve to
    the checkout first on sys.path."""
    spec = importlib.util.spec_from_file_location("chip_smoke_timers",
                                                  os.path.join(HERE, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _design(cs, shape):
    import torch

    if shape == "driver":
        # write_examples' design: the hashed fields, then the intercept
        np = cs.np
        n, d = cs.TRAIN_RECORDS, cs.D_HASHED + 1
        rows, cols, vals = cs.make_criteo_like(n, cs.SEED + 5)
        ell = cs.from_coo(np.concatenate([rows, np.arange(n)]),
                          np.concatenate([cols % cs.D_HASHED, np.full(n, d - 1)]),
                          np.concatenate([vals, np.ones(n)]), n, d,
                          dtype=torch.float64, device="cuda")
        return ell.indices, ell.values, d
    idx, vals64 = cs.make_ell(cs.KERNEL_ROWS, cs.K, cs.D_HASHED, "cuda")
    if shape == "hot":
        g = torch.Generator(device="cuda").manual_seed(cs.SEED + 7)
        idx[:, :cs.HOT_COLUMNS] = torch.randperm(cs.D_HASHED, generator=g, device="cuda")[
            :cs.HOT_COLUMNS].to(torch.int32)
    return idx, vals64, cs.D_HASHED


def worker(root: str) -> dict:
    sys.path.insert(0, os.path.abspath(root))
    cs = _smoke()
    import torch

    cs.build.build()
    out = {"root": root, "card": cs.nvidia_smi(), "times": []}
    for shape in SHAPES:
        idx, vals64, d = _design(cs, shape)
        n = idx.shape[0]
        for label, vdt, cd, *_ in cs.FUSED_CASES:
            if label != "f64" and shape == "driver":
                continue
            vals = vals64.to(vdt)
            y, off, ew, w = cs.row_inputs(n, d, cd, idx.device)
            loss = cs.LOGISTIC_LOSS
            c = cs.fused_value_grad_curvature(idx, vals, y, off, ew, w, d, loss)[3]
            shift = torch.tensor(0.05, dtype=cd, device=idx.device)
            calls = {"fused_hdiag": lambda: cs.fused_hessian_diagonal(
                idx, vals, y, off, ew, w, d, loss)}
            if label == "f64":
                calls.update({
                    "ell_matvec": lambda: cs.ell_matvec(idx, vals, w, d),
                    "ell_scatter_add": lambda: cs.ell_scatter_add(idx, vals, d),
                    "fused_vgc": lambda: cs.fused_value_grad_curvature(
                        idx, vals, y, off, ew, w, d, loss),
                    "fused_hvp": lambda: cs.fused_hessian_vector(idx, vals, c, w, shift, d),
                })
            for kernel, fn in calls.items():
                ms = cs.time_ms(fn)
                device_ms, host_ms = cs.device_ms(fn)
                out["times"].append({"shape": shape, "kernel": kernel, "dtype": label,
                                     "ms": ms, "device_ms": device_ms, "host_ms": host_ms})
            del vals, y, off, ew, w, c, calls
        del idx, vals64
        torch.cuda.empty_cache()
    return out


def main(argv) -> int:
    if len(argv) >= 2 and argv[0] == "--worker":
        print(json.dumps(worker(argv[1])), flush=True)
        return 0
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    for root in argv:
        root = os.path.abspath(root)
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--worker", root],
                              capture_output=True, text=True, cwd=root)
        if proc.returncode != 0:
            sys.stderr.write(proc.stdout + proc.stderr)
            return proc.returncode
        print(proc.stdout.strip().splitlines()[-1], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
