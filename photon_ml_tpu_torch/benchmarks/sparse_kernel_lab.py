"""The sparse kernel lab on the card (counterpart of
``benchmarks/sparse_kernel_lab.py``): the padded-ELL gather and scatter,
and the lab's three other forms of them, each timed beside a PyTorch call.

    python -m photon_ml_tpu_torch.benchmarks.sparse_kernel_lab [n] [k] [d]

Defaults n = 200,000 rows, k = 32 slots, d = 120,000 columns, with the
lab's Zipf(1.1) column ids (``make_data``). Lines, as the lab prints them:

  A1 ``ell_matvec`` (z = X w), ``torch.mv`` on a CSR tensor beside;
  A2 ``ell_scatter_add`` (g = X^T a, the update v * a formed outside),
     ``index_add_`` beside;
  B  ``lane_gather`` on an 8192 x 128 table (seed 3), ``torch.gather``
     beside;
  C  prep: ``column_sorted_tiles``, the column-sorted layout, and its time;
  C1 ``onehot_gather``, then the ``index_add_`` of e into rows that gives
     z, timed apart; maxerr against A1;
  C2 the ``a[row]`` gather that forms the update, timed apart, then
     ``onehot_reduce``; maxerr against A2.

On the card each time is the median of CUDA-event timings around one
call after warm-up (CUDA keeps no dispatch cache, so calls need no chained
inputs). Entry point: ``main(argv, device="cuda")``; it runs on the card
unless the caller asks for the CPU, where its times are host-clock times
of the plain versions. It prints the lines and returns ``{"records":
[one dict per line], "inputs": LabInputs}``.
"""

from __future__ import annotations

import dataclasses
import sys
import time
from typing import Callable, List, Optional

import numpy as np
import torch

from photon_ml_tpu_torch.kernels.ell import (
    ell_matvec,
    ell_matvec_reference,
    ell_scatter_add,
    ell_scatter_add_reference,
)
from photon_ml_tpu_torch.kernels.lab import (
    LANES,
    ColumnTiles,
    column_sorted_tiles,
    lane_gather,
    onehot_gather,
    onehot_reduce,
)
from photon_ml_tpu_torch.utils.device import resolve_device

DEFAULTS = (200_000, 32, 120_000)
# B's table: the lab's (BR, BC) and seed
LANE_ROWS = 8192
LANE_SEED = 3


def make_data(n: int, k: int, d: int, seed: int = 0):
    """Zipf-distributed column ids (power-law features, like CTR data):
    (n, k) int32 ids and float32 values, the lab's ``make_data``."""
    rng = np.random.default_rng(seed)
    ranks = rng.zipf(1.1, size=(n, k)).astype(np.int64)
    cols = (ranks - 1) % d
    vals = rng.standard_normal((n, k)).astype(np.float32)
    return cols.astype(np.int32), vals


@dataclasses.dataclass
class LabInputs:
    """The lab's data on one device: the (n, k) ELL (``cols``, ``vals``),
    w (seed 1), a (seed 2), B's table and ids, and the column-sorted
    ``tiles`` with the update ``upd = vals * a[row]`` over them."""

    n: int
    k: int
    d: int
    cols: torch.Tensor
    vals: torch.Tensor
    w: torch.Tensor
    a: torch.Tensor
    tbl: torch.Tensor
    idx: torch.Tensor
    tiles: Optional[ColumnTiles] = None
    upd: Optional[torch.Tensor] = None


def lab_inputs(n: int, k: int, d: int, device) -> LabInputs:
    cols, vals = make_data(n, k, d)
    w = np.random.default_rng(1).standard_normal(d).astype(np.float32)
    a = np.random.default_rng(2).standard_normal(n).astype(np.float32)
    rng_b = np.random.default_rng(LANE_SEED)
    tbl = rng_b.standard_normal((LANE_ROWS, LANES)).astype(np.float32)
    idx = rng_b.integers(0, LANES, size=(LANE_ROWS, LANES)).astype(np.int32)
    on = lambda x: torch.from_numpy(x).to(device)  # noqa: E731
    return LabInputs(n=n, k=k, d=d, cols=on(cols), vals=on(vals), w=on(w), a=on(a),
                     tbl=on(tbl), idx=on(idx))


def row_gather(tiles: ColumnTiles, a: torch.Tensor) -> torch.Tensor:
    """The update over the tiles, ``vals * a[row]`` (C2's gather; int32
    row ids, as stored)."""
    return tiles.vals * a.index_select(0, tiles.rows.reshape(-1)).view(tiles.rows.shape)


def rows_sum(tiles: ColumnTiles, e: torch.Tensor, n: int) -> torch.Tensor:
    """z from C1's e: ``index_add_`` of every entry into its row (a miss
    adds its 0 to row 0, as in the lab)."""
    z = torch.zeros(n, dtype=e.dtype, device=e.device)
    return z.index_add_(0, tiles.rows.reshape(-1), e.reshape(-1))


def csr_of(cols: torch.Tensor, vals: torch.Tensor, d: int) -> torch.Tensor:
    """The lab's ELL (no padding slots) as a CSR tensor."""
    n, k = cols.shape
    crow = torch.arange(0, n * k + 1, k, dtype=torch.int64, device=cols.device)
    return torch.sparse_csr_tensor(crow, cols.reshape(-1).long(), vals.reshape(-1),
                                   size=(n, d), check_invariants=False)


def time_call(fn: Callable, device: torch.device, warmup: int = 3, runs: int = 25):
    """(ms, clock): on the card the median of ``runs`` CUDA-event timings
    of one call after ``warmup`` calls; on the CPU the host clock's."""
    for _ in range(warmup):
        fn()
    times = []
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        for _ in range(runs):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return float(np.median(times)), "cuda events"
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times)), "host clock"


def _max_err(got: torch.Tensor, ref: torch.Tensor, scale: torch.Tensor):
    """(max |got - ref|, the largest |got - ref| / scale)."""
    err = (got.double() - ref.double()).abs()
    share = torch.where(err > 0, err / scale.double(), torch.zeros_like(err))
    return float(err.max()), float(share.max())


def run(n: int, k: int, d: int, device) -> dict:
    """Run the lab at (n, k, d) on ``device``; print its lines and return
    ``{"records": [...], "inputs": LabInputs}``."""
    dev = resolve_device(device)
    runs = 25 if dev.type == "cuda" else 5
    timed = lambda fn: time_call(fn, dev, runs=runs)  # noqa: E731
    nnz = n * k
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"n={n} k={k} d={d} nnz={nnz / 1e6:.1f}M device={dev} ({name})", flush=True)
    x = lab_inputs(n, k, d, dev)
    records: List[dict] = []

    def rate(elems, ms):
        return elems / (ms * 1e-3) / 1e6 if ms > 0 else float("inf")

    # ---- A. the production kernels on the ELL -------------------------------
    z_ref = ell_matvec(x.cols, x.vals, x.w, d)
    csr = csr_of(x.cols, x.vals, d)
    t, clock = timed(lambda: ell_matvec(x.cols, x.vals, x.w, d))
    t_lib, _ = timed(lambda: torch.mv(csr, x.w))
    print(f"A1 ell_matvec gather:      {t:8.4f} ms  ({rate(nnz, t):7.0f} M elem/s); "
          f"torch.mv(CSR) {t_lib:.4f} ms [{clock}]", flush=True)
    records.append({"line": "A1", "kernel": "ell_matvec", "ms": t, "library": "torch.mv(CSR)",
                    "library_ms": t_lib, "elements": nnz, "clock": clock})
    del csr
    upd_ell = x.vals * x.a[:, None]
    ids = x.cols.reshape(-1).long()
    g_ref = ell_scatter_add(x.cols, upd_ell, d)
    t, _ = timed(lambda: ell_scatter_add(x.cols, upd_ell, d))
    t_lib, _ = timed(lambda: torch.zeros(d, dtype=upd_ell.dtype, device=dev).index_add_(
        0, ids, upd_ell.reshape(-1)))
    print(f"A2 ell_scatter_add rmatvec: {t:8.4f} ms  ({rate(nnz, t):7.0f} M elem/s); "
          f"index_add_ {t_lib:.4f} ms [{clock}]", flush=True)
    records.append({"line": "A2", "kernel": "ell_scatter_add", "ms": t, "library": "index_add_",
                    "library_ms": t_lib, "elements": nnz, "clock": clock})

    # ---- B. lane gather -----------------------------------------------------
    t, _ = timed(lambda: lane_gather(x.tbl, x.idx))
    idx64 = x.idx.long()
    t_lib, _ = timed(lambda: torch.gather(x.tbl, 1, idx64))
    elems = x.tbl.numel()
    print(f"B  lane_gather:             {t:8.4f} ms  ({rate(elems, t):7.0f} M elem/s); "
          f"torch.gather {t_lib:.4f} ms [1M-elem same-shape tile] [{clock}]", flush=True)
    records.append({"line": "B", "kernel": "lane_gather", "ms": t, "library": "torch.gather",
                    "library_ms": t_lib, "elements": elems, "clock": clock})

    # ---- C. column-sorted tiles ---------------------------------------------
    t_prep, _ = time_call(lambda: column_sorted_tiles(x.cols, x.vals, d), dev,
                          warmup=1, runs=3)
    x.tiles = tiles = column_sorted_tiles(x.cols, x.vals, d)
    total = tiles.cols.numel()
    print(f"C  prep: {total / 1e6:.1f}M padded entries ({100 * (total - nnz) / max(nnz, 1):.1f}% "
          f"pad), {tiles.ntiles} tiles, {tiles.chains.shape[0]} columns across tiles; "
          f"layout {t_prep:.4f} ms [{clock}]", flush=True)
    records.append({"line": "C prep", "layout_ms": t_prep, "padded_entries": total,
                    "tiles": tiles.ntiles, "blocks": tiles.nblocks,
                    "chains": tiles.chains.shape[0], "clock": clock})

    # scales of z and g: the row and column sums of |terms|, in f64 by the
    # plain versions
    row_abs = ell_matvec_reference(x.cols, x.vals.abs().double(), x.w.abs().double(), d)
    col_abs = ell_scatter_add_reference(x.cols, upd_ell.abs().double(), d)

    t, _ = timed(lambda: onehot_gather(tiles, x.w))
    e = onehot_gather(tiles, x.w)
    t_rows, _ = timed(lambda: rows_sum(tiles, e, n))
    err, share = _max_err(rows_sum(tiles, e, n), z_ref, row_abs)
    print(f"C1 onehot_gather:          {t:8.4f} ms  ({rate(total, t):7.0f} M elem/s) "
          f"(+{t_rows:.4f} ms index_add_ into rows)  maxerr={err:.2e} [{clock}]", flush=True)
    records.append({"line": "C1", "kernel": "onehot_gather", "ms": t, "elements": total,
                    "rows_index_add_ms": t_rows, "max_err": err, "max_err_share": share,
                    "clock": clock})

    t_gather, _ = timed(lambda: row_gather(tiles, x.a))
    x.upd = upd = row_gather(tiles, x.a)
    t, _ = timed(lambda: onehot_reduce(tiles, upd))
    err, share = _max_err(onehot_reduce(tiles, upd)[:d], g_ref, col_abs)
    print(f"C2 onehot_reduce:          {t:8.4f} ms  ({rate(total, t):7.0f} M elem/s) "
          f"(+{t_gather:.4f} ms a[row] gather)  maxerr={err:.2e} [{clock}]", flush=True)
    records.append({"line": "C2", "kernel": "onehot_reduce", "ms": t, "elements": total,
                    "row_gather_ms": t_gather, "max_err": err, "max_err_share": share,
                    "clock": clock})
    return {"records": records, "inputs": x}


def main(argv: Optional[List[str]] = None, device="cuda") -> dict:
    """``argv``: [n] [k] [d] (the command line's arguments; defaults
    200,000, 32, 120,000)."""
    argv = sys.argv[1:] if argv is None else list(argv)
    n, k, d = (int(argv[i]) if len(argv) > i else DEFAULTS[i] for i in range(3))
    return run(n, k, d, device)


if __name__ == "__main__":
    main()
