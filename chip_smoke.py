#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Needs one CUDA device and ``nvcc``; exits non-zero without them, and
whenever any phase fails. Phases, in order:

1. device: the card's name and power limit (``nvidia-smi``);
2. build: every CUDA kernel of the port, from ``photon_ml_tpu_torch/
   kernels/csrc``, one ``nvcc`` per source, all at once;
3. kernel: ``ell_matvec`` against its plain PyTorch version on the card at
   n = 2^22 rows, k = 40 slots, d = 2^20 columns, with padding slots and
   duplicate ids, for (f64, f64), (f32, f32) and (bf16, f32); times of the
   kernel, the plain version and ``torch.mv`` on a CSR tensor of the same
   matrix (a yardstick the port never calls), against the HBM bound;
4. score: the port's GLM scoring driver (``run_scoring``, sparse, with
   evaluation) end to end at the Criteo Terabyte width — 13 integer and
   26 categorical fields hashed into 2^20 columns plus the intercept —
   on 2^16 synthetic records made from a seed, with every launch counter
   set to 0 just before and read just after; the kernel against its plain
   version at the shape the driver gave it; then the same run again under
   ``torch.profiler`` for the card's busy and idle share;
5. the ``{"kernels": [...]}`` line, the ``nvidia-smi`` line, and last the
   ``{"ok": true, "device": ...}`` line.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

from photon_ml_tpu_torch.cli.score import run_scoring
from photon_ml_tpu_torch.core.tasks import TaskType
from photon_ml_tpu_torch.core.types import Coefficients
from photon_ml_tpu_torch.io.avro import write_avro_file
from photon_ml_tpu_torch.io.models import save_glm_model
from photon_ml_tpu_torch.io.schemas import TRAINING_EXAMPLE_SCHEMA
from photon_ml_tpu_torch.io.vocab import FeatureVocabulary, feature_key
from photon_ml_tpu_torch.kernels import build, dispatch
from photon_ml_tpu_torch.kernels.ell import ell_matvec, ell_matvec_reference
from photon_ml_tpu_torch.ops.sparse import from_coo

ROOT = os.path.dirname(os.path.abspath(__file__))
SEED = 20261016

# Criteo Terabyte Click Logs layout: 13 integer + 26 categorical fields,
# hashed into 2^20 columns, plus the intercept -> 40 ELL slots per row
INT_FIELDS = 13
CAT_FIELDS = 26
HASH_BITS = 20
D_HASHED = 1 << HASH_BITS
K = INT_FIELDS + CAT_FIELDS + 1
KERNEL_ROWS = 1 << 22  # kernel phase depth
SCORE_RECORDS = 1 << 16  # end-to-end depth (the pure-Python Avro codec)

# (values dtype, w dtype, stated tolerance: |kernel - plain| <=
#  rtol * sum_k |v_ik w[c_ik]| per row — a bound on any summation order)
DTYPE_CASES = [
    ("f64", torch.float64, torch.float64, 1e-12),
    ("f32", torch.float32, torch.float32, 1e-5),
    ("bf16xf32", torch.bfloat16, torch.float32, 1e-2),
]

# published peaks, NVIDIA data sheets (dense, no sparsity): HBM bytes/s,
# FP64 and FP32 FLOP/s outside the tensor cores
PEAKS = [
    ("H200", {"hbm": 4.8e12, "f64": 34e12, "f32": 67e12}),
    ("H100 NVL", {"hbm": 3.9e12, "f64": 30e12, "f32": 60e12}),
    ("H100 PCIe", {"hbm": 2.0e12, "f64": 26e12, "f32": 51e12}),
    ("H100", {"hbm": 3.35e12, "f64": 34e12, "f32": 67e12}),  # SXM5
]


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def peaks_for(name: str) -> dict:
    for key, peaks in PEAKS:
        if key in name:
            return peaks
    raise RuntimeError(f"no published peaks for card {name!r}")


def time_ms(fn, warmup: int = 3, runs: int = 25) -> float:
    """Median of ``runs`` CUDA-event timings of ``fn`` after warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


# -- phase 3: the kernel against its plain version ---------------------------


def make_ell(n: int, k: int, d: int, device, seed: int = SEED):
    """Seeded (indices, f64 values) with 0-3 trailing padding slots per row
    (id d, value 0) and a duplicate id in every 16th row."""
    g = torch.Generator(device=device).manual_seed(seed)
    idx = torch.randint(0, d, (n, k), generator=g, device=device, dtype=torch.int32)
    vals = torch.randn((n, k), generator=g, device=device, dtype=torch.float64)
    n_pad = torch.randint(0, 4, (n, 1), generator=g, device=device)
    pad = torch.arange(k, device=device)[None, :] >= (k - n_pad)
    idx[pad] = d
    vals[pad] = 0.0
    idx[::16, 1] = torch.where(pad[::16, 1], idx[::16, 1], idx[::16, 0])
    return idx, vals


def csr_of(idx: torch.Tensor, vals: torch.Tensor, d: int) -> torch.Tensor:
    """The ELL as a CSR tensor without its padding slots (duplicates kept:
    a sparse product sums them like the ELL)."""
    keep = idx < d
    crow = torch.zeros(idx.shape[0] + 1, dtype=torch.int64, device=idx.device)
    crow[1:] = torch.cumsum(keep.sum(1), 0)
    return torch.sparse_csr_tensor(
        crow, idx[keep].long(), vals[keep], size=(idx.shape[0], d)
    )


def check_kernel(idx, vals64, d, vdt, wdt, rtol, w64):
    vals = vals64.to(vdt)
    w = w64.to(wdt)
    got = ell_matvec(idx, vals, w, d)
    ref = ell_matvec_reference(idx, vals, w, d)
    row_abs = ell_matvec_reference(idx, vals.abs().double(), w.abs().double(), d)
    torch.cuda.synchronize()
    err = (got.double() - ref.double()).abs()
    ok = bool(torch.all(err <= rtol * row_abs)) and bool(torch.isfinite(got).all())
    return vals, w, got, float(err.max()), ok


def kernel_phase(name: str, n: int = KERNEL_ROWS, d: int = D_HASHED, k: int = K):
    peaks = peaks_for(name)
    idx, vals64 = make_ell(n, k, d, "cuda")
    g = torch.Generator(device="cuda").manual_seed(SEED + 1)
    w64 = torch.randn(d, generator=g, device="cuda", dtype=torch.float64)
    valid_slots = int((idx < d).sum())
    results = []
    for label, vdt, wdt, rtol in DTYPE_CASES:
        vals, w, got, max_err, ok = check_kernel(idx, vals64, d, vdt, wdt, rtol, w64)
        log(f"[kernel] ell_matvec {label}: max |kernel - plain| = {max_err:.3e} "
            f"(rtol {rtol:g} x row sum of |v w|): {'ok' if ok else 'DISAGREES'}")
        if not ok:
            raise AssertionError(f"ell_matvec {label} disagrees with its plain version")
        # library yardstick: torch.mv on CSR (bf16 values upcast to f32 once,
        # outside the timing: the sparse product takes one dtype)
        csr = csr_of(idx, vals.to(got.dtype), d)
        lib_out = torch.mv(csr, w.to(got.dtype))
        lib_err = float((lib_out.double() - got.double()).abs().max())
        kernel_ms = time_ms(lambda: ell_matvec(idx, vals, w, d))
        plain_ms = time_ms(lambda: ell_matvec_reference(idx, vals, w, d))
        library_ms = time_ms(lambda: torch.mv(csr, w.to(got.dtype)))
        del csr, lib_out
        nbytes = (n * k * (4 + vals.element_size()) + d * w.element_size()
                  + n * got.element_size())
        ops = 2 * valid_slots
        bytes_ms = nbytes / peaks["hbm"] * 1e3
        ops_ms = ops / peaks["f64" if got.dtype == torch.float64 else "f32"] * 1e3
        results.append({
            "name": "ell_matvec",
            "dtype": label,
            "route": "cuda",
            "source": "photon_ml_tpu_torch/kernels/csrc/ell_matvec.cu",
            "replaces": "photon_ml_tpu/kernels/ell.py:115",
            "shape": {"n": n, "k": k, "d": d},
            "max_abs_err": max_err,
            "library_max_abs_diff": lib_err,
            "ms": kernel_ms,
            "plain_ms": plain_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": library_ms,
            "bytes": nbytes,
            "ops": ops,
        })
        log(f"[kernel] ell_matvec {label}: kernel {kernel_ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, torch.mv(CSR) {library_ms:.4f} ms, bound "
            f"{max(bytes_ms, ops_ms):.4f} ms")
        del vals, w, got
        torch.cuda.empty_cache()
    del idx, vals64
    torch.cuda.empty_cache()
    return results


# -- phase 4: the scoring driver end to end ----------------------------------


def _hash(field: np.ndarray, value: np.ndarray) -> np.ndarray:
    """splitmix64 of (field, value) -> a bucket in [0, 2^HASH_BITS)."""
    with np.errstate(over="ignore"):
        x = (field.astype(np.uint64) << np.uint64(40)) ^ value.astype(np.uint64)
        x = x + np.uint64(0x9E3779B97F4A7C15)
        x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        x = x ^ (x >> np.uint64(31))
    return (x >> np.uint64(64 - HASH_BITS)).astype(np.int64)


def make_criteo_like(n: int, seed: int = SEED):
    """Seeded records in the Criteo layout, as COO over the hashed columns:
    integer field j -> column hash(j, 0) with value log1p(count);
    categorical field j -> column hash(13 + j, category) with value 1,
    categories Zipf-distributed. Returns (rows, cols, vals) of the 39
    hashed fields per row (duplicates not yet summed)."""
    rng = np.random.default_rng(seed)
    counts = rng.geometric(0.05, size=(n, INT_FIELDS)) - 1
    int_vals = np.log1p(counts.astype(np.float64))
    int_cols = np.broadcast_to(
        _hash(np.arange(INT_FIELDS), np.zeros(INT_FIELDS, np.int64)), (n, INT_FIELDS)
    )
    cats = rng.zipf(1.2, size=(n, CAT_FIELDS)) % 1_000_003
    cat_cols = _hash(np.arange(INT_FIELDS, INT_FIELDS + CAT_FIELDS)[None, :], cats)
    cols = np.concatenate([int_cols, cat_cols], axis=1)
    vals = np.concatenate([int_vals, np.ones((n, CAT_FIELDS))], axis=1)
    rows = np.repeat(np.arange(n), cols.shape[1])
    return rows, cols.reshape(-1), vals.reshape(-1)


def write_scoring_inputs(work: str, n: int, d_hashed: int, seed: int = SEED):
    """feature-index.txt (d_hashed keys + intercept), best-model.avro
    (seeded f64 coefficients) and n TrainingExample records with offsets
    and labels drawn from the seeded logistic model."""
    rng = np.random.default_rng(seed + 2)
    keys = [feature_key("h", str(b)) for b in range(d_hashed)]
    vocab = FeatureVocabulary(keys, add_intercept=True)
    model_dir = os.path.join(work, "model")
    vocab.save(os.path.join(model_dir, "feature-index.txt"))
    w = rng.normal(0.0, 0.25, size=len(vocab))
    save_glm_model(
        os.path.join(model_dir, "best-model.avro"),
        Coefficients(means=torch.from_numpy(w)), vocab,
        task=TaskType.LOGISTIC_REGRESSION,
    )
    rows, cols, vals = make_criteo_like(n, seed)
    cols = cols % d_hashed
    offsets = rng.normal(0.0, 0.1, size=n)
    icpt = vocab.intercept_index
    margins = np.bincount(rows, vals * w[cols], minlength=n) + w[icpt] + offsets
    labels = (rng.uniform(size=n) < 1.0 / (1.0 + np.exp(-margins))).astype(np.float64)
    per_row = cols.size // n
    c2, v2 = cols.reshape(n, per_row), vals.reshape(n, per_row)
    records = (
        {
            "uid": f"r{i}",
            "label": float(labels[i]),
            "features": [
                {"name": "h", "term": str(c), "value": float(v)}
                for c, v in zip(c2[i].tolist(), v2[i].tolist())
            ],
            "metadataMap": None,
            "weight": None,
            "offset": float(offsets[i]),
        }
        for i in range(n)
    )
    data = os.path.join(work, "data", "part-00000.avro")
    write_avro_file(data, TRAINING_EXAMPLE_SCHEMA, records)
    # the expected design, built straight from the generator's COO
    all_rows = np.concatenate([rows, np.arange(n)])
    all_cols = np.concatenate([cols, np.full(n, icpt)])
    all_vals = np.concatenate([vals, np.ones(n)])
    return model_dir, data, w, offsets, (all_rows, all_cols, all_vals, len(vocab))


def device_busy(prof) -> dict:
    """Device time of a profiled window: the union of every CUDA activity
    (kernels, copies, sets) on the card, and the ``ell_matvec`` kernels'
    own time, in seconds. None where the profiler saw no device activity
    (a machine whose CUPTI tracing is off): not measured."""
    spans = sorted(
        (e.time_range.start, e.time_range.end, e.name) for e in prof.events()
        if e.device_type == torch.autograd.DeviceType.CUDA
    )
    if not spans:
        return {"device_busy_s": None, "ell_matvec_device_s": None}
    busy_us, reach = 0.0, float("-inf")
    for start, end, _ in spans:
        if end > reach:
            busy_us += end - max(start, reach)
            reach = end
    kernel_us = sum(end - start for start, end, name in spans if "ell_matvec" in name)
    return {"device_busy_s": busy_us * 1e-6, "ell_matvec_device_s": kernel_us * 1e-6}


def score_phase(work: str, n: int = SCORE_RECORDS, d_hashed: int = D_HASHED,
                **device_kw):
    """Run the port's GLM scoring driver; ``device_kw`` is empty for the
    card (the driver's default device)."""
    t0 = time.perf_counter()
    model_dir, data, w, offsets, coo = write_scoring_inputs(work, n, d_hashed)
    setup_s = time.perf_counter() - t0
    log(f"[score] wrote {n} records, {d_hashed} hashed columns + intercept, "
        f"model and vocabulary in {setup_s:.1f} s (set-up)")
    params = {
        "input": [data],
        "model_dir": model_dir,
        "output_dir": os.path.join(work, "scores"),
        "model_kind": "glm",
        "sparse": True,
        "evaluate": True,
    }
    dispatch.reset_launch_counts()
    t0 = time.perf_counter()
    run = run_scoring(params, **device_kw)
    wall_s = time.perf_counter() - t0
    launches = dispatch.launch_counts()

    # the same run again under torch.profiler, for the card's busy share;
    # tracing slows the synchronised margin step, so the run above is the
    # one whose phases are reported
    activities = [torch.profiler.ProfilerActivity.CPU]
    if not device_kw:
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        t0 = time.perf_counter()
        run_scoring({**params, "overwrite": True}, **device_kw)
        traced_wall_s = time.perf_counter() - t0
    busy = device_busy(prof)

    # the kernel against its plain version at the shape the driver gave it
    device = torch.device(run.device)
    rows, cols, vals, d = coo
    ell = from_coo(rows, cols, vals, n, d, dtype=torch.float64, device=device)
    w_dev = torch.from_numpy(w).to(device)
    plain = ell_matvec_reference(ell.indices, ell.values, w_dev, d)
    kernel = ell_matvec(ell.indices, ell.values, w_dev, d)
    row_abs = ell_matvec_reference(ell.indices, ell.values.abs(), w_dev.abs(), d)
    kernel_err = (kernel - plain).abs()
    assert bool(torch.all(kernel_err <= 1e-12 * row_abs)), float(kernel_err.max())

    ref = plain.cpu().numpy() + offsets
    assert run.scores.shape == (n,), run.scores.shape
    assert np.isfinite(run.scores).all(), "non-finite scores"
    np.testing.assert_allclose(run.scores, ref, rtol=1e-10, atol=1e-10)
    auc = run.metrics["AREA_UNDER_RECEIVER_OPERATOR_CHARACTERISTICS"]
    assert 0.5 < auc <= 1.0, auc
    summary = {
        "records": n,
        "k": int(ell.nnz_per_row),
        "d": d,
        "device": run.device,
        "wall_s": wall_s,
        "rows_per_s": n / wall_s,
        "margin_rows_per_s": n / run.timings["margins"],
        "timings_s": run.timings,
        "launches": launches,
        "traced_wall_s": traced_wall_s,
        **busy,
        "device_idle_share": (None if busy["device_busy_s"] is None
                              else 1.0 - busy["device_busy_s"] / traced_wall_s),
        "kernel_max_abs_err": float(kernel_err.max()),
        "metrics": run.metrics,
        "setup_s": setup_s,
    }
    log(f"[score] {json.dumps(summary)}")
    return summary


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke run needs one card",
              file=sys.stderr)
        return 1
    # 1. device
    smi = nvidia_smi()
    name = torch.cuda.get_device_name(0)
    log(f"[device] {smi}")
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"device 0: {name} ({torch.cuda.device_count()} visible)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 2. build
    t0 = time.perf_counter()
    build.build()
    log(f"[build] CUDA kernels built in {time.perf_counter() - t0:.1f} s (set-up)")
    ptxas = build.build_log("ell_matvec")
    regs = sorted({int(r) for r in re.findall(r"Used (\d+) registers", ptxas)})
    spills = sorted({int(s) for s in re.findall(r"(\d+) bytes spill stores", ptxas)})
    log(f"[build] ell_matvec instantiations: registers per thread {regs}, "
        f"spill-store bytes {spills}")

    # 3. kernel against its plain version
    checks = kernel_phase(name)
    log(json.dumps({"ell_matvec_checks": checks}))

    # 4. the main path: GLM scoring end to end
    work = os.path.join(ROOT, "_smoke_work")
    shutil.rmtree(work, ignore_errors=True)
    try:
        summary = score_phase(work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    if summary["launches"]["ell_matvec"] < 1:
        raise AssertionError("the scoring run did not launch the ell_matvec kernel")

    # 5. result lines
    keys = ("name", "route", "source", "replaces", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    main_path = next(c for c in checks if c["dtype"] == "f64")  # the driver's dtype
    kernels = [{**{k: main_path[k] for k in keys},
                "launches": summary["launches"]["ell_matvec"]}]
    log(json.dumps({"kernels": kernels}))
    log(nvidia_smi())
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": name,
                   "count": torch.cuda.device_count()},
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
