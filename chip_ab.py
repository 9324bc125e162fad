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
(``device_ms``, ``host_ms``). ``ell_matvec`` and ``ell_scatter_add`` in
f64 (the main path's type), the three fused passes in f64, f32 and bf16 x
f32. A checkout with the column-sorted reduce (``kernels/colsort.py``)
also times the reduce (``colsort_reduce``, linear, each dtype) and the
build of the design's column-sorted copy (``copy_build``, once per shape:
its ``ms`` is the build's CUDA-event time, with its bytes and, where the
copy is cut into blocks of rows, its blocks). Prints one
JSON line per checkout. Needs one CUDA device and ``nvcc``.

    python3 chip_ab.py --train DIR [DIR ...]

times the training drivers end to end instead. This checkout's
``chip_smoke.py`` first writes the inputs of phases 5c, 5d and 6 once,
into ``_ab_work/`` of this checkout, and times ``torch.cumsum`` and
``ops.metrics.fixed_order_cumsum`` on the card, with the distinct bit
patterns each gives over 50 calls on one vector; then each DIR in turn, in
a process of its own, runs its own drivers on those inputs on the card,
one run each, counters set to 0 just before and read just after: phase
5c's GAME training, phase 5d's, phase 5e's (5d's at lambda 1), and
phase 6's GLM training. Per run: the wall seconds, the driver's
``timings`` and the launches; then the kernels at the ``driver`` shape as
above. Prints the inputs' line, then one JSON line per checkout.

    python3 chip_ab.py --lab DIR [DIR ...]

times the sparse kernel lab's kernels instead: ``lane_gather`` beside
``torch.gather`` on the lab's table (8192 x 128), ``onehot_gather`` and
``onehot_reduce`` on the lab's column-sorted tiles at its default shape
(n = 200,000, k = 32, d = 120,000, Zipf(1.1)) and on the ``uniform``
design in f32 (``lab``, ``uniform``), each as ``ms``, ``device_ms`` and
``host_ms`` above.

    python3 chip_ab.py --writers

times ``--lab``'s calls of this checkout in turns with ``chip_smoke.py``'s
input writers idle and busy (at nice 19, as the smoke run starts them,
and at nice 0): the host's part of a call beside the writers that the
smoke run keeps busy during its kernel phases. One JSON line.
"""

from __future__ import annotations

import importlib.util
import json
import os
import shutil
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
SHAPES = ("uniform", "hot", "driver")


def _smoke():
    """This checkout's chip_smoke.py, whose imports of the port resolve to
    the checkout first on sys.path."""
    spec = importlib.util.spec_from_file_location("chip_smoke_timers",
                                                  os.path.join(HERE, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    # a module loaded under this name cannot be imported by the smoke run's
    # spawned writer processes: its records are encoded here, at the call
    module.write_examples_file = module.encode_examples
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


def prepare(work: str, device_kw=None, game=None, proj=None, glm=None) -> dict:
    """Write the training drivers' inputs under ``work`` with this
    checkout's writers (``game``, ``proj``, ``glm``: (records, held-out
    records) of phases 5c, 5d and 6, by default theirs), and on the card
    time the two scans. Returns the paths and the scans' record."""
    cs = _smoke()
    game = game or (cs.GAME_TRAIN_RECORDS, cs.GAME_TRAIN_HELDOUT)
    proj = proj or (cs.GAME_PROJ_RECORDS, cs.GAME_PROJ_HELDOUT)
    glm = glm or (cs.TRAIN_RECORDS, cs.HELDOUT_RECORDS)
    shutil.rmtree(work, ignore_errors=True)
    t0 = time.perf_counter()
    (gpath, upath), (train, heldout), _ = cs.write_game_training_inputs(
        os.path.join(work, "game"), *game, cs.D_HASHED, cs.GAME_TRAIN_USERS)
    vocab_paths, (ptrain, pheldout), _ = cs.write_game_training_inputs(
        os.path.join(work, "proj"), *proj, cs.D_HASHED, cs.GAME_TRAIN_USERS,
        user_cols=cs.GAME_USER_COLS, n_ads=cs.GAME_PROJ_ADS)
    vocab_path, _, sets = cs.write_training_inputs(os.path.join(work, "glm"), *glm, cs.D_HASHED)
    out = {"work": work, "setup_s": time.perf_counter() - t0,
           "game": [gpath, upath, train, heldout],
           "proj": [list(vocab_paths), ptrain, pheldout],
           "glm": [vocab_path, sets["train"][0], sets["heldout"][0]]}
    if not device_kw:
        out["card"] = cs.nvidia_smi()
        out["scans"] = [scan_bits(cs, n) for n in (glm[1], 1 << 22)]
    return out


def scan_bits(cs, n: int, calls: int = 50) -> dict:
    """``torch.cumsum`` and ``fixed_order_cumsum`` of one seeded (n,) f64
    vector on the card: the distinct bit patterns over ``calls`` calls and
    the CUDA-event median of each."""
    import torch

    from photon_ml_tpu_torch.ops.metrics import fixed_order_cumsum

    g = torch.Generator(device="cuda").manual_seed(cs.SEED + 11)
    x = torch.rand(n, generator=g, device="cuda", dtype=torch.float64) * 3.0
    rec = {"n": n, "calls": calls}
    for name, fn in (("torch_cumsum", lambda: torch.cumsum(x, 0)),
                     ("fixed_order_cumsum", lambda: fixed_order_cumsum(x))):
        first = fn()
        distinct = {first.cpu().numpy().tobytes()}
        for _ in range(calls - 1):
            distinct.add(fn().cpu().numpy().tobytes())
        rec[name] = {"distinct_bits": len(distinct), "ms": cs.time_ms(fn)}
    return rec


def train_runs(cs, inputs: dict, device_kw=None) -> list:
    """One run of each training driver of this checkout on ``inputs``,
    outputs under a directory of its own, removed after."""
    from photon_ml_tpu_torch.cli.game_train import run_game_training
    from photon_ml_tpu_torch.cli.train import run_glm_training
    from photon_ml_tpu_torch.kernels import dispatch

    device_kw = device_kw or {}
    work = os.path.join(inputs["work"], f"out-{os.getpid()}")
    gpath, upath, train, heldout = inputs["game"]
    vocab_paths, ptrain, pheldout = inputs["proj"]
    vocab_path, gtrain, gheldout = inputs["glm"]
    configs = [
        ("game_train_5c", "game", cs.game_train_params(work, train, heldout, gpath, upath)),
        ("game_projected_5d", "game",
         cs.game_projected_params(work, ptrain, pheldout, vocab_paths, "out")),
        ("game_determinism_5e", "game",
         {**cs.game_projected_params(work, ptrain, pheldout, vocab_paths, "out"),
          "coordinates": cs.GAME_DET_COORDINATES}),
        ("train_6", "glm", {
            "train_input": [gtrain], "validate_input": [gheldout],
            "output_dir": os.path.join(work, "out"), "feature_file": vocab_path,
            "optimizer": "TRON", "reg_type": "L2", "reg_weights": cs.TRAIN_LAMBDAS,
            "tolerance": cs.TRAIN_TOLERANCE, "max_iters": cs.TRAIN_MAX_ITERS,
            "sparse": True, "precision": "float64"}),
    ]
    records = []
    for name, kind, params in configs:
        dispatch.reset_launch_counts()
        t0 = time.perf_counter()
        run = (run_game_training if kind == "game" else run_glm_training)(params, **device_kw)
        wall_s = time.perf_counter() - t0
        rec = {"run": name, "wall_s": wall_s, "timings_s": dict(run.timings),
               "launches": {k: v for k, v in dispatch.launch_counts().items() if v}}
        if kind == "game":
            rec["fixed_iterations"] = [int(h.solver_iterations) for c in run.sweep
                                       for h in c["history"] if h.coordinate == "global"]
        else:
            rec["iterations"] = [int(tm.result.iterations) for tm in run.models]
        records.append(rec)
        shutil.rmtree(work, ignore_errors=True)
    return records


def worker(root: str, inputs=None) -> dict:
    sys.path.insert(0, os.path.abspath(root))
    cs = _smoke()
    import torch

    cs.build.build()
    has_reduce = importlib.util.find_spec("photon_ml_tpu_torch.kernels.colsort") is not None
    out = {"root": root, "card": cs.nvidia_smi(), "times": []}
    if inputs is not None:
        out["runs"] = train_runs(cs, inputs)
    for shape in (SHAPES if inputs is None else ("driver",)):
        idx, vals64, d = _design(cs, shape)
        n = idx.shape[0]
        copy = None
        if has_reduce:
            from photon_ml_tpu_torch.kernels.colsort import column_reduce, column_values

            copy, rec = cs.copy_build(idx, d, f"ab-{shape}")
            out["times"].append({"shape": shape, "kernel": "copy_build", "dtype": "-",
                                 "ms": rec["build_ms"], **rec})
        for label, vdt, cd, *_ in cs.FUSED_CASES:
            vals = vals64.to(vdt)
            y, off, ew, w = cs.row_inputs(n, d, cd, idx.device)
            loss = cs.LOGISTIC_LOSS
            c = cs.fused_value_grad_curvature(idx, vals, y, off, ew, w, d, loss)[3]
            shift = torch.tensor(0.05, dtype=cd, device=idx.device)
            calls = {
                "fused_vgc": lambda: cs.fused_value_grad_curvature(
                    idx, vals, y, off, ew, w, d, loss),
                "fused_hvp": lambda: cs.fused_hessian_vector(idx, vals, c, w, shift, d),
                "fused_hdiag": lambda: cs.fused_hessian_diagonal(
                    idx, vals, y, off, ew, w, d, loss),
            }
            if label == "f64":
                calls.update({
                    "ell_matvec": lambda: cs.ell_matvec(idx, vals, w, d),
                    "ell_scatter_add": lambda: cs.ell_scatter_add(idx, vals, d),
                })
            if copy is not None:
                cvals = column_values(copy, vals)
                calls["colsort_reduce"] = lambda: column_reduce(copy, cvals, c, "linear")
            for kernel, fn in calls.items():
                ms = cs.time_ms(fn)
                device_ms, host_ms = cs.device_ms(fn)
                out["times"].append({"shape": shape, "kernel": kernel, "dtype": label,
                                     "ms": ms, "device_ms": device_ms, "host_ms": host_ms})
            del vals, y, off, ew, w, c, calls
        del idx, vals64, copy
        torch.cuda.empty_cache()
    return out


def _lab_calls(cs):
    """The lab's calls of ``--lab``, on their inputs on the card."""
    import torch

    lab = cs.sparse_kernel_lab
    x = lab.lab_inputs(*(int(a) for a in cs.LAB_ARGS), torch.device("cuda"))
    tiles = cs.column_sorted_tiles(x.cols, x.vals, x.d)
    upd = lab.row_gather(tiles, x.a)
    idx64 = x.idx.long()
    idx, vals64, d = _design(cs, "uniform")
    vals = vals64.float()
    del vals64
    g = torch.Generator(device="cuda").manual_seed(cs.SEED + 11)
    w = torch.randn(d, generator=g, device="cuda")
    a = torch.randn(idx.shape[0], generator=g, device="cuda")
    utiles = cs.column_sorted_tiles(idx, vals, d)
    uupd = lab.row_gather(utiles, a)
    del idx, vals, a
    calls = [
        ("lab", "lane_gather", lambda: cs.lane_gather(x.tbl, x.idx)),
        ("lab", "torch.gather", lambda: torch.gather(x.tbl, 1, idx64)),
        ("lab", "onehot_gather", lambda: cs.onehot_gather(tiles, x.w)),
        ("lab", "onehot_reduce", lambda: cs.onehot_reduce(tiles, upd)),
        ("uniform", "onehot_gather", lambda: cs.onehot_gather(utiles, w)),
        ("uniform", "onehot_reduce", lambda: cs.onehot_reduce(utiles, uupd)),
    ]
    return calls


def _time_calls(cs, calls) -> list:
    times = []
    for shape, kernel, fn in calls:
        ms = cs.time_ms(fn)
        device_ms, host_ms = cs.device_ms(fn)
        times.append({"shape": shape, "kernel": kernel, "dtype": "f32", "ms": ms,
                      "device_ms": device_ms, "host_ms": host_ms})
    return times


def lab_worker(root: str) -> dict:
    sys.path.insert(0, os.path.abspath(root))
    cs = _smoke()
    cs.build.build()
    return {"root": root, "card": cs.nvidia_smi(), "times": _time_calls(cs, _lab_calls(cs))}


def writers_turns() -> dict:
    """``--lab``'s calls of this checkout timed in turns with the smoke
    run's input writers idle (``quiet``) and busy: every phase's records
    drawn and handed to its writer processes (``write_inputs_ahead``) at
    nice 19, as the smoke run starts them, and at nice 0; the order quiet,
    nice 19, nice 0, quiet. A busy turn times the calls once the draws are
    done and records how many of the writes were still running or queued
    when its timing ended."""
    sys.path.insert(0, HERE)
    import chip_smoke as cs  # by name: the spawned writers import it so

    cs.build.build()
    calls = _lab_calls(cs)
    work = os.path.join(HERE, "_ab_work", "writers")
    out = {"card": cs.nvidia_smi(), "turns": []}
    try:
        for turn, nice in (("quiet", None), ("nice 19", 19), ("nice 0", 0), ("quiet", None)):
            if nice is not None:
                shutil.rmtree(work, ignore_errors=True)
                cs.start_writers(nice=nice)
                cs.write_inputs_ahead(work)
            rec = {"turn": turn, "times": _time_calls(cs, calls)}
            if nice is not None:
                rec["writes_unfinished"] = sum(not f.done() for f in cs._written.values())
                rec["writes"] = len(cs._written)
                cs.stop_writers()
            out["turns"].append(rec)
    finally:
        cs.stop_writers()
        shutil.rmtree(os.path.join(HERE, "_ab_work"), ignore_errors=True)
    return out


def _last_line(args, cwd):
    """Run this script with ``args`` in a process of its own: (exit code,
    its last line of output), its output passed on to stderr on failure."""
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), *args],
                          capture_output=True, text=True, cwd=cwd)
    if proc.returncode != 0:
        sys.stderr.write(proc.stdout + proc.stderr)
        return proc.returncode, None
    return 0, proc.stdout.strip().splitlines()[-1]


def main(argv) -> int:
    if argv == ["--writers"]:
        print(json.dumps(writers_turns()), flush=True)
        return 0
    if len(argv) == 3 and argv[0] == "--worker" and argv[2] == "--lab":
        print(json.dumps(lab_worker(argv[1])), flush=True)
        return 0
    if len(argv) >= 2 and argv[0] == "--worker":
        inputs = json.loads(argv[2]) if len(argv) > 2 else None
        print(json.dumps(worker(argv[1], inputs)), flush=True)
        return 0
    if len(argv) == 2 and argv[0] == "--prepare":
        print(json.dumps(prepare(argv[1])), flush=True)
        return 0
    train = bool(argv) and argv[0] == "--train"
    lab = bool(argv) and argv[0] == "--lab"
    roots = argv[1:] if train or lab else argv
    if not roots:
        print(__doc__, file=sys.stderr)
        return 2
    extra = ["--lab"] if lab else []
    if train:
        code, line = _last_line(["--prepare", os.path.join(HERE, "_ab_work")], HERE)
        if code:
            return code
        print(line, flush=True)
        extra = [line]
    try:
        for root in roots:
            root = os.path.abspath(root)
            code, line = _last_line(["--worker", root, *extra], root)
            if code:
                return code
            print(line, flush=True)
    finally:
        if train:
            shutil.rmtree(os.path.join(HERE, "_ab_work"), ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
