#!/usr/bin/env python3
"""Planted faults against the GAME-training gates of ``chip_smoke.py``.

    python3 chip_game_faults.py

Phase 5c of ``chip_smoke.py`` holds the port's GAME training on the card to
the same run on the CPU: the same best combo, per-update objectives within
``GAME_TRAIN_OBJECTIVE_RTOL`` relative, the fixed effect within 1e-6 of
max(1, |w|inf), the random-effect table within 1e-6 of its scale and the
validation AUC within 1e-6. This script reads how far from the CPU run a
healthy card run lands and how far runs with a planted fault land, on
phase 5c's inputs and configuration: once on the CPU, then on the card
healthy and with each fault. The faults are planted at run time, in this
process; no file of the package changes:

- ``bucket_f32``: the per-user coordinate's largest size bucket (the most
  entities) is solved in float32, its result cast back to float64;
- ``bucket_stale``: on the last pass of each combo, that bucket's lanes
  keep the coefficients they had before the update;
- ``lane_stale``: the same for that bucket's first lane alone, one
  entity.

Prints one JSON line per card run (the readings of
``chip_smoke.game_train_gaps`` and the gates they break), the card's name
and power limit, and last ``{"ok": true}`` when every faulted run breaks
a gate and the healthy run breaks none. Needs one CUDA device and
``nvcc``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import sys
import time

import torch

import chip_smoke
from photon_ml_tpu_torch.cli.game_train import run_game_training
from photon_ml_tpu_torch.game.coordinates import RandomEffectCoordinate
from photon_ml_tpu_torch.game.data import RandomEffectDesign
from photon_ml_tpu_torch.kernels import build

FAULTS = (None, "bucket_f32", "bucket_stale", "lane_stale")


def plant(fault: str):
    """Install ``fault`` in every random-effect coordinate built from now
    on; returns the function that takes it out."""
    init = RandomEffectCoordinate.__init__

    def faulty_init(self, *args, **kwargs):
        init(self, *args, **kwargs)
        target = max(self.design.buckets, key=lambda b: b.num_entities)
        solve, passes = self._solve, [0]

        def faulty_solve(w0, lams, design, offsets):
            if design is not target:
                return solve(w0, lams, design, offsets)
            passes[0] += 1
            if fault == "bucket_f32":
                narrow = RandomEffectDesign(*(
                    t.float() if t.is_floating_point() else t
                    for t in (design.features, design.labels, design.weights, design.mask,
                              design.row_index)))
                result = solve(w0.float(), lams, narrow, offsets.float())
                return dataclasses.replace(result, w=result.w.to(w0.dtype))
            result = solve(w0, lams, design, offsets)
            if passes[0] < chip_smoke.GAME_TRAIN_ITERATIONS:
                return result
            if fault == "bucket_stale":
                return dataclasses.replace(result, w=w0)
            w = result.w.clone()
            w[0] = w0[0]
            return dataclasses.replace(result, w=w)

        self._solve = faulty_solve

    RandomEffectCoordinate.__init__ = faulty_init
    return lambda: setattr(RandomEffectCoordinate, "__init__", init)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_game_faults: no CUDA device; this run needs one card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    build.build()
    work = os.path.join(chip_smoke.ROOT, "_smoke_work", "game_faults")
    shutil.rmtree(work, ignore_errors=True)
    ok = True
    try:
        (gpath, upath), (train, heldout), _ = chip_smoke.write_game_training_inputs(
            work, chip_smoke.TRAIN_RECORDS, chip_smoke.HELDOUT_RECORDS, chip_smoke.D_HASHED,
            chip_smoke.GAME_TRAIN_USERS)
        chip_smoke.wait_written(train, heldout)
        chip_smoke.stop_writers()
        params = chip_smoke.game_train_params(work, train, heldout, gpath, upath)
        t0 = time.perf_counter()
        cpu = run_game_training({**params, "output_dir": os.path.join(work, "cpu")},
                                device="cpu")
        chip_smoke.log(f"[faults] the CPU run took {time.perf_counter() - t0:.2f} s")
        for fault in FAULTS:
            undo = plant(fault) if fault else (lambda: None)
            try:
                t0 = time.perf_counter()
                run = run_game_training(
                    {**params, "output_dir": os.path.join(work, fault or "healthy")})
                wall_s = time.perf_counter() - t0
            finally:
                undo()
            gaps = chip_smoke.game_train_gaps(run, cpu)
            broken = chip_smoke.game_train_gate_failures(gaps)
            ok = ok and (bool(broken) if fault else not broken)
            chip_smoke.log(json.dumps({"fault": fault, "wall_s": wall_s,
                                       "gates_broken": broken, **gaps}))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    chip_smoke.log(chip_smoke.nvidia_smi())
    print(json.dumps({"ok": ok}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
