#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Needs one CUDA device and ``nvcc``; exits non-zero without them, and
whenever any phase fails. Phases, in order:

1. device: the card's name and power limit (``nvidia-smi``);
2. build: every CUDA kernel of the port, from ``photon_ml_tpu_torch/
   kernels/csrc``, one ``nvcc`` per source, all at once; then every driver
   phase's records drawn (in each phase's order, from its seeds) and
   handed to 4 worker processes at nice 19, which encode and write them
   with the Python codec while phases 3-4b hold the card
   (``write_inputs_ahead``);
   each phase waits for its own files;
3. kernel: ``ell_matvec`` against its plain PyTorch version on the card at
   n = 2^22 rows, k = 40 slots, d = 2^20 columns, with padding slots and
   duplicate ids, for (f64, f64), (f32, f32) and (bf16, f32); times of the
   kernel, the plain version and ``torch.mv`` on a CSR tensor of the same
   matrix (a yardstick the port never calls), against the HBM bound;
4. kernel: the training kernels against their plain versions at the same
   shape — ``ell_scatter_add`` (f64, f32 updates; yardstick
   ``index_add_``), ``fused_vgc`` (logistic loss; beside it a composite of
   library calls: ``torch.mv`` on CSR for z, the elementwise loss terms,
   ``torch.mv`` on the transposed CSR for X^T a), ``fused_hvp`` (beside
   it a composite: ``torch.mv`` on CSR, elementwise,
   ``torch.mv`` on the transposed CSR) and ``fused_hdiag`` (logistic loss;
   beside it a composite: ``torch.mv`` on CSR, the curvature, ``torch.mv``
   on the transposed CSR of the squares and of the values, a sum) in the
   three dtype pairs — with times against the HBM bound, the fused passes
   held to their plain versions in the compute type and in f64, and every
   output (the scalars and the (d,) column sums) to the same bits over 3
   calls; the column-sorted reduce (``colsort_reduce``, the X^T side of
   the fused passes, ``ell_rmatvec`` and ``ell_colsum``) in its linear and
   pair modes against its plain version summed in f64, to the same bits
   over 3 calls, timed beside ``torch.mv`` on the transposed CSR, with the
   design's column-sorted copy built and timed on its own; then
   ``ell_scatter_add``, ``fused_vgc``, ``fused_hvp``, ``fused_hdiag`` (f64,
   f32) and the reduce again on the same design with 14 columns named by
   every row (the Criteo layout's hot columns);
4b. lab: the port's sparse kernel lab (``photon_ml_tpu_torch.benchmarks.
   sparse_kernel_lab.main``) at its defaults, n = 200,000, k = 32,
   d = 120,000 with Zipf(1.1) column ids, counters set to 0 just before
   and read just after; then ``lane_gather`` and ``onehot_gather`` held to
   their plain versions bit for bit, ``onehot_reduce`` within 1e-6 of each
   column's sum of |upd| of the plain version summed in f64 and to the
   same bits over 3 calls, C1's z and C2's g to ``ell_matvec`` and
   ``ell_scatter_add`` within 1e-6 of the scale; each timed beside
   ``torch.gather``, a ``torch.take`` composite and ``index_add_`` (the
   host's part of a call too, the library call's beside the kernel's);
   ``onehot_reduce``'s output in recycled NaN memory with every column no
   entry names exactly 0.0, its device operations timed apart under
   ``torch.profiler`` and a sweep of its chunk of tiles per block (each
   chunk held to the plain version as above); then ``onehot_reduce`` and
   ``onehot_gather`` on the uniform design of phase 3 (f32) with the same
   checks, beside ``ell_scatter_add``, ``index_add_`` and ``torch.mv`` on
   the transposed CSR (built untimed) on it, the layout, its sort and the
   ``a[row]`` gather timed apart;
5. score: the port's GLM scoring driver (``run_scoring``, sparse, with
   evaluation) end to end at the Criteo Terabyte width — 13 integer and
   26 categorical fields hashed into 2^20 columns plus the intercept —
   on 2^15 synthetic records made from a seed, with every launch counter
   set to 0 just before and read just after; the kernel against its plain
   version at the shape the driver gave it; then the same run again under
   ``torch.profiler`` for the card's busy and idle share;
5b. GAME score: the port's scoring driver with ``model_kind="game"`` on a
   model written by the port's ``save_game_model`` from seeded numpy —
   ``global``, a fixed effect on the Criteo layout (ELL, ``ell_matvec``);
   ``per-user``, a random effect on a 20,000-column sparse shard, 4,096
   users with a private pool of 25 columns each, 5 per row (the compact
   join); ``per-ad``, a dense random effect on the 13 integer fields plus
   the intercept, 1,024 ads; ``per-ad-latent``, a factored one on the same
   type and shard, latent dimension 8, holding another random half of the
   2,048 ads — on 30,000 records padded to the 2^15 bucket (1/16 with a
   user the model lacks, 1/32 without an ad), counters set to 0 just
   before and read just after (``ell_matvec`` exactly 1, every other
   kernel 0); the phase seconds; the same run under ``torch.profiler``;
   then the driver on the CPU: scores within 1e-10 max(1, |s|), every
   metric within 1e-10 and the same uids in order, and the scores within
   1e-10 of the generator's own numpy margins; ``ell_matvec`` against its
   plain version and timed beside ``torch.mv`` on CSR at the driver's
   shape (n = 2^15, k = 40, d = 2^20 + 1);
5f. online serving, on phase 5b's model directory and records (run right
   after 5b): ``ScoringEngine.from_model_dir`` in float64 on the card,
   the 8-64 ladder and its degraded ladder built (8 builds, the warmup
   seconds, the resident entity bytes and the ``hbm.serving.warmup``
   gauges printed); 4,096 of the records as ``ScoreRequest``s from their
   raw feature keys, entity ids and offsets, in calls of mixed size 1-64,
   every score within 1e-10 max(1, |s|) of 5b's card scores, per bucket
   the p50/p99 of ``featurize``, of the engine's bucket latency (copy in,
   device, copy out) and of the whole call, and no build and no new CUDA
   memory segment after warmup; 1,024 of them through ``MicroBatcher``
   (64 rows, 2 ms) from 8 closed-loop clients (requests/s, p50/p99, every
   answer the direct engine's); ``ModelRegistry`` hot reload to the model
   re-saved with every coefficient halved, under the same load (no
   dropped request, every answer one of the two versions'); the tiered
   cache with 512 slots per entity type under Zipf(1.1) users (the hit
   rate; a resident entity scores as uncached, a missed one as cold
   start); ``python -m photon_ml_tpu_torch.cli.serve`` over a pipe (its
   scores the engine's; ``stats``, ``metrics`` and ``health`` answered).
   The engine featurizes densely, as the JAX engine does: 8.55 MB a row,
   so call counts are cut and widths never;
5g. the quality loop (run after phase 7, on phase 6's files):
   ``python -m photon_ml_tpu_torch.cli.build_index`` on phase 6's training
   Avro, in the GLM layout and as a GAME shard with ``--name-prefix``, each
   file byte for byte ``FeatureVocabulary.from_records`` over the same
   file, the native scan's keys equal and its codec native; the GLM driver
   on that index with the quality fingerprint (the default), counters set
   to 0 just before and read just after (``ell_matvec``: two per lambda
   and the fingerprint's one), its fingerprint's rows, label and feature
   sketches equal to the same ingest on the CPU and its margin sketch's
   moments within 1e-9 of the same model's margins there; the GAME driver
   at phase 5c's layout on 2^13 + 2^11 records with the global shard
   without a feature file (the from-records vocabulary, the records' own
   keys), counted as 5c's plus the fingerprint's pass, a fingerprint in
   every export subdir (the fixed effect at phase 5c's tolerance, 1e-15);
   the same GAME run again with ``hot_columns: -1`` on ``global`` (a
   hybrid design inside the fixed effect), held to the ELL run: the same
   best combo, per-update objectives within 1e-7 relative, the per-user
   table within 1e-6 of its scale, and its launches to its solves and
   split (one ``ell_matvec`` per cold segment per margins pass, one
   reduce per segment that holds an entry per X^T pass); that export
   through ``ScoringEngine.from_model_dir``
   (its drift monitor set from the fingerprint): the training records in
   calls of 64, every drift check under the 0.25 PSI alarm (features and
   scores), their served scores' moments within 1e-9 of the
   fingerprint's margins, then the held-out records (their drift
   reported), no build and no new CUDA segment after warmup, all their
   labels fed back into the online-quality window (its AUC within 1e-12
   of the exact AUC), then
   4,096 of them with one integer field planted 4x through the
   micro-batcher from 8 closed-loop clients, which must raise the alarm;
   and ``cli.serve`` over a pipe answering ``feedback``, ``quality`` and
   ``drift``;
5c. GAME train: the port's GAME training driver (``run_game_training``)
   in the configuration of ``examples/game_train.json`` at the Criteo
   layout's width — ``global``, a fixed effect on the 13 + 26 hashed
   fields in 2^20 + 1 columns (ELL: TRON, lambda 1, tolerance 1e-15, 100
   iterations at most), ``per-user``, a random effect on the 13 integer
   fields plus the intercept (dense, d = 14: TRON, lambda in {10, 1},
   tolerance 1e-8, 20 iterations, 2 size buckets) — 3 passes per combo,
   float64, validation after every update, BEST output, on 2^15 training
   and 2^13 held-out records (cut from 2^16 and 2^14 so that phase 5d fits
   the run's time) drawn as phase 6's with a userId drawn
   Zipf(1.1) over 4,096 users and labels from a seeded global model plus
   per-user models; counters set to 0 just before and read just after,
   held to the trainer's own counts (``fused_vgc`` to the fixed effect's
   evaluations, ``fused_hvp`` to its CG steps, ``ell_matvec`` to the
   initial scores, rescores and validations; every other kernel 0); the
   descent alone (ingest excluded) under ``torch.profiler``, its per-update
   objectives beside the first run's (the card against itself); the
   descent again with ``examples/game_train.json``'s own solver settings
   (the fixed effect at lambda 0.1, 20 iterations, tolerance 1e-8), timed,
   traced and its launches held to its own counts; then the driver on the
   CPU: the same best combo, per-update objectives within
   1e-7 relative, the fixed effect within 1e-6 max(1, |w|inf), the
   random-effect table within 1e-6 of its scale, validation AUC within
   1e-6, the count of entity updates whose iterations differ printed;
   ``fused_vgc`` and ``fused_hvp`` held to their plain versions on the
   last fixed-effect update's batch and offsets;
5d. GAME train, projected and factored: the same driver on phase 5c's
   records at 2^16 + 2^14 with a 20,000-column sparse per-user shard
   (phase 5b's layout) and an adId drawn uniformly over 1,024 ads, 2
   passes per combo, validation after every update, ``checkpoint_every``
   1 — ``global`` at phase 5c's check settings but lambda 10;
   ``per-user-wide``, the userId effect on the sparse shard through
   ``INDEX_MAP`` (``examples/run_wide_game.sh``'s settings: ``min_support`` 1, TRON,
   lambda 1, 30 iterations, 1e-8); ``per-ad``, the adId effect on the 13
   integer fields plus the intercept through ``RANDOM=8`` (NEWTON, lambda
   in {10, 1}); ``per-user-latent``, a factored userId effect on the same
   shard (latent 8, OWL-QN for gamma at lambda 100 and for B at lambda
   300, tolerance 1e-15, 1,000 iterations at most) —
   counters set to 0 just before and read just after, held to the
   trainer's counts; a run preempted by SIGTERM after its first pass
   (``preempted.json``, no model) and resumed, held to the first run with
   the card-against-CPU gates; the descent alone under ``torch.profiler``;
   the driver on the CPU: the same best combo, per-update objectives
   within 1e-7 relative, the fixed effect, each random-effect table in the
   original space and gamma and B apart within 1e-6 of their scales, the
   INDEX_MAP table's nonzero pattern equal, validation AUC within 1e-6;
   the saved model scored by the GAME scoring driver within 1e-10
   max(1, |s|) of the training's own model, and its tables and the
   factored effect through ``save_mf_model`` / ``load_mf_model`` read
   back bit for bit;
5e. determinism at the settings users run: phase 5d's records and
   coordinates with ``examples/run_wide_game.sh``'s lambda 1 for
   ``global`` (TRON, 30 iterations, 1e-8) and ``per-user-wide``, and the
   factored effect at lambda 1 for gamma and B, 100 iterations at most:
   two runs on the card, then one preempted by SIGTERM after its first
   pass and resumed, all three bit for bit equal (every update's objective
   and AUC, every combo's tables in memory, the saved tables read back,
   the MF files); no CPU reference (the GLM half, two training runs with
   the same w bits, runs in phase 6 on its design);
6. train: the port's GLM training driver (``run_glm_training``, sparse
   TRON, L2 logistic, lambda in {10, 1}, float64, with validation) on 2^16
   Criteo-layout records and 2^14 held-out ones, counters set to 0 just
   before and read just after; the launch counts held to the solver's
   iteration and CG counts; coefficients and held-out AUC held to
   ``train_glm`` on the same batch on the CPU; phase seconds and host
   syncs per iteration; every kernel (``ell_matvec`` with ``torch.mv`` on
   CSR beside it, ``fused_hvp`` with its composite) checked and timed at
   the shape the training driver gave them, the fused passes' outputs
   held to the same bits over 3 calls, and the host's part of each call
   timed beside the card's; then the same run under ``torch.profiler``,
   whose w must equal the first run's bit for bit at every lambda (phase
   5e's GLM gate);
7. full trainer: on the same records, each run with the counters set to 0
   just before and read just after, and each held to the same training on
   the CPU (the same convergence reason; coefficients within 1e-6 max(1,
   |w|inf), variances within 1e-6 relative, held-out AUC within 1e-6, the
   same nonzero coefficients; for the first-order runs B and C, where the
   card's trajectory may split from the CPU's on the atomics' last bits,
   a split is recorded and held to the objective within 2e-4 relative and
   the held-out AUC within 1e-3):
   A. ``run_glm_training``, TRON, L2, lambda in {10, 1},
      ``compute_variances`` (one ``fused_hdiag`` per lambda),
      ``diagnostics`` and ``training_diagnostics`` (model-diagnostic.html);
   B. ``run_glm_training``, L-BFGS with ELASTIC_NET (alpha 0.5, OWL-QN),
      lambda in {10, 1}, ``compute_variances``, 100 iterations at most;
   C. ``train_glm`` in memory: L-BFGS L2 with a constraint file boxing
      the 13 integer-field coefficients;
   D. ``train_glm`` in memory: NEWTON on the dense intercept + 13 integer
      fields (d = 14) of the training records;
   with the variance pass timed on the card at the driver's shape;
6h. hybrid designs (run after phase 7, on phase 6's files): phase 6's
   driver with ``hot_columns`` -1 (the JAX package's split sized by column
   counts) and 14 (the intercept and the 13 integer fields), each held to
   phase 6's CPU models at phase 6's gates, its launches held to its
   solves and its splits (``hybrid_expected_launches``), with H, each
   segment's width and rows, the stored cold entries, the padded slots
   and the solve seconds per lambda beside phase 6's printed; the
   14-column run again under ``torch.profiler`` (the busy share), which
   must end with the first run's w bits; then, for each split, each
   segment's column-sorted copy built and timed, ``ell_matvec`` and the
   reduce at the widest segment's shape held to their plain versions and
   timed, the slab's ``torch.matmul`` both ways, the whole hybrid
   ``matvec`` / ``rmatvec``, and the adds of the segments' (d,) outputs;
8. the ``{"kernels": [...]}`` line, the ``nvidia-smi`` line, and last the
   ``{"ok": true, "device": ...}`` line.

Every driver run of phases 5-7 must read (and write) its Avro through the
native C++ codec (``run.codecs``): a phase whose codec fell back to the
Python one fails. ``determinism_probe`` (not a phase) runs phase 5e's
GAME configuration and phase 6's GLM training under
``torch.use_deterministic_algorithms(True, warn_only=True)`` and lists
what PyTorch reports as nondeterministic.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import shutil
import signal
import subprocess
import sys
import time

import numpy as np
import torch

from photon_ml_tpu_torch.cli import game_train as game_train_mod
from photon_ml_tpu_torch.cli.game_train import build_coordinates, run_game_training
from photon_ml_tpu_torch.cli.score import run_scoring
from photon_ml_tpu_torch.cli.train import run_glm_training, write_model_text
from photon_ml_tpu_torch.core.tasks import TaskType
from photon_ml_tpu_torch.core.types import Coefficients, LabeledBatch
from photon_ml_tpu_torch.game.coordinates import FixedEffectCoordinate
from photon_ml_tpu_torch.game.data import GameData
from photon_ml_tpu_torch.game.descent import CoordinateDescent
from photon_ml_tpu_torch.game.factored import FactoredParams, MatrixFactorizationModel
from photon_ml_tpu_torch.game.scoring import score_game_data
from photon_ml_tpu_torch.io.avro import read_avro_file, write_avro_file
from photon_ml_tpu_torch.io.ingest import IngestSource
from photon_ml_tpu_torch.io.models import (
    load_game_model,
    load_mf_model,
    save_game_model,
    save_glm_model,
    save_mf_model,
)
from photon_ml_tpu_torch.io.schemas import TRAINING_EXAMPLE_SCHEMA
from photon_ml_tpu_torch.io.vocab import FeatureVocabulary, feature_key
from photon_ml_tpu_torch.benchmarks import sparse_kernel_lab
from photon_ml_tpu_torch.kernels import build, dispatch
from photon_ml_tpu_torch.kernels.ell import (
    ell_matvec,
    ell_matvec_reference,
    ell_scatter_add,
    ell_scatter_add_reference,
)
from photon_ml_tpu_torch.kernels.fused import (
    fused_hessian_diagonal,
    fused_hessian_diagonal_reference,
    fused_hessian_vector,
    fused_hessian_vector_reference,
    fused_value_grad_curvature,
    fused_value_grad_curvature_reference,
)
from photon_ml_tpu_torch.kernels.lab import (
    LAB_BLOCK,
    column_sorted_tiles,
    lane_gather,
    lane_gather_reference,
    onehot_gather,
    onehot_gather_reference,
    onehot_reduce,
    onehot_reduce_reference,
)
from photon_ml_tpu_torch.io.constraints import load_constraint_bounds
from photon_ml_tpu_torch.models.training import GLMTrainingConfig, OptimizerType, train_glm
from photon_ml_tpu_torch.ops import metrics as metrics_mod
from photon_ml_tpu_torch.ops.losses import LOGISTIC_LOSS
from photon_ml_tpu_torch.ops.objective import GLMObjective, RegularizationContext
from photon_ml_tpu_torch.ops.sparse import (
    cast_values,
    cold_padded_slots,
    from_coo,
    matvec,
    rmatvec,
    stored_cold_entries,
    to_hybrid,
)
from photon_ml_tpu_torch.kernels import colsort
from photon_ml_tpu_torch.resilience import GracefulShutdown, read_preempted_marker
from photon_ml_tpu_torch import obs
from photon_ml_tpu_torch.obs import quality as quality_mod
from photon_ml_tpu_torch.obs.sketches import MomentSketch
from photon_ml_tpu_torch.io.models import write_model_manifest
from photon_ml_tpu_torch.serving import (
    MicroBatcher,
    ModelRegistry,
    ScoreRequest,
    ScoringEngine,
    ServingStats,
    bucket_builds,
)
from photon_ml_tpu_torch.serving.engine import bucket_size
from photon_ml_tpu_torch.solvers import host_reads, reset_host_reads
from photon_ml_tpu_torch.utils.device import synchronize

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
# end-to-end depth (the pure-Python Avro codec); scoring cut to 2^15 for the
# full trainer's time
SCORE_RECORDS = 1 << 15
TRAIN_RECORDS = 1 << 16
HELDOUT_RECORDS = 1 << 14
TRAIN_LAMBDAS = [10.0, 1.0]
# converged far past the default 1e-7, so that the card's run and the
# CPU's, whose last bits differ (atomics), meet within 1e-6 in w
TRAIN_TOLERANCE = 1e-12
TRAIN_MAX_ITERS = 100

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
    """Median of ``runs`` CUDA-event timings of ``fn`` after warm-up (the
    lab's timer, so that its lines and this script's records agree)."""
    return sparse_kernel_lab.time_call(fn, torch.device("cuda"), warmup, runs)[0]


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


def device_ms(fn, runs: int = 20, spin_cycles: int = 200_000_000):
    """(device ms, host ms) per call of ``fn``, calls back to back: the card
    first spins (``torch.cuda._sleep``, about 0.1 s) while the host queues
    ``runs`` calls, so the events around them time the card's work alone,
    and the host's clock around the queueing times the host's part of a
    call (the wrapper and its launches). ``time_ms``'s events around one
    call count both, and the host's part sets the pace of a short call.
    Raises if the host took longer to queue the calls than the card spun."""
    fn()
    torch.cuda.synchronize()
    events = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    events[0].record()
    torch.cuda._sleep(spin_cycles)
    events[1].record()
    t0 = time.perf_counter()
    for _ in range(runs):
        fn()
    queued_ms = (time.perf_counter() - t0) * 1e3
    events[2].record()
    events[2].synchronize()
    if queued_ms >= events[0].elapsed_time(events[1]):
        raise AssertionError(f"device_ms: queueing {runs} calls took {queued_ms:.1f} ms, "
                             "longer than the card's spin")
    return events[1].elapsed_time(events[2]) / runs, queued_ms / runs


def timed_record(kernel, dtype_label, cd, max_err, fn, plain_fn, nbytes, ops, peaks,
                 shape, label, lib_fn=None, lib_name="index_add_", composite=None):
    """Time ``fn``, its plain version, the library call (if any) and a
    composite of library calls (``(name, fn)``, if any), and return the
    kernel's record against its bound, with the device time per call of
    the kernel, the library call and the composite, and the host's time
    per call of the kernel and the library call, beside."""
    kernel_ms = time_ms(fn)
    plain_ms = time_ms(plain_fn)
    library_ms = None if lib_fn is None else time_ms(lib_fn)
    kernel_device_ms, kernel_host_ms = device_ms(fn)
    library_device_ms, library_host_ms = (None, None) if lib_fn is None else device_ms(lib_fn)
    composite_ms = composite_device_ms = None
    if composite is not None:
        composite_ms = time_ms(composite[1])
        composite_device_ms = device_ms(composite[1])[0]
    bound_ms, bound_by = bound(nbytes, ops, cd, peaks)
    src, replaces = SOURCES[kernel]
    lib = ("" if library_ms is None else
           f", {lib_name} {library_ms:.4f} ms (device {library_device_ms:.4f} ms, host "
           f"{library_host_ms:.4f} ms)")
    if composite is not None:
        lib += (f", composite {composite[0]} {composite_ms:.4f} ms (device "
                f"{composite_device_ms:.4f} ms)")
    log(f"[{label}] {kernel} {dtype_label}: kernel {kernel_ms:.4f} ms (device "
        f"{kernel_device_ms:.4f} ms, host {kernel_host_ms:.4f} ms), plain {plain_ms:.4f} ms"
        f"{lib}, bound {bound_ms:.4f} ms ({bound_by}); max |kernel - plain| {max_err:.3e}")
    return {
        "name": kernel, "dtype": dtype_label, "route": "cuda", "source": src,
        "replaces": replaces, "shape": shape, "max_abs_err": max_err, "ms": kernel_ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": library_ms, "device_ms": kernel_device_ms, "host_ms": kernel_host_ms,
        "library_device_ms": library_device_ms, "library_host_ms": library_host_ms,
        "composite": None if composite is None else composite[0],
        "composite_ms": composite_ms, "composite_device_ms": composite_device_ms,
        "bytes": nbytes, "ops": ops,
    }


def matvec_checks(idx, vals64, d, w64, peaks, label="kernel"):
    """Check and time ell_matvec on one design in the three type pairs,
    against its plain version and ``torch.mv`` on a CSR tensor of the same
    matrix. Returns one record per type pair."""
    n, k = idx.shape
    valid_slots = int(((idx >= 0) & (idx < d)).sum())
    results = []
    for dtype_label, vdt, wdt, rtol in DTYPE_CASES:
        vals, w, got, max_err, ok = check_kernel(idx, vals64, d, vdt, wdt, rtol, w64)
        log(f"[{label}] ell_matvec {dtype_label}: max |kernel - plain| = {max_err:.3e} "
            f"(rtol {rtol:g} x row sum of |v w|): {'ok' if ok else 'DISAGREES'}")
        if not ok:
            raise AssertionError(f"ell_matvec {dtype_label} disagrees with its plain version")
        # library yardstick: torch.mv on CSR (bf16 values upcast to f32 once,
        # outside the timing: the sparse product takes one dtype)
        csr = csr_of(idx, vals.to(got.dtype), d)
        w_lib = w.to(got.dtype)
        lib_err = float((torch.mv(csr, w_lib).double() - got.double()).abs().max())
        rec = timed_record(
            "ell_matvec", dtype_label, got.dtype, max_err,
            lambda: ell_matvec(idx, vals, w, d),
            lambda: ell_matvec_reference(idx, vals, w, d),
            n * k * (4 + vals.element_size()) + d * w.element_size() + n * got.element_size(),
            2 * valid_slots, peaks, {"n": n, "k": k, "d": d}, label,
            lambda: torch.mv(csr, w_lib), "torch.mv(CSR)",
        )
        rec["library_max_abs_diff"] = lib_err
        results.append(rec)
        del vals, w, got, csr, w_lib
        torch.cuda.empty_cache()
    return results


def kernel_phase(name: str, n: int = KERNEL_ROWS, d: int = D_HASHED, k: int = K):
    idx, vals64 = make_ell(n, k, d, "cuda")
    g = torch.Generator(device="cuda").manual_seed(SEED + 1)
    w64 = torch.randn(d, generator=g, device="cuda", dtype=torch.float64)
    results = matvec_checks(idx, vals64, d, w64, peaks_for(name))
    del idx, vals64, w64
    torch.cuda.empty_cache()
    return results


# -- phase 4: the training kernels against their plain versions --------------

# (values dtype, compute dtype, rtol against the plain version in the
# compute type, rtol against the plain version in f64) for the fused
# passes: in f32 the plain version's own rounding takes more of the scale
# than the kernel's, so the kernel's own error is held to 1e-6 against f64
FUSED_CASES = [
    ("f64", torch.float64, torch.float64, 1e-12, 1e-12),
    ("f32", torch.float32, torch.float32, 1e-5, 1e-6),
    ("bf16xf32", torch.bfloat16, torch.float32, 1e-2, 1e-2),
]
SCATTER_CASES = [("f64", torch.float64, 1e-12), ("f32", torch.float32, 1e-5)]
SOURCES = {
    "ell_matvec": ("photon_ml_tpu_torch/kernels/csrc/ell_matvec.cu",
                   "photon_ml_tpu/kernels/ell.py:115"),
    "ell_scatter_add": ("photon_ml_tpu_torch/kernels/csrc/ell_scatter_add.cu",
                        "photon_ml_tpu/kernels/ell.py:166"),
    "fused_vgc": ("photon_ml_tpu_torch/kernels/csrc/fused.cu",
                  "photon_ml_tpu/kernels/fused.py:120"),
    "fused_hvp": ("photon_ml_tpu_torch/kernels/csrc/fused.cu",
                  "photon_ml_tpu/kernels/fused.py:185"),
    "fused_hdiag": ("photon_ml_tpu_torch/kernels/csrc/fused.cu",
                    "photon_ml_tpu/kernels/fused.py:245"),
    "lane_gather": ("photon_ml_tpu_torch/kernels/csrc/lab.cu",
                    "benchmarks/sparse_kernel_lab.py:130"),
    "onehot_gather": ("photon_ml_tpu_torch/kernels/csrc/lab.cu",
                      "benchmarks/sparse_kernel_lab.py:229"),
    "onehot_reduce": ("photon_ml_tpu_torch/kernels/csrc/lab.cu",
                      "benchmarks/sparse_kernel_lab.py:288"),
    # the X^T side of rows 3-5 (and of ell_rmatvec / ell_colsum), on row
    # 8's scheme
    "colsort_reduce": ("photon_ml_tpu_torch/kernels/csrc/colsort.cuh",
                       "photon_ml_tpu/kernels/fused.py:185"),
}
# the X^T sides the column-sorted reduce replaces: the Pallas kernels'
# scatters, each file:line
REDUCE_REPLACES = ["photon_ml_tpu/kernels/fused.py:120", "photon_ml_tpu/kernels/fused.py:185",
                   "photon_ml_tpu/kernels/fused.py:245", "photon_ml_tpu/kernels/ell.py:191",
                   "photon_ml_tpu/kernels/ell.py:204"]
# the wrappers that launch the column-sorted reduce, once per call
REDUCE_CALLERS = ("fused_vgc", "fused_hvp", "fused_hdiag", "ell_rmatvec", "ell_colsum")


def with_reduce(expected: dict) -> dict:
    """A run's expected launches with the column-sorted reduce's: one per
    fused pass and per ``ell_rmatvec`` or ``ell_colsum`` call."""
    return {**expected, "colsort_reduce": sum(expected.get(k, 0) for k in REDUCE_CALLERS)}


def require_native(run, label: str) -> None:
    """The ingest gate: every Avro read and write of a driver run went
    through the native codec (a broken build would otherwise hide behind
    the Python codec)."""
    if not run.codecs or any(c != "native" for c in run.codecs.values()):
        raise AssertionError(f"{label}: the run's codecs are {run.codecs}; every read and "
                             f"write must be native")
# columns named by every row in the hot-column scatter case: the Criteo
# layout's intercept and 13 integer fields
HOT_COLUMNS = INT_FIELDS + 1
# operations per row of the loss terms (logistic: a few exp/log1p and
# products), counted at 20; per valid slot: 2 for the margin, 2 for the
# scatter (1 for ell_scatter_add)
LOSS_OPS_PER_ROW = 20


def within(got, ref, scale, rtol):
    """(max |got - ref|, every element within rtol * scale, the largest
    |got - ref| / scale: the share of the stated scale the error took)."""
    err = (got.double() - ref.double()).abs()
    scale = scale.double()
    share = torch.where(err > 0, err / scale, torch.zeros_like(err))
    return (float(err.max()), bool(torch.all(err <= rtol * scale)),
            float(share.max()) if share.numel() else 0.0)


def bound(nbytes, ops, dtype, peaks):
    bytes_ms = nbytes / peaks["hbm"] * 1e3
    ops_ms = ops / peaks["f64" if dtype == torch.float64 else "f32"] * 1e3
    return max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations"


def row_inputs(n, d, cd, device, seed=SEED + 3):
    """Seeded labels, offsets, weights (every 7th row 0, as padding) and
    coefficients for the fused passes."""
    g = torch.Generator(device=device).manual_seed(seed)
    y = torch.randint(0, 2, (n,), generator=g, device=device).double()
    off = 0.1 * torch.randn(n, generator=g, device=device, dtype=torch.float64)
    ew = torch.rand(n, generator=g, device=device, dtype=torch.float64) + 0.5
    ew[::7] = 0.0
    w = 0.2 * torch.randn(d, generator=g, device=device, dtype=torch.float64)
    return tuple(t.to(cd) for t in (y, off, ew, w))


def check_scatter(idx, upd, d, rtol):
    """The kernel against its plain version summed in f64 from the same
    updates: in f32 the plain version's own atomics (65,536 adds into each
    hot column at the driver's shape) are off by more than the tolerance."""
    got = ell_scatter_add(idx, upd, d)
    ref = ell_scatter_add_reference(idx, upd.double(), d)
    col_abs = ell_scatter_add_reference(idx, upd.abs().double(), d)
    return within(got, ref, col_abs, rtol)


def check_vgc(idx, vals, y, off, ew, w, d, rtol):
    """The four outputs against the plain version. Scales: val sum|ew l|;
    grad per column sum|v| (|a| + ew 0.25 row_abs), the second term the
    move of a = ew l'(z) under a margin error of rtol * row_abs (|l''| <=
    0.25); asum sum|a|; c = ew l''(z) per row |c| + ew row_abs (0.25 +
    |l''|), l''' bounded the same way."""
    got = fused_value_grad_curvature(idx, vals, y, off, ew, w, d, LOGISTIC_LOSS)
    ref = fused_value_grad_curvature_reference(idx, vals, y, off, ew, w, d, LOGISTIC_LOSS)
    cd = ref[1].dtype
    v = vals.to(cd)
    z = ell_matvec_reference(idx, v, w, d) + off
    row_abs = ell_matvec_reference(idx, v.abs().double(), w.abs().double(), d) + off.abs().double()
    a_abs = (ew * LOGISTIC_LOSS.d1(z, y)).abs().double()
    a_move = ew.double() * 0.25 * row_abs
    d2 = LOGISTIC_LOSS.d2(z, y).abs().double()
    scales = [
        (ew * LOGISTIC_LOSS.value(z, y)).abs().double().sum(),
        ell_scatter_add_reference(idx, v.abs().double() * (a_abs + a_move)[:, None], d),
        (a_abs + a_move).sum(),
        ref[3].abs().double() + ew.double() * row_abs * (0.25 + d2),
    ]
    errs = [within(g_, r_, s_, rtol) for g_, r_, s_ in zip(got, ref, scales)]
    finite = all(bool(torch.isfinite(t).all()) for t in got)
    # the share against the plain version in f64 on the same inputs: the
    # kernel's own rounding, without the plain version's
    ref64 = fused_value_grad_curvature_reference(
        idx, vals.double(), y.double(), off.double(), ew.double(), w.double(), d, LOGISTIC_LOSS)
    return (max(e for e, _, _ in errs), all(ok for _, ok, _ in errs) and finite,
            max(share for _, _, share in errs),
            max(within(g_, r_, s_, rtol)[2] for g_, r_, s_ in zip(got, ref64, scales)))


def check_hvp(idx, vals, c, v_eff, shift, d, rtol):
    """hv and usum against the plain version (scales: sums of |terms|),
    with the share of the scale against the plain version in f64, as
    ``check_vgc``."""
    hv, usum = fused_hessian_vector(idx, vals, c, v_eff, shift, d)
    ref_hv, ref_usum = fused_hessian_vector_reference(idx, vals, c, v_eff, shift, d)
    zv_abs = (ell_matvec_reference(idx, vals.abs().double(), v_eff.abs().double(), d)
              + shift.abs().double())
    u_abs = c.abs().double() * zv_abs
    hv_scale = ell_scatter_add_reference(idx, vals.abs().double() * u_abs[:, None], d)
    e1, ok1, share1 = within(hv, ref_hv, hv_scale, rtol)
    e2, ok2, share2 = within(usum, ref_usum, u_abs.sum(), rtol)
    hv64, usum64 = fused_hessian_vector_reference(
        idx, vals.double(), c.double(), v_eff.double(), shift.double(), d)
    share64 = max(within(hv, hv64, hv_scale, rtol)[2], within(usum, usum64, u_abs.sum(), rtol)[2])
    return (max(e1, e2), ok1 and ok2 and bool(torch.isfinite(hv).all()), max(share1, share2),
            share64)


def check_hdiag(idx, vals, y, off, ew, w, d, rtol):
    """The three outputs against the plain version: its margins, c and slot
    updates in the compute type, summed in f64, as ``check_scatter`` sums
    the same updates (in f32 the plain version's own index_add_ drifts by
    1e-3 of a column named by all of 2^22 rows). Scales: each output's sum
    of |terms|, with c = ew l''(z) widened by its move under a margin error
    of rtol * row_abs (the logistic loss's third derivative is at most 0.1
    in magnitude); with the share of the scale against the plain version
    in f64, as ``check_vgc``."""
    got = fused_hessian_diagonal(idx, vals, y, off, ew, w, d, LOGISTIC_LOSS)
    v_cd = vals.to(got[0].dtype)
    c = ew * LOGISTIC_LOSS.d2(ell_matvec_reference(idx, v_cd, w, d) + off, y)
    ref = (ell_scatter_add_reference(idx, (v_cd * v_cd * c[:, None]).double(), d),
           ell_scatter_add_reference(idx, (v_cd * c[:, None]).double(), d), c.double().sum())
    v = v_cd.double()
    row_abs = ell_matvec_reference(idx, v.abs(), w.abs().double(), d) + off.abs().double()
    z = ell_matvec_reference(idx, v, w.double(), d) + off.double()
    c_abs = ew.double() * (LOGISTIC_LOSS.d2(z, y.double()).abs() + 0.1 * row_abs)
    scales = [ell_scatter_add_reference(idx, v * v * c_abs[:, None], d),
              ell_scatter_add_reference(idx, v.abs() * c_abs[:, None], d), c_abs.sum()]
    errs = [within(g_, r_, s_, rtol) for g_, r_, s_ in zip(got, ref, scales)]
    finite = all(bool(torch.isfinite(t).all()) for t in got)
    ref64 = fused_hessian_diagonal_reference(
        idx, vals.double(), y.double(), off.double(), ew.double(), w.double(), d, LOGISTIC_LOSS)
    return (max(e for e, _, _ in errs), all(ok for _, ok, _ in errs) and finite,
            max(share for _, _, share in errs),
            max(within(g_, r_, s_, rtol)[2] for g_, r_, s_ in zip(got, ref64, scales)))


def scatter_checks(idx, vals64, d, peaks, label="kernel"):
    """Check and time ell_scatter_add on one design (f64 and f32 updates)
    against its plain version and ``index_add_``. One record per dtype."""
    n, k = idx.shape
    valid = int(((idx >= 0) & (idx < d)).sum())
    flat_ids = torch.where((idx >= 0) & (idx < d), idx, d).reshape(-1).long()
    results = []
    for dtype_label, dt, rtol in SCATTER_CASES:
        upd = vals64.to(dt)
        max_err, ok, share = check_scatter(idx, upd, d, rtol)
        log(f"[{label}] ell_scatter_add {dtype_label}: max |kernel - plain| = "
            f"{max_err:.3e} (rtol {rtol:g} x column sum of |upd|; {share:.2e} of it): "
            f"{'ok' if ok else 'DISAGREES'}")
        if not ok:
            raise AssertionError(f"ell_scatter_add {dtype_label} ({label}) disagrees with "
                                 f"its plain version")
        flat_upd = upd.reshape(-1)
        s = upd.element_size()
        results.append(timed_record(
            "ell_scatter_add", dtype_label, dt, max_err,
            lambda: ell_scatter_add(idx, upd, d),
            lambda: ell_scatter_add_reference(idx, upd, d),
            n * k * (4 + s) + d * s, valid, peaks, {"n": n, "k": k, "d": d}, label,
            lambda: torch.zeros(d + 1, dtype=dt, device=idx.device).index_add_(
                0, flat_ids, flat_upd),
        ))
        results[-1]["max_err_share"] = share
        del upd, flat_upd
    del flat_ids
    torch.cuda.empty_cache()
    return results


def csr_t_of(idx: torch.Tensor, vals: torch.Tensor, d: int) -> torch.Tensor:
    """The ELL's transpose, (d, n), as a CSR tensor without its padding
    slots; a stable sort by column keeps each column's rows in order."""
    keep = idx < d
    n = idx.shape[0]
    rows = torch.arange(n, device=idx.device)[:, None].expand_as(idx)[keep]
    cols = idx[keep].long()
    order = torch.argsort(cols, stable=True)
    crow = torch.zeros(d + 1, dtype=torch.int64, device=idx.device)
    crow[1:] = torch.cumsum(torch.bincount(cols, minlength=d), 0)
    return torch.sparse_csr_tensor(crow, rows[order], vals[keep][order], size=(d, n))


# the fused passes' yardsticks: no single PyTorch call computes a pass, so
# a composite of library calls the port never uses (bf16 values upcast once)
VGC_COMPOSITE = ("z = torch.mv(X_csr, w) + off; l, l', l'' elementwise; sum(ew * l), "
                 "torch.mv(XT_csr, ew * l'), sum(ew * l'), ew * l''")
HVP_COMPOSITE = "torch.mv(XT_csr, c * (torch.mv(X_csr, v) + shift)), three calls"
HDIAG_COMPOSITE = ("c = ew * l''(torch.mv(X_csr, w) + off); torch.mv(X2T_csr, c), "
                   "torch.mv(XT_csr, c), c.sum()")


def same_bits(fn, outputs, calls: int = 3) -> bool:
    """``fn``'s outputs (indices into its result: the scalars and the (d,)
    column sums) have the same bits over ``calls`` calls."""
    first = fn()
    return all(torch.equal(first[i], again[i])
               for again in (fn() for _ in range(calls - 1)) for i in outputs)


def fused_checks(idx, vals64, d, peaks, label, cases=None):
    """Check and time fused_vgc, fused_hvp and fused_hdiag (each with a
    composite of library calls beside) on one design in each of ``cases`` (default
    every dtype pair) against their plain versions; the scalars (val,
    asum; usum; csum) and the (d,) outputs (grad; hv; dx2, dx) are held to
    the same bits over 3 calls. One record per (kernel, dtype)."""
    n, k = idx.shape
    valid = int((idx < d).sum())
    results = []

    def record(kernel, dtype_label, cd, max_err, fn, plain_fn, nbytes, ops, composite=None):
        results.append(timed_record(kernel, dtype_label, cd, max_err, fn, plain_fn,
                                    nbytes, ops, peaks, {"n": n, "k": k, "d": d}, label,
                                    composite=composite))
        results[-1]["max_err_share"] = share
        results[-1]["max_err_share_vs_f64"] = share64

    for dtype_label, vdt, cd, rtol, rtol64 in FUSED_CASES if cases is None else cases:
        vals = vals64.to(vdt)
        y, off, ew, w = row_inputs(n, d, cd, idx.device)
        s, sc = vals.element_size(), cd.itemsize
        max_err, ok, share, share64 = check_vgc(idx, vals, y, off, ew, w, d, rtol)
        ok = ok and share64 <= rtol64
        log(f"[{label}] fused_vgc {dtype_label}: max |kernel - plain| = {max_err:.3e} "
            f"(rtol {rtol:g} x sum of |terms|; {share:.2e} of it, {share64:.2e} against "
            f"the plain version in f64, rtol {rtol64:g}): {'ok' if ok else 'DISAGREES'}")
        if not ok:
            raise AssertionError(f"fused_vgc {dtype_label} ({label}) disagrees with its "
                                 f"plain version")
        vgc = lambda: fused_value_grad_curvature(idx, vals, y, off, ew, w, d, LOGISTIC_LOSS)
        if not same_bits(vgc, (0, 1, 2)):
            raise AssertionError(f"fused_vgc {dtype_label} ({label}): val, grad or asum "
                                 f"changed bits from call to call")
        # the composites' two CSR tensors are built outside the timed region
        x_csr, xt_csr = csr_of(idx, vals.to(cd), d), csr_t_of(idx, vals.to(cd), d)

        def vgc_composite():
            z = torch.mv(x_csr, w) + off
            a = ew * LOGISTIC_LOSS.d1(z, y)
            return ((ew * LOGISTIC_LOSS.value(z, y)).sum(), torch.mv(xt_csr, a), a.sum(),
                    ew * LOGISTIC_LOSS.d2(z, y))

        composite_diff = max(float((a.double() - b.double()).abs().max())
                             for a, b in zip(vgc_composite(), vgc()))
        record("fused_vgc", dtype_label, cd, max_err, vgc,
               lambda: fused_value_grad_curvature_reference(
                   idx, vals, y, off, ew, w, d, LOGISTIC_LOSS),
               n * k * (4 + s) + 2 * d * sc + 4 * n * sc,
               4 * valid + LOSS_OPS_PER_ROW * n, composite=(VGC_COMPOSITE, vgc_composite))
        results[-1]["composite_max_abs_diff"] = composite_diff
        c = vgc()[3]
        shift = torch.tensor(0.05, dtype=cd, device=idx.device)
        max_err, ok, share, share64 = check_hvp(idx, vals, c, w, shift, d, rtol)
        ok = ok and share64 <= rtol64
        log(f"[{label}] fused_hvp {dtype_label}: max |kernel - plain| = {max_err:.3e} "
            f"(rtol {rtol:g} x sum of |terms|; {share:.2e} of it, {share64:.2e} against "
            f"the plain version in f64, rtol {rtol64:g}): {'ok' if ok else 'DISAGREES'}")
        if not ok:
            raise AssertionError(f"fused_hvp {dtype_label} ({label}) disagrees with its "
                                 f"plain version")
        hvp = lambda: fused_hessian_vector(idx, vals, c, w, shift, d)
        if not same_bits(hvp, (0, 1)):
            raise AssertionError(f"fused_hvp {dtype_label} ({label}): hv or usum changed "
                                 f"bits from call to call")
        composite = lambda: torch.mv(xt_csr, c * (torch.mv(x_csr, w) + shift))
        composite_diff = float((composite().double() - hvp()[0].double()).abs().max())
        record("fused_hvp", dtype_label, cd, max_err, hvp,
               lambda: fused_hessian_vector_reference(idx, vals, c, w, shift, d),
               n * k * (4 + s) + 2 * d * sc + n * sc, 4 * valid + 2 * n,
               composite=(HVP_COMPOSITE, composite))
        results[-1]["composite_max_abs_diff"] = composite_diff
        del composite
        max_err, ok, share, share64 = check_hdiag(idx, vals, y, off, ew, w, d, rtol)
        ok = ok and share64 <= rtol64
        log(f"[{label}] fused_hdiag {dtype_label}: max |kernel - plain| = {max_err:.3e} "
            f"(rtol {rtol:g} x sum of |terms|; {share:.2e} of it, {share64:.2e} against "
            f"the plain version in f64, rtol {rtol64:g}): {'ok' if ok else 'DISAGREES'}")
        if not ok:
            raise AssertionError(f"fused_hdiag {dtype_label} ({label}) disagrees with its "
                                 f"plain version")
        hdiag = lambda: fused_hessian_diagonal(idx, vals, y, off, ew, w, d, LOGISTIC_LOSS)
        if not same_bits(hdiag, (0, 1, 2)):
            raise AssertionError(f"fused_hdiag {dtype_label} ({label}): dx2, dx or csum "
                                 f"changed bits from call to call")
        x2t_csr = csr_t_of(idx, vals.to(cd) ** 2, d)

        def composite():
            c_ = ew * LOGISTIC_LOSS.d2(torch.mv(x_csr, w) + off, y)
            return torch.mv(x2t_csr, c_), torch.mv(xt_csr, c_), c_.sum()

        composite_diff = max(float((a.double() - b.double()).abs().max())
                             for a, b in zip(composite(), hdiag()))
        # reads the design, w and three row vectors; writes two (d,) sums
        record("fused_hdiag", dtype_label, cd, max_err, hdiag,
               lambda: fused_hessian_diagonal_reference(
                   idx, vals, y, off, ew, w, d, LOGISTIC_LOSS),
               n * k * (4 + s) + 3 * d * sc + 3 * n * sc,
               5 * valid + LOSS_OPS_PER_ROW * n, composite=(HDIAG_COMPOSITE, composite))
        results[-1]["composite_max_abs_diff"] = composite_diff
        del x_csr, xt_csr, x2t_csr, composite
        del vals, y, off, ew, w, c
        torch.cuda.empty_cache()
    return results


# the reduce's yardstick: one sparse product on the transposed CSR (built
# untimed; bf16 values upcast once)
REDUCE_LIBRARY = "torch.mv(XT_csr, a)"


def copy_build(idx, d, label, vals64=None):
    """Build the design's column-sorted copy anew, timed on its own (CUDA
    events around the sort, the layout and the chains, which end in host
    reads), and its bytes: (copy, record). With ``vals64`` the record also
    holds the most device memory the build and the first layout of those
    f64 values held at once above what was held before (``peak_bytes``),
    and the most ELL slots that the card's memory holds as the design alone
    (int32 ids + f64 values) and as the design with its copy: the copy's
    bytes a slot, with the rest of the peak (one build chunk's sort, which
    does not grow with the design) held once. A copy in blocks of rows
    keeps each entry's slot within its block in int32 at any size, so its
    bytes a slot here are its bytes a slot at the size reported."""
    from photon_ml_tpu_torch.kernels.colsort import build_design_columns

    build_design_columns(idx, d)  # warm-up: the sort's first call allocates
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    copy = build_design_columns(idx, d)
    end.record()
    end.synchronize()
    rec = {"build_ms": start.elapsed_time(end), "entries": copy.nvalid,
           "ntiles": copy.ntiles, "chains": int(copy.chains.shape[0]),
           "blocks": getattr(copy, "nblocks", 1), "row_block": getattr(copy, "row_block", None),
           "bytes": copy.nbytes(), "bytes_f64_values": copy.nbytes(8),
           "ell_bytes": idx.numel() * (4 + 8)}
    if vals64 is not None:
        laid = copy.layout(vals64)
        torch.cuda.synchronize()
        slots = idx.numel()
        card = torch.cuda.get_device_properties(idx.device).total_memory
        peak = torch.cuda.max_memory_allocated() - base
        kept = copy.nbytes(8)
        # the design (12 bytes a slot) and its copy with an f64 layout at
        # this run's bytes a slot; int32 slots at any size (a copy whose
        # slot is not int32 here is not scaled)
        per_slot = 12 + kept / slots
        scales = getattr(copy, "perm").dtype == torch.int32 and hasattr(copy, "nblocks")
        rec.update({"peak_bytes": peak, "card_bytes": card,
                    "bytes_per_slot_with_copy": per_slot,
                    "largest_slots_design_alone": card // 12,
                    "largest_slots_with_copy": (int((card - max(0, peak - kept)) // per_slot)
                                                if scales else None)})
        del laid
    log(f"[{label}] column-sorted copy: built in {rec['build_ms']:.4f} ms, {copy.nvalid} "
        f"entries in {copy.ntiles} tiles and {rec['blocks']} blocks, {rec['chains']} chains, "
        f"{rec['bytes']} bytes ({rec['bytes_f64_values']} with f64 values; the ELL "
        f"{rec['ell_bytes']})"
        + ("" if vals64 is None else
           f"; at most {rec['peak_bytes']} bytes held at once by the build and an f64 "
           f"layout: the card's {rec['card_bytes']} bytes hold "
           f"{rec['largest_slots_design_alone']} slots of a design alone, "
           f"{rec['largest_slots_with_copy']} with its copy "
           f"({rec['bytes_per_slot_with_copy']:.4f} bytes a slot)"))
    return copy, rec


def reduce_error(copy, vals, a, mode, rtol, what):
    """The reduce of ``mode`` against its plain version summed in f64 from
    the same inputs, within ``rtol`` x each column's sum of |terms|:
    (max |kernel - plain|, the largest share of the tolerance's scale it
    took); raises where it disagrees or is not finite."""
    from photon_ml_tpu_torch.kernels.colsort import column_reduce, column_reduce_reference

    v = vals.double()
    got = column_reduce(copy, vals, a, mode)
    ref = column_reduce_reference(copy, v, a.double(), mode)
    worst = (0.0, 0.0)
    pairs = zip(got, ref, (v * v, v)) if mode == "pair" else [(got, ref, v)]
    for out, want, t in pairs:
        scale = column_reduce_reference(copy, t.abs(), a.abs().double(), "linear")
        err, ok, share = within(out, want, scale, rtol)
        if not (ok and bool(torch.isfinite(out).all())):
            raise AssertionError(f"colsort_reduce {mode} {what} disagrees with its plain "
                                 f"version: {err:.3e}")
        worst = max(worst, (err, share))
    return worst


def reduce_same_bits(copy, vals, a, mode, what):
    """Raise unless the reduce's output(s) keep their bits over 3 calls."""
    from photon_ml_tpu_torch.kernels.colsort import column_reduce

    fn = ((lambda: column_reduce(copy, vals, a, mode)) if mode == "pair"
          else (lambda: (column_reduce(copy, vals, a, mode),)))
    if not same_bits(fn, (0, 1) if mode == "pair" else (0,)):
        raise AssertionError(f"colsort_reduce {mode} {what} changed bits from call to call")


def reduce_vector(n, cd, device):
    """The reduce's seeded (n,) row vector."""
    g = torch.Generator(device=device).manual_seed(SEED + 9)
    return (torch.rand(n, generator=g, device=device, dtype=torch.float64) - 0.3).to(cd)


def reduce_bound_bytes(copy, n, d, itemsize, cd):
    """The least traffic of X^T a: each entry's column id and value read
    once, a read, g written."""
    return copy.nvalid * (4 + itemsize) + n * cd.itemsize + d * cd.itemsize


def reduce_checks(idx, vals64, d, peaks, label):
    """Check and time the column-sorted reduce on one design in the three
    dtype pairs: the linear and the pair mode against the plain version
    summed in f64 from the same inputs (rtol x each column's sum of
    |terms|), both held to the same bits over 3 calls; the linear mode
    timed beside ``torch.mv`` on the transposed CSR. One record per dtype
    (the linear mode), with the copy's build time and bytes."""
    from photon_ml_tpu_torch.kernels.colsort import (block_bytes, column_reduce,
                                                     column_reduce_reference, column_values)

    n = idx.shape[0]
    copy, build_rec = copy_build(idx, d, label, vals64)
    results = []
    for dtype_label, vdt, cd, rtol, _ in FUSED_CASES:
        vals = column_values(copy, vals64.to(vdt))
        a = reduce_vector(n, cd, idx.device)
        what = f"{dtype_label} ({label})"
        worst = max(reduce_error(copy, vals, a, mode, rtol, what) for mode in ("linear", "pair"))
        for mode in ("linear", "pair"):
            reduce_same_bits(copy, vals, a, mode, what)
        log(f"[{label}] colsort_reduce {dtype_label}: linear and pair within "
            f"{worst[1]:.2e} of rtol {rtol:g} x column sum of |terms| (max |kernel - plain| "
            f"{worst[0]:.3e}); the same bits over 3 calls")
        xt_csr = csr_t_of(idx, vals64.to(vdt).to(cd), d)
        s_, sc = vals.element_size(), cd.itemsize
        # the bound: the least traffic; the copy's slots, its tiles' padding
        # and its later blocks' columns are this design's own, reported as
        # analytic_bytes
        results.append(timed_record(
            "colsort_reduce", dtype_label, cd, worst[0],
            lambda: column_reduce(copy, vals, a, "linear"),
            lambda: column_reduce_reference(copy, vals, a, "linear"),
            reduce_bound_bytes(copy, n, d, s_, cd), 2 * copy.nvalid, peaks,
            {"n": n, "k": idx.shape[1], "d": d, "entries": copy.nvalid}, label,
            lambda: torch.mv(xt_csr, a), REDUCE_LIBRARY,
        ))
        results[-1].update({"max_err_share": worst[1], "replaces_all": REDUCE_REPLACES,
                            "analytic_bytes": (copy.cols.shape[0] * (8 + s_) + n * sc + d * sc
                                               + block_bytes(copy, "linear", cd)),
                            "copy": build_rec})
        del vals, a, xt_csr
        torch.cuda.empty_cache()
    return results


# the ROW_BLOCKs of phase 4's f64 reduce sweep at 2^22: a quarter and half
# the default, the default, and one block over every row (the single
# sort's layout, the in-run baseline)
ROW_BLOCK_SWEEP = (1 << 19, 1 << 20, 1 << 21, KERNEL_ROWS)
# the rows of the f64 reduce's large line: a is 128 MB
REDUCE_LARGE_ROWS = 1 << 24


def reduce_sweep(idx, vals64, d, peaks, label="kernel-sweep", row_blocks=ROW_BLOCK_SWEEP):
    """The f64 linear reduce on one design with its copy built at each
    ``ROW_BLOCK`` of ``row_blocks``: held to its plain version (1e-12 x
    each column's sum of |terms|) and to the same bits over 3 calls, timed
    (CUDA-event median, device and host ms per call) with the copy's build
    record; ``torch.mv`` on the transposed CSR timed once beside, and the
    bound. Returns one record."""
    from photon_ml_tpu_torch.kernels import colsort

    n = idx.shape[0]
    a = reduce_vector(n, torch.float64, idx.device)
    xt_csr = csr_t_of(idx, vals64, d)
    library_ms = time_ms(lambda: torch.mv(xt_csr, a))
    library_device_ms = device_ms(lambda: torch.mv(xt_csr, a))[0]
    del xt_csr
    torch.cuda.empty_cache()
    rows, nbytes = [], None
    saved = colsort.ROW_BLOCK
    try:
        for row_block in row_blocks:
            colsort.ROW_BLOCK = row_block
            what = f"f64 ROW_BLOCK={row_block}"
            copy, build_rec = copy_build(idx, d, f"{label} ROW_BLOCK={row_block}")
            vals = copy.layout(vals64)
            err, share = reduce_error(copy, vals, a, "linear", 1e-12, what)
            reduce_same_bits(copy, vals, a, "linear", what)
            fn = lambda: colsort.column_reduce(copy, vals, a, "linear")  # noqa: E731
            ms = time_ms(fn)
            dev_ms, host_ms = device_ms(fn)
            nbytes = reduce_bound_bytes(copy, n, d, 8, torch.float64)
            rows.append({"row_block": row_block, "blocks": copy.nblocks, "ms": ms,
                         "device_ms": dev_ms, "host_ms": host_ms, "max_abs_err": err,
                         "max_err_share": share, "copy": build_rec})
            log(f"[{label}] colsort_reduce f64 ROW_BLOCK={row_block} ({copy.nblocks} blocks): "
                f"{ms:.4f} ms (device {dev_ms:.4f} ms, host {host_ms:.4f} ms), max |kernel - "
                f"plain| {err:.3e}, the same bits over 3 calls")
            del copy, vals, fn
            torch.cuda.empty_cache()
    finally:
        colsort.ROW_BLOCK = saved
    bound_ms, bound_by = bound(nbytes, 2 * rows[-1]["copy"]["entries"], torch.float64, peaks)
    log(f"[{label}] beside: {REDUCE_LIBRARY} {library_ms:.4f} ms (device "
        f"{library_device_ms:.4f} ms), bound {bound_ms:.4f} ms ({bound_by})")
    return {"n": n, "k": idx.shape[1], "d": d, "library": REDUCE_LIBRARY,
            "library_ms": library_ms, "library_device_ms": library_device_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes, "row_blocks": rows}


def reduce_large_check(peaks, n=REDUCE_LARGE_ROWS, d=D_HASHED, k=K):
    """The f64 linear reduce at ``n`` rows, at the default ``ROW_BLOCK``:
    against its plain version (1e-12 x each column's sum of |terms|) and
    the same bits over 3 calls, timed beside ``torch.mv`` on the
    transposed CSR and the bound; then its device time with the copy in
    one block over every row (``one_block_device_ms``). One record."""
    from photon_ml_tpu_torch.kernels import colsort
    from photon_ml_tpu_torch.kernels.colsort import column_reduce, column_reduce_reference

    label = f"kernel-{n}"
    idx, vals64 = make_ell(n, k, d, "cuda")
    copy, build_rec = copy_build(idx, d, label)
    vals = copy.layout(vals64)
    xt_csr = csr_t_of(idx, vals64, d)
    del idx, vals64
    torch.cuda.empty_cache()
    a = reduce_vector(n, torch.float64, "cuda")
    err, share = reduce_error(copy, vals, a, "linear", 1e-12, f"f64 ({label})")
    reduce_same_bits(copy, vals, a, "linear", f"f64 ({label})")
    rec = timed_record(
        "colsort_reduce", "f64", torch.float64, err,
        lambda: column_reduce(copy, vals, a, "linear"),
        lambda: column_reduce_reference(copy, vals, a, "linear"),
        reduce_bound_bytes(copy, n, d, 8, torch.float64), 2 * copy.nvalid, peaks,
        {"n": n, "k": k, "d": d, "entries": copy.nvalid}, label,
        lambda: torch.mv(xt_csr, a), REDUCE_LIBRARY,
    )
    rec.update({"max_err_share": share, "blocks": copy.nblocks, "copy": build_rec})
    want = column_reduce(copy, vals, a, "linear")
    del copy, vals, xt_csr
    torch.cuda.empty_cache()
    # the same seeded design again, its copy in one block
    saved = colsort.ROW_BLOCK
    try:
        colsort.ROW_BLOCK = n
        idx, vals64 = make_ell(n, k, d, "cuda")
        one = colsort.build_design_columns(idx, d)
        vals = one.layout(vals64)
        del idx, vals64
        torch.cuda.empty_cache()
        err, _ = reduce_error(one, vals, a, "linear", 1e-12, f"f64 one block ({label})")
        rec["one_block_device_ms"] = device_ms(lambda: column_reduce(one, vals, a, "linear"))[0]
        rec["one_block_max_abs_err"] = err
        rec["one_block_max_abs_diff_vs_blocks"] = float(
            (column_reduce(one, vals, a, "linear") - want).abs().max())
    finally:
        colsort.ROW_BLOCK = saved
    log(f"[{label}] colsort_reduce f64 in one block: device {rec['one_block_device_ms']:.4f} "
        f"ms against {rec['device_ms']:.4f} in {rec['blocks']} blocks")
    del one, vals, a, want
    torch.cuda.empty_cache()
    return rec


def training_kernels(name, idx, vals64, d, peaks, label="kernel"):
    """Check and time ell_scatter_add, fused_vgc, fused_hvp, fused_hdiag
    and the column-sorted reduce on one design (every dtype each takes),
    against their plain versions and, for ell_scatter_add, ``index_add_``.
    Returns one record per (kernel, dtype)."""
    return (scatter_checks(idx, vals64, d, peaks, label)
            + fused_checks(idx, vals64, d, peaks, label)
            + reduce_checks(idx, vals64, d, peaks, label))


def training_kernel_phase(name: str, n: int = KERNEL_ROWS, d: int = D_HASHED, k: int = K):
    """The training kernels on the uniform design, the f64 reduce's
    ``ROW_BLOCK`` sweep on it, then ell_scatter_add, the fused passes (f64
    and f32) and the reduce on the same design with HOT_COLUMNS columns
    named by every row, then the f64 reduce at REDUCE_LARGE_ROWS rows.
    Returns (uniform records, hot-column records, {"row_block_sweep",
    "large"} of the reduce)."""
    idx, vals64 = make_ell(n, k, d, "cuda")
    peaks = peaks_for(name)
    results = training_kernels(name, idx, vals64, d, peaks)
    sweep = reduce_sweep(idx, vals64, d, peaks)
    g = torch.Generator(device="cuda").manual_seed(SEED + 7)
    idx[:, :HOT_COLUMNS] = torch.randperm(d, generator=g, device="cuda")[:HOT_COLUMNS].to(
        torch.int32)
    hot = (scatter_checks(idx, vals64, d, peaks, label="kernel-hot")
           + fused_checks(idx, vals64, d, peaks, "kernel-hot", FUSED_CASES[:2])
           + reduce_checks(idx, vals64, d, peaks, "kernel-hot"))
    del idx, vals64
    torch.cuda.empty_cache()
    large = reduce_large_check(peaks)
    return results, hot, {"row_block_sweep": sweep, "large": large}


# -- phase 4b: the sparse kernel lab -----------------------------------------

# the lab's defaults (benchmarks/sparse_kernel_lab.py): 6.4M Zipf(1.1) entries
LAB_ARGS = ("200000", "32", "120000")
LAB_KERNELS = ("lane_gather", "onehot_gather", "onehot_reduce")
# the lab's f32 tolerance, of the scale (a column's or row's sum of |terms|)
LAB_RTOL = 1e-6
ONEHOT_GATHER_COMPOSITE = "vals * torch.take(w_pad, global column), two calls"


def bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.shape == b.shape and torch.equal(a.contiguous().view(torch.int32),
                                              b.contiguous().view(torch.int32))


def check_onehot_reduce(tiles, upd, label):
    """onehot_reduce against the plain version summed in f64 from the same
    updates, within LAB_RTOL of each column's sum of |upd|, and its output
    the same bits over 3 calls. Returns (g, max err, share)."""
    got = onehot_reduce(tiles, upd)
    ref = onehot_reduce_reference(tiles, upd.double())
    scale = onehot_reduce_reference(tiles, upd.abs().double())
    max_err, ok, share = within(got, ref, scale, LAB_RTOL)
    same = all(bits_equal(onehot_reduce(tiles, upd), got) for _ in range(2))
    log(f"[{label}] onehot_reduce: max |kernel - plain in f64| = {max_err:.3e} (rtol "
        f"{LAB_RTOL:g} x column sum of |upd|; {share:.2e} of it), same bits over 3 calls "
        f"{same}: {'ok' if ok and same else 'DISAGREES'}")
    if not (ok and same):
        raise AssertionError(f"onehot_reduce ({label}) disagrees with its plain version or "
                             f"changed bits from call to call")
    return got, max_err, share


def onehot_reduce_ops(tiles, upd, label, calls: int = 20) -> dict:
    """onehot_reduce's device operations timed apart: ``calls`` calls under
    ``torch.profiler``, each CUDA activity's time summed by its kernel's
    name (``memset`` for a memset), in ms per call, and their sum. Empty
    where the profiler saw no device activity: not measured. A kernel
    launched as a programmatic dependent (the chains pass) starts while
    the one before it drains and waits for it, so its span counts some of
    the other's time and the sum can exceed ``device_ms``'s."""
    onehot_reduce(tiles, upd)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            onehot_reduce(tiles, upd)
        torch.cuda.synchronize()
    ops = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != torch.autograd.DeviceType.CUDA:
            continue
        found = re.search(r"(\w+_kernel)", e.name())
        op = "memset" if "memset" in e.name().lower() else (
            found.group(1) if found else e.name())
        ops[op] = ops.get(op, 0.0) + (e.end_ns() - e.start_ns()) * 1e-6 / calls
    if ops:
        ops["sum"] = sum(ops.values())
    log(f"[{label}] onehot_reduce device operations, ms per call over {calls} calls: "
        + (", ".join(f"{op} {ms:.4f}" for op, ms in ops.items()) or "not measured"))
    return ops


def host_us(fn, calls: int = 500) -> float:
    """The host's µs per call of ``fn`` over ``calls`` calls back to back
    (the card synchronised before and after)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) * 1e6 / calls
    torch.cuda.synchronize()
    return us


def lane_gather_host_parts(tbl, idx, label) -> dict:
    """The host's µs per call of each part of ``lane_gather``'s launch path
    (kernels/launch.py), and of the whole wrapper and ``torch.gather``: the
    key and its plan's lookup, the per-call alignment and contiguity
    checks with the pointers, the output's allocation, the entry point's
    ctypes call with the kernel's launch, and ``Entry.launch`` (that call
    with the device check, the stream's handle, the return code and the
    count)."""
    from photon_ml_tpu_torch.kernels import lab as lab_kernels

    entry, rows = lab_kernels._LANE_GATHER, tbl.shape[0]
    out = torch.empty_like(tbl)
    ptrs = (tbl.data_ptr(), idx.data_ptr(), out.data_ptr(), rows)
    dev = tbl.device.index
    idx64 = idx.long()
    parts = {
        "key_and_plan": lambda: lab_kernels._lane_plans.get(
            (tbl.dtype, idx.dtype, tbl.shape, idx.shape, tbl.device, idx.device)),
        "checks": lambda: ((tbl.data_ptr() | idx.data_ptr()) & 15
                           or not (tbl.is_contiguous() and idx.is_contiguous())),
        "allocation": lambda: torch.empty_like(tbl),
        "ctypes_call": lambda: entry._fn(*ptrs, torch._C._cuda_getCurrentRawStream(dev)),
        "entry_launch": lambda: entry.launch(dev, *ptrs),
        "wrapper": lambda: lane_gather(tbl, idx),
        "torch.gather": lambda: torch.gather(tbl, 1, idx64),
    }
    us = {name: host_us(fn) for name, fn in parts.items()}
    log(f"[{label}] lane_gather's host path, µs per call: "
        + ", ".join(f"{name} {v:.2f}" for name, v in us.items()))
    return us


# the chunks of tiles per block of phase 4b's onehot_reduce sweep
# (kernels/lab.py's LAB_CHUNK is the default)
REDUCE_CHUNKS = (1, 2, 4, 8, 16, 24, 32, 64)


def onehot_reduce_sweep(tiles, upd, label, chunks=REDUCE_CHUNKS) -> list:
    """onehot_reduce at each chunk of tiles per block: within LAB_RTOL of
    the plain version in f64 and the same bits over 3 calls, then its
    CUDA-event ms and device and host ms per call."""
    ref = onehot_reduce_reference(tiles, upd.double())
    scale = onehot_reduce_reference(tiles, upd.abs().double())
    rows = []
    for chunk in chunks:
        got = onehot_reduce(tiles, upd, chunk=chunk)
        max_err, ok, share = within(got, ref, scale, LAB_RTOL)
        same = all(bits_equal(onehot_reduce(tiles, upd, chunk=chunk), got) for _ in range(2))
        if not (ok and same):
            raise AssertionError(f"onehot_reduce ({label}, chunk {chunk}) disagrees with its "
                                 "plain version or changed bits from call to call")
        fn = lambda: onehot_reduce(tiles, upd, chunk=chunk)  # noqa: E731
        ms = time_ms(fn)
        dev_ms, host_ms = device_ms(fn)
        rows.append({"chunk": chunk, "blocks": -(-tiles.ntiles // chunk), "ms": ms,
                     "device_ms": dev_ms, "host_ms": host_ms, "max_abs_err": max_err,
                     "max_err_share": share})
    log(f"[{label}] onehot_reduce chunk sweep, device ms per call: " + ", ".join(
        f"{r['chunk']}: {r['device_ms']:.4f}" for r in rows) + " (each within "
        f"{LAB_RTOL:g} of the plain version in f64, the same bits over 3 calls)")
    return rows


def check_recycled_zeros(tiles, upd, label) -> dict:
    """onehot_reduce's output in memory that held NaN: the output's whole
    buffer is freed, filled with NaN in a tensor of its size and freed
    again, so the caching allocator hands the next call that block; every
    column that no entry names must then read exactly 0.0."""
    width = tiles.nblocks * LAB_BLOCK
    named = torch.bincount(tiles.global_cols().reshape(-1), minlength=width + 1)[:width] > 0
    g = onehot_reduce(tiles, upd)
    floats = g.untyped_storage().nbytes() // 4
    del g
    nan = torch.full((floats,), float("nan"), device=upd.device)
    nan_ptr = nan.data_ptr()
    del nan
    g = onehot_reduce(tiles, upd)
    reused = g.data_ptr() == nan_ptr
    unnamed = int((~named).sum())
    zeros = bool((g[~named] == 0).all()) and not bool(g.isnan().any())
    log(f"[{label}] onehot_reduce in recycled NaN memory (the same block: {reused}): "
        f"{unnamed} of {width} columns named by no entry, all exactly 0.0 and no NaN "
        f"anywhere: {'ok' if zeros else 'FAILS'}")
    if not (reused and zeros):
        raise AssertionError(f"onehot_reduce ({label}) left a column unwritten in recycled "
                             f"memory (block reused {reused})")
    return {"unnamed_columns": unnamed, "width": width, "exact_zeros": zeros}


def check_onehot_gather(tiles, w, label):
    """onehot_gather against its plain version, bit for bit."""
    got = onehot_gather(tiles, w)
    ok = bits_equal(got, onehot_gather_reference(tiles, w))
    log(f"[{label}] onehot_gather: bit for bit with the plain version: "
        f"{'ok' if ok else 'DISAGREES'}")
    if not ok:
        raise AssertionError(f"onehot_gather ({label}) disagrees with its plain version")
    return got


def check_lab_sums(label, z_c, z, row_abs, g_c, g, col_abs):
    """C1's z and C2's g against ell_matvec and ell_scatter_add on the same
    matrix, within LAB_RTOL of each row's and column's sum of |terms|."""
    z_err, z_ok, z_share = within(z_c, z, row_abs, LAB_RTOL)
    g_err, g_ok, g_share = within(g_c, g, col_abs, LAB_RTOL)
    log(f"[{label}] z from onehot_gather vs ell_matvec: {z_err:.3e} ({z_share:.2e} of the "
        f"row scale); g from onehot_reduce vs ell_scatter_add: {g_err:.3e} ({g_share:.2e} of "
        f"the column scale): {'ok' if z_ok and g_ok else 'DISAGREE'}")
    if not (z_ok and g_ok):
        raise AssertionError(f"the lab's C1 or C2 ({label}) disagrees with ell_matvec or "
                             "ell_scatter_add")
    return {"z_max_err": z_err, "z_max_err_share": z_share, "g_max_err": g_err,
            "g_max_err_share": g_share}


def onehot_records(tiles, w, upd, e, g, peaks, label, shape):
    """onehot_gather (beside the take-based composite) and onehot_reduce
    (beside ``index_add_`` into the tiles' global columns), timed."""
    gcol = tiles.global_cols().reshape(-1)
    w_pad = torch.zeros(tiles.nblocks * LAB_BLOCK + 1, dtype=w.dtype, device=w.device)
    w_pad[:tiles.d] = w
    flat_upd = upd.reshape(-1)
    padded = tiles.cols.numel()
    valid = int((tiles.cols < LAB_BLOCK).sum())
    width = tiles.nblocks * LAB_BLOCK
    gather = timed_record(
        "onehot_gather", "f32", torch.float32, 0.0, lambda: onehot_gather(tiles, w),
        lambda: onehot_gather_reference(tiles, w), 12 * padded + 4 * width, valid, peaks,
        shape, label, composite=(ONEHOT_GATHER_COMPOSITE,
                                 lambda: tiles.vals * torch.take(w_pad, gcol).view_as(e)))
    gather["max_err_share"] = 0.0
    _, max_err, share = g
    reduce = timed_record(
        "onehot_reduce", "f32", torch.float32, max_err, lambda: onehot_reduce(tiles, upd),
        lambda: onehot_reduce_reference(tiles, upd), 8 * padded + 4 * width, valid, peaks,
        shape, label, lambda: torch.zeros(width + 1, device=upd.device).index_add_(
            0, gcol, flat_upd), "index_add_")
    reduce["max_err_share"] = share
    return [gather, reduce]


def lab_phase(name: str):
    """(a) the port's lab at its default shape, counters set to 0 just
    before and read just after, then each kernel held to its plain version
    and timed; (b) onehot_reduce and onehot_gather on the kernel phase's
    uniform design beside ell_scatter_add, index_add_, torch.mv on the
    transposed CSR and ell_matvec, with the layout, its sort and the
    a[row] gather timed apart. Returns (launches, records at the lab's
    shape, records at 2^22, summary)."""
    peaks = peaks_for(name)
    dispatch.reset_launch_counts()
    out = sparse_kernel_lab.main(list(LAB_ARGS))
    torch.cuda.synchronize()
    launches = dispatch.launch_counts()
    log(f"[lab] launches on the lab's path: {json.dumps(launches)}")
    missed = [k for k in LAB_KERNELS + ("ell_matvec", "ell_scatter_add") if launches[k] < 1]
    if missed:
        raise AssertionError(f"the lab did not launch {missed}")
    x = out["inputs"]
    tiles, shape = x.tiles, {"n": x.n, "k": x.k, "d": x.d}
    # (a) lane gather, bit for bit, beside torch.gather
    got = lane_gather(x.tbl, x.idx)
    ok = bits_equal(got, lane_gather_reference(x.tbl, x.idx))
    log(f"[lab] lane_gather: bit for bit with the plain version: {'ok' if ok else 'DISAGREES'}")
    if not ok:
        raise AssertionError("lane_gather disagrees with its plain version")
    idx64 = x.idx.long()
    records = [timed_record(
        "lane_gather", "f32", torch.float32, 0.0, lambda: lane_gather(x.tbl, x.idx),
        lambda: lane_gather_reference(x.tbl, x.idx), 3 * x.tbl.numel() * 4, 0, peaks,
        {"rows": x.tbl.shape[0], "lanes": x.tbl.shape[1]}, "lab",
        lambda: torch.gather(x.tbl, 1, idx64), "torch.gather")]
    records[0]["max_err_share"] = 0.0
    host_parts = lane_gather_host_parts(x.tbl, x.idx, "lab")
    e = check_onehot_gather(tiles, x.w, "lab")
    g = check_onehot_reduce(tiles, x.upd, "lab")
    upd_ell = x.vals * x.a[:, None]
    summary = {"lines": out["records"], "tiles": tiles.ntiles, "chains": tiles.chains.shape[0],
               "lane_gather_host_us": host_parts,
               "recycled_zeros": check_recycled_zeros(tiles, x.upd, "lab"),
               "reduce_ops": onehot_reduce_ops(tiles, x.upd, "lab"),
               "reduce_chunks": onehot_reduce_sweep(tiles, x.upd, "lab")}
    summary["sums"] = check_lab_sums(
        "lab", sparse_kernel_lab.rows_sum(tiles, e, x.n), ell_matvec(x.cols, x.vals, x.w, x.d),
        ell_matvec_reference(x.cols, x.vals.abs().double(), x.w.abs().double(), x.d),
        g[0][:x.d],
        ell_scatter_add(x.cols, upd_ell, x.d),
        ell_scatter_add_reference(x.cols, upd_ell.abs().double(), x.d))
    records += onehot_records(tiles, x.w, x.upd, e, g, peaks, "lab", shape)
    del out, x, tiles, e, g, upd_ell, idx64
    torch.cuda.empty_cache()
    return launches, records, *lab_uniform(peaks, summary)


def lab_uniform(peaks, summary, n: int = KERNEL_ROWS, d: int = D_HASHED, k: int = K):
    """(b): the kernel phase's uniform design (padding slots, duplicate
    ids), f32 values, through column_sorted_tiles."""
    idx, vals64 = make_ell(n, k, d, "cuda")
    vals = vals64.float()
    del vals64
    g_ = torch.Generator(device="cuda").manual_seed(SEED + 11)
    w = torch.randn(d, generator=g_, device="cuda")
    a = torch.randn(n, generator=g_, device="cuda")
    flat_ids = idx.reshape(-1)
    sort_ms = time_ms(lambda: torch.sort(flat_ids, stable=True), warmup=1, runs=5)
    layout_ms = time_ms(lambda: column_sorted_tiles(idx, vals, d), warmup=1, runs=5)
    tiles = column_sorted_tiles(idx, vals, d)
    gather_ms = time_ms(lambda: sparse_kernel_lab.row_gather(tiles, a))
    upd = sparse_kernel_lab.row_gather(tiles, a)
    upd_ell = vals * a[:, None]
    e = check_onehot_gather(tiles, w, "lab-uniform")
    g = check_onehot_reduce(tiles, upd, "lab-uniform")
    zeros = check_recycled_zeros(tiles, upd, "lab-uniform")
    ops = onehot_reduce_ops(tiles, upd, "lab-uniform")
    sweep = onehot_reduce_sweep(tiles, upd, "lab-uniform")
    row_abs = ell_matvec_reference(idx, vals.abs().double(), w.abs().double(), d)
    col_abs = ell_scatter_add_reference(idx, upd_ell.abs().double(), d)
    shape = {"n": n, "k": k, "d": d}
    uniform = {"layout_ms": layout_ms, "sort_ms": sort_ms, "row_gather_ms": gather_ms,
               "tiles": tiles.ntiles, "padded_entries": tiles.cols.numel(),
               "chains": tiles.chains.shape[0], "recycled_zeros": zeros, "reduce_ops": ops,
               "reduce_chunks": sweep,
               **check_lab_sums("lab-uniform", sparse_kernel_lab.rows_sum(tiles, e, n),
                                ell_matvec(idx, vals, w, d), row_abs, g[0][:d],
                                ell_scatter_add(idx, upd_ell, d), col_abs)}
    log(f"[lab-uniform] layout {layout_ms:.4f} ms (its stable sort {sort_ms:.4f} ms), "
        f"a[row] gather {gather_ms:.4f} ms, {tiles.ntiles} tiles, "
        f"{tiles.chains.shape[0]} columns across tiles")
    records = onehot_records(tiles, w, upd, e, g, peaks, "lab-uniform", shape)
    # the atomic scatter on the same matrix, in the same call
    valid = int((idx < d).sum())
    max_err, ok, share = check_scatter(idx, upd_ell, d, 1e-5)
    if not ok:
        raise AssertionError("ell_scatter_add (lab-uniform) disagrees with its plain version")
    ids = torch.where(idx < d, idx, d).reshape(-1).long()
    records.append(timed_record(
        "ell_scatter_add", "f32", torch.float32, max_err,
        lambda: ell_scatter_add(idx, upd_ell, d),
        lambda: ell_scatter_add_reference(idx, upd_ell, d), n * k * 8 + d * 4, valid, peaks,
        shape, "lab-uniform", lambda: torch.zeros(d + 1, device="cuda").index_add_(
            0, ids, upd_ell.reshape(-1))))
    records[-1]["max_err_share"] = share
    # the library's way to X^T a without atomics: torch.mv on the
    # transposed CSR, built untimed (the composite's side of fused_hvp)
    xt_csr = csr_t_of(idx, vals, d)
    uniform["xt_csr_mv_max_abs_diff"] = float(
        (torch.mv(xt_csr, a).double() - g[0][:d].double()).abs().max())
    uniform["xt_csr_mv_ms"] = time_ms(lambda: torch.mv(xt_csr, a))
    uniform["xt_csr_mv_device_ms"] = device_ms(lambda: torch.mv(xt_csr, a))[0]
    log(f"[lab-uniform] torch.mv(XT_csr, a): {uniform['xt_csr_mv_ms']:.4f} ms (device "
        f"{uniform['xt_csr_mv_device_ms']:.4f} ms), max |it - onehot_reduce| "
        f"{uniform['xt_csr_mv_max_abs_diff']:.3e}")
    summary["uniform"] = uniform
    del idx, vals, tiles, upd, upd_ell, e, g, ids, xt_csr
    torch.cuda.empty_cache()
    return records, summary


# -- phase 5: the scoring driver end to end ----------------------------------


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


# the smoke run's inputs: each phase's arrays are drawn in this process (the
# seeds' order unchanged), and the records encoded and written by
# ``encode_examples`` on worker processes, started at the first write and at
# the lowest scheduling priority, so that the card's timed phases keep the
# host's cores first; each phase waits for its own files (``wait_written``)
_writers = None  # the worker pool, started by the first write
_written = {}  # path -> its write's future
WRITER_PROCESSES = 4


def encode_examples(path: str, uid_prefix: str, labels: np.ndarray, offsets: np.ndarray,
                    blocks, metadata=None) -> str:
    """Write n TrainingExample records at ``path`` with the Python codec:
    record i has uid ``uid_prefix + str(i)``, its label and offset, no
    weight, the features of every block ``(name, (n, m) column ids, (n, m)
    values)`` in block order (term: the column id), and a metadataMap of
    each ``metadata`` key whose (n,) entry is not None (None: no map)."""
    n = labels.shape[0]
    blocks = [(name, c.tolist(), v.tolist()) for name, c, v in blocks]
    labels, offsets = labels.tolist(), offsets.tolist()
    records = (
        {
            "uid": f"{uid_prefix}{i}",
            "label": float(labels[i]),
            "features": [{"name": name, "term": str(c), "value": float(v)}
                         for name, cols, vals in blocks for c, v in zip(cols[i], vals[i])],
            "metadataMap": None if metadata is None else {
                k: v[i] for k, v in metadata.items() if v[i] is not None},
            "weight": None,
            "offset": float(offsets[i]),
        }
        for i in range(n)
    )
    write_avro_file(path, TRAINING_EXAMPLE_SCHEMA, records)
    return path


def write_examples_file(path: str, *args) -> None:
    """``encode_examples(path, *args)`` on a worker process;
    ``wait_written(path)`` waits for it."""
    _written[path] = start_writers().submit(encode_examples, path, *args)


def wait_written(*paths) -> float:
    """Wait for the pending writes of ``paths`` (a worker's error raised
    here); returns the seconds waited."""
    t0 = time.perf_counter()
    for path in paths:
        pending = _written.pop(path, None)
        if pending is not None:
            pending.result()
    return time.perf_counter() - t0


def start_writers(processes: int = WRITER_PROCESSES, nice: int = 19):
    """The pool of writer processes, started at the first call (spawned:
    they touch no CUDA state of this process), each at ``nice``, and
    stopped at the latest when this process exits."""
    global _writers
    if _writers is None:
        import atexit
        import concurrent.futures
        import multiprocessing

        _writers = concurrent.futures.ProcessPoolExecutor(
            processes, mp_context=multiprocessing.get_context("spawn"),
            initializer=os.nice, initargs=(nice,))
        atexit.register(stop_writers)
    return _writers


def stop_writers() -> None:
    """Stop the writer processes, cancelling any write not yet begun."""
    global _writers
    if _writers is not None:
        _writers.shutdown(wait=True, cancel_futures=True)
        _writers = None
    _written.clear()


def write_inputs_ahead(work: str) -> dict:
    """Every driver phase's inputs under ``work`` — phases 5, 5b, 5c, 5d
    (and 5e, which reads 5d's), 6 and 5g's GAME half — drawn here in the
    phases' order with their seeds, and written by ``WRITER_PROCESSES``
    worker processes, which encode while the kernel phases hold the card;
    each phase waits for its own files. Returns {phase: its writer's
    return}, the ``inputs`` of each phase function."""
    t0 = time.perf_counter()
    ahead = {
        "score": write_scoring_inputs(os.path.join(work, "score"), SCORE_RECORDS, D_HASHED),
        "game": write_game_inputs(os.path.join(work, "game"), GAME_RECORDS, D_HASHED,
                                  GAME_USERS, GAME_USER_COLS, GAME_ADS),
        "game_train": write_game_training_inputs(
            os.path.join(work, "game_train"), GAME_TRAIN_RECORDS, GAME_TRAIN_HELDOUT,
            D_HASHED, GAME_TRAIN_USERS),
        "game_proj": write_game_training_inputs(
            os.path.join(work, "game_proj"), GAME_PROJ_RECORDS, GAME_PROJ_HELDOUT, D_HASHED,
            GAME_TRAIN_USERS, user_cols=GAME_USER_COLS, n_ads=GAME_PROJ_ADS),
        "train": write_training_inputs(os.path.join(work, "train"), TRAIN_RECORDS,
                                       HELDOUT_RECORDS, D_HASHED),
        "quality_game": write_game_training_inputs(
            os.path.join(work, "quality", "game"), QUALITY_GAME_RECORDS,
            QUALITY_GAME_HELDOUT, D_HASHED, QUALITY_GAME_USERS),
    }
    log(f"[inputs] every phase's records drawn (and the scoring models saved) in "
        f"{time.perf_counter() - t0:.1f} s (set-up); {len(_written)} files being written by "
        f"{WRITER_PROCESSES} processes")
    return ahead


def write_examples(path: str, n: int, d_hashed: int, w: np.ndarray, icpt: int,
                   seed: int, rng):
    """n TrainingExample records in the Criteo layout at ``path``, with
    offsets and labels drawn (from ``rng``) from the logistic model ``w``.
    Returns the expected design straight from the generator's COO (the
    intercept included), the labels and the offsets."""
    rows, cols, vals = make_criteo_like(n, seed)
    cols = cols % d_hashed
    offsets = rng.normal(0.0, 0.1, size=n)
    margins = np.bincount(rows, vals * w[cols], minlength=n) + w[icpt] + offsets
    labels = (rng.uniform(size=n) < 1.0 / (1.0 + np.exp(-margins))).astype(np.float64)
    per_row = cols.size // n
    write_examples_file(path, "r", labels, offsets,
                        [("h", cols.reshape(n, per_row), vals.reshape(n, per_row))])
    coo = (
        np.concatenate([rows, np.arange(n)]),
        np.concatenate([cols, np.full(n, icpt)]),
        np.concatenate([vals, np.ones(n)]),
    )
    return coo, labels, offsets


def hashed_vocabulary(path: str, d_hashed: int) -> FeatureVocabulary:
    """feature-index.txt with the d_hashed bucket keys in bucket order and
    the intercept last, so column j is bucket j."""
    vocab = FeatureVocabulary(
        [feature_key("h", str(b)) for b in range(d_hashed)], add_intercept=True
    )
    vocab.save(path)
    return vocab


def write_scoring_inputs(work: str, n: int, d_hashed: int, seed: int = SEED):
    """feature-index.txt (d_hashed keys + intercept), best-model.avro
    (seeded f64 coefficients) and n TrainingExample records with offsets
    and labels drawn from the seeded logistic model."""
    rng = np.random.default_rng(seed + 2)
    model_dir = os.path.join(work, "model")
    vocab = hashed_vocabulary(os.path.join(model_dir, "feature-index.txt"), d_hashed)
    w = rng.normal(0.0, 0.25, size=len(vocab))
    save_glm_model(
        os.path.join(model_dir, "best-model.avro"),
        Coefficients(means=torch.from_numpy(w)), vocab,
        task=TaskType.LOGISTIC_REGRESSION,
    )
    data = os.path.join(work, "data", "part-00000.avro")
    (rows, cols, vals), _, offsets = write_examples(
        data, n, d_hashed, w, vocab.intercept_index, seed, rng
    )
    return model_dir, data, w, offsets, (rows, cols, vals, len(vocab))


# the port's kernels by name; sum_partials is the fused passes' second,
# single-block launch
PROFILED_KERNELS = ("ell_matvec", "ell_scatter_add", "fused_vgc", "fused_hvp",
                    "fused_hdiag", "sum_partials")


def device_busy(prof) -> dict:
    """Device time of a profiled window: the union of every CUDA activity
    (kernels, copies, sets) on the card, and each port kernel's own time,
    in seconds. None where the profiler saw no device activity (a machine
    whose CUPTI tracing is off): not measured. Read from the raw trace's
    events: ``prof.events()`` builds a Python object per launch, too slow
    for the launches of a GAME descent."""
    spans = sorted(
        (e.start_ns() * 1e-3, e.end_ns() * 1e-3, e.name())
        for e in prof.profiler.kineto_results.events()
        if e.device_type() == torch.autograd.DeviceType.CUDA
    )
    if not spans:
        return {"device_busy_s": None,
                **{f"{k}_device_s": None for k in PROFILED_KERNELS}}
    busy_us, reach = 0.0, float("-inf")
    for start, end, _ in spans:
        if end > reach:
            busy_us += end - max(start, reach)
            reach = end
    out = {"device_busy_s": busy_us * 1e-6}
    for kernel in PROFILED_KERNELS:
        us = sum(end - start for start, end, name in spans if f"{kernel}_kernel" in name)
        out[f"{kernel}_device_s"] = us * 1e-6
    return out


def score_phase(work: str, n: int = SCORE_RECORDS, d_hashed: int = D_HASHED,
                inputs=None, **device_kw):
    """Run the port's GLM scoring driver; ``device_kw`` is empty for the
    card (the driver's default device). ``inputs``: the return of
    ``write_scoring_inputs`` over ``work``, written ahead."""
    t0 = time.perf_counter()
    if inputs is None:
        inputs = write_scoring_inputs(work, n, d_hashed)
    model_dir, data, w, offsets, coo = inputs
    wait_written(data)
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
    require_native(run, "[score]")

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
        "codecs": run.codecs,
    }
    log(f"[score] {json.dumps(summary)}")
    return summary


# -- phase 5b: GAME scoring end to end --------------------------------------

# a GAME model on the Criteo layout: the fixed effect on the hashed columns
# (ELL, ell_matvec), a random effect per user on a wide sparse shard laid
# out as examples/make_wide_game_data.py (a private pool of 25 columns per
# user, 5 per row), and two per-ad effects on the 13 integer fields plus
# the intercept: a dense table and a factored one (latent dimension 8),
# each holding its own random half of the ads
GAME_RECORDS = 30_000  # padded to the 2^15 bucket
GAME_USERS = 4096
GAME_USER_COLS = 20_000
GAME_USER_POOL = 25
GAME_USER_PER_ROW = 5
GAME_ADS = 1024  # per coordinate, out of 2 * GAME_ADS
GAME_LATENT = 8
GAME_SPARSE_SHARDS = ["global", "user"]


def write_game_inputs(work: str, n: int, d_hashed: int, n_users: int, user_cols: int,
                      n_ads: int, seed: int = SEED + 20):
    """The GAME model directory (written by the port's ``save_game_model``
    from seeded numpy, with one feature-index file per shard) and n
    TrainingExample records: the Criteo fields, 5 user features, a userId
    (1/16 of rows one the model lacks) and an adId (absent from 1/32 of
    rows, drawn from all 2 * n_ads ads). Returns (model dir, data file,
    the records' margins from the generator's own numpy, without
    offsets)."""
    rng = np.random.default_rng(seed)
    model_dir = os.path.join(work, "model")
    gvocab = hashed_vocabulary(os.path.join(model_dir, "feature-index-global.txt"), d_hashed)
    uvocab = FeatureVocabulary([feature_key("u", str(j)) for j in range(user_cols)])
    uvocab.save(os.path.join(model_dir, "feature-index-user.txt"))
    int_cols = _hash(np.arange(INT_FIELDS), np.zeros(INT_FIELDS, np.int64)) % d_hashed
    avocab = FeatureVocabulary([feature_key("h", str(c)) for c in int_cols.tolist()],
                               add_intercept=True)
    avocab.save(os.path.join(model_dir, "feature-index-ad.txt"))
    d_ad = len(avocab)

    w_g = rng.normal(0.0, 0.25, size=len(gvocab))
    pools = rng.integers(0, user_cols, size=(n_users, GAME_USER_POOL))
    user_table = np.zeros((n_users, user_cols))
    user_table[np.arange(n_users)[:, None], pools] = rng.normal(0.0, 0.5, size=pools.shape)
    ad_table = rng.normal(0.0, 0.3, size=(n_ads, d_ad))
    gamma = rng.normal(0.0, 0.5, size=(n_ads, GAME_LATENT))
    projection = rng.normal(0.0, 0.3, size=(d_ad, GAME_LATENT))
    ad_half = rng.permutation(2 * n_ads)[:n_ads]
    latent_half = rng.permutation(2 * n_ads)[:n_ads]
    save_game_model(
        model_dir,
        params={"global": w_g, "per-user": user_table, "per-ad": ad_table,
                "per-ad-latent": FactoredParams(torch.from_numpy(gamma),
                                                torch.from_numpy(projection))},
        shards={"global": "global", "per-user": "user", "per-ad": "ad",
                "per-ad-latent": "ad"},
        vocabs={"global": gvocab, "per-user": uvocab, "per-ad": avocab,
                "per-ad-latent": avocab},
        entity_vocabs={"per-user": {f"user{u}": u for u in range(n_users)},
                       "per-ad": {f"ad{a}": i for i, a in enumerate(ad_half.tolist())},
                       "per-ad-latent": {f"ad{a}": i for i, a in enumerate(latent_half.tolist())}},
        random_effects={"global": None, "per-user": "userId", "per-ad": "adId",
                        "per-ad-latent": "adId"},
        task=TaskType.LOGISTIC_REGRESSION,
    )

    rows, cols, vals = make_criteo_like(n, seed)
    cols = cols % d_hashed
    users = rng.integers(0, n_users, n)
    known_user = np.arange(n) % 16 != 3
    ucols = pools[users[:, None], rng.integers(0, GAME_USER_POOL, (n, GAME_USER_PER_ROW))]
    uvals = rng.normal(size=ucols.shape)
    ads = rng.integers(0, 2 * n_ads, n)
    has_ad = np.arange(n) % 32 != 7
    offsets = rng.normal(0.0, 0.1, size=n)

    # the margins, from the generator's numpy: every feature lands in each
    # shard whose vocabulary names it (an integer field's column, and any
    # categorical value hashed onto one, in the ad shard too)
    margins = np.bincount(rows, vals * w_g[cols], minlength=n) + w_g[gvocab.intercept_index]
    margins += known_user * np.einsum("nj,nj->n", uvals, user_table[users[:, None], ucols])
    slot = np.full(d_hashed, -1)
    slot[int_cols] = np.arange(INT_FIELDS)
    in_ad = slot[cols] >= 0
    x_ad = np.zeros((n, d_ad))
    np.add.at(x_ad, (rows[in_ad], slot[cols[in_ad]]), vals[in_ad])
    x_ad[:, avocab.intercept_index] = 1.0
    for half, coef in ((ad_half, lambda r: ad_table[r]),
                       (latent_half, lambda r: gamma[r] @ projection.T)):
        row_of = np.full(2 * n_ads, -1)
        row_of[half] = np.arange(n_ads)
        r = row_of[ads]
        hit = has_ad & (r >= 0)
        margins[hit] += np.einsum("nd,nd->n", x_ad[hit], coef(r[hit]))
    labels = (rng.uniform(size=n) < 1.0 / (1.0 + np.exp(-(margins + offsets)))).astype(np.float64)

    per_row = cols.size // n
    data = os.path.join(work, "data", "part-00000.avro")
    write_examples_file(
        data, "g", labels, offsets,
        [("h", cols.reshape(n, per_row), vals.reshape(n, per_row)), ("u", ucols, uvals)],
        {"userId": [f"user{users[i] if known_user[i] else n_users + i}" for i in range(n)],
         "adId": [f"ad{ads[i]}" if has_ad[i] else None for i in range(n)]})
    icpt = np.full(n, gvocab.intercept_index)
    coo = (np.concatenate([rows, np.arange(n)]), np.concatenate([cols, icpt]),
           np.concatenate([vals, np.ones(n)]), len(gvocab), w_g)
    return model_dir, data, margins + offsets, coo


def game_phase(work: str, name: str = "", n: int = GAME_RECORDS, d_hashed: int = D_HASHED,
               n_users: int = GAME_USERS, user_cols: int = GAME_USER_COLS,
               n_ads: int = GAME_ADS, inputs=None, **device_kw):
    """Run the port's GAME scoring driver on the card (the driver's default
    device; ``device_kw`` names another for a rehearsal), with the counters
    set to 0 just before and read just after, then the same run under
    ``torch.profiler``, then on the CPU; hold the card's scores, metrics
    and uids to the CPU's and the scores to the generator's margins, and
    time ``ell_matvec`` at the shape the driver gave it."""
    t0 = time.perf_counter()
    if inputs is None:
        inputs = write_game_inputs(work, n, d_hashed, n_users, user_cols, n_ads)
    model_dir, data, ref, coo = inputs
    wait_written(data)
    setup_s = time.perf_counter() - t0
    log(f"[game] wrote {n} records and a 4-coordinate GAME model ({d_hashed} hashed "
        f"columns + intercept, {n_users} users x {user_cols} columns, 2 x {n_ads} ads) "
        f"in {setup_s:.1f} s (set-up)")
    params = {
        "input": [data],
        "model_dir": model_dir,
        "output_dir": os.path.join(work, "scores"),
        "model_kind": "game",
        "sparse_shards": GAME_SPARSE_SHARDS,
        "evaluate": True,
    }
    dispatch.reset_launch_counts()
    t0 = time.perf_counter()
    run = run_scoring(params, **device_kw)
    wall_s = time.perf_counter() - t0
    launches = dispatch.launch_counts()
    on_card = not device_kw
    want = {k: (1 if on_card and k == "ell_matvec" else 0) for k in launches}
    if launches != want:
        raise AssertionError(f"GAME scoring launched {launches}, expected {want}")
    require_native(run, "[game]")
    log(f"[game] card run {wall_s:.4f} s, phases {json.dumps(run.timings)}, "
        f"launches {json.dumps({k: v for k, v in launches.items() if v})}")

    busy = {"device_busy_s": None}
    traced_wall_s = None
    if on_card:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run_scoring({**params, "overwrite": True})
            traced_wall_s = time.perf_counter() - t0
        busy = device_busy(prof)

    t0 = time.perf_counter()
    cpu = run_scoring({**params, "output_dir": os.path.join(work, "scores-cpu")}, device="cpu")
    cpu_wall_s = time.perf_counter() - t0
    require_native(cpu, "[game] the CPU run")

    # the card against the CPU, and both against the generator's margins
    scale = np.maximum(1.0, np.abs(cpu.scores))
    if run.scores.shape != (n,) or not np.isfinite(run.scores).all():
        raise AssertionError(f"GAME scores: shape {run.scores.shape}, finite "
                             f"{bool(np.isfinite(run.scores).all())}")
    card_err = float(np.max(np.abs(run.scores - cpu.scores) / scale))
    ref_err = float(np.max(np.abs(cpu.scores - ref) / np.maximum(1.0, np.abs(ref))))
    metric_err = {k: abs(run.metrics[k] - v) for k, v in cpu.metrics.items()}
    _, card_recs = read_avro_file(run.output_path)
    _, cpu_recs = read_avro_file(cpu.output_path)
    same_uids = [r["uid"] for r in card_recs] == [r["uid"] for r in cpu_recs]
    auc = run.metrics["AREA_UNDER_RECEIVER_OPERATOR_CHARACTERISTICS"]
    log(f"[game] card vs CPU: max |s - s_cpu| / max(1, |s_cpu|) {card_err:.3e} (limit 1e-10), "
        f"metrics {json.dumps(metric_err)} (limit 1e-10), same uids in order {same_uids}; "
        f"CPU vs the generator's margins {ref_err:.3e}; AUC {auc:.6f}")
    if (card_err > 1e-10 or ref_err > 1e-10 or set(run.metrics) != set(cpu.metrics)
            or max(metric_err.values()) > 1e-10 or not same_uids or not 0.5 < auc <= 1.0):
        raise AssertionError("GAME scoring on the card disagrees with the CPU run")

    # the kernel against its plain version at the shape the driver gave it
    rows, cols, vals, d, w = coo
    device = torch.device(run.device)
    ell = from_coo(rows, cols, vals, bucket_size(n), d, dtype=torch.float64, device=device)
    w_dev = torch.from_numpy(w).to(device)
    kernel = ell_matvec(ell.indices, ell.values, w_dev, d)
    plain = ell_matvec_reference(ell.indices, ell.values, w_dev, d)
    row_abs = ell_matvec_reference(ell.indices, ell.values.abs(), w_dev.abs(), d)
    kernel_err = (kernel - plain).abs()
    if not bool(torch.all(kernel_err <= 1e-12 * row_abs)):
        raise AssertionError(f"ell_matvec at the GAME shape: {float(kernel_err.max())}")
    record = None
    if on_card:
        m, k = ell.indices.shape
        valid = int((ell.indices < d).sum())
        csr = csr_of(ell.indices, ell.values, d)
        record = timed_record(
            "ell_matvec", "f64", torch.float64, float(kernel_err.max()),
            lambda: ell_matvec(ell.indices, ell.values, w_dev, d),
            lambda: ell_matvec_reference(ell.indices, ell.values, w_dev, d),
            m * k * 12 + d * 8 + m * 8, 2 * valid, peaks_for(name),
            {"n": m, "k": k, "d": d}, "game", lambda: torch.mv(csr, w_dev), "torch.mv(CSR)",
        )
        del csr
    summary = {
        "records": n,
        "bucket": bucket_size(n),
        "device": run.device,
        "wall_s": wall_s,
        "rows_per_s": n / wall_s,
        "timings_s": run.timings,
        "launches": launches,
        "traced_wall_s": traced_wall_s,
        **busy,
        "device_idle_share": (None if busy["device_busy_s"] is None
                              else 1.0 - busy["device_busy_s"] / traced_wall_s),
        "cpu_wall_s": cpu_wall_s,
        "cpu_timings_s": cpu.timings,
        "max_err_vs_cpu": card_err,
        "max_err_vs_generator": ref_err,
        "metrics": run.metrics,
        "setup_s": setup_s,
    }
    log(f"[game] {json.dumps(summary)}")
    served = {"model_dir": model_dir, "data": data, "scores": run.scores}
    return summary, record, served


# -- phase 5f: online serving ------------------------------------------------

# phase 5b's model and records through the online engine on the card. The
# engine featurizes densely (as the JAX engine does): 2^20 + 1 + 20,000 +
# 14 columns, 8.55 MB a row in f64, so the call counts are cut, never the
# widths: 4,096 of the 30,000 records scored directly, 1,024 in each of the
# batcher, reload and cache passes
SERVE_DIRECT = 4096
SERVE_PASS = 1024
SERVE_MAX_BATCH = 64
SERVE_WAIT_MS = 2.0
SERVE_CLIENTS = 8
SERVE_CACHE = 512
SERVE_ZIPF = 1.1
SERVE_CLI_REQUESTS = 8
SERVE_RTOL = 1e-10


def serving_requests(records) -> list:
    """ScoreRequests from TrainingExample records: each feature under its
    raw ``name\\x01term`` key (duplicate keys summed, as ingest sums them),
    the metadata's entity ids and the record's offset."""
    out = []
    for r in records:
        feats = {}
        for f in r["features"]:
            key = feature_key(f["name"], f["term"])
            feats[key] = feats.get(key, 0.0) + f["value"]
        out.append(ScoreRequest(features=feats, entities=dict(r["metadataMap"]),
                                offset=float(r["offset"] or 0.0)))
    return out


def serving_gaps(got, want) -> float:
    """max |got - want| / max(1, |want|)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if got.shape != want.shape or not np.isfinite(got).all():
        return float("inf")
    return float(np.max(np.abs(got - want) / np.maximum(1.0, np.abs(want)), initial=0.0))


def quantiles_ms(seconds) -> dict:
    ms = np.asarray(seconds, np.float64) * 1e3
    return {"n": int(ms.size), "p50": float(np.percentile(ms, 50)),
            "p99": float(np.percentile(ms, 99))}


class _RawBucketStats(ServingStats):
    """ServingStats that also keeps every per-bucket latency the engine
    records (copy in, device work, copy out), for exact percentiles."""

    def __init__(self):
        super().__init__()
        self.raw = {}

    def record_bucket_latency(self, bucket, device_s):
        super().record_bucket_latency(bucket, device_s)
        self.raw.setdefault(int(bucket), []).append(device_s)


def closed_loop(submit, requests, clients: int, keep_going=None):
    """``clients`` threads, each sending its share of ``requests`` one at a
    time (submit, wait for the answer, send the next); while
    ``keep_going()`` is true a client starts its share over. Returns
    ([(request index, answer or exception, seconds)], wall seconds)."""
    import threading

    results, lock = [], threading.Lock()

    def client(c):
        mine = list(range(c, len(requests), clients))
        while True:
            for i in mine:
                t0 = time.perf_counter()
                try:
                    answer = submit(requests[i]).result(timeout=120)
                except Exception as e:  # noqa: BLE001 — counted as dropped
                    answer = e
                with lock:
                    results.append((i, answer, time.perf_counter() - t0))
            if keep_going is None or not keep_going():
                return

    threads = [threading.Thread(target=client, args=(c,), name=f"client-{c}")
               for c in range(clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)
        if t.is_alive():
            raise AssertionError(f"{t.name} did not finish")
    return results, time.perf_counter() - t0


def scaled_game_model(src: str, dst: str, factor: float) -> None:
    """Re-save phase 5b's model with every coefficient times ``factor``
    (a factored effect's per-entity gamma; its shared projection as is)
    and its vocabularies, then its manifest."""
    shard_of = {"global": "global", "per-user": "user", "per-ad": "ad", "per-ad-latent": "ad"}
    vocabs = {s: FeatureVocabulary.load(os.path.join(src, f"feature-index-{s}.txt"))
              for s in set(shard_of.values())}
    coord_vocabs = {c: vocabs[s] for c, s in shard_of.items()}
    params, shards, res, entity_vocabs = load_game_model(src, coord_vocabs)
    scaled = {n: (FactoredParams(p.gamma * factor, p.projection)
                  if isinstance(p, FactoredParams) else np.asarray(p) * factor)
              for n, p in params.items()}
    save_game_model(dst, params=scaled, shards=shards, vocabs=coord_vocabs,
                    entity_vocabs={n: v for n, v in entity_vocabs.items() if res.get(n)},
                    random_effects=res, task=TaskType.LOGISTIC_REGRESSION)
    for s, v in vocabs.items():
        v.save(os.path.join(dst, f"feature-index-{s}.txt"))
    write_model_manifest(dst)


def serve_pipe(model_dir: str, device, exchange, *flags):
    """``python -m photon_ml_tpu_torch.cli.serve`` over a pipe, as an
    interactive client: ``exchange(ask)`` sends lines through ``ask(obj,
    timeout=60)``, each answer read before the next line is sent (the
    first waits for the model's load and the ladder). Returns (what
    ``exchange`` returned, the exit code, its stderr); the process is
    stopped whatever happens."""
    import queue as queue_mod
    import threading

    proc = subprocess.Popen(
        [sys.executable, "-m", "photon_ml_tpu_torch.cli.serve", "--model-dir", model_dir,
         "--dtype", "float64", *flags, *(["--device", device] if device else [])],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        cwd=ROOT, env={**os.environ, "PYTHONPATH": ROOT},
    )
    lines = queue_mod.Queue()
    err = []
    reader = threading.Thread(target=lambda: [lines.put(x) for x in proc.stdout], daemon=True)
    err_reader = threading.Thread(target=lambda: err.append(proc.stderr.read()), daemon=True)
    reader.start()
    err_reader.start()
    first = [True]

    def ask(obj, timeout=60):
        proc.stdin.write(json.dumps(obj) + "\n")
        proc.stdin.flush()
        wait, first[0] = (600 if first[0] else timeout), False
        return json.loads(lines.get(timeout=wait))

    try:
        out = exchange(ask)
        proc.stdin.close()
        code = proc.wait(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    err_reader.join(10)
    return out, code, "".join(err)


def request_line(r: ScoreRequest) -> dict:
    return {"features": r.features, "entities": r.entities, "offset": r.offset}


def serving_cli(model_dir: str, requests, want, device=None) -> dict:
    """``cli.serve`` over a pipe (``serve_pipe``): the requests, then
    ``stats``, ``metrics`` and ``health``. The scores must equal ``want``
    and the commands must count the requests."""
    t0 = time.perf_counter()
    (scores, stats_r, metrics_r, health_r), code, err = serve_pipe(
        model_dir, device, lambda ask: (
            [ask(request_line(r)).get("score", np.nan) for r in requests],
            *(ask({"cmd": c}) for c in ("stats", "metrics", "health"))))
    n = len(requests)
    summary = {"seconds": time.perf_counter() - t0, "exit": code,
               "max_err_vs_engine": serving_gaps(scores, want),
               "stats_requests": stats_r.get("requests"),
               "health_version": health_r.get("version"),
               "health_breaker": health_r.get("breaker", {}).get("state"),
               "metrics_lines": len(metrics_r.get("prometheus", "").splitlines())}
    log(f"[serve] cli.serve: {json.dumps(summary)}")
    if (code != 0 or summary["max_err_vs_engine"] > SERVE_RTOL or stats_r.get("requests") != n
            or f"photon_serving_requests {n}" not in metrics_r.get("prometheus", "")
            or health_r.get("version") != os.path.basename(model_dir)):
        raise AssertionError(f"cli.serve over a pipe: {json.dumps(summary)}; {err[-4000:]}")
    return summary


def serving_phase(work: str, served: dict, name: str = "", direct: int = SERVE_DIRECT,
                  per_pass: int = SERVE_PASS, cache_entities: int = SERVE_CACHE,
                  seed: int = SEED + 50, **device_kw):
    """Phase 5f: phase 5b's model directory and records through the
    online serving stack, on the card (``device_kw`` names another device
    for a rehearsal). Every gate raises."""
    phase_t0 = time.perf_counter()
    on_card = not device_kw
    device = device_kw.get("device")
    cuda = on_card or torch.device(device).type == "cuda"
    model_dir, card_scores = served["model_dir"], served["scores"]
    t0 = time.perf_counter()
    _, records = read_avro_file(served["data"])
    n_req = min(direct, len(records))
    requests = serving_requests(records[:n_req])
    want = np.asarray(card_scores[:n_req], np.float64)
    del records
    read_s = time.perf_counter() - t0
    log(f"[serve] {n_req} requests from phase 5b's records in {read_s:.1f} s (set-up)")

    # the engine and its ladder
    stats = _RawBucketStats()
    t0 = time.perf_counter()
    engine = ScoringEngine.from_model_dir(model_dir, dtype=torch.float64, stats=stats,
                                          **device_kw)
    load_s = time.perf_counter() - t0
    builds0 = bucket_builds()
    t0 = time.perf_counter()
    warmed = engine.warmup(max_batch=SERVE_MAX_BATCH, include_degraded=True)
    warmup_s = time.perf_counter() - t0
    builds = bucket_builds() - builds0
    gauges = {k: obs.registry().gauge(k).value for k in obs.registry().names("hbm.serving.warmup")}
    resident = stats.registry.gauge("serving.shard.resident_re_bytes_per_process").value
    dims = {s: engine._shard_dim(s) for s in engine._used_shards}
    log(f"[serve] engine on {engine.device}: load {load_s:.2f} s, warmup of {list(warmed)} and "
        f"the degraded ladder {warmup_s:.2f} s, {builds} builds (8 expected), compile_count "
        f"{engine.compile_count}, resident RE bytes {resident:.0f}, hbm {json.dumps(gauges)}, "
        f"columns per shard {json.dumps(dims)} ({sum(dims.values()) * 8} bytes a row in f64)")
    if builds != 8 or engine.compile_count != 8:
        raise AssertionError(f"warmup built {builds} bucket scorers, expected 8")
    if on_card and not gauges:
        raise AssertionError("warmup recorded no hbm.serving.warmup gauges on the card")

    # direct scoring: mixed sizes 1-64, every score against phase 5b's card
    # scores, no build and no new CUDA segment after warmup
    rng = np.random.default_rng(seed)
    sizes = []
    while sum(sizes) < n_req:
        sizes.append(int(min(rng.integers(1, SERVE_MAX_BATCH + 1), n_req - sum(sizes))))
    segments = torch.cuda.memory_stats()["segment.all.allocated"] if cuda else None
    got = np.empty(n_req)
    per_bucket = {}
    lo = 0
    t_direct = time.perf_counter()
    for size in sizes:
        batch = requests[lo:lo + size]
        t0 = time.perf_counter()
        feats, ents, offsets = engine.featurize(batch)
        t1 = time.perf_counter()
        got[lo:lo + size] = engine.score_arrays(feats, ents, offsets)
        t2 = time.perf_counter()
        del feats
        b = per_bucket.setdefault(bucket_size(size), {"featurize": [], "call": []})
        b["featurize"].append(t1 - t0)
        b["call"].append(t2 - t0)
        lo += size
    direct_s = time.perf_counter() - t_direct
    rebuilt = bucket_builds() - builds0 - builds
    new_segments = (torch.cuda.memory_stats()["segment.all.allocated"] - segments
                    if cuda else None)
    direct_err = serving_gaps(got, want)
    bucket_lines = {
        str(b): {"calls": len(v["call"]), "featurize_ms": quantiles_ms(v["featurize"]),
                 "bucket_latency_ms": quantiles_ms(stats.raw[b]),
                 "call_ms": quantiles_ms(v["call"])}
        for b, v in sorted(per_bucket.items())}
    log(f"[serve] direct: {n_req} requests in {len(sizes)} calls, {direct_s:.2f} s; max |s - "
        f"s_5b| / max(1, |s_5b|) {direct_err:.3e} (limit {SERVE_RTOL}); builds after warmup "
        f"{rebuilt}, new CUDA segments {new_segments}")
    for b, line in bucket_lines.items():
        log(f"[serve] bucket {b}: {json.dumps(line)}")
    if direct_err > SERVE_RTOL:
        raise AssertionError(f"engine scores differ from phase 5b's by {direct_err:.3e}")
    if rebuilt or engine.compile_count != 8:
        raise AssertionError("steady-state traffic built a bucket scorer")
    if cuda and new_segments != 0:
        raise AssertionError(f"steady-state traffic allocated {new_segments} CUDA segments")

    # the micro-batcher, 8 closed-loop clients
    pass_reqs = requests[:per_pass]
    pass_want = got[:per_pass]
    with MicroBatcher(engine.score, max_batch=SERVE_MAX_BATCH, max_wait_ms=SERVE_WAIT_MS,
                      stats=stats) as batcher:
        results, wall = closed_loop(batcher.submit, pass_reqs, SERVE_CLIENTS)
    errors = [a for _, a, _ in results if isinstance(a, Exception)]
    answers = np.full(per_pass, np.nan)
    for i, a, _ in results:
        if not isinstance(a, Exception):
            answers[i] = a
    batcher_err = serving_gaps(answers, pass_want)
    same_bits = int(np.sum(answers == pass_want))
    batcher_summary = {"requests": len(results), "requests_per_s": len(results) / wall,
                       "latency_ms": quantiles_ms([t for _, _, t in results]),
                       "batches": int(stats.batches),
                       "occupancy_mean": stats.snapshot()["batch_occupancy_mean"],
                       "max_err_vs_direct": batcher_err, "same_bits_as_direct": same_bits,
                       "errors": len(errors)}
    log(f"[serve] batcher: {json.dumps(batcher_summary)}")
    if errors or len(results) != per_pass or batcher_err > SERVE_RTOL:
        raise AssertionError(f"batcher answers: {len(errors)} errors, {len(results)} of "
                             f"{per_pass}, max err {batcher_err:.3e}")

    # hot reload under that load: v2 is the model with every coefficient
    # halved, so its score is 0.5 (s - offset) + offset
    watch = os.path.join(work, "watch")
    v2_dir = os.path.join(watch, "v2")
    t0 = time.perf_counter()
    write_model_manifest(model_dir)
    scaled_game_model(model_dir, v2_dir, 0.5)
    publish_s = time.perf_counter() - t0
    offsets = np.asarray([r.offset for r in pass_reqs])
    v2_want = 0.5 * (pass_want - offsets) + offsets
    reg_stats = ServingStats()

    def factory(root):
        # v1 is the warmed engine above; v2 is built from its directory
        if root == model_dir:
            return engine
        return ScoringEngine.from_model_dir(root, dtype=torch.float64, stats=reg_stats,
                                            **device_kw)

    registry = ModelRegistry(engine_factory=factory, warmup_max_batch=SERVE_MAX_BATCH,
                             stats=reg_stats)
    registry.load(model_dir)
    import threading

    reloaded = threading.Event()
    out = []
    with MicroBatcher(registry.score, max_batch=SERVE_MAX_BATCH, max_wait_ms=SERVE_WAIT_MS,
                      stats=reg_stats) as batcher:
        loop = threading.Thread(target=lambda: out.append(closed_loop(
            batcher.submit, pass_reqs, SERVE_CLIENTS, keep_going=lambda: not reloaded.is_set())))
        loop.start()
        while len(out) == 0 and reg_stats.requests < per_pass // 4:
            time.sleep(0.01)
        t0 = time.perf_counter()
        v2 = registry.load(v2_dir)
        reload_s = time.perf_counter() - t0
        reloaded.set()
        loop.join(900)
        if loop.is_alive() or not out:
            raise AssertionError("the reload pass's clients did not finish")
    results, wall = out[0]
    dropped = [a for _, a, _ in results if isinstance(a, Exception)]
    which = {"v1": 0, "v2": 0, "neither": 0}
    for i, a, _ in results:
        if isinstance(a, Exception):
            continue
        if serving_gaps([a], [pass_want[i]]) <= SERVE_RTOL:
            which["v1"] += 1
        elif serving_gaps([a], [v2_want[i]]) <= SERVE_RTOL:
            which["v2"] += 1
        else:
            which["neither"] += 1
    after = registry.score(pass_reqs[:SERVE_MAX_BATCH])
    after_err = serving_gaps(after, v2_want[:SERVE_MAX_BATCH])
    reload_summary = {"requests": len(results), "dropped": len(dropped), **which,
                      "requests_per_s": len(results) / wall, "reload_s": reload_s,
                      "publish_s": publish_s, "version": registry.version(),
                      "retired": registry.retired_versions,
                      "after_reload_max_err_vs_v2": after_err}
    log(f"[serve] hot reload: {json.dumps(reload_summary)}")
    if (dropped or which["neither"] or not which["v1"] or not which["v2"]
            or len(results) < per_pass or registry.version() != "v2" or after_err > SERVE_RTOL):
        raise AssertionError(f"hot reload under load: {json.dumps(reload_summary)}")
    v2.engine.close()
    del registry, v2

    # the tiered entity cache: 512 slots per RE key under Zipf(1.1) users;
    # promotion between batches (the workers stopped), so each row's
    # residency is known when it is scored
    n_users = len(engine.re_vocabs["userId"])
    zipf_users = (rng.zipf(SERVE_ZIPF, per_pass) - 1) % n_users
    cache_reqs = [ScoreRequest(r.features, {**r.entities, "userId": f"user{u}"}, r.offset)
                  for r, u in zip(pass_reqs, zipf_users.tolist())]
    cached = ScoringEngine.from_model_dir(model_dir, dtype=torch.float64,
                                          hbm_cache_entities=cache_entities, **device_kw)
    cached.warmup(max_batch=SERVE_MAX_BATCH)
    for cache in cached._caches.values():
        cache.close()
    cache_err, hit_rows = 0.0, 0
    for lo in range(0, per_pass, SERVE_MAX_BATCH):
        batch = cache_reqs[lo:lo + SERVE_MAX_BATCH]
        feats, ents, offs = cached.featurize(batch)
        masked = {rk: np.where(cached._caches[rk].slot_of[np.maximum(col, 0)] >= 0, col, -1)
                  for rk, col in ents.items()}
        hit_rows += int(np.sum(masked["userId"] >= 0))
        cache_err = max(cache_err, serving_gaps(cached.score_arrays(feats, ents, offs),
                                                engine.score_arrays(feats, masked, offs)))
        del feats
        for cache in cached._caches.values():
            cache.promote_pending()
    cache_summary = {"requests": per_pass, "capacity": cache_entities, "users": n_users,
                     "user_hit_rate": hit_rows / per_pass,
                     "hit_rate_all_keys": cached.stats.cache_hit_frac(),
                     "snapshot": cached.cache_snapshot(),
                     "resident_re_bytes": cached.stats.registry.gauge(
                         "serving.shard.resident_re_bytes_per_process").value,
                     "max_err_vs_uncached_with_misses_cold": cache_err}
    log(f"[serve] tiered cache: {json.dumps(cache_summary)}")
    if cache_err > SERVE_RTOL or not 0 < hit_rows < per_pass:
        raise AssertionError(f"tiered cache: {json.dumps(cache_summary)}")
    cached.close()
    del cached

    # the CLI over a pipe: the requests first (their answers read back),
    # then the commands
    cli_summary = serving_cli(model_dir, requests[:SERVE_CLI_REQUESTS],
                              got[:SERVE_CLI_REQUESTS], device)
    summary = {
        "device": str(engine.device), "requests_direct": n_req, "calls_direct": len(sizes),
        "load_s": load_s, "warmup_s": warmup_s, "builds": builds,
        "builds_after_warmup": rebuilt,
        "new_cuda_segments": new_segments, "resident_re_bytes": resident,
        "hbm_warmup": gauges, "row_bytes": sum(dims.values()) * 8,
        "direct_s": direct_s, "max_err_vs_5b": direct_err, "buckets": bucket_lines,
        "batcher": batcher_summary, "reload": reload_summary, "cache": cache_summary,
        "cli": cli_summary, "phase_s": time.perf_counter() - phase_t0,
    }
    log(f"[serve] {json.dumps(summary)}")
    engine.close()
    return summary


# -- phase 5c: GAME training end to end -------------------------------------

# examples/game_train.json at the Criteo layout's width: the global fixed
# effect on the 13 + 26 hashed fields (ELL: fused_vgc / fused_hvp in its
# TRON, ell_matvec in its rescore and in every validation) and a per-user
# random effect on the 13 integer fields plus the intercept (dense, d = 14;
# the batched per-entity TRON), users drawn Zipf(1.1)
GAME_TRAIN_USERS = 4096
GAME_TRAIN_ITERATIONS = 3
# depth cut from 2^16 + 2^14 so that phase 5d fits the run's time
GAME_TRAIN_RECORDS = 1 << 15
GAME_TRAIN_HELDOUT = 1 << 13
# the card's fused passes split from the CPU's in the last bits (atomics),
# TRON's trajectory amplifies the split (its iterations differ from the
# first solve on), and coordinate descent feeds it into the next
# coordinate's offsets: the fixed effect converges far past the default so
# that both runs end near one optimum. On an H100 at 1e-12 the card and the
# CPU ended 2.6e-6 apart in w (over the 1e-6 gate), at 1e-15 8.1e-8 apart
GAME_TRAIN_FIXED_TOLERANCE = 1e-15
# card against CPU, per-update training objectives, relative. An update
# after the fixed effect's moves the objective at first order in the fixed
# effect's split: on an H100 the card against ITSELF differed by 1.3e-9
# (7.3e-9) at 1e-15 (1e-14), and healthy runs against the CPU by at most
# 1.09e-8; with a per-user bucket solved in float32 (chip_game_faults.py)
# by 1.01e-6. The gate sits between the two. A fault in one entity moves
# the objectives no more than the healthy split: the table's gate is the
# one that sees it (4.0e-4 of a 1e-6 limit)
GAME_TRAIN_OBJECTIVE_RTOL = 1e-7
GAME_TRAIN_COORDINATES = {
    "global": {"shard": "gshard", "optimizer": "TRON", "reg_weights": [1.0],
               "max_iters": 100},
    "per-user": {"shard": "ushard", "random_effect": "userId", "optimizer": "TRON",
                 "reg_weights": [10.0, 1.0], "max_iters": 20, "tolerance": 1e-8,
                 "num_buckets": 2},
}


# the solver settings that the descent at examples/game_train.json's
# settings takes from that file, per coordinate
EXAMPLE_SOLVER_FIELDS = ("optimizer", "reg_weights", "max_iters", "tolerance")


def write_game_training_inputs(work: str, n: int, n_heldout: int, d_hashed: int,
                               n_users: int, seed: int = SEED + 30, user_cols: int = 0,
                               n_ads: int = 0):
    """Both shards' feature-index files and two Avro inputs, training and
    held-out, drawn as phase 6's from one seeded global logistic model plus
    a seeded model per user: the Criteo fields, a userId drawn Zipf(1.1)
    over ``n_users`` users, offsets. Returns (vocabulary paths, the two
    data paths, the training set's design straight from the generator:
    ELL COO over the global shard, the dense user shard, the user ids).

    With ``user_cols`` and ``n_ads`` (phase 5d) each record also carries a
    wide per-user shard in phase 5b's layout (a private pool of 25 of
    ``user_cols`` columns per user, 5 a row, feature name ``w``) and an
    adId drawn uniformly over ``n_ads`` ads, both in the labels' model
    (per-user coefficients on the pool, a per-ad model on the user
    shard), drawn from a second generator so that the base records keep
    their draws; the vocabulary paths then include the wide shard's and
    the design the wide COO and the ad ids."""
    rng = np.random.default_rng(seed)
    xrng = np.random.default_rng(seed + 7)
    gpath = os.path.join(work, "feature-index-gshard.txt")
    upath = os.path.join(work, "feature-index-ushard.txt")
    gvocab = hashed_vocabulary(gpath, d_hashed)
    int_cols = _hash(np.arange(INT_FIELDS), np.zeros(INT_FIELDS, np.int64)) % d_hashed
    uvocab = FeatureVocabulary([feature_key("h", str(c)) for c in int_cols.tolist()],
                               add_intercept=True)
    uvocab.save(upath)
    slot = np.full(d_hashed, -1)
    slot[int_cols] = np.arange(INT_FIELDS)
    w_g = rng.normal(0.0, 0.25, size=len(gvocab))
    w_u = rng.normal(0.0, 0.3, size=(n_users, len(uvocab)))
    vocab_paths = [gpath, upath]
    if user_cols:
        wpath = os.path.join(work, "feature-index-wshard.txt")
        FeatureVocabulary([feature_key("w", str(j)) for j in range(user_cols)]).save(wpath)
        vocab_paths.append(wpath)
        pools = xrng.integers(0, user_cols, size=(n_users, GAME_USER_POOL))
        w_pool = xrng.normal(0.0, 0.5, size=pools.shape)
        w_ad = xrng.normal(0.0, 0.3, size=(n_ads, len(uvocab)))
    paths, train_design = [], None
    for label, count, set_seed in (("train", n, seed + 1), ("heldout", n_heldout, seed + 2)):
        rows, cols, vals = make_criteo_like(count, set_seed)
        cols = cols % d_hashed
        users = (rng.zipf(1.1, size=count) - 1) % n_users
        # the user shard: every feature its vocabulary names (an integer
        # field's column, and any categorical value hashed onto one)
        in_u = slot[cols] >= 0
        x_u = np.zeros((count, len(uvocab)))
        np.add.at(x_u, (rows[in_u], slot[cols[in_u]]), vals[in_u])
        x_u[:, uvocab.intercept_index] = 1.0
        offsets = rng.normal(0.0, 0.1, size=count)
        margins = (np.bincount(rows, vals * w_g[cols], minlength=count)
                   + w_g[gvocab.intercept_index] + np.einsum("nd,nd->n", x_u, w_u[users])
                   + offsets)
        per_row = cols.size // count
        blocks = [("h", cols.reshape(count, per_row), vals.reshape(count, per_row))]
        metadata = {"userId": [f"user{u}" for u in users.tolist()]}
        if user_cols:
            pick = xrng.integers(0, GAME_USER_POOL, (count, GAME_USER_PER_ROW))
            wcols = pools[users[:, None], pick]
            wvals = xrng.normal(size=wcols.shape)
            ads = xrng.integers(0, n_ads, count)
            margins += (np.einsum("nj,nj->n", wvals, w_pool[users[:, None], pick])
                        + np.einsum("nd,nd->n", x_u, w_ad[ads]))
            blocks.append(("w", wcols, wvals))
            metadata["adId"] = [f"ad{a}" for a in ads.tolist()]
        labels = (rng.uniform(size=count) < 1.0 / (1.0 + np.exp(-margins))).astype(np.float64)
        path = os.path.join(work, label, "part-00000.avro")
        write_examples_file(path, "t", labels, offsets, blocks, metadata)
        paths.append(path)
        if label == "train":
            icpt = np.full(count, gvocab.intercept_index)
            train_design = ((np.concatenate([rows, np.arange(count)]),
                             np.concatenate([cols, icpt]),
                             np.concatenate([vals, np.ones(count)]), len(gvocab)),
                            x_u, users, labels, offsets)
            if user_cols:
                train_design += ((wcols, wvals, user_cols), ads)
    return tuple(vocab_paths), paths, train_design


def _fixed_records(history):
    return [h for h in history if h.coordinate == "global"]


def game_train_params(work: str, train: str, heldout: str, gpath: str, upath: str,
                      fixed_tolerance: float = GAME_TRAIN_FIXED_TOLERANCE) -> dict:
    """Phase 5c's driver configuration over the written inputs."""
    return {
        "train_input": [train],
        "validate_input": [heldout],
        "output_dir": os.path.join(work, "out"),
        "task": "LOGISTIC_REGRESSION",
        "num_iterations": GAME_TRAIN_ITERATIONS,
        "updating_sequence": ["global", "per-user"],
        "feature_shards": {"gshard": gpath, "ushard": upath},
        "coordinates": {**GAME_TRAIN_COORDINATES, "global": {
            **GAME_TRAIN_COORDINATES["global"], "tolerance": fixed_tolerance}},
        "sparse_shards": ["gshard"],
        "model_output_mode": "BEST",
        "precision": "float64",
    }


def game_train_gaps(run, cpu) -> dict:
    """A GAME training run's readings against the CPU's run of the same
    configuration (or against another run, on any device), the quantities
    phase 5c's gates hold: the best combo, the per-update training
    objectives (relative), the validation AUC,
    the best model's fixed effect and random-effect table (absolute, with
    their scales), and the entity updates whose iterations differ."""
    history = [h for s in run.sweep for h in s["history"]]
    cpu_history = [h for s in cpu.sweep for h in s["history"]]
    obj_errs = [abs(a.objective - b.objective) / abs(b.objective)
                for a, b in zip(history, cpu_history)]
    best, cpu_best = run.sweep[run.best_index]["model"], cpu.sweep[cpu.best_index]["model"]
    w_card, w_cpu = best.params["global"].cpu(), cpu_best.params["global"].cpu()
    t_card, t_cpu = best.params["per-user"].cpu(), cpu_best.params["per-user"].cpu()
    per_user = [(a, b) for a, b in zip(history, cpu_history) if a.coordinate == "per-user"]
    return {
        "best_index": [run.best_index, cpu.best_index],
        "updates": [len(history), len(cpu_history)],
        "objective": max(obj_errs),
        "objective_per_update": obj_errs,
        "auc": max(abs(a.validation_metric - b.validation_metric)
                   for a, b in zip(history, cpu_history)),
        "w": float((w_card - w_cpu).abs().max()),
        "w_scale": max(1.0, float(w_cpu.abs().max())),
        "table": float((t_card - t_cpu).abs().max()),
        "table_scale": max(1.0, float(t_cpu.abs().max())),
        "entity_updates_with_other_iterations": int(sum(
            int(np.sum(a.entity_iterations != b.entity_iterations)) for a, b in per_user)),
        "fixed_iterations": [(int(a.solver_iterations), int(b.solver_iterations))
                             for a, b in zip(_fixed_records(history),
                                             _fixed_records(cpu_history))],
    }


def game_train_gate_failures(gaps: dict) -> list:
    """Which of phase 5c's card-against-CPU gates a run's readings break."""
    failed = []
    if gaps["best_index"][0] != gaps["best_index"][1]:
        failed.append("best combo")
    if gaps["updates"][0] != gaps["updates"][1]:
        failed.append("update count")
    if not gaps["objective"] <= GAME_TRAIN_OBJECTIVE_RTOL:
        failed.append("objectives")
    if not gaps["auc"] <= 1e-6:
        failed.append("AUC")
    if not gaps["w"] <= 1e-6 * gaps["w_scale"]:
        failed.append("fixed effect")
    if not gaps["table"] <= 1e-6 * gaps["table_scale"]:
        failed.append("random-effect table")
    return failed


def traced_descents(gparams, data: GameData, entity_counts: dict, columns, device,
                    cache: dict, on_card: bool):
    """Each combo's coordinate descent over ``data`` (ingest excluded)
    under ``torch.profiler``, with the launch counters set to 0 just
    before and read just after. Returns (the histories, the card's busy
    time, the wall seconds, the launches)."""
    coords_by_combo = [
        build_coordinates(gparams, data, TaskType.LOGISTIC_REGRESSION, combo,
                          entity_counts, device=device, design_cache=cache)
        for combo in gparams.grid()
    ]
    # the card's activity only: tracing every host op of some 20,000 CG
    # steps took 100 s to record and read back on an H100 host
    activities = ([torch.profiler.ProfilerActivity.CUDA] if on_card
                  else [torch.profiler.ProfilerActivity.CPU])
    synchronize(device)
    dispatch.reset_launch_counts()
    with torch.profiler.profile(activities=activities) as prof:
        t0 = time.perf_counter()
        histories = [
            CoordinateDescent(coords, *columns, task=TaskType.LOGISTIC_REGRESSION).run(
                gparams.num_iterations)[1]
            for coords in coords_by_combo
        ]
        synchronize(device)
        wall_s = time.perf_counter() - t0
    launches = dispatch.launch_counts()
    return histories, device_busy(prof), wall_s, launches


def game_train_phase(work: str, name: str = "", n: int = GAME_TRAIN_RECORDS,
                     n_heldout: int = GAME_TRAIN_HELDOUT, d_hashed: int = D_HASHED,
                     n_users: int = GAME_TRAIN_USERS,
                     fixed_tolerance: float = GAME_TRAIN_FIXED_TOLERANCE, inputs=None,
                     **device_kw):
    """Run the port's GAME training driver on the card (``device_kw``
    names another device for a rehearsal), counters set to 0 just before
    and read just after and held to the trainer's own counts; then the
    descent alone under ``torch.profiler``, in this configuration and with
    ``examples/game_train.json``'s solver settings; then the same driver on
    the CPU, the card held to it; then ``fused_vgc`` and ``fused_hvp`` held to their
    plain versions on the last fixed-effect update's batch and offsets."""
    t0 = time.perf_counter()
    if inputs is None:
        inputs = write_game_training_inputs(work, n, n_heldout, d_hashed, n_users)
    (gpath, upath), (train, heldout), design = inputs
    wait_written(train, heldout)
    setup_s = time.perf_counter() - t0
    log(f"[game-train] wrote {n} training and {n_heldout} held-out records "
        f"({d_hashed} hashed columns + intercept, {n_users} users) in {setup_s:.1f} s (set-up)")
    params = game_train_params(work, train, heldout, gpath, upath, fixed_tolerance)
    on_card = not device_kw

    # the last fixed-effect update's inputs, for the kernel checks below
    last_fixed = {}
    update_and_score = FixedEffectCoordinate.update_and_score

    def recording(self, w, partial_scores, generator=None):
        last_fixed.update(batch=self.batch, w=w, partial=partial_scores)
        return update_and_score(self, w, partial_scores, generator)

    FixedEffectCoordinate.update_and_score = recording
    try:
        dispatch.reset_launch_counts()
        reset_host_reads()
        t0 = time.perf_counter()
        run = run_game_training(params, **device_kw)
        wall_s = time.perf_counter() - t0
        launches = dispatch.launch_counts()
        reads = host_reads()
    finally:
        FixedEffectCoordinate.update_and_score = update_and_score
    require_native(run, "[game-train]")

    # the trainer's own counts: a TRON evaluation per iteration plus the
    # first, a CG step per fused_hvp; ell_matvec for each combo's initial
    # score, each fixed-effect rescore and each validation, and the quality
    # fingerprint's margin pass over the training rows
    history = [h for s in run.sweep for h in s["history"]]
    fixed = _fixed_records(history)
    expected = with_reduce({
        "fused_vgc": sum(int(h.solver_iterations) + 1 for h in fixed),
        "fused_hvp": sum(h.cg_iterations for h in fixed),
        "ell_matvec": (len(run.sweep) + len(fixed)
                       + sum(h.validation_metric is not None for h in history)
                       + fingerprint_launches(run)),
    })
    want = {k: (expected.get(k, 0) if on_card else 0) for k in launches}
    failures = []
    if launches != want:
        failures.append(f"GAME training launched {launches}, expected {want}")
    per_user = [h for h in history if h.coordinate == "per-user"]
    for combo in run.sweep:
        log(f"[game-train] combo {json.dumps(combo['combo'])}: "
            + "; ".join(f"pass {h.iteration} {h.coordinate} objective {h.objective!r} "
                        f"AUC {h.validation_metric!r} {h.seconds:.4f} s"
                        for h in combo["history"]))
    hist = np.bincount(np.concatenate([h.entity_iterations for h in per_user]))
    log(f"[game-train] card run {wall_s:.4f} s, phases {json.dumps(run.timings)}, "
        f"launches {json.dumps({k: v for k, v in launches.items() if v})}, "
        f"{reads} host reads; per-user iterations histogram {hist.tolist()}")

    # the descent alone, ingest excluded, under torch.profiler: the design
    # straight from the generator, each combo's three passes; first in
    # this configuration, then with the solver settings of
    # examples/game_train.json (the fixed effect at lambda 0.1, 20
    # iterations, tolerance 1e-8), the settings users run
    (rows, cols, vals, d), x_u, users, labels, offsets = design
    device = torch.device(run.device)
    entity_ids = np.unique(users, return_inverse=True)[1].astype(np.int32)
    data = GameData.create(
        features={"gshard": from_coo(rows, cols, vals, n, d, dtype=torch.float64), "ushard": x_u},
        labels=labels, offsets=offsets, entity_ids={"userId": entity_ids},
    )
    columns = [torch.as_tensor(c, dtype=torch.float64, device=device)
               for c in (data.labels, data.offsets, data.weights)]
    cache = {}
    traced, busy, traced_wall_s, _ = traced_descents(
        run.params, data, {"userId": int(entity_ids.max()) + 1}, columns, device, cache,
        on_card)
    # the card against itself: the same descent on the same card, apart
    # from the atomics' last bits (and the entities' order)
    card_spread = max(abs(a.objective - b.objective) / abs(b.objective)
                      for a, b in zip([h for t in traced for h in t], history))
    with open(os.path.join(ROOT, "examples", "game_train.json")) as f:
        example = json.load(f)["coordinates"]
    example_params = dataclasses.replace(run.params, coordinates={
        name: dataclasses.replace(spec, **{k: example[name][k] for k in EXAMPLE_SOLVER_FIELDS})
        for name, spec in run.params.coordinates.items()})
    ex_traced, ex_busy, ex_wall_s, ex_launches = traced_descents(
        example_params, data, {"userId": int(entity_ids.max()) + 1}, columns, device,
        cache, on_card)
    ex_history = [h for t in ex_traced for h in t]
    ex_fixed = _fixed_records(ex_history)
    ex_expected = with_reduce({
        "fused_vgc": sum(int(h.solver_iterations) + 1 for h in ex_fixed),
        "fused_hvp": sum(h.cg_iterations for h in ex_fixed),
        "ell_matvec": len(ex_traced) + len(ex_fixed),
    })
    ex_want = {k: (ex_expected.get(k, 0) if on_card else 0) for k in ex_launches}
    if ex_launches != ex_want:
        failures.append(f"GAME descent at the example's settings launched {ex_launches}, "
                        f"expected {ex_want}")
    example_summary = {
        "solver_settings": {name: {k: example[name][k] for k in EXAMPLE_SOLVER_FIELDS}
                            for name in example},
        "traced_descent_s": ex_wall_s,
        **ex_busy,
        "device_idle_share": (None if ex_busy["device_busy_s"] is None
                              else 1.0 - ex_busy["device_busy_s"] / ex_wall_s),
        "update_s": {c: [h.seconds for h in ex_history if h.coordinate == c]
                     for c in ("global", "per-user")},
        "fixed_iterations": [int(h.solver_iterations) for h in ex_fixed],
        "fixed_cg_iterations": [h.cg_iterations for h in ex_fixed],
        "per_user_mean_iterations": [h.solver_iterations for h in ex_history
                                     if h.coordinate == "per-user"],
        "launches": ex_launches,
    }
    log(f"[game-train] the descent at examples/game_train.json's solver settings: "
        f"{json.dumps(example_summary)}")
    del cache, data, columns

    # the same driver on the CPU
    t0 = time.perf_counter()
    cpu = run_game_training({**params, "output_dir": os.path.join(work, "out-cpu")},
                            device="cpu")
    cpu_wall_s = time.perf_counter() - t0
    require_native(cpu, "[game-train] the CPU run")
    gaps = game_train_gaps(run, cpu)
    gate_failures = game_train_gate_failures(gaps)
    log(f"[game-train] card vs CPU: objectives {gaps['objective']:.3e} relative (limit "
        f"{GAME_TRAIN_OBJECTIVE_RTOL:g}; per update "
        f"{['%.1e' % e for e in gaps['objective_per_update']]}; the card against itself "
        f"{card_spread:.3e}), AUC {gaps['auc']:.3e} (limit 1e-6), fixed effect "
        f"{gaps['w']:.3e} of {gaps['w_scale']:.4f} (limit 1e-6), per-user table "
        f"{gaps['table']:.3e} of {gaps['table_scale']:.4f} (limit 1e-6); "
        f"{gaps['entity_updates_with_other_iterations']} entity updates with other "
        f"iterations; fixed-effect iterations (card, CPU) {gaps['fixed_iterations']}")
    if gate_failures:
        failures.append(f"GAME training on the card disagrees with the CPU run: "
                        f"{', '.join(gate_failures)}")
    w_card = run.sweep[run.best_index]["model"].params["global"].cpu()
    t_card = run.sweep[run.best_index]["model"].params["per-user"].cpu()
    auc = run.sweep[run.best_index]["validation_metric"]
    if not (0.5 < auc <= 1.0 and np.isfinite(w_card.numpy()).all()
            and np.isfinite(t_card.numpy()).all()):
        failures.append(f"GAME training: AUC {auc}, non-finite coefficients")

    # fused_vgc and fused_hvp against their plain versions on the last
    # fixed-effect update's batch and offsets (nonzero: the random
    # effect's scores)
    kernel_errs = {}
    if on_card:
        b, w = last_fixed["batch"], last_fixed["w"]
        x = b.features
        off = b.offsets + last_fixed["partial"]
        ew = b.effective_weights()
        got = fused_value_grad_curvature(x.indices, x.values, b.labels, off, ew, w, x.d,
                                         LOGISTIC_LOSS)
        ref = fused_value_grad_curvature_reference(x.indices, x.values, b.labels, off, ew, w,
                                                   x.d, LOGISTIC_LOSS)
        kernel_errs["fused_vgc"] = max(
            float((g - r).abs().max()) / (float(r.abs().max()) + 1.0) for g, r in zip(got, ref))
        g = torch.Generator(device=device).manual_seed(SEED + 31)
        v = torch.randn(x.d, generator=g, device=device, dtype=torch.float64)
        shift = torch.zeros((), dtype=torch.float64, device=device)
        got = fused_hessian_vector(x.indices, x.values, ref[3], v, shift, x.d)
        ref_h = fused_hessian_vector_reference(x.indices, x.values, ref[3], v, shift, x.d)
        kernel_errs["fused_hvp"] = max(
            float((a - r).abs().max()) / (float(r.abs().max()) + 1.0) for a, r in zip(got, ref_h))
        log(f"[game-train] kernels on the last fixed-effect update's inputs: "
            f"{json.dumps(kernel_errs)} (limit 1e-10 of the output's scale); "
            f"offsets max |partial| {float(last_fixed['partial'].abs().max()):.4f}")
        if max(kernel_errs.values()) > 1e-10:
            failures.append(f"fused passes at the GAME shape: {kernel_errs}")
        del b, x, off, ew, got, ref, ref_h, v
        last_fixed.clear()
    summary = {
        "records": n,
        "heldout_records": n_heldout,
        "users": n_users,
        "entities": len(run.entity_vocabs["userId"]),
        "device": run.device,
        "wall_s": wall_s,
        "timings_s": run.timings,
        "combo_s": [s["seconds"] for s in run.sweep],
        "update_s": {c: [h.seconds for h in history if h.coordinate == c]
                     for c in ("global", "per-user")},
        "best_combo": run.sweep[run.best_index]["combo"],
        "best_auc": auc,
        "launches": launches,
        "expected_launches": expected,
        "host_reads": reads,
        "fixed_iterations": [int(h.solver_iterations) for h in fixed],
        "fixed_cg_iterations": [h.cg_iterations for h in fixed],
        "per_user_iterations_histogram": hist.tolist(),
        "per_user_mean_iterations": [h.solver_iterations for h in per_user],
        "traced_descent_s": traced_wall_s,
        **busy,
        "device_idle_share": (None if busy["device_busy_s"] is None
                              else 1.0 - busy["device_busy_s"] / traced_wall_s),
        "cpu_wall_s": cpu_wall_s,
        "cpu_timings_s": cpu.timings,
        "gaps_vs_cpu": gaps,
        "card_vs_card_objective_spread": card_spread,
        "fixed_tolerance": fixed_tolerance,
        "example_settings": example_summary,
        "kernel_errs_at_last_update": kernel_errs,
        "setup_s": setup_s,
    }
    log(f"[game-train] {json.dumps(summary)}")
    if failures:
        raise AssertionError("; ".join(failures))
    return summary


# -- phase 5d: GAME training with projected and factored effects -------------

# phase 5c's layout plus a wide per-user shard (phase 5b's layout) and an
# adId over 1,024 ads; the coordinates of examples/run_wide_game.sh's
# wide effect (INDEX_MAP), a RANDOM=8 per-ad effect (NEWTON) and a factored
# per-user effect (latent 8, OWL-QN for gamma and for B). The settings
# under which the card first meets the gates against itself, on an H100:
# the fixed effect at phase 5c's check settings but lambda 10 (at lambda
# 1 its first solve on these records split 1.6e-6 and 1.2e-6 from the
# CPU's, at 10 1.2e-7); the factored effect converged (tolerance 1e-15,
# at most 1,000 iterations; at 30 or 100 every heavy user stopped at the
# cap and the split grew to 1e-3), gamma at lambda 100 and B at 300: B's
# objective sums every row, so a function-value stopping rule leaves it
# sqrt(tolerance x objective / weight) loose, 7.2e-6 at 30 and 4.3e-9 at
# 300 from the CPU's; gamma at 30 ended 7.4e-7 from the CPU's, at 100
# 3.5e-9
GAME_PROJ_ITERATIONS = 2
GAME_PROJ_ADS = 1024
# phases 5d and 5e: depth cut from 2^16 + 2^14 to phase 5c's, so that the
# whole run keeps inside its time limit on a slow host (a run of 1153 s on
# an H100 whose CPU references ran 1.7-2.9x slower than the run before)
GAME_PROJ_RECORDS = GAME_TRAIN_RECORDS
GAME_PROJ_HELDOUT = GAME_TRAIN_HELDOUT
GAME_PROJ_COORDINATES = {
    "global": {"shard": "gshard", "optimizer": "TRON", "reg_weights": [10.0],
               "max_iters": 100, "tolerance": GAME_TRAIN_FIXED_TOLERANCE},
    "per-user-wide": {"shard": "wshard", "random_effect": "userId", "projector": "INDEX_MAP",
                      "min_support": 1, "optimizer": "TRON", "reg_weights": [1.0],
                      "max_iters": 30, "tolerance": 1e-8},
    "per-ad": {"shard": "ushard", "random_effect": "adId", "projector": "RANDOM=8",
               "optimizer": "NEWTON", "reg_weights": [10.0, 1.0], "max_iters": 20,
               "tolerance": 1e-8},
    "per-user-latent": {"shard": "ushard", "random_effect": "userId", "latent_dim": 8,
                        "optimizer": "LBFGS", "l1_ratio": 0.5, "reg_weights": [100.0],
                        "latent_reg_weight": 300.0, "max_iters": 1000,
                        "tolerance": GAME_TRAIN_FIXED_TOLERANCE},
}
GAME_PROJ_SEQUENCE = ["global", "per-user-wide", "per-ad", "per-user-latent"]


def game_projected_params(work: str, train: str, heldout: str, vocab_paths, out: str) -> dict:
    gpath, upath, wpath = vocab_paths
    return {
        "train_input": [train],
        "validate_input": [heldout],
        "output_dir": os.path.join(work, out),
        "task": "LOGISTIC_REGRESSION",
        "num_iterations": GAME_PROJ_ITERATIONS,
        "updating_sequence": GAME_PROJ_SEQUENCE,
        "feature_shards": {"gshard": gpath, "ushard": upath, "wshard": wpath},
        "coordinates": GAME_PROJ_COORDINATES,
        "sparse_shards": ["gshard", "wshard"],
        "model_output_mode": "BEST",
        "precision": "float64",
        "checkpoint_every": 1,
    }


def _leaves(params: dict) -> dict:
    """A GAME model's tables by name, FactoredParams as two leaves."""
    out = {}
    for n, p in params.items():
        if isinstance(p, FactoredParams):
            out[f"{n}#gamma"], out[f"{n}#projection"] = p.gamma, p.projection
        else:
            out[n] = p
    return {n: (p if torch.is_tensor(p) else torch.from_numpy(np.asarray(p))).cpu()
            for n, p in out.items()}


def game_projected_gaps(run, other) -> dict:
    """Phase 5d's readings of a run against another of the same
    configuration: the best combo, the per-update objectives (relative),
    the validation AUC, the best model's fixed effect, each random-effect
    table in the original space (gamma and B apart for the factored one,
    each with its scale), and whether the INDEX_MAP table's nonzero
    pattern is the same."""
    history = [h for s in run.sweep for h in s["history"]]
    other_history = [h for s in other.sweep for h in s["history"]]
    a = _leaves(run.sweep[run.best_index]["model"].params)
    b = _leaves(other.sweep[other.best_index]["model"].params)
    tables = {n: [float((a[n] - b[n]).abs().max()), max(1.0, float(b[n].abs().max()))]
              for n in b}
    return {
        "best_index": [run.best_index, other.best_index],
        "updates": [len(history), len(other_history)],
        "objective": max(abs(x.objective - y.objective) / abs(y.objective)
                         for x, y in zip(history, other_history)),
        "auc": max(abs(x.validation_metric - y.validation_metric)
                   for x, y in zip(history, other_history)),
        "tables": tables,
        "index_map_pattern_equal": bool(torch.equal(a["per-user-wide"] != 0,
                                                    b["per-user-wide"] != 0)),
    }


def game_projected_gate_failures(gaps: dict) -> list:
    failed = []
    if gaps["best_index"][0] != gaps["best_index"][1]:
        failed.append("best combo")
    if gaps["updates"][0] != gaps["updates"][1]:
        failed.append("update count")
    if not gaps["objective"] <= GAME_TRAIN_OBJECTIVE_RTOL:
        failed.append("objectives")
    if not gaps["auc"] <= 1e-6:
        failed.append("AUC")
    failed += [f"table {n}" for n, (err, scale) in gaps["tables"].items()
               if not err <= 1e-6 * scale]
    if not gaps["index_map_pattern_equal"]:
        failed.append("INDEX_MAP nonzero pattern")
    return failed


class _PreemptAfterFirstPass(GracefulShutdown):
    """The driver's preemption handler, hit by SIGTERM (through its own
    signal handler) at the end of the first pass: a deterministic
    preemption, with no sleep and no race."""

    def __call__(self) -> bool:
        if not self.requested:
            self._handle(signal.SIGTERM, None)
        return self.requested


def game_projected_phase(work: str, name: str = "", n: int = GAME_PROJ_RECORDS,
                         n_heldout: int = GAME_PROJ_HELDOUT, d_hashed: int = D_HASHED,
                         n_users: int = GAME_TRAIN_USERS, user_cols: int = GAME_USER_COLS,
                         n_ads: int = GAME_PROJ_ADS, inputs=None, **device_kw):
    """Phase 5d: the GAME training driver with an INDEX_MAP wide effect, a
    RANDOM=8 one and a factored one on the card (``device_kw`` names
    another device for a rehearsal), counters set to 0 just before and
    read just after and held to the trainer's counts; a run preempted
    after its first pass and resumed, held to the first run; the descent
    alone under ``torch.profiler``; the same driver on the CPU, the card
    held to it; the saved model scored by the GAME scoring driver and its
    factored effect through the matrix-factorization files."""
    phase_t0 = t0 = time.perf_counter()
    if inputs is None:
        inputs = write_game_training_inputs(work, n, n_heldout, d_hashed, n_users,
                                            user_cols=user_cols, n_ads=n_ads)
    vocab_paths, (train, heldout), design = inputs
    wait_written(train, heldout)
    setup_s = time.perf_counter() - t0
    log(f"[game-proj] wrote {n} training and {n_heldout} held-out records ({d_hashed} hashed "
        f"columns + intercept, {n_users} users x {user_cols} wide columns, {n_ads} ads) in "
        f"{setup_s:.1f} s (set-up)")
    params = game_projected_params(work, train, heldout, vocab_paths, "out")
    on_card = not device_kw
    failures = []

    dispatch.reset_launch_counts()
    reset_host_reads()
    t0 = time.perf_counter()
    run = run_game_training(params, **device_kw)
    wall_s = time.perf_counter() - t0
    launches = dispatch.launch_counts()
    reads = host_reads()
    require_native(run, "[game-proj]")
    history = [h for s in run.sweep for h in s["history"]]
    fixed = _fixed_records(history)
    expected = with_reduce({
        "fused_vgc": sum(int(h.solver_iterations) + 1 for h in fixed),
        "fused_hvp": sum(h.cg_iterations for h in fixed),
        # + the quality fingerprint's margin pass
        "ell_matvec": len(run.sweep) + len(fixed) + len(history) + fingerprint_launches(run),
    })
    want = {k: (expected.get(k, 0) if on_card else 0) for k in launches}
    if launches != want:
        failures.append(f"GAME training (projected) launched {launches}, expected {want}")
    for combo in run.sweep:
        log(f"[game-proj] combo {json.dumps(combo['combo'])}: "
            + "; ".join(f"pass {h.iteration} {h.coordinate} objective {h.objective!r} "
                        f"AUC {h.validation_metric!r} {h.seconds:.4f} s "
                        f"iterations {h.solver_iterations:.2f}"
                        for h in combo["history"]))
    log(f"[game-proj] card run {wall_s:.4f} s, phases {json.dumps(run.timings)}, launches "
        f"{json.dumps({k: v for k, v in launches.items() if v})}, {reads} host reads")
    steps = sorted(os.listdir(os.path.join(params["output_dir"], "checkpoints", "combo-0")))
    if steps != ["step-1", "step-2"]:
        failures.append(f"checkpoints of combo 0: {steps}")

    # preemption after the first pass, then resume: the card against itself
    t0 = time.perf_counter()
    pre_params = game_projected_params(work, train, heldout, vocab_paths, "out-preempt")
    shutdown_cls = game_train_mod.GracefulShutdown
    game_train_mod.GracefulShutdown = _PreemptAfterFirstPass
    try:
        pre = run_game_training(pre_params, **device_kw)
    finally:
        game_train_mod.GracefulShutdown = shutdown_cls
    ckdir = os.path.join(pre_params["output_dir"], "checkpoints", "combo-0")
    marker = read_preempted_marker(ckdir)
    if (marker is None or marker["step"] != 1 or marker["signal"] != int(signal.SIGTERM)
            or pre.output_dirs or os.path.exists(os.path.join(pre_params["output_dir"], "best"))
            or len(pre.sweep) != 1):
        failures.append(f"preempted run: marker {marker}, saved {pre.output_dirs}, "
                        f"{len(pre.sweep)} combos")
    resumed = run_game_training({**pre_params, "resume": True}, **device_kw)
    resume_s = time.perf_counter() - t0
    require_native(resumed, "[game-proj] the resumed run")
    resume_gaps = game_projected_gaps(resumed, run)
    log(f"[game-proj] preempted at step {marker and marker['step']} and resumed in "
        f"{resume_s:.1f} s: against the uninterrupted run {json.dumps(resume_gaps)}")
    if read_preempted_marker(ckdir) is not None:
        failures.append("the resumed run left preempted.json")
    resume_failures = game_projected_gate_failures(resume_gaps)
    if resume_failures:
        failures.append(f"resumed run against the uninterrupted one: {resume_failures}")

    # the descent alone, ingest excluded, under torch.profiler: the design
    # straight from the generator
    (rows, cols, vals, d), x_u, users, labels, offsets, (wcols, wvals, wd), ads = design
    device = torch.device(run.device)
    users_idx = np.unique(users, return_inverse=True)[1].astype(np.int32)
    ads_idx = np.unique(ads, return_inverse=True)[1].astype(np.int32)
    data = GameData.create(
        features={"gshard": from_coo(rows, cols, vals, n, d, dtype=torch.float64),
                  "ushard": x_u,
                  "wshard": from_coo(np.repeat(np.arange(n), wcols.shape[1]), wcols.reshape(-1),
                                     wvals.reshape(-1), n, wd, dtype=torch.float64)},
        labels=labels, offsets=offsets, entity_ids={"userId": users_idx, "adId": ads_idx},
    )
    columns = [torch.as_tensor(c, dtype=torch.float64, device=device)
               for c in (data.labels, data.offsets, data.weights)]
    traced, busy, traced_wall_s, traced_launches = traced_descents(
        run.params, data, {"userId": int(users_idx.max()) + 1, "adId": int(ads_idx.max()) + 1},
        columns, device, {}, on_card)
    log(f"[game-proj] traced descent {traced_wall_s:.1f} s, the phase at "
        f"{time.perf_counter() - phase_t0:.1f} s")
    traced_history = [h for t in traced for h in t]
    traced_fixed = _fixed_records(traced_history)
    traced_expected = with_reduce({
        "fused_vgc": sum(int(h.solver_iterations) + 1 for h in traced_fixed),
        "fused_hvp": sum(h.cg_iterations for h in traced_fixed),
        "ell_matvec": len(traced) + len(traced_fixed)})
    traced_want = {k: (traced_expected.get(k, 0) if on_card else 0) for k in traced_launches}
    if traced_launches != traced_want:
        failures.append(f"the traced descent launched {traced_launches}, expected {traced_want}")
    del data, columns

    # the same driver on the CPU
    t0 = time.perf_counter()
    cpu = run_game_training(game_projected_params(work, train, heldout, vocab_paths, "out-cpu"),
                            device="cpu")
    cpu_wall_s = time.perf_counter() - t0
    require_native(cpu, "[game-proj] the CPU run")
    gaps = game_projected_gaps(run, cpu)
    log(f"[game-proj] card vs CPU (CPU run {cpu_wall_s:.1f} s): {json.dumps(gaps)}")
    gate_failures = game_projected_gate_failures(gaps)
    if gate_failures:
        failures.append(f"GAME training (projected) on the card disagrees with the CPU run: "
                        f"{', '.join(gate_failures)}")

    # save and score: the GAME scoring driver on the saved model against the
    # training's own final model scoring the held-out records; the factored
    # effect through the matrix-factorization files and the model directory
    best = run.sweep[run.best_index]["model"].params
    shards = {c: GAME_PROJ_COORDINATES[c]["shard"] for c in GAME_PROJ_SEQUENCE}
    res = {c: GAME_PROJ_COORDINATES[c].get("random_effect") for c in GAME_PROJ_SEQUENCE}
    t0 = time.perf_counter()
    scored = run_scoring({"input": [heldout], "model_dir": run.output_dirs[0],
                          "output_dir": os.path.join(work, "scores"), "model_kind": "game",
                          "sparse_shards": ["gshard", "wshard"], "evaluate": True},
                         **device_kw)
    score_s = time.perf_counter() - t0
    require_native(scored, "[game-proj] the scoring run")
    vdata, _, _, _ = IngestSource([heldout]).game_data(
        run.shard_vocabs, sorted(run.entity_vocabs), entity_vocabs=run.entity_vocabs,
        sparse_shards={"gshard", "wshard"})
    own = (score_game_data(best, shards, res, vdata, device=device).cpu().numpy()
           + vdata.offsets)
    score_err = float(np.max(np.abs(scored.scores - own) / np.maximum(1.0, np.abs(own))))
    auc_err = abs(scored.metrics["AREA_UNDER_RECEIVER_OPERATOR_CHARACTERISTICS"] - run.sweep[run.best_index]["validation_metric"])
    latent = best["per-user-latent"]
    mf_dir = os.path.join(work, "mf")
    save_mf_model(mf_dir, MatrixFactorizationModel(latent.gamma, latent.projection),
                  "userId", "ushard", row_vocab=run.entity_vocabs["userId"])
    mf, _, _ = load_mf_model(mf_dir, "userId", "ushard", row_vocab=run.entity_vocabs["userId"])
    loaded, _, _, _ = load_game_model(
        run.output_dirs[0], {c: run.shard_vocabs[shards[c]] for c in GAME_PROJ_SEQUENCE},
        {c: run.entity_vocabs[res[c]] for c in GAME_PROJ_SEQUENCE if res[c]})
    round_trip = {
        "mf": bool(torch.equal(mf.row_factors, latent.gamma.cpu())
                   and torch.equal(mf.col_factors, latent.projection.cpu())),
        **{c: bool(all(torch.equal(x, y) for x, y in zip(
            _leaves({c: loaded[c]}).values(), _leaves({c: best[c]}).values())))
           for c in GAME_PROJ_SEQUENCE},
    }
    log(f"[game-proj] saved model scored by the GAME scoring driver in {score_s:.1f} s: "
        f"{score_err:.3e} of max(1, |s|) (limit 1e-10), AUC {auc_err:.3e} (limit 1e-10); "
        f"round trips {json.dumps(round_trip)}")
    if not (score_err <= 1e-10 and auc_err <= 1e-10 and all(round_trip.values())):
        failures.append(f"save and score: scores {score_err}, AUC {auc_err}, "
                        f"round trips {round_trip}")
    auc = run.sweep[run.best_index]["validation_metric"]
    if not (0.5 < auc <= 1.0 and all(torch.isfinite(t).all() for t in _leaves(best).values())):
        failures.append(f"GAME training (projected): AUC {auc}, non-finite coefficients")

    summary = {
        "records": n,
        "heldout_records": n_heldout,
        "users": n_users,
        "wide_columns": user_cols,
        "ads": n_ads,
        "entities": {k: len(v) for k, v in run.entity_vocabs.items()},
        "device": run.device,
        "wall_s": wall_s,
        "timings_s": run.timings,
        "combo_s": [s["seconds"] for s in run.sweep],
        "update_s": {c: [h.seconds for h in history if h.coordinate == c]
                     for c in GAME_PROJ_SEQUENCE},
        "mean_iterations": {c: [h.solver_iterations for h in history if h.coordinate == c]
                            for c in GAME_PROJ_SEQUENCE},
        "best_combo": run.sweep[run.best_index]["combo"],
        "best_auc": auc,
        "launches": launches,
        "expected_launches": expected,
        "host_reads": reads,
        "fixed_iterations": [int(h.solver_iterations) for h in fixed],
        "fixed_cg_iterations": [h.cg_iterations for h in fixed],
        "traced_descent_s": traced_wall_s,
        **busy,
        "device_idle_share": (None if busy["device_busy_s"] is None
                              else 1.0 - busy["device_busy_s"] / traced_wall_s),
        "traced_launches": traced_launches,
        "preempt_resume_s": resume_s,
        "resume_vs_uninterrupted": resume_gaps,
        "cpu_wall_s": cpu_wall_s,
        "cpu_timings_s": cpu.timings,
        "gaps_vs_cpu": gaps,
        "score_s": score_s,
        "score_err": score_err,
        "score_auc_err": auc_err,
        "round_trips": round_trip,
        "setup_s": setup_s,
        "phase_s": time.perf_counter() - phase_t0,
        # the written inputs, which phase 5e reads again
        "inputs": {"vocab_paths": list(vocab_paths), "train": train, "heldout": heldout},
    }
    log(f"[game-proj] {json.dumps(summary)}")
    if failures:
        raise AssertionError("; ".join(failures))
    return summary


# -- phase 5e: determinism at the settings users run -------------------------

# phase 5d's records and coordinates at examples/run_wide_game.sh's lambda 1
# for the fixed effect (TRON, 30 iterations, 1e-8: the example's own) and
# the wide per-user effect, and the factored effect at lambda 1 for gamma
# and B, capped at 100 iterations: settings at which the card's atomic
# X^T once split the card from itself (ROADMAP queue C, C1). The gate is
# bits, not convergence
GAME_DET_COORDINATES = {
    **GAME_PROJ_COORDINATES,
    "global": {**GAME_PROJ_COORDINATES["global"], "reg_weights": [1.0], "max_iters": 30,
               "tolerance": 1e-8},
    "per-user-latent": {**GAME_PROJ_COORDINATES["per-user-latent"], "reg_weights": [1.0],
                        "latent_reg_weight": 1.0, "max_iters": 100},
}


def _saved_leaves(run) -> dict:
    """The best model's tables as the model directory holds them (read
    back), and the factored effect through the matrix-factorization files."""
    shards = {c: GAME_DET_COORDINATES[c]["shard"] for c in GAME_PROJ_SEQUENCE}
    res = {c: GAME_DET_COORDINATES[c].get("random_effect") for c in GAME_PROJ_SEQUENCE}
    loaded, _, _, _ = load_game_model(
        run.output_dirs[0], {c: run.shard_vocabs[shards[c]] for c in GAME_PROJ_SEQUENCE},
        {c: run.entity_vocabs[res[c]] for c in GAME_PROJ_SEQUENCE if res[c]})
    leaves = {f"saved {k}": v for k, v in _leaves(loaded).items()}
    latent = run.sweep[run.best_index]["model"].params["per-user-latent"]
    mf_dir = os.path.join(run.params.output_dir, "mf")
    save_mf_model(mf_dir, MatrixFactorizationModel(latent.gamma, latent.projection),
                  "userId", "ushard", row_vocab=run.entity_vocabs["userId"])
    mf, _, _ = load_mf_model(mf_dir, "userId", "ushard", row_vocab=run.entity_vocabs["userId"])
    leaves["mf rows"], leaves["mf cols"] = mf.row_factors.cpu(), mf.col_factors.cpu()
    return leaves


def bit_gaps(run, other) -> list:
    """What differs, bit for bit, between two runs of one configuration:
    the best combo, every update's objective and validation AUC, every
    table of every combo's final model in memory, every saved table and
    the MF files. Empty when the runs are equal."""
    diffs = []
    if run.best_index != other.best_index:
        diffs.append("best combo")
    for i, (a, b) in enumerate(zip(run.sweep, other.sweep)):
        ha, hb = a["history"], b["history"]
        if [(h.objective, h.validation_metric) for h in ha] != [
                (h.objective, h.validation_metric) for h in hb]:
            diffs.append(f"combo {i}: per-update objectives or AUC")
        la, lb = _leaves(a["model"].params), _leaves(b["model"].params)
        diffs += [f"combo {i}: table {n}" for n in la if not torch.equal(la[n], lb[n])]
    if len(run.sweep) != len(other.sweep):
        diffs.append("combo count")
    sa, sb = _saved_leaves(run), _saved_leaves(other)
    diffs += [n for n in sa if not torch.equal(sa[n], sb[n])]
    return diffs


def game_determinism_phase(work: str, name: str = "", n: int = GAME_PROJ_RECORDS,
                           n_heldout: int = GAME_PROJ_HELDOUT, d_hashed: int = D_HASHED,
                           n_users: int = GAME_TRAIN_USERS, user_cols: int = GAME_USER_COLS,
                           n_ads: int = GAME_PROJ_ADS, inputs=None, **device_kw):
    """Phase 5e: two uninterrupted runs of phase 5d's driver at the
    settings users run (``GAME_DET_COORDINATES``) equal bit for bit, and a
    run preempted by SIGTERM after its first pass and resumed equal to
    them bit for bit: every update's objective, every table in memory and
    saved, the MF files. No CPU reference. (The GLM half of the gate, two
    training runs with the same w bits, runs in phase 6 on its design.)
    ``inputs`` is phase 5d's summary's ``"inputs"`` (its records, read
    again); without it the records are written anew."""
    phase_t0 = t0 = time.perf_counter()
    if inputs is not None:
        vocab_paths, train, heldout = inputs["vocab_paths"], inputs["train"], inputs["heldout"]
        log("[game-det] reads phase 5d's records")
    else:
        vocab_paths, (train, heldout), _ = write_game_training_inputs(
            work, n, n_heldout, d_hashed, n_users, user_cols=user_cols, n_ads=n_ads)
        wait_written(train, heldout)
        log(f"[game-det] wrote {n} training and {n_heldout} held-out records in "
            f"{time.perf_counter() - t0:.1f} s (set-up)")

    def params(out):
        return {**game_projected_params(work, train, heldout, vocab_paths, out),
                "coordinates": GAME_DET_COORDINATES}

    runs, walls = [], []
    for out in ("first", "second"):
        t0 = time.perf_counter()
        runs.append(run_game_training(params(out), **device_kw))
        walls.append(time.perf_counter() - t0)
        require_native(runs[-1], f"[game-det] the {out} run")
        history = [h for c in runs[-1].sweep for h in c["history"]]
        log(f"[game-det] {out} run {walls[-1]:.4f} s, phases "
            f"{json.dumps(runs[-1].timings)}, codecs {json.dumps(runs[-1].codecs)}, "
            f"iterations per update "
            f"{json.dumps([[h.coordinate, h.solver_iterations] for h in history])}")
    first, second = runs

    t0 = time.perf_counter()
    pre_params = params("preempt")
    shutdown_cls = game_train_mod.GracefulShutdown
    game_train_mod.GracefulShutdown = _PreemptAfterFirstPass
    try:
        pre = run_game_training(pre_params, **device_kw)
    finally:
        game_train_mod.GracefulShutdown = shutdown_cls
    marker = read_preempted_marker(
        os.path.join(pre_params["output_dir"], "checkpoints", "combo-0"))
    resumed = run_game_training({**pre_params, "resume": True}, **device_kw)
    resume_s = time.perf_counter() - t0
    require_native(resumed, "[game-det] the resumed run")

    failures = []
    if marker is None or marker["step"] != 1 or pre.output_dirs:
        failures.append(f"preempted run: marker {marker}, saved {pre.output_dirs}")
    rerun_gaps = bit_gaps(second, first)
    resume_gaps = bit_gaps(resumed, first)
    log(f"[game-det] second run against the first, bit for bit: "
        f"{'equal' if not rerun_gaps else rerun_gaps}")
    log(f"[game-det] preempted after pass {marker and marker['step']} and resumed "
        f"({resume_s:.1f} s) against the first run, bit for bit: "
        f"{'equal' if not resume_gaps else resume_gaps}")
    if rerun_gaps:
        failures.append(f"two card runs differ: {rerun_gaps}")
    if resume_gaps:
        failures.append(f"the resumed run differs from the uninterrupted one: {resume_gaps}")
    history = [h for c in first.sweep for h in c["history"]]
    fixed = _fixed_records(history)
    summary = {
        "records": n,
        "heldout_records": n_heldout,
        "device": first.device,
        "wall_s": walls,
        "timings_s": [r.timings for r in runs],
        "codecs": first.codecs,
        "preempt_resume_s": resume_s,
        "fixed_iterations": [int(h.solver_iterations) for h in fixed],
        "fixed_cg_iterations": [h.cg_iterations for h in fixed],
        "mean_iterations": {c: [h.solver_iterations for h in history if h.coordinate == c]
                            for c in GAME_PROJ_SEQUENCE},
        "second_run_bit_gaps": rerun_gaps,
        "resumed_bit_gaps": resume_gaps,
        "best_auc": first.sweep[first.best_index]["validation_metric"],
        "phase_s": time.perf_counter() - phase_t0,
    }
    log(f"[game-det] {json.dumps(summary)}")
    if failures:
        raise AssertionError("; ".join(failures))
    return summary


def determinism_probe(work: str, n: int = 1 << 14, n_heldout: int = 1 << 12, **device_kw):
    """Not a phase of the smoke run: phase 5e's GAME configuration and phase
    6's GLM training, once each under ``torch.use_deterministic_algorithms
    (True, warn_only=True)``, listing every operation that PyTorch reports
    as without a deterministic implementation (cuBLAS is held to one
    workspace, as the flag requires). Run it in a process of its own, first
    thing after the build. Returns {path: [messages]}."""
    import warnings

    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    found = {}
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for path in ("game", "glm"):
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                if path == "game":
                    vocab_paths, (train, heldout), _ = write_game_training_inputs(
                        os.path.join(work, path), n, n_heldout, D_HASHED, GAME_TRAIN_USERS,
                        user_cols=GAME_USER_COLS, n_ads=GAME_PROJ_ADS)
                    wait_written(train, heldout)
                    run_game_training({
                        **game_projected_params(os.path.join(work, path), train, heldout,
                                                vocab_paths, "out"),
                        "coordinates": GAME_DET_COORDINATES}, **device_kw)
                else:
                    vocab_path, _, sets = write_training_inputs(
                        os.path.join(work, path), n, n_heldout, D_HASHED)
                    wait_written(sets["train"][0], sets["heldout"][0])
                    run_glm_training({
                        "train_input": [sets["train"][0]], "validate_input": [sets["heldout"][0]],
                        "output_dir": os.path.join(work, path, "out"), "feature_file": vocab_path,
                        "optimizer": "TRON", "reg_type": "L2", "reg_weights": TRAIN_LAMBDAS,
                        "tolerance": TRAIN_TOLERANCE, "max_iters": TRAIN_MAX_ITERS,
                        "sparse": True, "precision": "float64"}, **device_kw)
            found[path] = sorted({str(w.message).splitlines()[0] for w in caught
                                  if "deterministic" in str(w.message)})
            log(f"[probe] {path}: {len(found[path])} operations without a deterministic "
                f"implementation: {json.dumps(found[path])}")
    finally:
        torch.use_deterministic_algorithms(False)
    return found


# -- phase 6: the training driver end to end ---------------------------------


def write_training_inputs(work: str, n: int, n_heldout: int, d_hashed: int,
                          seed: int = SEED):
    """feature-index.txt and two Avro inputs, training and held-out, drawn
    from one seeded logistic model over the hashed columns."""
    rng = np.random.default_rng(seed + 4)
    vocab_path = os.path.join(work, "feature-index.txt")
    vocab = hashed_vocabulary(vocab_path, d_hashed)
    w_true = rng.normal(0.0, 0.25, size=len(vocab))
    sets = {}
    for label, count, set_seed in (("train", n, seed + 5), ("heldout", n_heldout, seed + 6)):
        path = os.path.join(work, label, "part-00000.avro")
        coo, labels, offsets = write_examples(
            path, count, d_hashed, w_true, vocab.intercept_index, set_seed, rng
        )
        sets[label] = (path, coo, labels, offsets)
    return vocab_path, vocab, sets


def batch_from(coo, labels, offsets, d: int, device) -> LabeledBatch:
    """The LabeledBatch the driver should have built, straight from the
    generator's COO."""
    rows, cols, vals = coo
    n = labels.shape[0]
    ell = from_coo(rows, cols, vals, n, d, dtype=torch.float64, device=device)
    return LabeledBatch.create(ell, labels, offsets=offsets, dtype=torch.float64,
                               device=device)


def train_phase(work: str, name: str = "", n: int = TRAIN_RECORDS,
                n_heldout: int = HELDOUT_RECORDS, d_hashed: int = D_HASHED,
                inputs=None, **device_kw):
    """Run the port's GLM training driver (sparse TRON, L2 logistic) and
    hold it to ``train_glm`` on the CPU; ``device_kw`` is empty for the
    card (the driver's default device). ``inputs``: the return of
    ``write_training_inputs`` over ``work``, written ahead."""
    t0 = time.perf_counter()
    if inputs is None:
        inputs = write_training_inputs(work, n, n_heldout, d_hashed)
    vocab_path, vocab, sets = inputs
    wait_written(sets["train"][0], sets["heldout"][0])
    setup_s = time.perf_counter() - t0
    log(f"[train] wrote {n} training and {n_heldout} held-out records, "
        f"{d_hashed} hashed columns + intercept in {setup_s:.1f} s (set-up)")
    params = {
        "train_input": [sets["train"][0]],
        "validate_input": [sets["heldout"][0]],
        "output_dir": os.path.join(work, "out"),
        "feature_file": vocab_path,
        "optimizer": "TRON",
        "reg_type": "L2",
        "reg_weights": TRAIN_LAMBDAS,
        "tolerance": TRAIN_TOLERANCE,
        "max_iters": TRAIN_MAX_ITERS,
        "sparse": True,
        "precision": "float64",
    }
    dispatch.reset_launch_counts()
    reset_host_reads()
    t0 = time.perf_counter()
    run = run_glm_training(params, **device_kw)
    wall_s = time.perf_counter() - t0
    launches = dispatch.launch_counts()
    reads = host_reads()

    iters = [tm.result.iterations for tm in run.models]
    cg = [tm.result.cg_iterations for tm in run.models]
    expected = {"fused_vgc": sum(i + 1 for i in iters), "fused_hvp": sum(cg),
                # each lambda's validation metrics and its selection, then the
                # quality fingerprint's margin pass
                "ell_matvec": 2 * len(run.models) + fingerprint_launches(run)}
    # the feature summary's five column sums go through the reduce too
    expected["colsort_reduce"] = with_reduce({**expected, "ell_colsum": launches["ell_colsum"],
                                              "ell_rmatvec": launches["ell_rmatvec"]}
                                             )["colsort_reduce"]
    failures = []
    require_native(run, "[train] the training run")
    if not device_kw:
        for kernel, count in expected.items():
            if launches[kernel] != count:
                failures.append(f"{kernel}: {launches[kernel]} launches, the solves need {count}")
        if launches["ell_colsum"] < 5:
            failures.append(f"the training run missed a kernel: {launches}")

    # the same batch on the CPU through train_glm: coefficients and
    # held-out AUC (with the variances the full-trainer phase holds its
    # TRON run to; they do not change the solves)
    d = len(vocab)
    t0 = time.perf_counter()
    batch_cpu = batch_from(*sets["train"][1:], d, "cpu")
    heldout_cpu = batch_from(*sets["heldout"][1:], d, "cpu")
    cfg = dataclasses.replace(run.params.to_training_config(),
                              intercept_index=vocab.intercept_index, compute_variances=True)
    cpu_models = train_glm(batch_cpu, cfg)
    cpu_s = time.perf_counter() - t0
    auc_key = metrics_mod.AREA_UNDER_RECEIVER_OPERATOR_CHARACTERISTICS
    per_lambda = []
    for tm, ref, vm in zip(run.models, cpu_models, run.validation_metrics):
        w_card = tm.model.coefficients.means.cpu()
        w_cpu = ref.model.coefficients.means
        dw = float((w_card - w_cpu).abs().max())
        w_inf = float(w_cpu.abs().max())
        if not dw <= 1e-6 * max(1.0, w_inf):
            failures.append(f"lambda={tm.reg_weight}: max |dw| {dw} vs the CPU run")
        margins = ref.model.compute_margin(heldout_cpu.features, heldout_cpu.offsets)
        auc_cpu = float(metrics_mod.area_under_roc_curve(
            heldout_cpu.labels, margins, heldout_cpu.effective_weights()))
        auc = vm[auc_key]
        if not (0.5 < auc <= 1.0 and abs(auc - auc_cpu) <= 1e-6):
            failures.append(f"lambda={tm.reg_weight}: held-out AUC {auc} vs CPU {auc_cpu}")
        per_lambda.append({
            "lambda": tm.reg_weight, "iterations": tm.result.iterations,
            "cpu_iterations": ref.result.iterations, "reason": tm.result.reason,
            "cpu_reason": ref.result.reason, "cg_iterations": tm.result.cg_iterations,
            "cpu_cg_iterations": ref.result.cg_iterations, "solve_s": tm.seconds,
            "cpu_solve_s": ref.seconds, "max_abs_dw": dw, "w_inf": w_inf,
            "heldout_auc": auc, "cpu_heldout_auc": auc_cpu,
        })

    if failures:
        log(f"[train] per lambda, card vs CPU: {json.dumps(per_lambda)}")
        raise AssertionError("; ".join(failures))

    # the kernels against their plain versions at the shape the driver gave
    # them (the Criteo layout's hot columns included), then a traced run
    shape_checks = []
    if not device_kw:
        batch_card = batch_from(*sets["train"][1:], d, run.device)
        x = batch_card.features
        peaks = peaks_for(name)
        g = torch.Generator(device=run.device).manual_seed(SEED + 1)
        w64 = torch.randn(d, generator=g, device=run.device, dtype=torch.float64)
        shape_checks = (matvec_checks(x.indices, x.values, d, w64, peaks, label="train-shape")
                        + training_kernels(name, x.indices, x.values, d, peaks,
                                           label="train-shape"))
        del batch_card, x, w64
        torch.cuda.empty_cache()
    activities = [torch.profiler.ProfilerActivity.CPU]
    if not device_kw:
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        t0 = time.perf_counter()
        again = run_glm_training({**params, "overwrite": True}, **device_kw)
        traced_wall_s = time.perf_counter() - t0
    busy = device_busy(prof)
    # phase 5e's GLM gate, on this phase's design: the second run (traced)
    # ends with the first run's w bits at every lambda
    same_w = [bool(torch.equal(a.model.coefficients.means, b.model.coefficients.means))
              for a, b in zip(run.models, again.models)]
    log(f"[train] determinism: the second run's w bit for bit equal to the first's at "
        f"lambda {[tm.reg_weight for tm in run.models]}: {same_w}")
    require_native(again, "[train] the traced run")
    if not (all(same_w) and len(again.models) == len(run.models)):
        raise AssertionError(f"two GLM training runs ended with other w bits: {same_w}")

    total_iters = sum(iters)
    summary = {
        "records": n,
        "heldout_records": n_heldout,
        "d": d,
        "k": int(batch_cpu.features.nnz_per_row),
        "device": run.device,
        "wall_s": wall_s,
        "timings_s": run.timings,
        "per_lambda": per_lambda,
        "launches": launches,
        "expected_launches": expected,
        "host_reads": reads,
        "host_reads_per_iteration": reads / max(total_iters, 1),
        "cg_steps_per_iteration": sum(cg) / max(total_iters, 1),
        "traced_wall_s": traced_wall_s,
        **busy,
        "device_idle_share": (None if busy["device_busy_s"] is None
                              else 1.0 - busy["device_busy_s"] / traced_wall_s),
        "cpu_reference_s": cpu_s,
        "setup_s": setup_s,
        "codecs": run.codecs,
        "second_run_same_w_bits": same_w,
    }
    log(f"[train] {json.dumps(summary)}")
    reference = {"params": params, "vocab": vocab, "sets": sets, "batch_cpu": batch_cpu,
                 "heldout_cpu": heldout_cpu, "tron_models": cpu_models}
    return summary, shape_checks, reference


# -- phase 6h: hybrid designs on phase 6's records ---------------------------

# the hybrid runs: the JAX package's split sized by column counts (-1), and
# the 14 columns every row names (the intercept and the 13 integer fields)
HYBRID_HOT_COLUMNS = (-1, INT_FIELDS + 1)


def hybrid_split_summary(hf) -> dict:
    """H, the cold segments' widths and rows, how many hold no entry, the
    stored cold entries and the padded slots of a hybrid design."""
    bounds = hf.segment_bounds()
    return {"hot_columns": int(hf.dense.shape[1]), "segments": len(bounds),
            "widths": [seg.nnz_per_row for seg in hf.cold_segments],
            "rows": [hi - lo for lo, hi in bounds],
            "empty_segments": sum(not bool((seg.indices < seg.d).any())
                                  for seg in hf.cold_segments),
            "stored_cold_entries": stored_cold_entries(hf),
            "cold_padded_slots": cold_padded_slots(hf)}


def hybrid_expected_launches(run, split: dict, vsplit: dict) -> dict:
    """A GLM run's launches on hybrid designs, from its solves: a margins
    pass is one ``ell_matvec`` per cold segment, an X^T pass one reduce
    (``ell_rmatvec``, ``colsort_reduce``) per segment that holds an entry;
    TRON's evaluations (iterations + 1 a lambda) and CG steps are one of
    each; each lambda's validation metrics and selection are a margins pass
    over the held-out split (``vsplit``), the fingerprint one over the
    training split; the summary's five column sums run on the cold
    segments joined into one ELL (none when it holds no entry)."""
    passes = sum(tm.result.iterations + 1 + tm.result.cg_iterations for tm in run.models)
    full = split["segments"] - split["empty_segments"]
    want = {k: 0 for k in dispatch.KERNELS}
    want["ell_matvec"] = (split["segments"] * (passes + fingerprint_launches(run))
                          + 2 * len(run.models) * vsplit["segments"])
    want["ell_rmatvec"] = full * passes
    want["ell_colsum"] = 5 if split["stored_cold_entries"] else 0
    want["colsort_reduce"] = want["ell_rmatvec"] + want["ell_colsum"]
    return want


def segment_checks(seg, a_seg, w, what: str) -> dict:
    """One cold segment's kernels held to their plain versions at its own
    shape, raising where one disagrees: ``ell_matvec`` in the three type
    pairs (``check_kernel``: rtol x each row's sum of |v w|); the
    column-sorted reduce on the segment's own copy in its linear and pair
    modes in the three dtype pairs (``reduce_error``: rtol x each column's
    sum of |terms|); and the f64 X^T side as the hybrid path calls it,
    ``rmatvec`` on the segment with ``a_seg`` (the rows of the design's
    (n,) vector at the segment's offset, a view), within 1e-12 x each
    column's sum of |terms|. Returns the largest errors."""
    d = seg.d
    out = {"rows": int(seg.indices.shape[0]), "width": int(seg.indices.shape[1]),
           "ell_matvec_max_abs_err": 0.0, "reduce_max_abs_err": 0.0}
    for dtype_label, vdt, wdt, rtol in DTYPE_CASES:
        *_, err, ok = check_kernel(seg.indices, seg.values, d, vdt, wdt, rtol, w)
        if not ok:
            raise AssertionError(f"ell_matvec {dtype_label} disagrees with its plain version "
                                 f"on {what}: {err:.3e}")
        out["ell_matvec_max_abs_err"] = max(out["ell_matvec_max_abs_err"], err)
    copy = colsort.build_design_columns(seg.indices, d)
    for dtype_label, vdt, cd, rtol, _ in FUSED_CASES:
        vals = colsort.column_values(copy, seg.values.to(vdt))
        for mode in ("linear", "pair"):
            err, _ = reduce_error(copy, vals, a_seg.to(cd), mode, rtol,
                                  f"{dtype_label} ({what})")
            out["reduce_max_abs_err"] = max(out["reduce_max_abs_err"], err)
    terms = seg.values * a_seg[:, None]
    err, ok, _ = within(rmatvec(seg, a_seg),
                        ell_scatter_add_reference(seg.indices, terms, d),
                        ell_scatter_add_reference(seg.indices, terms.abs(), d), 1e-12)
    if not ok:
        raise AssertionError(f"the hybrid's f64 rmatvec on {what} disagrees with its plain "
                             f"version: {err:.3e}")
    out["rmatvec_max_abs_err"] = err
    return out


def hybrid_kernel_times(hf_cpu, label: str) -> dict:
    """On the card, for one hybrid split of the training design: each cold
    segment's column-sorted copy built and timed (seconds, bytes); the
    segment with the most slots and the one with the fewest rows held to
    their plain versions (``segment_checks``, which raises); at the widest
    segment's shape, ``ell_matvec`` and the reduce (``ell_rmatvec``) timed
    (event and device ms); the slab's ``torch.matmul`` both ways; the whole
    hybrid ``matvec`` and ``rmatvec``; and the adds of the segments' (d,)
    outputs in segment order, the cost of S full-width outputs."""
    from functools import reduce as fold

    hf = cast_values(hf_cpu, torch.float64, "cuda")
    n, d = hf.shape
    g = torch.Generator(device="cuda").manual_seed(SEED + 8)
    w = torch.randn(d, generator=g, device="cuda", dtype=torch.float64)
    a = torch.randn(n, generator=g, device="cuda", dtype=torch.float64)
    copies = []
    for seg in hf.cold_segments:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        copy = colsort.build_design_columns(seg.indices, d)
        torch.cuda.synchronize()
        copies.append({"build_s": time.perf_counter() - t0, "bytes": copy.nbytes(8),
                       "entries": copy.nvalid, "tiles": copy.ntiles})
        del copy
    bounds = hf.segment_bounds()
    held = [i for i, c in enumerate(copies) if c["entries"]]
    big = max(held, key=lambda i: hf.cold_segments[i].indices.numel())
    short = min(held, key=lambda i: bounds[i][1] - bounds[i][0])
    checked = {}
    for i in dict.fromkeys((big, short)):
        (lo, hi), what = bounds[i], f"{label} segment {i} (rows {bounds[i]})"
        checked[str(i)] = segment_checks(hf.cold_segments[i], a[lo:hi], w, what)
    seg, (lo, hi) = hf.cold_segments[big], bounds[big]
    a_seg = a[lo:hi]
    torch.cuda.synchronize()
    parts = [rmatvec(s_, a[l_:h_]) for s_, (l_, h_) in zip(hf.cold_segments, bounds)]
    hw = w.index_select(0, hf.hot_ids)
    timed = {
        "segment_ell_matvec": lambda: ell_matvec(seg.indices, seg.values, w, d),
        "segment_reduce": lambda: rmatvec(seg, a_seg),
        "slab_matvec": lambda: torch.matmul(hf.dense, hw),
        "slab_rmatvec": lambda: torch.matmul(a, hf.dense),
        "hybrid_matvec": lambda: matvec(hf, w),
        "hybrid_rmatvec": lambda: rmatvec(hf, a),
        "segment_output_adds": lambda: fold(torch.add, parts),
    }
    out = {"split": hybrid_split_summary(hf_cpu), "copies": copies,
           "segment_shape": list(seg.indices.shape), "segment_checks": checked,
           "slab_shape": list(hf.dense.shape),
           "segment_output_adds_bytes": 3 * 8 * d * (len(parts) - 1)}
    for key, fn in timed.items():
        out[f"{key}_ms"] = time_ms(fn)
        out[f"{key}_device_ms"], out[f"{key}_host_ms"] = device_ms(fn)
    log(f"[hybrid] {label} on the card: {json.dumps(out)}")
    del hf, parts
    torch.cuda.empty_cache()
    return out


def hybrid_train_phase(work: str, reference: dict, ell_summary=None, name: str = "",
                       **device_kw):
    """Phase 6h: phase 6's driver configuration with ``hot_columns`` -1 and
    14 on phase 6's files, each run held to phase 6's CPU models
    (``reference["tron_models"]``) at phase 6's gates, its launches held
    to the count its solves and splits give (``hybrid_expected_launches``);
    the 14-column run repeated under ``torch.profiler`` (the busy share;
    the same w bits as the first); then the kernels at the splits' shapes
    (``hybrid_kernel_times``, on the card). ``ell_summary``: phase 6's
    summary, whose solve seconds per lambda are printed beside these.
    Returns (summary, the two runs' launches summed)."""
    phase_t0 = time.perf_counter()
    on_card = not device_kw
    auc_key = metrics_mod.AREA_UNDER_RECEIVER_OPERATOR_CHARACTERISTICS
    heldout_cpu = reference["heldout_cpu"]
    ell_solve_s = {pl["lambda"]: pl["solve_s"] for pl in (ell_summary or {}).get(
        "per_lambda", [])}
    failures, runs, splits, launches = [], {}, {}, {k: 0 for k in dispatch.KERNELS}
    for hot in HYBRID_HOT_COLUMNS:
        t0 = time.perf_counter()
        splits[hot] = to_hybrid(reference["batch_cpu"].features, hot_columns=hot)
        split = hybrid_split_summary(splits[hot])
        vsplit = hybrid_split_summary(to_hybrid(heldout_cpu.features, hot_columns=hot))
        split_s = time.perf_counter() - t0
        params = {**reference["params"], "hot_columns": hot,
                  "output_dir": os.path.join(work, f"hot{hot}")}
        dispatch.reset_launch_counts()
        reset_host_reads()
        t0 = time.perf_counter()
        run = run_glm_training(params, **device_kw)
        wall_s = time.perf_counter() - t0
        got = dispatch.launch_counts()
        reads = host_reads()
        require_native(run, f"[hybrid] the hot_columns={hot} run")
        want = (hybrid_expected_launches(run, split, vsplit) if on_card
                else {k: 0 for k in dispatch.KERNELS})
        if got != want:
            failures.append(f"hot_columns={hot}: launched {got}, the solves need {want}")
        launches = {k: launches[k] + got[k] for k in launches}
        per_lambda = []
        for tm, ref, vm in zip(run.models, reference["tron_models"], run.validation_metrics):
            w_cpu = ref.model.coefficients.means
            dw = float((tm.model.coefficients.means.cpu() - w_cpu).abs().max())
            w_inf = float(w_cpu.abs().max())
            margins = ref.model.compute_margin(heldout_cpu.features, heldout_cpu.offsets)
            auc_cpu = float(metrics_mod.area_under_roc_curve(
                heldout_cpu.labels, margins, heldout_cpu.effective_weights()))
            if not dw <= 1e-6 * max(1.0, w_inf):
                failures.append(f"hot_columns={hot} lambda={tm.reg_weight}: max |dw| {dw} "
                                "vs the CPU run")
            if not (0.5 < vm[auc_key] <= 1.0 and abs(vm[auc_key] - auc_cpu) <= 1e-6):
                failures.append(f"hot_columns={hot} lambda={tm.reg_weight}: held-out AUC "
                                f"{vm[auc_key]} vs CPU {auc_cpu}")
            per_lambda.append({
                "lambda": tm.reg_weight, "iterations": tm.result.iterations,
                "cpu_iterations": ref.result.iterations, "cg_iterations": tm.result.cg_iterations,
                "cpu_cg_iterations": ref.result.cg_iterations, "solve_s": tm.seconds,
                "ell_solve_s": ell_solve_s.get(tm.reg_weight), "max_abs_dw": dw,
                "w_inf": w_inf, "heldout_auc": vm[auc_key], "cpu_heldout_auc": auc_cpu})
        runs[hot] = {"split": split, "heldout_split": vsplit, "split_on_host_s": split_s,
                     "wall_s": wall_s, "timings_s": run.timings, "launches": got,
                     "expected_launches": want, "host_reads": reads,
                     "per_lambda": per_lambda, "codecs": run.codecs}
        log(f"[hybrid] hot_columns={hot}: {json.dumps(runs[hot])}")
        if hot == HYBRID_HOT_COLUMNS[-1]:
            first = run
        del run

    # the 14-column run again, traced: the busy share, and the same w bits
    hot = HYBRID_HOT_COLUMNS[-1]
    activities = [torch.profiler.ProfilerActivity.CPU]
    if on_card:
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        t0 = time.perf_counter()
        again = run_glm_training({**reference["params"], "hot_columns": hot, "overwrite": True,
                                  "output_dir": os.path.join(work, f"hot{hot}")}, **device_kw)
        traced_wall_s = time.perf_counter() - t0
    busy = device_busy(prof)
    same_w = [bool(torch.equal(a.model.coefficients.means, b.model.coefficients.means))
              for a, b in zip(first.models, again.models)]
    if not (all(same_w) and len(again.models) == len(first.models)):
        failures.append(f"the traced hot_columns={hot} run ended with other w bits: {same_w}")
    del first, again
    kernels = {}
    if on_card:
        for hot in HYBRID_HOT_COLUMNS:
            kernels[hot] = hybrid_kernel_times(splits.pop(hot), f"hot_columns={hot}")
    splits.clear()
    summary = {"runs": {str(h): r for h, r in runs.items()},
               "traced_wall_s": traced_wall_s, **busy,
               "device_idle_share": (None if busy["device_busy_s"] is None
                                     else 1.0 - busy["device_busy_s"] / traced_wall_s),
               "traced_run_same_w_bits": same_w,
               "kernels": {str(h): k for h, k in kernels.items()},
               "phase_s": time.perf_counter() - phase_t0}
    log(f"[hybrid] {json.dumps({k: v for k, v in summary.items() if k != 'runs'})}")
    if failures:
        raise AssertionError("; ".join(failures))
    return summary, launches


# -- phase 5g: index -> train -> serve, with the quality loop ---------------

# the GAME half's depth: 5c's layout and users' Zipf(1.1), fewer records
QUALITY_GAME_RECORDS = 1 << 13
QUALITY_GAME_HELDOUT = 1 << 11
QUALITY_GAME_USERS = 1024
# the fixed effect at phase 5c's tolerance: the hybrid rerun sums in
# another order than the ELL run, and TRON amplifies the split (at 1e-8 the
# two ended 3.1e-6 apart in the per-user table on the CPU, over the 1e-6
# gate; at 1e-15 they meet near one optimum)
QUALITY_FIXED_TOLERANCE = GAME_TRAIN_FIXED_TOLERANCE
# the integer field planted out of its range in the shifted traffic
QUALITY_PLANT_FIELD = 0
QUALITY_PLANT_FACTOR = 4.0
QUALITY_PLANTED = 4096
QUALITY_CLI_REQUESTS = 8
# card against CPU: the margin sketch's moments (the card's margins are
# ell_matvec's sums, the CPU's the plain version's), relative
QUALITY_MARGIN_RTOL = 1e-9
# the online window's AUC against the exact one on the same labels/scores
QUALITY_AUC_TOL = 1e-12


def fingerprint_launches(run) -> int:
    """The ``ell_matvec`` launches of a driver run's quality fingerprint:
    one margin pass over the training rows after the solves — a sparse GLM
    design's one ``ell_matvec``, or GAME scoring's one per fixed effect on
    an ELL shard — and none with the fingerprint off or a preempted run,
    which saves nothing."""
    p = run.params
    if not p.quality_fingerprint:
        return 0
    if hasattr(run, "sweep"):
        if os.path.exists(os.path.join(p.output_dir, "preempted.json")):
            return 0
        return sum(1 for c in run.sweep[run.best_index]["model"].params
                   if p.coordinates[c].random_effect is None
                   and p.coordinates[c].shard in p.sparse_shards)
    return 1 if p.sparse and run.models else 0


def build_index_cli(*runs) -> list:
    """``python -m photon_ml_tpu_torch.cli.build_index`` once per argument
    list in ``runs``, all started at once: a function that waits for them
    and returns [(the path each printed, its seconds, the process
    included)]. Every process is stopped whatever happens."""
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "photon_ml_tpu_torch.cli.build_index", *args],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=ROOT,
        env={**os.environ, "PYTHONPATH": ROOT}) for args in runs]

    def wait():
        out = []
        try:
            for args, proc in zip(runs, procs):
                stdout, stderr = proc.communicate(timeout=600)
                if proc.returncode != 0:
                    raise AssertionError(f"cli.build_index {args}: exit {proc.returncode}: "
                                         f"{stderr[-4000:]}")
                out.append((stdout.strip().splitlines()[-1], time.perf_counter() - t0))
        finally:
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        return out

    return wait


def quality_cli(model_dir: str, requests, labels, want, n_rows: int, device=None) -> dict:
    """``cli.serve`` over a pipe (``serve_pipe``) on an export with a
    fingerprint: each request's score read back (the engine's), then a
    ``feedback`` line per request with its label and served score, then
    ``quality`` (the window's exact AUC) and ``drift`` (the baseline's
    monitor)."""
    def exchange(ask):
        scores = [ask(request_line(r)).get("score", np.nan) for r in requests]
        feedback = [ask({"cmd": "feedback", "label": float(y), "score": float(sc)})
                    for y, sc in zip(labels, scores)]
        return scores, feedback, ask({"cmd": "quality"}), ask({"cmd": "drift"})

    t0 = time.perf_counter()
    (scores, feedback, quality_r, drift_r), code, err = serve_pipe(
        model_dir, device, exchange, "--no-verify-manifest")
    k = len(requests)
    auc = round(quality_mod.exact_auc(labels, scores), 6)
    summary = {"seconds": time.perf_counter() - t0, "exit": code,
               "max_err_vs_engine": serving_gaps(scores, want),
               "feedback_window_n": [f.get("window_n") for f in feedback],
               "quality": quality_r, "drift": {key: drift_r.get(key) for key in (
                   "psi_alarm", "baseline_rows", "window_rows", "checks", "alarms",
                   "error")}}
    log(f"[quality] cli.serve: {json.dumps(summary)}")
    if (code != 0 or summary["max_err_vs_engine"] > SERVE_RTOL
            or summary["feedback_window_n"] != list(range(1, k + 1))
            or quality_r.get("window_n") != k or quality_r.get("auc") != auc
            or drift_r.get("baseline_rows") != n_rows
            or drift_r.get("psi_alarm") != quality_mod.DEFAULT_PSI_ALARM):
        raise AssertionError(f"cli.serve feedback/quality/drift: {json.dumps(summary)}; "
                             f"{err[-4000:]}")
    return summary


def quality_loop_phase(work: str, glm_sets: dict, name: str = "", serve_summary=None,
                       n: int = QUALITY_GAME_RECORDS, n_heldout: int = QUALITY_GAME_HELDOUT,
                       d_hashed: int = D_HASHED, n_users: int = QUALITY_GAME_USERS,
                       planted: int = QUALITY_PLANTED, game_inputs=None, **device_kw):
    """Phase 5g: the feature-indexing job on phase 6's training Avro, the
    GLM driver on its index with the quality fingerprint (the default), the
    GAME driver with a shard that has no feature file, and that export
    served with its drift monitor and the online-quality loop, on the card
    (``device_kw`` names another device for a rehearsal). ``glm_sets`` is
    phase 6's ``{"train": (path, ...), "heldout": (path, ...)}``. Returns
    (summary, {"glm": launches, "game": launches})."""
    phase_t0 = time.perf_counter()
    on_card = not device_kw
    device = device_kw.get("device")
    cuda = on_card or torch.device(device).type == "cuda"
    failures = []
    train_path, heldout_path = glm_sets["train"][0], glm_sets["heldout"][0]

    # the index: the CLI twice (GLM layout, a GAME shard with a prefix),
    # both byte for byte the from-records vocabulary of the same file,
    # decoded here by the Python codec while the two processes run
    index_dir = os.path.join(work, "index")
    wait_index = build_index_cli(
        ["--input", train_path, "--output-dir", index_dir, "--add-intercept"],
        ["--input", train_path, "--output-dir", index_dir, "--shard", "gshard",
         "--name-prefix", "h", "--add-intercept"])
    try:
        t0 = time.perf_counter()
        _, records = read_avro_file(train_path)
        reference = FeatureVocabulary.from_records(records, add_intercept=True)
        from_records_s = time.perf_counter() - t0
        del records
    finally:
        (glm_index, glm_index_s), (shard_index, shard_index_s) = wait_index()
    source = IngestSource([train_path])
    t0 = time.perf_counter()
    scanned = source.build_vocab(add_intercept=True)
    scan_s = time.perf_counter() - t0
    ref_path = os.path.join(index_dir, "from-records.txt")
    reference.save(ref_path)
    with open(ref_path, "rb") as f:
        ref_bytes = f.read()
    index = {"glm_index_s": glm_index_s, "shard_index_s": shard_index_s, "scan_s": scan_s,
             "codec": source.codec, "from_records_s": from_records_s,
             "columns": len(reference)}
    for label, path in (("glm", glm_index), ("shard", shard_index)):
        with open(path, "rb") as f:
            same = f.read() == ref_bytes
        index[f"{label}_file_equals_from_records"] = same
        if not same:
            failures.append(f"cli.build_index's {label} file differs from from_records'")
    if scanned.index_to_key != reference.index_to_key:
        failures.append("the native scan's keys differ from from_records'")
    if source.codec != "native":
        failures.append(f"the vocabulary scan ran on the {source.codec} codec")
    log(f"[quality] index: {json.dumps(index)}")

    # GLM training on that index, the fingerprint on by default; its
    # fingerprint against the same ingest and model's margins on the CPU
    params = {
        "train_input": [train_path], "validate_input": [heldout_path],
        "output_dir": os.path.join(work, "glm"), "feature_file": glm_index,
        "optimizer": "TRON", "reg_type": "L2", "reg_weights": TRAIN_LAMBDAS,
        "tolerance": TRAIN_TOLERANCE, "max_iters": TRAIN_MAX_ITERS, "sparse": True,
        "precision": "float64", "model_output_mode": "BEST",
    }
    dispatch.reset_launch_counts()
    t0 = time.perf_counter()
    run = run_glm_training(params, **device_kw)
    glm_wall_s = time.perf_counter() - t0
    glm_launches = dispatch.launch_counts()
    require_native(run, "[quality] the GLM run")
    iters = [tm.result.iterations for tm in run.models]
    want = {"fused_vgc": sum(i + 1 for i in iters),
            "fused_hvp": sum(tm.result.cg_iterations for tm in run.models),
            # each lambda's validation metrics and its selection, then the
            # fingerprint's margin pass
            "ell_matvec": 2 * len(run.models) + fingerprint_launches(run)}
    for kernel, count in want.items():
        if glm_launches[kernel] != (count if on_card else 0):
            failures.append(f"GLM run: {kernel} launched {glm_launches[kernel]}, expected "
                            f"{count if on_card else 0}")
    with open(os.path.join(params["output_dir"], quality_mod.QUALITY_FINGERPRINT)) as f:
        card_fp = json.load(f)
    t0 = time.perf_counter()
    cpu_fp = quality_mod.install_fingerprint_collector()
    try:
        cpu_batch, _, _ = IngestSource([train_path]).labeled_batch(
            run.vocab, sparse=True, dtype=torch.float64, device="cpu")
    finally:
        quality_mod.uninstall_fingerprint_collector()
    chosen = run.best if run.best is not None else run.models[0]
    # the write phase's parts: one model text and one Avro model save
    t0 = time.perf_counter()
    write_model_text(os.path.join(work, "model.txt"), chosen.model.coefficients.means,
                     run.vocab)
    text_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    save_glm_model(os.path.join(work, "model.avro"), chosen.model.coefficients, run.vocab,
                   TaskType.LOGISTIC_REGRESSION)
    avro_s = time.perf_counter() - t0
    margins = matvec(cpu_batch.features, chosen.model.coefficients.means.cpu()) + cpu_batch.offsets
    cpu_fp.observe_margins(margins.numpy(), cpu_batch.effective_weights().numpy())
    cpu_doc = cpu_fp.to_dict()
    cpu_fp_s = time.perf_counter() - t0
    del cpu_batch, margins
    m_card, m_cpu = card_fp["margin"]["moments"], cpu_doc["margin"]["moments"]
    fp_gaps = {key: (abs(m_card[key] - m_cpu[key]) / max(abs(m_cpu[key]), 1e-300))
               for key in ("weight", "mean", "m2")}
    fp_same = {"rows": card_fp["rows"] == cpu_doc["rows"],
               "label": card_fp["label"] == cpu_doc["label"],
               "shards": card_fp["shards"] == cpu_doc["shards"],
               "margin_count": m_card["count"] == m_cpu["count"] == cpu_doc["rows"]}
    glm = {"wall_s": glm_wall_s, "timings_s": run.timings, "launches": glm_launches,
           "expected_launches": want, "columns": len(run.vocab),
           "fingerprint_rows": card_fp["rows"], "fingerprint_equal_to_cpu": fp_same,
           "margin_moment_gaps_vs_cpu": fp_gaps, "cpu_fingerprint_s": cpu_fp_s,
           "summary_write_s": run.timings["summary_write"], "write_s": run.timings["write"],
           "one_model_text_s": text_s, "one_model_avro_s": avro_s,
           "nonzero_coefficients": int((chosen.model.coefficients.means != 0).sum()),
           "run_bc_summary_write_s": 4.65, "run_bc_write_s": 6.17}
    log(f"[quality] GLM: {json.dumps(glm)}")
    if not all(fp_same.values()):
        failures.append(f"the GLM fingerprint differs from the CPU's: {fp_same}")
    if not all(g <= QUALITY_MARGIN_RTOL for g in fp_gaps.values()):
        failures.append(f"the GLM margin sketch is off the CPU's: {fp_gaps}")
    del run

    # GAME training: 5c's layout, the global shard without a feature file
    gdir = os.path.join(work, "game")
    t0 = time.perf_counter()
    if game_inputs is None:
        game_inputs = write_game_training_inputs(gdir, n, n_heldout, d_hashed, n_users)
    (gpath, upath), (gtrain, gheldout), design = game_inputs
    wait_written(gtrain, gheldout)
    game_setup_s = time.perf_counter() - t0
    gparams = game_train_params(gdir, gtrain, gheldout, gpath, upath,
                                fixed_tolerance=QUALITY_FIXED_TOLERANCE)
    gparams["feature_shards"] = {"ushard": upath}
    dispatch.reset_launch_counts()
    t0 = time.perf_counter()
    game_run = run_game_training(gparams, **device_kw)
    game_wall_s = time.perf_counter() - t0
    game_launches = dispatch.launch_counts()
    require_native(game_run, "[quality] the GAME run")
    history = [h for sw in game_run.sweep for h in sw["history"]]
    fixed = _fixed_records(history)
    game_want = with_reduce({
        "fused_vgc": sum(int(h.solver_iterations) + 1 for h in fixed),
        "fused_hvp": sum(h.cg_iterations for h in fixed),
        "ell_matvec": (len(game_run.sweep) + len(fixed)
                       + sum(h.validation_metric is not None for h in history)
                       + fingerprint_launches(game_run)),
    })
    game_want = {k: (game_want.get(k, 0) if on_card else 0) for k in game_launches}
    if game_launches != game_want:
        failures.append(f"GAME run launched {game_launches}, expected {game_want}")
    hashed = np.unique(design[0][1][design[0][1] < d_hashed])
    want_keys = sorted(feature_key("h", str(c)) for c in hashed.tolist())
    gvocab = game_run.shard_vocabs["gshard"]
    if gvocab.index_to_key != FeatureVocabulary(want_keys, add_intercept=True).index_to_key:
        failures.append("the GAME run's from-records vocabulary is not the records' keys")
    fp_docs = []
    for d in game_run.output_dirs:
        with open(os.path.join(d, quality_mod.QUALITY_FINGERPRINT)) as f:
            fp_docs.append(json.load(f))
    game_fp = fp_docs[0] if fp_docs else {}
    if (not fp_docs or len(fp_docs) != len(game_run.output_dirs)
            or any(doc["rows"] != n or sorted(doc["shards"]) != ["ushard"]
                   or len(doc["shards"]["ushard"]) != INT_FIELDS + 1
                   or doc["margin"]["moments"]["count"] != n
                   or "userId" not in doc["categoricals"] for doc in fp_docs)):
        failures.append("a GAME export's fingerprint is missing or incomplete")
    game = {"records": n, "heldout_records": n_heldout, "setup_s": game_setup_s,
            "wall_s": game_wall_s, "timings_s": game_run.timings, "launches": game_launches,
            "expected_launches": game_want, "gshard_columns": len(gvocab),
            "export_dirs": len(game_run.output_dirs)}
    log(f"[quality] GAME: {json.dumps(game)}")

    # the same GAME run with hot_columns -1 on the global shard (a hybrid
    # inside the fixed effect), held to the ELL run above at every gate of
    # phase 5c (``game_train_gate_failures``): the same best combo and
    # update count, per-update objectives within 1e-7, held-out AUC within
    # 1e-6, the fixed effect's w and the tables within 1e-6 of their scale;
    # its launches from its solves and its split
    hparams = {**gparams, "output_dir": os.path.join(gdir, "hybrid"), "coordinates": {
        **gparams["coordinates"],
        "global": {**gparams["coordinates"]["global"], "hot_columns": -1}}}
    dispatch.reset_launch_counts()
    t0 = time.perf_counter()
    hybrid_run = run_game_training(hparams, **device_kw)
    hybrid_wall_s = time.perf_counter() - t0
    hybrid_launches = dispatch.launch_counts()
    require_native(hybrid_run, "[quality] the hybrid GAME run")
    # the driver's global design, from the generator's COO in the columns
    # of its from-records vocabulary
    rows, cols, vals, _ = design[0]
    cols = np.asarray([gvocab.get("h", str(c)) if c < d_hashed else gvocab.intercept_index
                       for c in cols.tolist()])
    split = hybrid_split_summary(to_hybrid(
        from_coo(rows, cols, vals, n, len(gvocab), dtype=torch.float64), hot_columns=-1))
    hybrid_history = [h for sw in hybrid_run.sweep for h in sw["history"]]
    hybrid_fixed = _fixed_records(hybrid_history)
    passes = sum(int(h.solver_iterations) + 1 + h.cg_iterations for h in hybrid_fixed)
    hybrid_want = {k: 0 for k in hybrid_launches}
    if on_card:
        hybrid_want["ell_matvec"] = (
            split["segments"] * (passes + len(hybrid_run.sweep) + len(hybrid_fixed))
            + sum(h.validation_metric is not None for h in hybrid_history)
            + fingerprint_launches(hybrid_run))
        hybrid_want["ell_rmatvec"] = hybrid_want["colsort_reduce"] = (
            (split["segments"] - split["empty_segments"]) * passes)
    if hybrid_launches != hybrid_want:
        failures.append(f"hybrid GAME run launched {hybrid_launches}, expected {hybrid_want}")
    hgaps = game_train_gaps(hybrid_run, game_run)
    hybrid_failed = game_train_gate_failures(hgaps)
    if hybrid_failed:
        failures.append(f"the hybrid GAME run against the ELL run: {hybrid_failed} "
                        f"({json.dumps(hgaps)})")
    game["hybrid"] = {"wall_s": hybrid_wall_s, "timings_s": hybrid_run.timings,
                      "split": split, "launches": hybrid_launches,
                      "expected_launches": hybrid_want, "gaps_vs_ell": hgaps}
    log(f"[quality] hybrid GAME: {json.dumps(game['hybrid'])}")
    del hybrid_run

    # serving the export with its drift monitor: its training records (the
    # baseline's own rows: every check must stay quiet), then its held-out
    # ones, a window of their own (reported: the baseline's margins are the
    # training rows', which a model fits more closely than new rows)
    best_dir = game_run.output_dirs[0]
    records = read_avro_file(gtrain)[1] + read_avro_file(gheldout)[1]
    requests = serving_requests(records)
    labels = np.asarray([r["label"] for r in records], np.float64)
    del records
    stats = _RawBucketStats()
    t0 = time.perf_counter()
    engine = ScoringEngine.from_model_dir(best_dir, dtype=torch.float64, stats=stats,
                                          **device_kw)
    load_s = time.perf_counter() - t0
    if engine.drift is None:
        raise AssertionError(f"the engine over {best_dir} has no drift monitor")
    builds0 = bucket_builds()
    engine.warmup(max_batch=SERVE_MAX_BATCH, include_degraded=True)
    builds = bucket_builds() - builds0
    segments = torch.cuda.memory_stats()["segment.all.allocated"] if cuda else None
    scores = np.empty(len(requests))
    call_s = []

    def serve_pass(lo_row, hi_row):
        """Calls of 64 rows over requests[lo_row:hi_row]; the drift reports
        of the checks they completed, the window's remainder closed last."""
        reports, checks = [], engine.drift.checks
        for lo in range(lo_row, hi_row, SERVE_MAX_BATCH):
            batch = requests[lo:min(lo + SERVE_MAX_BATCH, hi_row)]
            t0 = time.perf_counter()
            feats, ents, offsets = engine.featurize(batch)
            scores[lo:lo + len(batch)] = engine.score_arrays(feats, ents, offsets)
            if len(batch) == SERVE_MAX_BATCH:
                call_s.append(time.perf_counter() - t0)
            del feats
            if engine.drift.checks != checks:
                checks = engine.drift.checks
                reports.append(engine.drift.last_report)
        tail = engine.drift.check()
        return reports + ([tail] if tail is not None else [])

    t_quiet = time.perf_counter()
    reports = serve_pass(0, n)
    quiet_alarms = engine.drift.alarms
    heldout_reports = serve_pass(n, len(requests))
    quiet_s = time.perf_counter() - t_quiet
    rebuilt = bucket_builds() - builds0 - builds
    new_segments = (torch.cuda.memory_stats()["segment.all.allocated"] - segments
                    if cuda else None)
    served = MomentSketch().add(scores[:n])
    base = game_fp["margin"]["moments"]
    served_gaps = {"mean": abs(served.mean - base["mean"]) / abs(base["mean"]),
                   "m2": abs(served.m2 - base["m2"]) / abs(base["m2"]),
                   "count": served.count - base["count"]}
    # delayed labels for the served scores: the window's AUC
    online = quality_mod.OnlineQuality(registry=stats.registry, max_samples=len(requests))
    for y, sc in zip(labels.tolist(), scores.tolist()):
        online.record(y, sc)
    snap = online.snapshot()
    window_auc = stats.registry.gauge("quality.auc").value
    exact = quality_mod.exact_auc(labels, scores)
    ops_auc = float(metrics_mod.area_under_roc_curve(
        torch.from_numpy(labels), torch.from_numpy(scores), torch.ones(len(labels),
                                                                       dtype=torch.float64)))
    # the same records with one integer field planted 4x out of its range,
    # through the micro-batcher from closed-loop clients
    plant_key = feature_key("h", str(int(_hash(np.array([QUALITY_PLANT_FIELD]),
                                                np.zeros(1, np.int64))[0] % d_hashed)))
    shifted = [ScoreRequest({k: (v * QUALITY_PLANT_FACTOR if k == plant_key else v)
                             for k, v in r.features.items()}, r.entities, r.offset)
               for r in requests[:planted]]
    heldout_alarms = engine.drift.alarms - quiet_alarms
    alarms0, checks0 = engine.drift.alarms, engine.drift.checks
    with MicroBatcher(engine.score, max_batch=SERVE_MAX_BATCH, max_wait_ms=SERVE_WAIT_MS,
                      stats=stats) as batcher:
        results, planted_wall = closed_loop(batcher.submit, shifted, SERVE_CLIENTS)
    errors = [a for _, a, _ in results if isinstance(a, Exception)]
    engine.drift.check()
    last = engine.drift.last_report or {}
    drift = {"quiet_checks": len(reports), "quiet_alarms": quiet_alarms,
             "quiet_psi_max": max((r["psi_max"] for r in reports), default=None),
             "quiet_score_psi_max": max((r["score_psi"] or 0.0 for r in reports),
                                        default=None),
             "heldout_checks": len(heldout_reports), "heldout_alarms": heldout_alarms,
             "heldout_psi_max": max((r["psi_max"] for r in heldout_reports), default=None),
             "heldout_score_psi_max": max((r["score_psi"] or 0.0 for r in heldout_reports),
                                          default=None),
             "planted_requests": len(results), "planted_errors": len(errors),
             "planted_checks": engine.drift.checks - checks0,
             "planted_alarms": engine.drift.alarms - alarms0,
             "planted_last_flagged": last.get("flagged"), "planted_psi_max": last.get("psi_max"),
             "planted_score_psi": last.get("score_psi"), "planted_feature": plant_key}
    bucket = stats.raw.get(SERVE_MAX_BATCH, [])
    f5 = (serve_summary or {}).get("buckets", {}).get(str(SERVE_MAX_BATCH), {})
    serving = {"load_s": load_s, "builds": builds, "builds_after_warmup": rebuilt,
               "new_cuda_segments": new_segments, "quiet_s": quiet_s,
               "requests": len(requests), "row_bytes": 8 * sum(
                   engine._shard_dim(s) for s in engine._used_shards),
               "call_64_ms_drift_on": quantiles_ms(call_s),
               "bucket_latency_64_ms_drift_on": quantiles_ms(bucket),
               "call_64_ms_5f": f5.get("call_ms"), "drift": drift,
               "served_vs_fingerprint_margin": served_gaps,
               "online": {**snap, "auc_gauge": window_auc, "exact_auc": exact,
                          "auc_gap": abs(window_auc - exact), "ops_metrics_auc": ops_auc,
                          "ops_metrics_gap": abs(ops_auc - exact)},
               "batcher_requests_per_s": len(results) / planted_wall}
    log(f"[quality] serving: {json.dumps(serving)}")
    if builds != 8 or rebuilt or (cuda and new_segments != 0):
        failures.append(f"drift-on serving built {rebuilt} scorers after warmup ({builds} at "
                        f"warmup) and {new_segments} CUDA segments")
    if not reports or quiet_alarms or max(
            drift["quiet_psi_max"], drift["quiet_score_psi_max"]) >= quality_mod.DEFAULT_PSI_ALARM:
        failures.append(f"the training records raised the drift alarm: {json.dumps(drift)}")
    if errors or drift["planted_alarms"] < 1:
        failures.append(f"the planted feature did not raise the alarm: {json.dumps(drift)}")
    if served_gaps["count"] or max(served_gaps["mean"], served_gaps["m2"]) > QUALITY_MARGIN_RTOL:
        failures.append(f"served scores off the fingerprint's margins: {served_gaps}")
    if abs(window_auc - exact) > QUALITY_AUC_TOL or snap["window_n"] != len(requests):
        failures.append(f"the online window's AUC {window_auc} vs exact {exact}")
    engine.close()

    k = QUALITY_CLI_REQUESTS
    cli = quality_cli(best_dir, requests[:k], labels[:k], scores[:k], n, device)
    summary = {"index": index, "glm": glm, "game": game, "serving": serving, "cli": cli,
               "phase_s": time.perf_counter() - phase_t0}
    log(f"[quality] {json.dumps(summary)}")
    if failures:
        raise AssertionError("; ".join(failures))
    return summary, {"glm": glm_launches, "game": game_launches,
                     "game_hybrid": hybrid_launches}


# -- phase 7: the full trainer -----------------------------------------------

# bounds of the 13 integer-field coefficients in run C: a box around their
# optimum at lambda 10 (the largest |w| there is 0.58). A box that binds at
# the optimum stalls the projected L-BFGS (the JAX package's, ported as it
# is): two runs on the card ended 0.1-0.7 apart in w after 500 iterations
INT_FIELD_BOUND = 1.0
ELASTIC_NET_ALPHA = 0.5
CONSTRAINED_TOLERANCE = 1e-8
CONSTRAINED_MAX_ITERS = 300
NEWTON_LAMBDA = 1.0


def heldout_auc(model, heldout) -> float:
    margins = model.compute_margin(heldout.features, heldout.offsets)
    return float(metrics_mod.area_under_roc_curve(
        heldout.labels, margins, heldout.effective_weights()))


def compare_models(label, card_models, cpu_models, heldout_cpu, failures, split_ok=False):
    """Card against CPU per lambda: the same convergence reason, then
    coefficients within 1e-6 max(1, |w|inf), variances within 1e-6
    relative, held-out AUC within 1e-6 and the same nonzero coefficients
    (magnitudes under 1e-8 aside). With ``split_ok`` (the first-order
    solvers: OWL-QN and bounded L-BFGS) the card's run may leave the CPU's
    trajectory — an orthant or line-search test flipping on the atomics'
    last bits — and is then held on what the solver's stopping test fixes:
    its objective within 2e-4 relative and the held-out AUC within 1e-3
    (OWL-QN at lambda 1 stops on max_iters mid-descent; PERF.md has the
    gaps split runs ended with); the split is recorded. Returns one record
    per lambda."""
    out = []
    for tm, ref in zip(card_models, cpu_models):
        coef = tm.model.coefficients
        w_card, w_cpu = coef.means.cpu(), ref.model.coefficients.means
        dw = float((w_card - w_cpu).abs().max())
        w_inf = float(w_cpu.abs().max())
        f_card, f_cpu = float(tm.result.value), float(ref.result.value)
        rec = {"lambda": tm.reg_weight, "iterations": tm.result.iterations,
               "cpu_iterations": ref.result.iterations, "reason": tm.result.reason,
               "cpu_reason": ref.result.reason, "solve_s": tm.seconds,
               "cpu_solve_s": ref.seconds, "max_abs_dw": dw, "w_inf": w_inf,
               "objective": f_card, "cpu_objective": f_cpu,
               "objective_rel_diff": abs(f_card - f_cpu) / abs(f_cpu)}
        same = dw <= 1e-6 * max(1.0, w_inf)
        rec["split"] = not same
        where = f"{label} lambda={tm.reg_weight}"
        if tm.result.reason != ref.result.reason:
            failures.append(f"{where}: reason {tm.result.reason} vs {ref.result.reason} on the CPU")
        if not same and not split_ok:
            failures.append(f"{where}: max |dw| {dw} vs the CPU run")
        if not same and rec["objective_rel_diff"] > 2e-4:
            failures.append(f"{where}: objective {f_card} vs {f_cpu} on the CPU")
        v_ref = ref.model.coefficients.variances
        if v_ref is not None:
            if coef.variances is None:
                failures.append(f"{where}: no variances")
            else:
                v_card = coef.variances.cpu()
                rel = float(((v_card - v_ref).abs() / v_ref.abs()).max())
                rec["max_rel_dvariance"] = rel
                if not (bool(torch.isfinite(v_card).all()) and bool((v_card > 0).all())):
                    failures.append(f"{where}: variances not finite and positive")
                if same and rel > 1e-6:
                    failures.append(f"{where}: variances {rel} apart")
        # the card's coefficients scored on the CPU's held-out batch
        card_model = dataclasses.replace(tm.model, coefficients=Coefficients(means=w_card))
        auc = heldout_auc(card_model, heldout_cpu)
        auc_cpu = heldout_auc(ref.model, heldout_cpu)
        rec.update(heldout_auc=auc, cpu_heldout_auc=auc_cpu)
        if not (0.5 < auc <= 1.0 and abs(auc - auc_cpu) <= (1e-6 if same else 1e-3)):
            failures.append(f"{where}: held-out AUC {auc} vs CPU {auc_cpu}")
        nz_card, nz_cpu = w_card.abs() > 1e-8, w_cpu.abs() > 1e-8
        rec.update(nonzeros=int(nz_card.sum()), cpu_nonzeros=int(nz_cpu.sum()),
                   nonzero_pattern_flips=int((nz_card != nz_cpu).sum()))
        if same and rec["nonzeros"] != rec["cpu_nonzeros"]:
            failures.append(f"{where}: {rec['nonzeros']} nonzero coefficients vs "
                            f"{rec['cpu_nonzeros']} on the CPU")
        out.append(rec)
    return out


def timed_run(params, device_kw):
    """``run_glm_training`` with the counters set to 0 just before and read
    just after: (run, wall seconds, launches, host reads)."""
    dispatch.reset_launch_counts()
    reset_host_reads()
    t0 = time.perf_counter()
    run = run_glm_training(params, **device_kw)
    wall_s = time.perf_counter() - t0
    require_native(run, "[full]")
    return run, wall_s, dispatch.launch_counts(), host_reads()


def timed_train(batch, cfg):
    """``train_glm`` in memory, counted the same way."""
    dispatch.reset_launch_counts()
    reset_host_reads()
    t0 = time.perf_counter()
    models = train_glm(batch, cfg)
    if batch.labels.is_cuda:
        torch.cuda.synchronize()
    return models, time.perf_counter() - t0, dispatch.launch_counts(), host_reads()


def dense_int_fields(coo, labels, offsets, d_int: int, device):
    """The intercept and the integer fields as a dense (n, 1 + d_int)
    batch: the first d_int of each row's generator slots, then a column of
    ones."""
    rows, cols, vals = coo
    n = labels.shape[0]
    per_row = (rows.size - n) // n
    x = np.concatenate([vals[: n * per_row].reshape(n, per_row)[:, :d_int],
                        np.ones((n, 1))], axis=1)
    return LabeledBatch.create(x, labels, offsets=offsets, dtype=torch.float64, device=device)


def full_trainer_phase(work: str, ref: dict, **device_kw):
    """Run A-D of phase 7 and hold each to the CPU. ``device_kw`` is empty
    for the card (the driver's default device)."""
    failures = []
    vocab, sets = ref["vocab"], ref["sets"]
    batch_cpu, heldout_cpu = ref["batch_cpu"], ref["heldout_cpu"]
    icpt = vocab.intercept_index
    base = {**ref["params"], "output_dir": None}
    summary = {}

    # A: TRON + variances + diagnostics
    params_a = {**base, "output_dir": os.path.join(work, "a"), "compute_variances": True,
                "diagnostics": True, "training_diagnostics": True}
    run, wall_s, launches, reads = timed_run(params_a, device_kw)
    lam_count = len(run.models)
    if not device_kw and launches["fused_hdiag"] != lam_count:
        failures.append(f"run A: {launches['fused_hdiag']} fused_hdiag launches, "
                        f"one per lambda is {lam_count}")
    if not device_kw and min(launches[k] for k in ("fused_vgc", "fused_hvp", "ell_matvec",
                                                      "ell_colsum", "colsort_reduce")) < 1:
        failures.append(f"run A missed a kernel: {launches}")
    html = os.path.join(run.params.output_dir, "model-diagnostic.html")
    if not (os.path.exists(html) and os.path.getsize(html) > 0):
        failures.append("run A wrote no model-diagnostic.html")
    per_lambda = compare_models("run A", run.models, ref["tron_models"], heldout_cpu, failures)
    summary["run_a"] = {"wall_s": wall_s, "timings_s": run.timings, "launches": launches,
                        "host_reads": reads, "per_lambda": per_lambda,
                        "report_bytes": os.path.getsize(html) if os.path.exists(html) else 0}
    log(f"[full] run A: {json.dumps(summary['run_a'])}")
    launches_a = launches

    # the variance pass alone at the driver's shape, on the run's own batch
    # and solution (card: CUDA events; CPU: the host clock)
    tm = run.models[-1]
    x_dev = batch_from(*sets["train"][1:], len(vocab), tm.model.coefficients.means.device)
    obj = GLMObjective(loss=LOGISTIC_LOSS, l2_weight=tm.reg_weight)
    w_dev = tm.result.w
    if not device_kw:
        summary["variance_pass_ms"] = time_ms(lambda: obj.hessian_diagonal(w_dev, x_dev))
    del x_dev

    # B: OWL-QN elastic net + variances
    params_b = {**base, "output_dir": os.path.join(work, "b"), "optimizer": "LBFGS",
                "reg_type": "ELASTIC_NET", "elastic_net_alpha": ELASTIC_NET_ALPHA,
                "compute_variances": True, "model_output_mode": "NONE"}
    run, wall_s, launches, reads = timed_run(params_b, device_kw)
    if not device_kw and (launches["fused_hdiag"] != len(run.models)
                          or launches["fused_vgc"] < 1):
        failures.append(f"run B missed a kernel: {launches}")
    cfg_b = dataclasses.replace(run.params.to_training_config(), intercept_index=icpt)
    t0 = time.perf_counter()
    cpu_b = train_glm(batch_cpu, cfg_b)
    cpu_b_s = time.perf_counter() - t0
    iters = sum(tm.result.iterations for tm in run.models)
    summary["run_b"] = {
        "wall_s": wall_s, "timings_s": run.timings, "launches": launches, "host_reads": reads,
        "host_reads_per_iteration": reads / max(iters, 1),
        "evals": [tm.result.evals for tm in run.models], "cpu_reference_s": cpu_b_s,
        "per_lambda": compare_models("run B", run.models, cpu_b, heldout_cpu, failures,
                                     split_ok=True)}
    log(f"[full] run B: {json.dumps(summary['run_b'])}")

    # C: L-BFGS L2 in memory, a constraint file on the 13 integer fields
    device = torch.device("cuda") if not device_kw else torch.device(device_kw["device"])
    batch_dev = batch_from(*sets["train"][1:], len(vocab), device)
    int_cols = sorted({int(c) for c in sets["train"][1][1][:INT_FIELDS]})
    path = os.path.join(work, "constraints.json")
    with open(path, "w") as f:
        json.dump([{"name": "h", "term": str(c), "lowerBound": -INT_FIELD_BOUND,
                    "upperBound": INT_FIELD_BOUND} for c in int_cols], f)
    lower, upper = load_constraint_bounds(path, vocab)
    cfg_c = GLMTrainingConfig(
        optimizer=OptimizerType.LBFGS, regularization=RegularizationContext("L2"),
        reg_weights=(TRAIN_LAMBDAS[0],), tolerance=CONSTRAINED_TOLERANCE,
        max_iters=CONSTRAINED_MAX_ITERS, intercept_index=icpt, lower_bounds=lower,
        upper_bounds=upper)
    models_c, wall_s, launches, reads = timed_train(batch_dev, cfg_c)
    if not device_kw and launches["fused_vgc"] < 1:
        failures.append(f"run C missed fused_vgc: {launches}")
    t0 = time.perf_counter()
    cpu_c = train_glm(batch_cpu, cfg_c)
    cpu_c_s = time.perf_counter() - t0
    w_c = models_c[0].model.coefficients.means.cpu()
    bound_ok = bool(torch.all(w_c[int_cols].abs() <= INT_FIELD_BOUND))
    at_bound = int((w_c[int_cols].abs() == INT_FIELD_BOUND).sum())
    if not bound_ok or models_c[0].result.reason == 1:
        failures.append(f"run C: bounds held {bound_ok}, reason {models_c[0].result.reason}")
    summary["run_c"] = {
        "wall_s": wall_s, "launches": launches, "host_reads": reads,
        "bounded_columns": len(int_cols), "at_bound": at_bound, "cpu_reference_s": cpu_c_s,
        "per_lambda": compare_models("run C", models_c, cpu_c, heldout_cpu, failures,
                                     split_ok=True)}
    log(f"[full] run C: {json.dumps(summary['run_c'])}")
    del batch_dev

    # D: NEWTON on the dense intercept + integer fields
    coo, labels, offsets = sets["train"][1:]
    dense_dev = dense_int_fields(coo, labels, offsets, INT_FIELDS, device)
    dense_cpu = dense_int_fields(coo, labels, offsets, INT_FIELDS, "cpu")
    hcoo, hlabels, hoffsets = sets["heldout"][1:]
    dense_heldout = dense_int_fields(hcoo, hlabels, hoffsets, INT_FIELDS, "cpu")
    cfg_d = GLMTrainingConfig(
        optimizer=OptimizerType.NEWTON, regularization=RegularizationContext("L2"),
        reg_weights=(NEWTON_LAMBDA,), tolerance=TRAIN_TOLERANCE, max_iters=25,
        intercept_index=INT_FIELDS, compute_variances=True)
    models_d, wall_s, launches, reads = timed_train(dense_dev, cfg_d)
    cpu_d = train_glm(dense_cpu, cfg_d)
    summary["run_d"] = {
        "d": INT_FIELDS + 1, "wall_s": wall_s, "host_reads": reads,
        "per_lambda": compare_models("run D", models_d, cpu_d, dense_heldout, failures)}
    log(f"[full] run D: {json.dumps(summary['run_d'])}")

    if failures:
        raise AssertionError("; ".join(failures))
    return summary, launches_a


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
    for library in build.SOURCES:
        ptxas = build.build_log(library)
        regs = sorted({int(r) for r in re.findall(r"Used (\d+) registers", ptxas)})
        spills = sorted({int(s) for s in re.findall(r"(\d+) bytes spill stores", ptxas)})
        log(f"[build] {library} instantiations: registers per thread {regs}, "
            f"spill-store bytes {spills}")

    # every driver phase's records, drawn now and written by worker
    # processes while phases 3-4b hold the card
    work = os.path.join(ROOT, "_smoke_work")
    shutil.rmtree(work, ignore_errors=True)
    try:
        ahead = write_inputs_ahead(work)

        # 3. ell_matvec against its plain version
        checks = kernel_phase(name)
        log(json.dumps({"ell_matvec_checks": checks}))

        # 4. the training kernels against their plain versions, and the
        # scatter with hot columns
        train_checks, hot_checks, reduce_extra = training_kernel_phase(name)
        log(json.dumps({"training_kernel_checks": train_checks}))
        log(json.dumps({"reduce_row_blocks": reduce_extra}))
        log(json.dumps({"hot_column_scatter_checks": [
            c for c in hot_checks if c["name"] == "ell_scatter_add"]}))
        log(json.dumps({"hot_column_fused_checks": [
            c for c in hot_checks if c["name"] != "ell_scatter_add"]}))

        # 4b. the sparse kernel lab, and its column-sorted kernels at 2^22
        lab_launches, lab_checks, lab_uniform_checks, lab_summary = lab_phase(name)
        log(json.dumps({"lab_checks": lab_checks, "lab_uniform_checks": lab_uniform_checks,
                        "lab": lab_summary}))

        # 5. GLM scoring end to end
        summary = score_phase(os.path.join(work, "score"), inputs=ahead.pop("score"))
        if summary["launches"]["ell_matvec"] < 1:
            raise AssertionError("the scoring run did not launch the ell_matvec kernel")
        # 5b. GAME scoring end to end, held to the CPU
        game_summary, game_record, served = game_phase(os.path.join(work, "game"), name,
                                                       inputs=ahead.pop("game"))
        # 5f. online serving: 5b's model and records through the engine,
        # the micro-batcher, a hot reload, the tiered cache and cli.serve
        serve_summary = serving_phase(os.path.join(work, "serve"), served, name)
        del served
        shutil.rmtree(os.path.join(work, "game"), ignore_errors=True)
        shutil.rmtree(os.path.join(work, "serve"), ignore_errors=True)
        # 5c. GAME training end to end, held to the CPU
        game_train_summary = game_train_phase(os.path.join(work, "game_train"), name,
                                              inputs=ahead.pop("game_train"))
        shutil.rmtree(os.path.join(work, "game_train"), ignore_errors=True)
        # 5d. GAME training with projected and factored effects, checkpoints
        # and a resume, held to the CPU
        game_proj_summary = game_projected_phase(os.path.join(work, "game_proj"), name,
                                                 inputs=ahead.pop("game_proj"))
        # 5e. determinism at the settings users run: two card runs and a
        # preempted-and-resumed one, bit for bit, on 5d's records
        game_det_summary = game_determinism_phase(os.path.join(work, "game_det"), name,
                                                  inputs=game_proj_summary["inputs"])
        shutil.rmtree(os.path.join(work, "game_proj"), ignore_errors=True)
        shutil.rmtree(os.path.join(work, "game_det"), ignore_errors=True)
        # 6. GLM training end to end
        train_summary, shape_checks, reference = train_phase(os.path.join(work, "train"), name,
                                                             inputs=ahead.pop("train"))
        # 7. the full trainer on the same records
        full_summary, full_launches = full_trainer_phase(os.path.join(work, "full"), reference)
        shutil.rmtree(os.path.join(work, "full"), ignore_errors=True)
        # 6h. hybrid designs: phase 6's driver with hot_columns -1 and 14
        hybrid_summary, hybrid_launches = hybrid_train_phase(
            os.path.join(work, "hybrid"), reference, train_summary, name)
        shutil.rmtree(os.path.join(work, "hybrid"), ignore_errors=True)
        # 5g. the index job on phase 6's training file, the GLM and GAME
        # drivers with the quality fingerprint (the GAME one again with a
        # hybrid fixed effect), the export served with its drift monitor and
        # the feedback loop
        quality_summary, quality_launches = quality_loop_phase(
            os.path.join(work, "quality"), reference["sets"], name, serve_summary,
            game_inputs=ahead.pop("quality_game"))
        del reference
    finally:
        stop_writers()
        shutil.rmtree(work, ignore_errors=True)
    log(json.dumps({"train_shape_checks": shape_checks}))
    log(json.dumps({"serving": serve_summary}))
    log(json.dumps({"full_trainer": full_summary}))
    log(json.dumps({"hybrid": hybrid_summary}))
    log(json.dumps({"quality_loop": quality_summary}))
    log(json.dumps({"determinism": {"game": game_det_summary,
                                    "glm_second_run_same_w_bits":
                                        train_summary["second_run_same_w_bits"]}}))

    # 8. result lines: each kernel at the kernel-phase shape in the main
    # path's dtype (f64), its time at the training driver's shape (and
    # with hot columns for all but ell_matvec; for ell_matvec at the GAME
    # scoring shape too), and its launches on its main path — the training
    # run, and for fused_hdiag the full trainer's run A (per path: GLM
    # scoring, GAME scoring, GAME training, training, run A, lab); the
    # composites of
    # library calls beside fused_hvp's and fused_hdiag's times
    keys = ("name", "route", "source", "replaces", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    shape_keys = ("shape", "ms", "plain_ms", "bound_ms", "library_ms", "device_ms",
                  "host_ms", "library_device_ms", "library_host_ms", "composite_ms",
                  "composite_device_ms",
                  "max_abs_err", "max_err_share", "max_err_share_vs_f64")

    def f64_record(records, kernel):
        return next((c for c in records if c["name"] == kernel and c["dtype"] == "f64"), None)

    kernels = []
    for kernel in ("ell_matvec", "ell_scatter_add", "fused_vgc", "fused_hvp", "fused_hdiag",
                   "colsort_reduce"):
        main_path = f64_record(checks + train_checks, kernel)
        at_shape = f64_record(shape_checks, kernel)
        hot = f64_record(hot_checks, kernel)
        # ell_scatter_add's path is the lab's A2 since the training paths'
        # column sums went to the reduce
        launches = {"fused_hdiag": full_launches, "ell_scatter_add": lab_launches}.get(
            kernel, train_summary["launches"])
        kernels.append({
            **{k: main_path[k] for k in keys},
            "launches": launches[kernel],
            "launches_by_path": {"score": summary["launches"][kernel],
                                 "game_score": game_summary["launches"][kernel],
                                 "game_train": game_train_summary["launches"][kernel],
                                 "game_train_projected": game_proj_summary["launches"][kernel],
                                 "train": train_summary["launches"][kernel],
                                 "full_trainer_a": full_launches[kernel],
                                 "quality_glm": quality_launches["glm"][kernel],
                                 "quality_game": quality_launches["game"][kernel],
                                 "train_hybrid": hybrid_launches[kernel],
                                 "quality_game_hybrid": quality_launches["game_hybrid"][kernel],
                                 "lab": lab_launches[kernel]},
            "device_ms": main_path["device_ms"],
            "host_ms": main_path["host_ms"],
            "library_device_ms": main_path["library_device_ms"],
            "library_host_ms": main_path.get("library_host_ms"),
            "train_shape": None if at_shape is None else {
                k: at_shape.get(k) for k in shape_keys},
        })
        if hot is not None:
            kernels[-1]["hot_columns"] = {k: hot.get(k) for k in shape_keys}
        if kernel == "ell_matvec":
            kernels[-1]["game_shape"] = {k: game_record.get(k) for k in shape_keys}
        if main_path["composite"] is not None:
            kernels[-1].update({k: main_path[k] for k in (
                "composite", "composite_ms", "composite_device_ms")})
        if kernel == "colsort_reduce":
            kernels[-1].update({"replaces_all": REDUCE_REPLACES,
                                "bytes": main_path["bytes"],
                                "analytic_bytes": main_path["analytic_bytes"],
                                "copy": main_path["copy"],
                                "hot_copy": hot["copy"], "train_shape_copy": at_shape["copy"],
                                "row_block_sweep": reduce_extra["row_block_sweep"],
                                "large": {k: reduce_extra["large"].get(k) for k in (
                                    "shape", "blocks", *shape_keys[1:])}})
    # the lab's kernels: each at the lab's default shape, its launches on
    # the lab's path, and the column-sorted pair at the uniform 2^22 design
    for kernel in LAB_KERNELS:
        main_path = next(c for c in lab_checks if c["name"] == kernel)
        uniform = next((c for c in lab_uniform_checks if c["name"] == kernel), None)
        kernels.append({
            **{k: main_path[k] for k in keys},
            "launches": lab_launches[kernel],
            "launches_by_path": {"lab": lab_launches[kernel],
                                 "game_score": game_summary["launches"][kernel],
                                 "game_train": game_train_summary["launches"][kernel],
                                 "game_train_projected": game_proj_summary["launches"][kernel]},
            **{k: main_path[k] for k in ("device_ms", "host_ms", "library_device_ms",
                                         "library_host_ms", "composite", "composite_ms", "composite_device_ms",
                                         "max_err_share")},
            "uniform_2_22": None if uniform is None else {k: uniform.get(k) for k in shape_keys},
        })
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
