"""Block coordinate descent over GAME coordinates (counterpart of
``photon_ml_tpu/game/descent.py``; the reference's
``algorithm/CoordinateDescent.scala:39-198``): for each outer iteration,
update every coordinate in the configured sequence against the residual of
all the others (partial score = total - own), rescore, and log the full
training objective (loss + all regularization terms). Per-coordinate
scores are dense (n,) tensors on the coordinates' device.

The JAX package runs a pass as one XLA dispatch (``fuse_passes=True``), one
dispatch per update (``"coordinate"``), several passes per dispatch
(``passes_per_dispatch``), or the per-update loop; all four compute the
same math. The port runs the per-update loop (the divergence guard and
the caller's ``freeze`` included) and takes neither option: the driver
runs every ``passes_per_dispatch`` one pass at a time. Down-sampling
draws come from a ``torch.Generator`` seeded by ``seed``, not
``jax.random``. Checkpoints (:mod:`photon_ml_tpu_torch.io.checkpoint`)
are written at pass boundaries by a one-deep background writer, and a run
restarted over the same directory resumes from the newest valid step with
the generator's state, reproducing the uninterrupted run bit for bit on
the CPU. Each update probes the ``descent.update`` fault site (key = the
coordinate's name): a ``corrupt`` action poisons the accepted update with
NaN, the drill for the divergence guard. Not ported: the sharded
checkpoints and the heartbeat (ROADMAP.md queue A items 9, 10).
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Dict, List, Mapping, Optional

import numpy as np
import torch

from photon_ml_tpu_torch.core.tasks import TaskType
from photon_ml_tpu_torch.game.factored import FactoredParams, is_factored_params
from photon_ml_tpu_torch.ops import metrics as metrics_mod
from photon_ml_tpu_torch.resilience import faults as _faults
from photon_ml_tpu_torch.resilience.shutdown import (
    clear_preempted_marker,
    write_preempted_marker,
)
from photon_ml_tpu_torch.solvers.common import ConvergenceReason
from photon_ml_tpu_torch.utils.device import to_numpy


@dataclasses.dataclass
class GameModel:
    """name -> parameters (fixed effect: (d,); random effect: (E, d), in
    the projected space for a projected coordinate; factored:
    FactoredParams)."""

    params: Dict[str, torch.Tensor]

    def copy(self) -> "GameModel":
        return GameModel(params=dict(self.params))


@dataclasses.dataclass
class CoordinateUpdateRecord:
    """One coordinate update's snapshot (``CoordinateDescent.scala:160-189``,
    ``optimization/game/*Tracker``). ``seconds`` is the update's host wall
    time on every record (the JAX package's fused pass keeps it on the
    first record only). Two fields are the port's additions:
    ``cg_iterations``, TRON's CG steps in the update (summed over entities
    for a random effect; None for other solvers), and
    ``entity_iterations``, a random effect's per-entity solver iterations
    (in the update summary's entity order; None for a fixed effect)."""

    iteration: int
    coordinate: str
    objective: float
    seconds: Optional[float]
    solver_iterations: float  # mean over entities for random effects
    convergence_histogram: Dict[str, int]
    validation_metric: Optional[float] = None
    # divergence guard: None, "recovered" (rolled back, the damped retry
    # succeeded) or "frozen" (the retry failed too; no further updates)
    event: Optional[str] = None
    cg_iterations: Optional[int] = None
    entity_iterations: Optional[np.ndarray] = None


def _coordinate_reg_term(coord, params) -> torch.Tensor:
    """The coordinate's own reg_term when it defines one, else its config
    applied to the params."""
    if hasattr(coord, "reg_term"):
        return coord.reg_term(params)
    return _config_reg_term(coord.config, params)


def _config_reg_term(cfg, params) -> torch.Tensor:
    """The loss-side penalty of one coordinate's params under its config."""
    l2 = cfg.reg_weight * (1.0 - cfg.l1_ratio)
    l1 = cfg.reg_weight * cfg.l1_ratio
    return 0.5 * l2 * torch.sum(params * params) + l1 * torch.sum(torch.abs(params))


def _history_record(iteration, coordinate, objective, reasons, iterations, seconds,
                    validation_metric=None, event=None, cg_iterations=None,
                    entity_iterations=None) -> CoordinateUpdateRecord:
    """The one place that makes a record: the reason histogram and the solver
    iterations' mean. The solver fields may be host values or tensors on
    any device (a batched solve's per-lane results)."""
    reasons = np.atleast_1d(to_numpy(reasons))
    iters_arr = to_numpy(iterations)
    return CoordinateUpdateRecord(
        iteration=iteration,
        coordinate=coordinate,
        objective=float(objective),
        seconds=seconds,
        validation_metric=validation_metric,
        event=event,
        solver_iterations=float(np.mean(iters_arr)) if iters_arr.size else 0.0,
        convergence_histogram={
            ConvergenceReason(int(r)).name: int(c)
            for r, c in zip(*np.unique(reasons, return_counts=True))
        },
        cg_iterations=None if cg_iterations is None else int(np.sum(to_numpy(cg_iterations))),
        entity_iterations=entity_iterations,
    )


def _loss_fn_for_task(task: TaskType):
    if task == TaskType.LOGISTIC_REGRESSION:
        return metrics_mod.total_logistic_loss
    if task == TaskType.LINEAR_REGRESSION:
        return metrics_mod.total_squared_loss
    if task == TaskType.POISSON_REGRESSION:
        return metrics_mod.total_poisson_loss
    raise ValueError(f"no GAME training evaluator for {task}")


class _AsyncCheckpointWriter:
    """One-deep background checkpoint writer: the loop hands a write
    closure over a host snapshot (numpy only: no device tensor crosses
    threads) to :meth:`submit` and goes on with the next pass while
    serialization and the atomic swap hit the disk. ``submit`` joins the
    previous write first, so writes land in step order and at most one is
    in flight. A background failure surfaces at the next ``submit`` or
    ``join`` (at the latest before ``run()`` returns), where the retained
    closure runs again synchronously; only a second failure raises."""

    def __init__(self):
        self._thread = None
        self._fn = None
        self._exc: Optional[BaseException] = None

    def submit(self, write_fn) -> None:
        self.join()
        self._fn = write_fn

        def run():
            try:
                write_fn()
            except Exception as e:  # noqa: BLE001 — surfaces at join
                self._exc = e

        self._thread = threading.Thread(target=run, name="game-ckpt-writer", daemon=True)
        self._thread.start()

    def join(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._exc is not None:
            self._exc = None
            # the caller stands on a point that promised a checkpoint
            self._fn()


def _host_params(p):
    """A coordinate's parameters as host numpy (FactoredParams leaf by leaf)."""
    if is_factored_params(p):
        return FactoredParams(gamma=to_numpy(p.gamma), projection=to_numpy(p.projection))
    return to_numpy(p)


def _poisoned(p):
    """A coordinate's parameters with every entry NaN (FactoredParams leaf
    by leaf): what a ``corrupt`` action of ``descent.update`` makes of an
    update."""
    if is_factored_params(p):
        return FactoredParams(gamma=torch.full_like(p.gamma, float("nan")),
                              projection=torch.full_like(p.projection, float("nan")))
    return torch.full_like(p, float("nan"))


class CoordinateDescent:
    """Owns the coordinates and the outer loop. ``coordinates``: ordered
    name -> coordinate (the updating sequence); all see the same rows in
    the same order. The JAX package's ``fuse_passes`` modes all run the
    per-update loop here, so the port takes no such option."""

    def __init__(
        self,
        coordinates: Mapping[str, object],
        labels: torch.Tensor,
        base_offsets: torch.Tensor,
        weights: torch.Tensor,
        task: TaskType,
    ):
        self.coordinates = dict(coordinates)
        self.labels = labels
        self.base_offsets = base_offsets
        self.weights = weights
        self.task = task
        self._loss_fn = _loss_fn_for_task(task)

    def _full_objective(self, scores: Dict[str, torch.Tensor], params) -> torch.Tensor:
        """Loss + every coordinate's penalty, in the JAX package's order
        (``descent.py:337-342``)."""
        names = list(self.coordinates)
        reg = sum(_coordinate_reg_term(self.coordinates[n], params[n]) for n in names)
        total = sum(scores[n] for n in names)
        return self._loss_fn(self.labels, self.base_offsets + total, self.weights) + reg

    def run(
        self,
        num_iterations: int,
        initial_model: Optional[GameModel] = None,
        seed: int = 0,
        validation_fn=None,
        checkpoint_dir: Optional[str] = None,
        checkpoint_every: int = 1,
        resume: bool = True,
        divergence_guard: bool = False,
        stop_check=None,
        freeze=None,
    ):
        """Returns (model, history): one record per coordinate update
        (``CoordinateDescent.scala:160-189``), with
        ``validation_fn(model) -> float`` evaluated after every update when
        given. ``initial_model`` (a GameModel or a name -> params mapping)
        warm-starts the coordinates it names through
        :func:`_warm_start_params`; the others start cold.

        ``checkpoint_dir``: every ``checkpoint_every`` passes the full
        training state (parameters, the generator's state, the pass
        counter, the history, the frozen set) is written there atomically;
        with ``resume`` a run over the same directory continues from the
        newest valid step, reproducing the uninterrupted run. A checkpoint
        that lacks a coordinate, or whose step exceeds ``num_iterations``,
        is refused.

        ``divergence_guard``: after each update, a non-finite training
        objective rolls the coordinate back and retries once against a
        DAMPED residual (half the partial score); if that fails too the
        coordinate is FROZEN at its last finite state and skipped for the
        rest of the run (and of a resumed run), while the others keep
        training. ``freeze`` names coordinates excluded from updates for
        the whole run (they keep their warm start and still score).
        ``stop_check``, a zero-arg callable, is polled at pass boundaries:
        when it turns true the run ends after that pass, and with a
        checkpoint directory it writes a final checkpoint and a
        ``preempted.json`` marker there first."""
        names = list(self.coordinates)
        seed_frozen = set(freeze or ())
        unknown = seed_frozen - set(names)
        if unknown:
            raise ValueError(f"freeze names unknown coordinates: {sorted(unknown)}")
        if seed_frozen >= set(names):
            raise ValueError("freeze covers every coordinate — nothing would train")
        frozen = set(seed_frozen)
        history: List[CoordinateUpdateRecord] = []
        generator = torch.Generator().manual_seed(seed)
        start_it = 0
        ckpt = None
        if checkpoint_dir is not None and resume:
            from photon_ml_tpu_torch.io.checkpoint import latest_checkpoint

            ckpt = latest_checkpoint(checkpoint_dir)
        if ckpt is not None:
            missing = set(names) - set(ckpt.params)
            if missing:
                raise ValueError(f"checkpoint lacks coordinates {sorted(missing)}")
            if ckpt.step > num_iterations:
                raise ValueError(
                    f"checkpoint at step {ckpt.step} exceeds num_iterations="
                    f"{num_iterations}; refusing to return a longer run's state as if "
                    "it were shorter"
                )
            model = GameModel(_warm_start_params(self.coordinates, names, ckpt.params))
            if ckpt.generator_state is not None:
                generator.set_state(torch.from_numpy(np.array(ckpt.generator_state)))
            start_it = ckpt.step
            history = [_record_from_dict(h) for h in ckpt.history]
            frozen = (set(ckpt.frozen) & set(names)) | seed_frozen
        else:
            model = GameModel(_warm_start_params(self.coordinates, names, initial_model))
        scores = {n: self.coordinates[n].score(model.params[n]) for n in names}
        # per-update device values stay on the device until a checkpoint
        # or the run's end reads them
        pending: List[dict] = []

        def materialize():
            for p in pending:
                # a SolverResult, a BatchedSolverResult or a
                # RandomEffectUpdateSummary
                r = p["result"]
                history.append(_history_record(
                    p["iteration"], p["coordinate"], float(p["objective"]), r.reason,
                    r.iterations, p["seconds"], p["validation_metric"], p["event"],
                    r.cg_iterations, r.iterations if hasattr(r, "entity_ids") else None,
                ))
            pending.clear()

        writer = _AsyncCheckpointWriter()

        def save(step: int, wait: bool = False) -> None:
            from photon_ml_tpu_torch.io.checkpoint import jax_prng_key, save_checkpoint

            materialize()
            # the host snapshot of THIS boundary, taken before the next
            # pass mutates anything
            snapshot = dict(
                params={n: _host_params(model.params[n]) for n in names},
                rng_key=jax_prng_key(seed),
                history=[dataclasses.asdict(h) for h in history],
                frozen=sorted(frozen),
                generator_state=generator.get_state().numpy().copy(),
            )
            writer.submit(lambda: save_checkpoint(checkpoint_dir, step, **snapshot))
            if wait:
                writer.join()

        stopped = False
        for it in range(start_it, num_iterations):
            for name in names:
                if name in frozen:
                    continue
                t0 = time.perf_counter()
                coord = self.coordinates[name]
                total = sum(scores.values())
                partial = total - scores[name]

                def _attempt(prev_p, residual):
                    p, r, s = coord.update_and_score(prev_p, residual, generator)
                    # fault site: corrupt-mode poisons the accepted update
                    # with non-finites — the drill for the divergence guard
                    if _faults.fire("descent.update", key=name).corrupt:
                        p = _poisoned(p)
                        s = torch.full_like(s, float("nan"))
                    return p, r, s

                params, result, new_scores = _attempt(model.params[name], partial)
                event = None
                if divergence_guard:
                    obj = float(self._full_objective(
                        {**scores, name: new_scores}, {**model.params, name: params}))
                    if not np.isfinite(obj):
                        params, result, new_scores = _attempt(
                            model.params[name], partial * 0.5
                        )
                        obj = float(self._full_objective(
                            {**scores, name: new_scores}, {**model.params, name: params}))
                        if np.isfinite(obj):
                            event = "recovered"
                        else:
                            # keep the last finite state; the record's
                            # objective is that state's
                            frozen.add(name)
                            event = "frozen"
                            params = model.params[name]
                            new_scores = scores[name]
                model.params[name] = params
                scores[name] = new_scores
                obj = self._full_objective(scores, model.params)
                seconds = time.perf_counter() - t0
                vmetric = float(validation_fn(model)) if validation_fn is not None else None
                pending.append({
                    "iteration": it, "coordinate": name, "objective": obj,
                    "seconds": seconds, "validation_metric": vmetric, "event": event,
                    "result": result,
                })
            saved = False
            if checkpoint_dir is not None and (it + 1 - start_it) % checkpoint_every == 0:
                save(it + 1)
                saved = True
            if stop_check is not None and stop_check():
                stopped = True
                if checkpoint_dir is not None:
                    # the marker promises a durable checkpoint at this step
                    if saved:
                        writer.join()
                    else:
                        save(it + 1, wait=True)
                    write_preempted_marker(checkpoint_dir, it + 1,
                                           getattr(stop_check, "signum", None))
                break
        # every checkpoint submitted is on disk (or has raised) before the
        # run returns
        writer.join()
        materialize()
        if checkpoint_dir is not None and not stopped:
            # the run reached its target: a marker of an earlier preempted
            # attempt no longer applies
            clear_preempted_marker(checkpoint_dir)
        return model, history

    def total_scores(self, model: GameModel) -> torch.Tensor:
        return sum(self.coordinates[n].score(model.params[n]) for n in self.coordinates)


def _record_from_dict(h: dict) -> CoordinateUpdateRecord:
    """A checkpoint's history record (either package's) as a record."""
    h = dict(h)
    if h.get("entity_iterations") is not None:
        h["entity_iterations"] = np.asarray(h["entity_iterations"])
    return CoordinateUpdateRecord(**h)


def _warm_start_params(coords, names, initial_model):
    """Per-coordinate starting params: the warm start's table where one is
    given (a GameModel or a plain name -> params mapping), the coordinate's
    cold ``initial_params()`` otherwise. A warm start must match the cold
    start's structure (a table, or FactoredParams) and shapes exactly
    (warm starts re-key by entity id, never by position); it takes the
    cold start's dtype and device."""
    init = getattr(initial_model, "params", initial_model) if initial_model is not None else None

    def like(got, want):
        got = got if torch.is_tensor(got) else torch.from_numpy(np.array(got))
        return got.to(want)

    out = {}
    for n in names:
        want = coords[n].initial_params()
        if init is None or n not in init:
            out[n] = want
            continue
        got = init[n]
        if is_factored_params(want) != is_factored_params(got):
            raise ValueError(
                f"warm start for coordinate {n!r} does not match its parameter structure"
            )
        if is_factored_params(want):
            got = FactoredParams(gamma=like(got.gamma, want.gamma),
                                 projection=like(got.projection, want.projection))
            pairs = [(got.gamma, want.gamma), (got.projection, want.projection)]
        else:
            got = like(got, want)
            pairs = [(got, want)]
        if any(tuple(g.shape) != tuple(w.shape) for g, w in pairs):
            raise ValueError(
                f"warm start for coordinate {n!r} has mismatched shapes — warm "
                "starts re-key by entity id (load_game_model), never by position"
            )
        out[n] = got
    return out
