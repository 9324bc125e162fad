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
``jax.random``. The update's fault site (``descent.update``) and
checkpoints are not ported (ROADMAP.md queue A).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Mapping, Optional

import numpy as np
import torch

from photon_ml_tpu_torch.core.tasks import TaskType
from photon_ml_tpu_torch.ops import metrics as metrics_mod
from photon_ml_tpu_torch.solvers.common import ConvergenceReason


@dataclasses.dataclass
class GameModel:
    """name -> parameters (fixed effect: (d,); random effect: (E, d))."""

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
    iterations' mean."""
    reasons = np.atleast_1d(np.asarray(reasons))
    iters_arr = np.asarray(iterations)
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
        cg_iterations=None if cg_iterations is None else int(np.sum(cg_iterations)),
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

        ``divergence_guard``: after each update, a non-finite training
        objective rolls the coordinate back and retries once against a
        DAMPED residual (half the partial score); if that fails too the
        coordinate is FROZEN at its last finite state and skipped for the
        rest of the run, while the others keep training. ``freeze``
        names coordinates excluded from updates for the whole run (they
        keep their warm start and still score). ``stop_check``, a zero-arg
        callable, is polled at pass boundaries: when it turns true the run
        ends after that pass."""
        names = list(self.coordinates)
        frozen = set(freeze or ())
        unknown = frozen - set(names)
        if unknown:
            raise ValueError(f"freeze names unknown coordinates: {sorted(unknown)}")
        if frozen >= set(names):
            raise ValueError("freeze covers every coordinate — nothing would train")
        model = GameModel(_warm_start_params(self.coordinates, names, initial_model))
        generator = torch.Generator().manual_seed(seed)
        scores = {n: self.coordinates[n].score(model.params[n]) for n in names}
        # per-update device values stay on the device until the run ends
        pending: List[dict] = []
        for it in range(num_iterations):
            for name in names:
                if name in frozen:
                    continue
                t0 = time.perf_counter()
                coord = self.coordinates[name]
                total = sum(scores.values())
                partial = total - scores[name]
                params, result, new_scores = coord.update_and_score(
                    model.params[name], partial, generator
                )
                event = None
                if divergence_guard:
                    obj = float(self._full_objective(
                        {**scores, name: new_scores}, {**model.params, name: params}))
                    if not np.isfinite(obj):
                        params, result, new_scores = coord.update_and_score(
                            model.params[name], partial * 0.5, generator
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
            if stop_check is not None and stop_check():
                break
        history = []
        for p in pending:
            # a SolverResult or a RandomEffectUpdateSummary
            r = p["result"]
            history.append(_history_record(
                p["iteration"], p["coordinate"], float(p["objective"]), r.reason,
                r.iterations, p["seconds"], p["validation_metric"], p["event"],
                r.cg_iterations, r.iterations if hasattr(r, "entity_ids") else None,
            ))
        return model, history

    def total_scores(self, model: GameModel) -> torch.Tensor:
        return sum(self.coordinates[n].score(model.params[n]) for n in self.coordinates)


def _warm_start_params(coords, names, initial_model):
    """Per-coordinate starting params: the warm start's table where one is
    given (a GameModel or a plain name -> params mapping), the coordinate's
    cold ``initial_params()`` otherwise. A warm table must match the cold
    start's shape exactly (warm starts re-key by entity id, never by
    position); it takes the cold start's dtype and device."""
    init = getattr(initial_model, "params", initial_model) if initial_model is not None else None
    out = {}
    for n in names:
        want = coords[n].initial_params()
        if init is None or n not in init:
            out[n] = want
            continue
        got = init[n]
        got = (got if torch.is_tensor(got) else torch.from_numpy(np.asarray(got))).to(want)
        if tuple(got.shape) != tuple(want.shape):
            raise ValueError(
                f"warm start for coordinate {n!r} has mismatched shapes — warm "
                "starts re-key by entity id (load_game_model), never by position"
            )
        out[n] = got
    return out
