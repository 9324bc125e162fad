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
the caller's ``freeze`` included) and takes no ``fuse_passes``; with
``passes_per_dispatch`` it runs the passes in chunks with the JAX
superpass's boundaries, tolerance check and guard replay. The combo grid
(:func:`run_grid`) and the warm-started lambda path
(:func:`run_lambda_path`) run on the coordinates' grid surface
(``fused_state_for_reg``). Down-sampling
draws come from a ``torch.Generator`` seeded by ``seed``, not
``jax.random``. Checkpoints (:mod:`photon_ml_tpu_torch.io.checkpoint`)
are written at pass boundaries by a one-deep background writer, and a run
restarted over the same directory resumes from the newest valid step with
the generator's state, reproducing the uninterrupted run bit for bit on
the CPU. Each update probes the ``descent.update`` fault site (key = the
coordinate's name): a ``corrupt`` action poisons the accepted update with
NaN, the drill for the divergence guard.

Observability (JAX ``descent.py:127``, ``:839-941``, ``:1300-1700``): every
update is a ``game.update`` span and every pass a ``game.pass`` span (a
chunk of passes adds a ``game.superpass`` span around its passes), each
materialized update record feeds the ``game.*`` registry metrics, and the
pass counters ``game.passes`` / ``game.pass_ms`` are kept always (host
values only). Under a tracer an update's span ends in a device sync and
carries the cost book's attribution where the update has a pass record (a
fixed effect: its solve's design passes over its design); pass spans carry
the sum of their updates' records, and each pass boundary samples the
card's memory (``obs.sample_hbm``). With a convergence tracker installed
each update's per-entity convergence is decoded (``obs.convergence.
note_update``) when the records are read. The divergence guard's rollback
emits ``resilience.rollback`` and dumps the flight recorder
(``flight-divergence.json``) before the damped retry. The grid
(:func:`run_grid`) traces its passes and updates the same way, each
update span covering every combo's update.

On a world of ranks (an active mesh, ``parallel.mesh.set_mesh``) each rank
holds its rows, and an entity-sharded coordinate its block of the table
(``sharded_params``): the objective after each update is the sum of every
rank's partial (the loss of its rows and its blocks' penalties), taken
with ONE all-reduce over the rows' axis, plus the replicated coordinates'
penalties. ``run(..., sharded_checkpoints=True)`` writes the JAX
package's sharded checkpoints (every rank its shard, the stored tables
gathered at the boundary), restores them re-keyed by entity at any width,
and polls ``heartbeat`` at pass boundaries: on a lost peer the survivors
write a final shard set with no collective, then ``host-loss.json``, and
re-raise :class:`~photon_ml_tpu_torch.resilience.hostloss.HostLossDetected`.
With a heartbeat, every pass boundary of such a world also gathers its
block-held tables into a host copy of the training state (only cadence
steps reach the disk), so that any one survivor writes the complete final
set at any boundary.
"""

from __future__ import annotations

import dataclasses
import threading
import time
import warnings
from typing import Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch

from photon_ml_tpu_torch import obs
from photon_ml_tpu_torch.core.tasks import TaskType
from photon_ml_tpu_torch.game.factored import FactoredParams, is_factored_params
from photon_ml_tpu_torch.ops import metrics as metrics_mod
from photon_ml_tpu_torch.parallel.mesh import all_reduce, row_axis
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


def _pending_record(p: dict) -> CoordinateUpdateRecord:
    """The record of one pending update (its objective and its solver's
    result still on the device): a SolverResult, a BatchedSolverResult or
    a RandomEffectUpdateSummary."""
    r = p["result"]
    return _history_record(
        p["iteration"], p["coordinate"], float(p["objective"]), r.reason, r.iterations,
        p["seconds"], p.get("validation_metric"), p.get("event"), r.cg_iterations,
        r.iterations if hasattr(r, "entity_ids") else None,
    )


def _record_update_metrics(rec: CoordinateUpdateRecord) -> None:
    """One materialized update record into the registry (JAX
    ``descent.py:123-138``): host values, recorded untraced too."""
    reg = obs.registry()
    reg.inc("game.updates")
    reg.inc("game.solver_iterations", rec.solver_iterations)
    reg.set_gauge("game.objective", rec.objective)
    if rec.validation_metric is not None:
        reg.set_gauge("game.validation_metric", rec.validation_metric)
    if rec.seconds is not None:
        reg.observe("game.update_ms", rec.seconds * 1e3)
    if rec.event == "recovered":
        reg.inc("resilience.rollbacks")
    elif rec.event == "frozen":
        reg.inc("resilience.frozen_coordinates")


def _materialized(pending: List[dict]) -> List[CoordinateUpdateRecord]:
    """The records of ``pending`` updates, each recorded in the registry
    and, with a convergence tracker installed, its per-entity convergence
    noted (JAX ``descent.py:839-941``; the fleet decode reads the solver
    fields to the host, as the records do)."""
    track = obs.convergence.tracking_enabled()
    records = []
    for p in pending:
        rec = _pending_record(p)
        _record_update_metrics(rec)
        if track:
            r = p["result"]
            if hasattr(r, "entity_ids"):
                reasons, iterations = r.reason, r.iterations
                grad_norms, entity_ids = r.grad_norms, r.entity_ids
            else:
                reasons, iterations = to_numpy(r.reason), to_numpy(r.iterations)
                gn = to_numpy(r.grad_norms)
                idx = np.minimum(iterations, gn.shape[-1] - 1).astype(np.int64)
                grad_norms = np.take_along_axis(gn, idx[..., None], axis=-1)[..., 0]
                entity_ids = None
            obs.convergence.note_update(coordinate=p["coordinate"], iteration=p["iteration"],
                                        reasons=reasons, iterations=iterations,
                                        grad_norms=grad_norms, entity_ids=entity_ids)
        records.append(rec)
    return records


def _update_record(coord, result):
    """The cost book's record of one update's device work and its passes,
    or (None, 0): a coordinate over a design whose objective pass has a
    record (a fixed effect: ``design_passes`` of its solve over its
    design); a batched per-entity update has none."""
    batch = getattr(coord, "batch", None)
    if batch is None or not hasattr(result, "masked_history"):
        return None, 0.0
    from photon_ml_tpu_torch.models.training import solve_dtype
    from photon_ml_tpu_torch.solvers.common import design_passes

    return obs.cost.pass_record(batch.features, solve_dtype(batch)), design_passes(result)


def _attribution(pieces, seconds: float, device) -> dict:
    """The summed attribution of ``pieces`` ((record, passes) of each update
    in a window of ``seconds``) against ``device``'s peaks, as span
    arguments (JAX ``descent.py:1655-1684``); empty where no piece has a
    record."""
    pieces = [(r, k) for r, k in pieces if r is not None]
    flops = sum((r.flops or 0.0) * k for r, k in pieces)
    nbytes = sum((r.roofline_bytes or r.bytes_accessed or 0.0) * k for r, k in pieces)
    if not (flops or nbytes) or seconds <= 0:
        return {}
    dtype = pieces[-1][0].dtype
    rec = obs.CostRecord(name="game.pass", bucket="", flops=flops or None,
                         roofline_bytes=nbytes or None, dtype=dtype)
    peak_flops, peak_hbm = obs.cost.peaks_for(device, dtype)
    return {"timing": "wall", **rec.achieved(seconds, peak_flops=peak_flops,
                                              peak_hbm_bps=peak_hbm)}


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
    in flight. A background failure (the ``checkpoint.async_write`` fault
    site probes the writer thread) surfaces at the next ``submit`` or
    ``join`` (at the latest before ``run()`` returns), where the retained
    closure runs again synchronously (``resilience.ckpt_async_fallbacks``);
    only a second failure raises."""

    def __init__(self):
        self._thread = None
        self._fn = None
        self._exc: Optional[BaseException] = None

    def submit(self, write_fn) -> None:
        self.join()
        self._fn = write_fn

        def run():
            try:
                _faults.fire("checkpoint.async_write")
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
            exc, self._exc = self._exc, None
            obs.registry().inc("resilience.ckpt_async_fallbacks")
            obs.emit_event("resilience.ckpt_async_fallback", cat="resilience",
                           error=repr(exc))
            # the caller stands on a point that promised a checkpoint
            self._fn()


def _host_params(p):
    """A coordinate's parameters as host numpy (FactoredParams leaf by leaf)."""
    if is_factored_params(p):
        return FactoredParams(gamma=to_numpy(p.gamma), projection=to_numpy(p.projection))
    return to_numpy(p)


def _finite(p) -> torch.Tensor:
    """A 0-dim bool tensor: every entry of ``p`` (FactoredParams leaf by
    leaf) is finite."""
    if is_factored_params(p):
        return torch.isfinite(p.gamma).all() & torch.isfinite(p.projection).all()
    return torch.isfinite(torch.as_tensor(p)).all()


def _pass_finite(records, params) -> bool:
    """The JAX superpass's guard predicate for one pass: every update's
    objective and every coordinate's parameters finite (one host read; on a
    world, every rank's blocks, by one all-reduce)."""
    ok = [_finite(r["objective"]) for r in records] + [_finite(p) for p in params.values()]
    flag = torch.stack([t.cpu() for t in ok]).all().to(torch.float64).reshape(1)
    axis = row_axis()
    if axis is not None:
        flag = all_reduce(flag, axis, "guard", op="min")
    return bool(flag[0] > 0)


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

    def _full_objective(self, scores: Dict[str, torch.Tensor], params,
                        coords: Optional[Mapping[str, object]] = None) -> torch.Tensor:
        """Loss + every coordinate's penalty, in the JAX package's order
        (``descent.py:337-342``); ``coords``: the coordinates whose
        penalties apply (a grid combo's), by default the descent's own.
        Under a mesh with a rows' axis this rank's loss and its sharded
        coordinates' penalties are summed over the ranks by one
        all-reduce, and the replicated coordinates' penalties added once."""
        coords = self.coordinates if coords is None else coords
        names = list(self.coordinates)
        total = sum(scores[n] for n in names)
        loss = self._loss_fn(self.labels, self.base_offsets + total, self.weights)
        axis = row_axis()
        if axis is None:
            return loss + sum(_coordinate_reg_term(coords[n], params[n]) for n in names)
        sharded = [n for n in names if getattr(coords[n], "sharded_params", False)]
        part = loss + sum(_coordinate_reg_term(coords[n], params[n]) for n in sharded)
        part = all_reduce(part.reshape(1), axis, "objective")[0]
        return part + sum(_coordinate_reg_term(coords[n], params[n])
                          for n in names if n not in sharded)

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
        passes_per_dispatch: int = 1,
        convergence_tolerance: float = 0.0,
        sharded_checkpoints=False,
        entity_keys=None,
        heartbeat=None,
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
        ``preempted.json`` marker there first.

        ``passes_per_dispatch`` (K) and ``convergence_tolerance``: where
        the JAX package runs K passes per dispatch (K > 1, no
        ``validation_fn``, no frozen coordinate), the passes run in chunks
        of K, shrunk to land on the checkpoint cadence and the run's end;
        checkpoints and ``stop_check`` fall on chunk boundaries, and a
        chunk's seconds go on its first record. With a tolerance > 0 the
        run ends after the first pass whose last objective moved at most
        ``tolerance * |objective at the chunk's entry|`` from the pass
        before (the chunk's entry objective for its first pass). With
        ``divergence_guard`` a pass of a chunk whose objectives or
        parameters are not all finite is rolled back and replayed through
        the guarded per-update loop, and the next pass starts a new chunk.
        Elsewhere K and the tolerance change nothing, as in the JAX
        package.

        ``sharded_checkpoints`` (JAX ``descent.py:625-720``): True writes
        the sharded format (in a world, every rank its shard, the
        entity-sharded tables gathered into their stored order first); an
        int N writes N shards from one process. ``entity_keys``
        (coordinate -> the ordered entity keys of its table's rows; the
        stored order for an entity-sharded coordinate) labels the rows, so
        that a restore at another width or entity order re-keys by entity
        (``io.checkpoint.reindex_entity_params``). Resume takes both
        formats. ``heartbeat`` (a ``parallel.heartbeat.HeartbeatMonitor``)
        is polled at pass boundaries after the boundary's checkpoint: on a
        lost peer the run writes a final checkpoint with no collective
        (where this boundary's cadence save has not already landed), then
        ``host-loss.json``, and re-raises
        :class:`~photon_ml_tpu_torch.resilience.hostloss.HostLossDetected`
        (the drivers' exit :data:`HOST_LOSS_EXIT_CODE`). In a world with
        block-held tables (``sharded_params``: an entity-sharded table, a
        factored coordinate's gamma) every boundary gathers them into a host
        copy of the state, from which any survivor writes the complete
        final set; a gather that a lost peer stalls (the collective
        watchdog, or the backend's failure) ends the run the same way from
        the last completed copy, and the marker names that step."""
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
            restored = ckpt.params
            if ckpt.entity_keys and entity_keys:
                # the entity tables re-keyed onto this run's entity order
                # (an identical order passes through: a bit-for-bit resume)
                from photon_ml_tpu_torch.io.checkpoint import reindex_entity_params

                restored = reindex_entity_params(
                    ckpt, {n: list(k) for n, k in entity_keys.items()})
            model = GameModel(_warm_start_params(self.coordinates, names, restored))
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
            history.extend(_materialized(pending))
            pending.clear()

        writer = _AsyncCheckpointWriter()
        ekeys = ({n: [str(k) for k in v] for n, v in entity_keys.items()}
                 if entity_keys else None)
        num_shards = None if sharded_checkpoints is True else int(sharded_checkpoints or 0)
        # whether every coordinate's whole parameters are on this rank
        whole_here = row_axis() is None or not any(
            getattr(c, "sharded_params", False) for c in self.coordinates.values())

        def host_params(stored: bool):
            """Every coordinate's parameters on the host; with ``stored``
            an entity-sharded table gathered whole (a collective, in
            pieces of at most one block on the card)."""
            return {n: (self.coordinates[n].stored_table_host(model.params[n])
                        if stored and getattr(self.coordinates[n], "sharded_params", False)
                        else _host_params(model.params[n]))
                    for n in names}

        def snapshot(params_host) -> dict:
            from photon_ml_tpu_torch.io.checkpoint import jax_prng_key

            # the host snapshot of THIS boundary, taken before the next
            # pass mutates anything
            return dict(params=params_host, rng_key=jax_prng_key(seed),
                        history=[dataclasses.asdict(h) for h in history],
                        frozen=sorted(frozen),
                        generator_state=generator.get_state().numpy().copy())

        # the whole training state on the host at every pass boundary, the
        # blocks of every block-held table gathered as a cadence save
        # gathers them: with it any one survivor of a lost peer writes the
        # complete final shard set at whatever boundary the loss is found
        # (the JAX guarantee, ``descent.py:1103-1142``). Only cadence steps
        # reach the disk; the copy stays in host memory
        copy_each_boundary = (bool(sharded_checkpoints) and heartbeat is not None
                              and checkpoint_dir is not None and not whole_here)
        host_copy: List[Optional[tuple]] = [None]  # (step, snapshot)

        def boundary_copy(step: int) -> dict:
            materialize()
            snap = snapshot(host_params(stored=True))
            host_copy[0] = (step, snap)
            return snap

        def save(step: int, wait: bool = False) -> None:
            from photon_ml_tpu_torch.io.checkpoint import save_checkpoint, save_checkpoint_sharded

            materialize()
            if sharded_checkpoints:
                # every rank reaches the digest exchange together: written
                # on the training thread
                writer.join()
                save_checkpoint_sharded(checkpoint_dir, step, entity_keys=ekeys,
                                        num_shards=num_shards, **boundary_copy(step))
                return
            snap = snapshot(host_params(stored=False))
            writer.submit(lambda: save_checkpoint(checkpoint_dir, step, **snap))
            if wait:
                writer.join()

        def save_final(step: int, snap: dict) -> None:
            """The survivors' final shard set, with no collective: the
            history written is the one already read (draining the pending
            stats could need a collective)."""
            from photon_ml_tpu_torch.io.checkpoint import save_checkpoint_sharded_final

            writer.join()
            save_checkpoint_sharded_final(checkpoint_dir, step, entity_keys=ekeys,
                                          num_shards=num_shards, **snap)

        def survivors_exit(step: int, e, saved: bool):
            """On a lost peer (JAX ``descent.py:1150-1204``): the final
            checkpoint (unless this boundary's cadence save landed), the
            marker naming its step, and the exception re-raised. A final
            save that fails leaves the marker all the same."""
            from photon_ml_tpu_torch.resilience.hostloss import write_host_loss_marker

            if checkpoint_dir is not None:
                final_ok = True
                try:
                    if saved:
                        writer.join()
                    elif not sharded_checkpoints:
                        save(step, wait=True)
                    elif whole_here:
                        save_final(step, snapshot(host_params(stored=False)))
                    elif host_copy[0] is not None:
                        # the last boundary whose gather completed
                        step, snap = host_copy[0]
                        save_final(step, snap)
                    else:
                        final_ok = False
                except Exception:  # noqa: BLE001 — the marker says so
                    final_ok = False
                peers = getattr(e, "peers", None)
                if peers is None:
                    peers = heartbeat.lost_peers() if heartbeat is not None else []
                write_host_loss_marker(checkpoint_dir, step, peers,
                                       reason=getattr(e, "reason", type(e).__name__),
                                       final_checkpoint=final_ok)
            raise e

        def save_or_copy(step: int, cadence: bool) -> bool:
            """This boundary's cadence save, or else its host copy: True
            when a save landed. A lost peer that stalls the gather (the
            collective watchdog, or the backend's own failure) ends the run
            through :func:`survivors_exit` with the last completed copy."""
            if not (cadence or copy_each_boundary):
                return False
            from photon_ml_tpu_torch.resilience.hostloss import is_host_loss

            try:
                if cadence:
                    save(step)
                else:
                    boundary_copy(step)
            except Exception as e:  # noqa: BLE001 — re-raised either way
                if not (copy_each_boundary and is_host_loss(e)):
                    raise
                prior = host_copy[0]
                survivors_exit(prior[0] if prior is not None else step, e, saved=False)
            return cadence

        def host_loss_boundary(step: int, saved: bool) -> None:
            """The heartbeat poll at a pass boundary (JAX
            ``descent.py:1060-1170``)."""
            if heartbeat is None:
                return
            from photon_ml_tpu_torch.resilience.hostloss import HostLossDetected

            try:
                heartbeat.check()
            except HostLossDetected as e:
                survivors_exit(step, e, saved)

        tol = float(convergence_tolerance)
        device = self.labels.device

        def run_chunk(it: int, chunk: int):
            """Up to ``chunk`` passes from pass ``it`` as one dispatch chunk
            of the JAX package's superpass (``descent.py:405-535``) ->
            (passes done, guard tripped, converged). ``obj_in``, the full
            objective at the chunk's entry, scales the tolerance check and
            is the first pass's previous objective; the run has converged
            after a pass when ``|prev - cur| <= tol * |obj_in|``, ``cur``
            the pass's last objective. With the divergence guard a pass
            with a non-finite objective or parameters is rolled back (its
            parameters, scores, draws and records) and not counted. The
            chunk's seconds go on its first record."""
            obj_in = self._full_objective(scores, model.params)
            tol_t = torch.as_tensor(tol, dtype=obj_in.dtype, device=obj_in.device)
            first = len(pending)
            tracer = obs.get_tracer()
            ts = tracer.now_us() if tracer is not None else 0.0
            t0 = time.perf_counter()
            prev = obj_in
            done, tripped, converged = 0, False, False
            pieces = []
            for p in range(chunk):
                mark = len(pending)
                if divergence_guard:
                    kept = (dict(model.params), dict(scores), generator.get_state())
                pass_pieces = run_pass(it + p, guard=False)
                if divergence_guard and not _pass_finite(pending[mark:], model.params):
                    del pending[mark:]
                    model.params.clear()
                    model.params.update(kept[0])
                    scores.clear()
                    scores.update(kept[1])
                    generator.set_state(kept[2])
                    tripped = True
                    break
                done += 1
                pieces += pass_pieces
                cur = pending[-1]["objective"]
                if tol > 0 and bool(torch.abs(prev - cur) <= tol_t * torch.abs(obj_in)):
                    converged = True
                    break
                prev = cur
            seconds = time.perf_counter() - t0
            for i, rec in enumerate(pending[first:]):
                rec["seconds"] = seconds if i == 0 else None
            if tracer is not None:
                tracer.add_span("game.superpass", ts, seconds * 1e6, cat="game", args={
                    "iteration": it, "chunk": chunk, "passes": done,
                    "coordinates": len(names), "guard": tripped, "converged": converged,
                    **_attribution(pieces, seconds, device)})
            reg = obs.registry()
            reg.inc("game.dispatches")
            reg.inc("game.superpasses")
            reg.inc("game.passes", done)
            if done:
                reg.observe("game.pass_ms", seconds * 1e3 / done)
            if tripped:
                obs.emit_event("resilience.superpass_guard", cat="resilience",
                               iteration=it + done, passes_done=done)
            return done, tripped, converged

        def run_pass(it: int, guard: bool) -> list:
            """One pass of updates, each against the others' scores, its
            record pending, each a ``game.update`` span and the pass a
            ``game.pass`` span; ``guard``: the divergence guard's rollback,
            damped retry and freeze after each update. Returns the pass's
            (cost record, passes) pieces (traced runs only)."""
            tracer = obs.get_tracer()
            pass_ts = tracer.now_us() if tracer is not None else 0.0
            pass_t0 = time.perf_counter()
            pieces = []
            for name in names:
                if name in frozen:
                    continue
                with obs.span("game.update", cat="game", coordinate=name,
                              iteration=it) as upd_span:
                    piece = update(it, name, guard, upd_span, tracer)
                if piece is not None:
                    pieces.append(piece)
            pass_seconds = time.perf_counter() - pass_t0
            if tracer is not None:
                tracer.add_span("game.pass", pass_ts, pass_seconds * 1e6, cat="game", args={
                    "iteration": it, "coordinates": len(names),
                    **_attribution(pieces, pass_seconds, device)})
                # the card's memory at the pass boundary (nothing off CUDA)
                obs.sample_hbm(device=device)
            return pieces

        def update(it: int, name: str, guard: bool, upd_span, tracer):
            """One coordinate update of pass ``it`` inside its span; under a
            tracer the span ends in a device sync and carries the update's
            attribution, and the update's (record, passes) is returned."""
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
            if guard:
                obj = float(self._full_objective(
                    {**scores, name: new_scores}, {**model.params, name: params}))
                if not np.isfinite(obj):
                    obs.emit_event("resilience.rollback", cat="resilience",
                                   coordinate=name, iteration=it)
                    # the spans and metrics leading INTO the divergence
                    # are the post-mortem: dumped before the retry
                    obs.flight_dump("divergence")
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
                        obs.emit_event("resilience.freeze", cat="resilience",
                                       coordinate=name, iteration=it)
                    upd_span.set(event=event)
            model.params[name] = params
            scores[name] = new_scores
            obj = self._full_objective(scores, model.params)
            piece = None
            if tracer is not None:
                upd_span.sync(obj)
                piece = _update_record(coord, result)
                upd_span.set(**_attribution([piece], time.perf_counter() - t0, device))
            seconds = time.perf_counter() - t0
            vmetric = float(validation_fn(model)) if validation_fn is not None else None
            pending.append({
                "iteration": it, "coordinate": name, "objective": obj,
                "seconds": seconds, "validation_metric": vmetric, "event": event,
                "result": result,
            })
            return piece

        def boundary(step: int, saved: bool) -> bool:
            """The heartbeat and preemption polls at a pass or chunk
            boundary: True when the run stops there, after a final
            checkpoint and the marker."""
            host_loss_boundary(step, saved)
            if stop_check is None or not stop_check():
                return False
            if checkpoint_dir is not None:
                # the marker promises a durable checkpoint at this step
                if saved:
                    writer.join()
                else:
                    save(step, wait=True)
                write_preempted_marker(checkpoint_dir, step,
                                       getattr(stop_check, "signum", None))
            return True

        # chunks of K passes where the JAX package runs its superpass
        # (``descent.py:982-989``): K > 1, no validation, no frozen set
        k_dispatch = max(1, int(passes_per_dispatch))
        use_chunks = k_dispatch > 1 and validation_fn is None
        stopped = False
        it = start_it
        # after a chunk's guard trips, the failing pass replays through the
        # guarded per-update loop before the next chunk starts
        force_plain = False
        while it < num_iterations:
            if use_chunks and not frozen and not force_plain:
                chunk = min(k_dispatch, num_iterations - it)
                if checkpoint_dir is not None:
                    # land on the checkpoint cadence
                    chunk = min(chunk, checkpoint_every - ((it - start_it) % checkpoint_every))
                done, guard_tripped, converged = run_chunk(it, chunk)
                it += done
                force_plain = guard_tripped
                saved = False
                if done:
                    saved = save_or_copy(it, checkpoint_dir is not None and (
                        it - start_it) % checkpoint_every == 0)
                if boundary(it, saved):
                    stopped = True
                    break
                if converged:
                    obs.emit_event("game.converged", cat="game", iteration=it,
                                   tolerance=float(convergence_tolerance))
                    break
                continue
            pass_t0 = time.perf_counter()
            run_pass(it, guard=divergence_guard)
            reg = obs.registry()
            reg.inc("game.passes")
            reg.observe("game.pass_ms", (time.perf_counter() - pass_t0) * 1e3)
            force_plain = False
            saved = save_or_copy(it + 1, checkpoint_dir is not None
                                 and (it + 1 - start_it) % checkpoint_every == 0)
            if boundary(it + 1, saved):
                stopped = True
                break
            it += 1
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


# the same-object audit's threshold: a piece of a coordinate's grid state
# that is value-equal across combos but a fresh object each call is held
# once per combo; from this size on that costs real memory
_GRID_STACK_WARN_BYTES = 1 << 20


def _state_leaves(state, path: str):
    """(path, tensor) of every tensor in a coordinate's grid state
    (tuples, lists and dataclasses such as a bucket's design walked
    through), in a fixed order; None pieces are skipped."""
    if torch.is_tensor(state):
        yield path, state
    elif isinstance(state, (tuple, list)):
        for i, x in enumerate(state):
            yield from _state_leaves(x, f"{path}[{i}]")
    elif dataclasses.is_dataclass(state) and not isinstance(state, type):
        for f in dataclasses.fields(state):
            yield from _state_leaves(getattr(state, f.name), f"{path}.{f.name}")


def _audit_grid_states(per_combo: List[dict], names) -> None:
    """The same-object contract of ``fused_state_for_reg`` (JAX
    ``descent.py:1873-1910``): a piece that is not the same object for
    every combo is held once per combo. Where that costs at least
    ``_GRID_STACK_WARN_BYTES`` and the first two combos' pieces are equal
    in value, warn: the coordinate should return the same object."""
    n_combo = len(per_combo)
    for n in names:
        columns = zip(*(list(_state_leaves(st[n], f"[{n!r}]")) for st in per_combo))
        for column in columns:
            leaves = [t for _, t in column]
            if all(t is leaves[0] for t in leaves):
                continue
            nbytes = sum(t.numel() * t.element_size() for t in leaves)
            if (nbytes >= _GRID_STACK_WARN_BYTES and leaves[0].shape == leaves[1].shape
                    and bool(torch.equal(leaves[0], leaves[1].to(leaves[0].device)))):
                warnings.warn(
                    f"run_grid: leaf {column[0][0]} ({nbytes / 1e6:.1f} MB stacked) is "
                    "value-identical across combos but was returned as a fresh object by "
                    "fused_state_for_reg, so it is stacked x{} instead of broadcast — "
                    "return the SAME array object for combo-invariant leaves".format(n_combo),
                    RuntimeWarning,
                    stacklevel=3,
                )


def _grid_coordinates(cd: CoordinateDescent, what: str):
    """The descent's coordinates, each refused unless it has the grid
    surface (JAX ``descent.py:1850-1855``)."""
    for c in cd.coordinates.values():
        if not hasattr(c, "fused_state_for_reg"):
            raise ValueError(
                f"{type(c).__name__} does not support {what} "
                "(no fused_state_for_reg); run combos sequentially"
            )
    return cd.coordinates


def run_grid(cd: CoordinateDescent, combos: Sequence[Mapping[str, float]],
             num_iterations: int, seed: int = 0, initial_model=None, stop_check=None):
    """Train every reg-weight combo at once (JAX ``descent.py:1805``; the
    reference trains grid entries independently,
    ``cli/game/training/Driver.scala:317-384``): pass by pass and
    coordinate by coordinate, all C combos take the update together, combo
    by combo, each through its coordinate's ``update_and_score`` with the
    solver and kernels of ``cd.run``, so each combo launches what
    ``cd.run`` launches for it. (The JAX package vmaps the combos; a pass
    that reads a design once for all combos is ROADMAP queue B's.)
    Every combo sees the draws of ``cd.run(seed=seed)``: one draw per
    update (a fixed effect's down-sampling), shared by the combos.

    Each combo's result is ``cd.run(num_iterations, seed=seed)`` with its
    weights; ``initial_model`` warm-starts every combo from the same
    tables (``_warm_start_params``, with its shape refusals). The pieces of
    each coordinate's state that do not depend on the weight are read
    from the same tensor objects for every combo, never copied; a fresh
    but equal piece of 1 MB or more warns (``_audit_grid_states``).

    ``stop_check``, a zero-arg callable (not in the JAX signature, whose
    grid is not preemptible), is polled after each pass: when it turns
    true the grid ends there, with every combo at the same pass.

    Returns ``(models, history)``: ``models[c]`` combo c's
    :class:`GameModel`, ``history[c]`` its records, with each pass's
    seconds on its first record and no validation metric. The objectives
    and trackers are read to the host once, at the end."""
    names = list(cd.coordinates)
    combos = list(combos)
    n_combo = len(combos)
    if n_combo < 2:
        raise ValueError(
            f"run_grid needs >= 2 combos (got {n_combo}); run cd.run() "
            "for a single configuration"
        )
    coords = _grid_coordinates(cd, "grid vmapping")
    per_combo = [{n: coords[n].fused_state_for_reg(cb[n]) for n in names} for cb in combos]
    _audit_grid_states(per_combo, names)
    lives = [{n: coords[n].with_fused_state(st[n]) for n in names} for st in per_combo]
    starts = _warm_start_params(coords, names, initial_model)
    params = [dict(starts) for _ in combos]
    # each combo scores its start, as its cd.run does
    scores = [{n: coords[n].score(starts[n]) for n in names} for _ in combos]
    generator = torch.Generator().manual_seed(seed)
    pending: List[List[dict]] = [[] for _ in combos]
    device = cd.labels.device
    for it in range(num_iterations):
        tracer = obs.get_tracer()
        pass_ts = tracer.now_us() if tracer is not None else 0.0
        t0 = time.perf_counter()
        first = len(pending[0])
        pass_pieces = []
        for name in names:
            drawn = generator.get_state()
            # one span per coordinate covers every combo's update
            with obs.span("game.update", cat="game", coordinate=name, iteration=it,
                          combos=n_combo) as upd_span:
                u0 = time.perf_counter()
                pieces = []
                for c, live in enumerate(lives):
                    # every combo takes the update's one draw
                    generator.set_state(drawn)
                    partial = sum(scores[c].values()) - scores[c][name]
                    p, r, sc = live[name].update_and_score(params[c][name], partial, generator)
                    params[c][name] = p
                    scores[c][name] = sc
                    pending[c].append({
                        "iteration": it, "coordinate": name, "seconds": None,
                        "objective": cd._full_objective(scores[c], params[c], live),
                        "result": r,
                    })
                    if tracer is not None:
                        pieces.append(_update_record(live[name], r))
                if tracer is not None:
                    upd_span.sync(pending[-1][-1]["objective"])
                    upd_span.set(**_attribution(pieces, time.perf_counter() - u0, device))
                    pass_pieces += pieces
        seconds = time.perf_counter() - t0
        for pc in pending:
            pc[first]["seconds"] = seconds
        if tracer is not None:
            tracer.add_span("game.pass", pass_ts, seconds * 1e6, cat="game", args={
                "iteration": it, "coordinates": len(names), "combos": n_combo,
                **_attribution(pass_pieces, seconds, device)})
            obs.sample_hbm(device=device)
        reg = obs.registry()
        reg.inc("game.passes")
        reg.observe("game.pass_ms", seconds * 1e3)
        if stop_check is not None and stop_check():
            break
    models = [GameModel(dict(p)) for p in params]
    return models, [_materialized(pc) for pc in pending]


def run_lambda_path(cd: CoordinateDescent, combos: Sequence[Mapping[str, float]],
                    num_iterations: int, seed: int = 0, initial_model=None,
                    scan: bool = True):
    """The warm-started lambda path over reg-weight combos (JAX
    ``descent.py:2031``): the combos run in order, each as ``cd.run`` over
    the coordinates on its weights (``with_fused_state``), combo c + 1
    starting from combo c's model (order them strongest lambda first), and
    the first from ``initial_model`` when one is given. Every combo
    restarts the draws from ``seed``; only the warm start carries forward,
    and each combo rescores its start (the JAX package carries the scores
    forward: the same values). ``scan`` is accepted for the JAX signature:
    both values run the same per-update loop (where the JAX package runs a
    combo's passes as one ``lax.scan`` or one dispatch per update, the same
    math). Returns ``(models, history)`` shaped like :func:`run_grid`, each
    combo's seconds on its first record."""
    names = list(cd.coordinates)
    combos = list(combos)
    if not combos:
        raise ValueError("run_lambda_path needs >= 1 combo")
    coords = _grid_coordinates(cd, "the lambda path")
    models: List[GameModel] = []
    history: List[List[CoordinateUpdateRecord]] = []
    model = initial_model
    for cb in combos:
        live = {n: coords[n].with_fused_state(coords[n].fused_state_for_reg(cb[n]))
                for n in names}
        t0 = time.perf_counter()
        model, records = CoordinateDescent(live, cd.labels, cd.base_offsets, cd.weights,
                                           cd.task).run(num_iterations, initial_model=model,
                                                        seed=seed)
        seconds = time.perf_counter() - t0
        models.append(model)
        history.append([dataclasses.replace(h, seconds=seconds if i == 0 else None)
                        for i, h in enumerate(records)])
    return models, history


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
        if hasattr(coords[n], "local_params"):
            # an entity-sharded coordinate starts from its block of a
            # stored table
            got = coords[n].local_params(got)
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
