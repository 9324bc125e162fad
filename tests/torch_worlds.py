"""Gloo worlds for the port's multi-rank tests, on the CPU.

``run_world(tmp_path, n, "worker_name", **inputs)`` spawns ``n`` processes
that join one gloo world through a file store under ``tmp_path``; rank r
calls ``worker_name(rank, world_size, inputs)`` from this module and its
return value (a picklable dict) comes back in rank order. The world is
joined under a time limit of its own: past it every rank is killed and the
call raises, so a deadlock fails one test instead of the suite's clock.

This module imports the port and numpy only (the spawned ranks never
import JAX); the tests hold what the ranks return against the JAX package
in the parent process.
"""

from __future__ import annotations

import os
import pickle
import time
import traceback

import numpy as np

WORLD_TIMEOUT_S = 120.0


def run_world(tmp_path, n: int, worker: str, timeout_s: float = WORLD_TIMEOUT_S, **inputs):
    import multiprocessing as mp

    root = os.path.join(str(tmp_path), f"world-{worker}-{time.monotonic_ns()}")
    os.makedirs(root)
    with open(os.path.join(root, "inputs.pkl"), "wb") as f:
        pickle.dump(inputs, f)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, args=(r, n, root, worker), daemon=True)
             for r in range(n)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout_s
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.kill()
    for p in procs:
        p.join(5.0)
    errors = []
    for r in range(n):
        path = os.path.join(root, f"error-{r}.txt")
        if os.path.exists(path):
            with open(path) as f:
                errors.append(f"rank {r}:\n{f.read()}")
    if alive:
        raise TimeoutError(f"world {worker!r} of {n} ranks did not end within "
                           f"{timeout_s:.0f} s; killed {len(alive)} ranks\n" + "\n".join(errors))
    if errors or any(p.exitcode != 0 for p in procs):
        raise RuntimeError(f"world {worker!r} failed (exit codes "
                           f"{[p.exitcode for p in procs]})\n" + "\n".join(errors))
    out = []
    for r in range(n):
        with open(os.path.join(root, f"result-{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


def _rank_main(rank: int, n: int, root: str, worker: str) -> None:
    try:
        import torch
        import torch.distributed as dist

        torch.set_num_threads(1)
        dist.init_process_group("gloo", init_method=f"file://{root}/store", world_size=n,
                                rank=rank)
        with open(os.path.join(root, "inputs.pkl"), "rb") as f:
            inputs = pickle.load(f)
        result = globals()[worker](rank, n, inputs)
        with open(os.path.join(root, f"result-{rank}.pkl"), "wb") as f:
            pickle.dump(result, f)
        dist.barrier()
        dist.destroy_process_group()
    except BaseException:  # noqa: BLE001 — reported to the parent
        with open(os.path.join(root, f"error-{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        raise


# -- helpers the workers share -------------------------------------------------


def _batch(design, y, dtype=None):
    """A batch from a dense (n, d) array or a COO tuple (rows, cols, vals,
    n, d) -> ELL."""
    import torch

    from photon_ml_tpu_torch.core.types import LabeledBatch
    from photon_ml_tpu_torch.ops import sparse as sparse_ops

    dtype = dtype or torch.float64
    if isinstance(design, tuple):
        r, c, v, n, d = design
        design = sparse_ops.from_coo(r, c, v, n, d, dtype=dtype)
    return LabeledBatch.create(design, y, dtype=dtype)


def _config(spec: dict):
    from photon_ml_tpu_torch.core.normalization import NormalizationType
    from photon_ml_tpu_torch.models.training import GLMTrainingConfig, OptimizerType
    from photon_ml_tpu_torch.ops.objective import RegularizationContext

    spec = dict(spec)
    spec.pop("initial", None)
    kw = {}
    if "normalization" in spec:
        kw["normalization"] = NormalizationType[spec.pop("normalization")]
    return GLMTrainingConfig(
        optimizer=OptimizerType[spec.pop("optimizer")],
        regularization=RegularizationContext(spec.pop("reg_type", "L2"),
                                             alpha=spec.pop("alpha", 0.0)),
        track_states=False,
        **kw, **spec,
    )


def _models(models) -> dict:
    out = {"w": [m.model.coefficients.means.numpy() for m in models],
           "iterations": [m.result.iterations for m in models],
           "cg": [m.result.cg_iterations for m in models]}
    var = [m.model.coefficients.variances for m in models]
    if all(v is not None for v in var):
        out["variances"] = [v.numpy() for v in var]
    if all(m.result.w_history is not None for m in models):
        out["w_history"] = [m.result.masked_history()[2] for m in models]
    return out


def _count_all_reduces(group_of):
    """Wrap ``torch.distributed.all_reduce`` to count the calls on each
    group; returns (counts dict, restore function)."""
    import torch.distributed as dist

    counts = {}
    real = dist.all_reduce

    def counted(t, *args, **kwargs):
        name = group_of(kwargs.get("group"))
        counts[name] = counts.get(name, 0) + 1
        return real(t, *args, **kwargs)

    dist.all_reduce = counted

    def restore():
        dist.all_reduce = real

    return counts, restore


def _logistic(l2: float):
    from photon_ml_tpu_torch.core.tasks import TaskType
    from photon_ml_tpu_torch.ops.losses import loss_for_task
    from photon_ml_tpu_torch.ops.objective import GLMObjective

    return GLMObjective(loss=loss_for_task(TaskType.LOGISTIC_REGRESSION), l2_weight=l2)


# -- the workers ----------------------------------------------------------------


def data_world(rank, n, inputs) -> dict:
    """Two ranks: ``distributed_train_glm`` on every case, the explicit
    value and gradient, the file split through ``process_local_paths`` and
    ``make_global_batch``, the host exchanges and the store heartbeats."""
    import torch

    from photon_ml_tpu_torch import parallel
    from photon_ml_tpu_torch.io.ingest import IngestSource
    from photon_ml_tpu_torch.io.vocab import FeatureVocabulary
    from photon_ml_tpu_torch.models.training import train_glm

    mesh = parallel.make_mesh()
    out = {"cases": {}}
    for name, (design, y, spec) in inputs["cases"].items():
        out["cases"][name] = _models(
            parallel.distributed_train_glm(_batch(design, y), _config(spec), mesh))

    # the explicit-collective value and gradient over this rank's rows
    x, y, w = inputs["probe"]
    shard = parallel.shard_batch(_batch(x, y), mesh)
    val, grad = parallel.shard_map_value_and_grad(_logistic(0.5), mesh)(
        torch.as_tensor(w), shard)
    out["shard_map"] = (float(val), grad.numpy())

    # (f): one part file per rank, its batch the rank's shard, train_glm
    # under the mesh, dense and ELL
    mine = parallel.process_local_paths(inputs["paths"])
    vocab = FeatureVocabulary.load(inputs["vocab"])
    local, _, _ = IngestSource(mine).labeled_batch(vocab, dtype=torch.float64, device="cpu")
    with parallel.set_mesh(mesh):
        (tm,) = train_glm(parallel.make_global_batch(local, mesh), _config(inputs["split_spec"]))
    local_sp, _, _ = IngestSource(mine).labeled_batch(vocab, sparse=True, nnz_per_row=12,
                                                       dtype=torch.float64, device="cpu")
    with parallel.set_mesh(mesh):
        (tm_sp,) = train_glm(parallel.make_global_batch(local_sp, mesh),
                             _config(inputs["split_spec"]))
    out["split"] = {"paths": mine, "rows": int(local.labels.shape[0]),
                    "w": tm.model.coefficients.means.numpy(),
                    "w_sparse": tm_sp.model.coefficients.means.numpy()}

    out["allgather"] = parallel.allgather_host(np.asarray([[rank, 10 + rank]]))
    out["strings"] = parallel.allgather_strings([f"r{rank}-{i}" for i in range(rank + 1)])
    out["rows"] = list(parallel.process_local_rows(11))

    # the store's heartbeats: each rank sees its peer's beat
    mon = parallel.HeartbeatMonitor(interval_s=0.05, miss_intervals=100.0)
    mon.poll_once()
    torch.distributed.barrier()
    out["heartbeat"] = {"transport": type(mon.transport).__name__, "ages": mon.poll_once(),
                        "lost": mon.lost_peers()}
    return out


def feature_world(rank, n, inputs) -> dict:
    """Four ranks as ('data', 'feature') = ``inputs["shape"]``:
    ``feature_sharded_train_glm`` on every case in its collective mode,
    one objective pass's all-reduces counted per group, and (at 2 x 2) the
    hierarchical reduction over ('host', 'device')."""
    import torch

    from photon_ml_tpu_torch import parallel
    from photon_ml_tpu_torch.core.types import Coefficients, LabeledBatch
    from photon_ml_tpu_torch.ops import sparse as sparse_ops
    from photon_ml_tpu_torch.parallel import mesh as mesh_mod
    from photon_ml_tpu_torch.parallel.overlap import COLLECTIVE_MODE_ENV

    n_data, n_feat = inputs["shape"]
    mesh = parallel.make_feature_mesh(n_data, n_feat)
    out = {"cases": {}, "coordinate": dict(mesh.coordinate)}
    for name, (design, y, spec, mode) in inputs["cases"].items():
        os.environ[COLLECTIVE_MODE_ENV] = mode
        kw = {}
        if spec.get("initial") is not None:
            kw["initial_coefficients"] = Coefficients(means=torch.as_tensor(spec["initial"]))
        mesh_mod.reset_collective_counts()
        models = parallel.feature_sharded_train_glm(_batch(design, y), _config(spec), mesh, **kw)
        out["cases"][name] = {**_models(models), "collectives": mesh_mod.collective_counts()}

    # (e): one fused objective pass and one Hessian-vector product on this
    # rank's block of the ELL, all-reduces counted per group
    os.environ[COLLECTIVE_MODE_ENV] = "fused"
    batch = _batch(*inputs["count_case"])
    blocked = sparse_ops.shard_columns(batch.features, n_feat)
    local = parallel.mesh.shard_rows(
        LabeledBatch(sparse_ops.feature_sharded_block(blocked, mesh.index("feature")),
                     batch.labels, batch.offsets, batch.weights, batch.mask),
        n_data, mesh.index("data"))
    obj = _logistic(0.5).with_axis("data")
    w = torch.full((blocked.d_shard,), 0.01, dtype=torch.float64)
    names = {id(mesh.group(a)): a for a in mesh.axis_names}
    counts, restore = _count_all_reduces(lambda g: names.get(id(g), "other"))
    try:
        with parallel.set_mesh(mesh):
            counts.clear()
            _, _, c = obj.value_grad_curvature(w, local)
            out["pass_all_reduces"] = dict(counts)
            counts.clear()
            obj.hessian_vector_at(c, w, local)
            out["hvp_all_reduces"] = dict(counts)
            if "reductions" in inputs:
                out["reductions"] = _feature_reductions(obj, local, blocked, mesh, counts,
                                                        inputs["reductions"])
    finally:
        restore()

    if (n_data, n_feat) == (2, 2):
        hmesh = parallel.make_host_device_mesh(2, 2)
        x, y, w = inputs["probe"]
        shard = parallel.shard_batch(_batch(x, y), hmesh)
        val, grad = parallel.hierarchical_value_and_grad(_logistic(0.5), hmesh)(
            torch.as_tensor(w), shard)
        out["hierarchical"] = (float(val), grad.numpy())
        t = torch.arange(7, dtype=torch.float64) * (rank + 1)
        out["hierarchical_psum"] = parallel.hierarchical_psum(t, mesh=hmesh).numpy()
    return out


def _feature_reductions(obj, local, blocked, mesh, counts, raw) -> dict:
    """One objective pass and one Hessian-vector product on this rank's
    block with whitening factors and shifts, with
    ``fuse_feature_reductions`` on and off: the value, this rank's blocks
    of the gradient and of H v, and the all-reduces per group (``counts``,
    the wrapped ``torch.distributed.all_reduce``)."""
    import dataclasses

    import torch

    from photon_ml_tpu_torch.core.normalization import NormalizationContext
    from photon_ml_tpu_torch.ops import sparse as sparse_ops

    n_feat, ds = mesh.axis_size("feature"), blocked.d_shard
    col_map = torch.as_tensor(sparse_ops.blocked_column_map(blocked.d_orig, n_feat))
    lo = mesh.index("feature") * ds

    def block(v, fill):
        full = torch.full((n_feat * ds,), fill, dtype=torch.float64)
        full[col_map] = torch.as_tensor(v)
        return full[lo:lo + ds].contiguous()

    factors, shifts, w, v = raw
    norm = NormalizationContext(factors=block(factors, 1.0), shifts=block(shifts, 0.0))
    out = {"lo": lo}
    for fuse in (True, False):
        o = dataclasses.replace(obj, normalization=norm, fuse_feature_reductions=fuse)
        counts.clear()
        val, grad, c = o.value_grad_curvature(block(w, 0.0), local)
        pass_counts = dict(counts)
        counts.clear()
        hv = o.hessian_vector_at(c, block(v, 0.0), local)
        out[fuse] = {"value": float(val), "grad": grad.numpy(), "hvp": hv.numpy(),
                     "pass_all_reduces": pass_counts, "hvp_all_reduces": dict(counts)}
    return out


def driver_world(rank, n, inputs) -> dict:
    """The port's GLM driver under the world (``mesh_shape``): rank 0
    writes the outputs, every rank returns its models."""
    from photon_ml_tpu_torch.cli import train as ttrain

    run = ttrain.run_glm_training(dict(inputs["params"]), device="cpu")
    return {
        "w": [tm.model.coefficients.means.numpy() for tm in run.models],
        "iterations": [tm.result.iterations for tm in run.models],
        "cg": [tm.result.cg_iterations for tm in run.models],
        "metrics": run.validation_metrics,
        "best_index": run.best_index,
    }


def traced_driver_world(rank, n, inputs) -> dict:
    """:func:`driver_world` with this rank's own ``trace_dir``
    (``<trace_root>/rank-<r>``): returns its models and its collective
    counts (``parallel.mesh.collective_counts``)."""
    from photon_ml_tpu_torch.cli import train as ttrain
    from photon_ml_tpu_torch.parallel.mesh import collective_counts

    params = {**inputs["params"],
              "trace_dir": os.path.join(inputs["trace_root"], f"rank-{rank}")}
    run = ttrain.run_glm_training(params, device="cpu")
    return {"w": [tm.model.coefficients.means.numpy() for tm in run.models],
            "counts": collective_counts()}


def _host(p):
    """A coordinate's params as numpy: a table, or {"gamma", "projection"}
    of FactoredParams."""
    if hasattr(p, "gamma"):
        return {"gamma": p.gamma.cpu().numpy(), "projection": p.projection.cpu().numpy()}
    return p.cpu().numpy()


def _game_run(run) -> dict:
    """A GAME driver run's sweep as numpy: per combo the tables (global
    entity order), the validation metric and the history's objectives."""
    out = []
    for s in run.sweep:
        out.append({
            "combo": s["combo"],
            "params": {n: _host(p) for n, p in s["model"].params.items()},
            "validation_metric": s["validation_metric"],
            "objectives": [h.objective for h in s["history"]],
            "validations": [h.validation_metric for h in s["history"]],
            "histograms": [h.convergence_histogram for h in s["history"]],
            "coordinates": [(h.iteration, h.coordinate) for h in s["history"]],
        })
    return {"sweep": out, "best_index": run.best_index, "output_dirs": run.output_dirs,
            "entity_vocabs": run.entity_vocabs}


def game_driver_world(rank, n, inputs) -> dict:
    """The port's GAME driver in the world (``entity_shards`` = n, or the
    multi-process branch without it): every rank returns its run; with
    ``count_update`` the collectives of one random-effect update are
    counted on each rank."""
    from photon_ml_tpu_torch.cli import game_train as tgame
    from photon_ml_tpu_torch.parallel import mesh as mesh_mod

    out = {}
    if "re_update" in inputs:
        out["re_update"] = _re_update(n, inputs["re_update"])
    for name, params in inputs.get("runs", {}).items():
        mesh_mod.reset_collective_counts()
        try:
            out[name] = _game_run(tgame.run_game_training(dict(params), device="cpu"))
        except ValueError as e:
            if not name.startswith("refused"):
                raise
            out[name] = str(e)
            continue
        out[name]["collectives"] = mesh_mod.collective_counts()
    return out


def _re_update(n, spec) -> dict:
    """One ``EntityShardedRandomEffectCoordinate`` update on this rank's
    block, from a start table and partial scores in global order: the
    table in global order, the rank's rescores (entity-partitioned rows),
    its penalty partial, the tracker summary and the collectives the
    update issued."""
    import torch

    from photon_ml_tpu_torch.game import coordinates as tcoords
    from photon_ml_tpu_torch.game import data as tdata
    from photon_ml_tpu_torch.models.training import OptimizerType
    from photon_ml_tpu_torch.parallel import make_entity_mesh, set_mesh
    from photon_ml_tpu_torch.parallel import mesh as mesh_mod

    e = spec["num_entities"]
    data = tdata.GameData.create(*spec["args"])
    assignment = tdata.entity_shard_assignment(e, n)
    pdata, part = tdata.entity_partition_game_data(data, "uid", assignment)
    design = tdata.build_bucketed_random_effect_design(pdata, "uid", "u", e, num_buckets=3,
                                                      dtype=torch.float64)
    cfg = tcoords.CoordinateConfig(optimizer=OptimizerType[spec["optimizer"]],
                                   **spec["config"])
    mesh = make_entity_mesh(n)
    coord = tcoords.EntityShardedRandomEffectCoordinate(
        design, torch.from_numpy(np.asarray(pdata.features["u"])), pdata.entity_ids["uid"],
        torch.from_numpy(pdata.offsets), cfg, mesh, assignment, part,
        reg_weights=spec["reg"])
    rows = slice(mesh.flat_index() * part.rows_per_shard,
                 (mesh.flat_index() + 1) * part.rows_per_shard)
    table0 = coord.local_params(assignment.table_from_global(spec["table"]))
    partial = torch.from_numpy(part.apply(spec["partial"])[rows])
    mesh_mod.reset_collective_counts()
    with set_mesh(mesh):
        table, summary, scores = coord.update_and_score(table0, partial)
    counted = mesh_mod.collective_counts()
    return {"collectives": counted, "table": coord.global_table(table).numpy(),
            "scores": scores.numpy(), "reg": float(coord.reg_term(table)),
            "row_perm": part.row_perm, "reason": summary.reason,
            "iterations": summary.iterations, "entity_ids": summary.entity_ids,
            "grad_norms": summary.grad_norms}


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_cli_world(tmp_path, n: int, params: dict, victim=None, victim_delay_s: float = 6.0,
                  timeout_s: float = WORLD_TIMEOUT_S):
    """The port's GAME CLI as a launcher starts it: ``n`` processes with
    ``RANK`` / ``WORLD_SIZE`` / ``MASTER_ADDR`` / ``MASTER_PORT`` set, each
    running ``main(["--config", ..., "--device", "cpu"])`` (the driver joins
    the gloo world itself). With ``victim`` = (rank, k): that rank goes
    silent on the heartbeat store at its k-th coordinate update and takes
    ``victim_delay_s`` longer over it (``_silence_at``), so that its peers
    find it lost at the next pass boundary: the delay must exceed the
    heartbeat's loss threshold (3 intervals) with room for beats that a
    busy machine delays. Returns every rank's exit code; a rank still
    running once the others have ended (the victim) is killed and reports
    None."""
    import json as _json
    import multiprocessing as mp

    root = os.path.join(str(tmp_path), f"cli-{time.monotonic_ns()}")
    os.makedirs(root)
    cfg = os.path.join(root, "config.json")
    with open(cfg, "w") as f:
        _json.dump(params, f)
    env = {"WORLD_SIZE": str(n), "MASTER_ADDR": "localhost", "MASTER_PORT": str(_free_port())}
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_cli_rank_main, args=(r, env, cfg, victim, victim_delay_s),
                         daemon=True)
             for r in range(n)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout_s
    others = [p for r, p in enumerate(procs) if victim is None or r != victim[0]]
    for p in others:
        p.join(max(0.0, deadline - time.monotonic()))
    codes = []
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(5.0)
            codes.append(None)
        else:
            codes.append(p.exitcode)
    if any(p.is_alive() for p in others):
        raise TimeoutError(f"CLI world of {n} did not end within {timeout_s:.0f} s")
    return codes


def _silence_at(rank: int, k: int, delay_s: float) -> None:
    """From this rank's k-th ``descent.update`` probe on, its heartbeat
    beats stop (an armed ``heartbeat.miss`` fault keyed by its index), and
    that update takes ``delay_s`` longer."""
    from photon_ml_tpu_torch.resilience import faults

    real = faults.fire
    seen = [0]

    def fire(site, key=None):
        if site == "descent.update":
            seen[0] += 1
            if seen[0] == k:
                faults.registry.arm(faults.FaultSpec("heartbeat.miss", "raise", nth=1, count=-1,
                                                     key=str(rank)))
                time.sleep(delay_s)
        return real(site, key)

    faults.fire = fire


def _cli_rank_main(rank: int, env: dict, cfg: str, victim, victim_delay_s: float) -> None:
    os.environ.update(env)
    os.environ["RANK"] = str(rank)
    os.environ["LOCAL_RANK"] = str(rank)
    import torch

    from photon_ml_tpu_torch.cli import game_train as tgame

    torch.set_num_threads(1)
    if victim is not None and victim[0] == rank:
        _silence_at(rank, victim[1], victim_delay_s)
    tgame.main(["--config", cfg, "--device", "cpu"])
