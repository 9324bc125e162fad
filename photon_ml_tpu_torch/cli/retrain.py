"""The self-healing lifecycle loop as a CLI (counterpart of
``photon_ml_tpu/cli/retrain.py``).

Drift alarms (the serving DriftMonitor, or a traffic fingerprint against
the export's baseline) TRIGGER a warm-started incremental retrain that
re-exports through the manifest gate and publishes into the serving watch
root, where ``cli.serve --watch-root`` hot-reloads it behind the reload
circuit breaker. docs/LIFECYCLE.md is the walkthrough (stage diagram,
failure matrix, admission-log format).

Subcommands::

    # show what a cycle WOULD do (admission candidates, convergence-
    # health retrain/freeze split, warm-start source) without training
    python -m photon_ml_tpu_torch.cli.retrain plan \\
        --watch-root out/serving --admission-log out/admission.json \\
        --convergence-report out/game/convergence-report.json

    # one cycle: probe the trigger, retrain if it fires (or --always)
    python -m photon_ml_tpu_torch.cli.retrain once \\
        --config game.json --watch-root out/serving \\
        --current-fp out/traffic-fp --admission-log out/admission.json

    # cron-less mode: poll the trigger every --poll-s seconds
    python -m photon_ml_tpu_torch.cli.retrain watch \\
        --config game.json --watch-root out/serving \\
        --current-fp out/traffic-fp --poll-s 300

The retrain runs on the card (``--device``, default ``cuda``, which
raises without one; ``--device cpu`` runs it on the CPU).

Trigger selection: ``--always`` latches unconditionally (the cron /
exit-code integration — run ``photon-obs drift``, and on exit 1 run
``cli.retrain once --always``); ``--current-fp DIR`` compares a
live-traffic quality fingerprint against the baseline fingerprint
inside the newest export under ``--watch-root`` (``--baseline-fp``
overrides the baseline), firing on PSI alarm. The same comparison runs
again as the post-reload verify stage — a retrain that does not clear
the alarm fails its cycle and the old model keeps serving. An export's
baseline fingerprint is the one at its root or, where the root holds
none (a GAME driver's output), the one beside its model (``best/``).

The retrain itself is the GAME driver (``--config`` is a
GameDriverParams JSON): each cycle trains into the next ``vNNNN``
version directory under the watch root, warm-started entity-keyed from
the newest live export (``initial_model_dir``, its model directory; rows
carry by entity id, never by position) with healthy coordinates frozen
per the convergence report, and admitted repeat-miss entities recorded
in ``retrain-plan.json`` for provenance. The warm start is gated first
(:func:`~photon_ml_tpu_torch.lifecycle.orchestrator.load_warm_start`:
the ``retrain.warm_start`` seam and the finiteness gate). Publishing the
manifest-bearing directory IS the reload: the serving process's own
watch-root poll performs the swap with the breaker in its loop.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

from photon_ml_tpu_torch.lifecycle.orchestrator import (
    RetrainOrchestrator,
    fingerprint_drift_trigger,
    latest_version_dir,
    load_admission_candidates,
    load_warm_start,
    next_version_dir,
    select_retrain_targets,
)


def _add_plan_inputs(p: argparse.ArgumentParser) -> None:
    p.add_argument(
        "--watch-root", required=True,
        help="serving watch root: warm starts load from the newest "
        "vNNNN export here and each retrain publishes the next one "
        "(cli.serve --watch-root hot-reloads it)",
    )
    p.add_argument(
        "--admission-log", default=None,
        help="persisted repeat-miss admission log (cli.serve "
        "--admission-log); promoted entities enter the next training "
        "set and are recorded in retrain-plan.json",
    )
    p.add_argument(
        "--min-misses", type=int, default=2,
        help="admission threshold: misses required before an entity "
        "is promoted (default 2 — one miss is noise)",
    )
    p.add_argument(
        "--max-admitted-per-key", type=int, default=None,
        help="cap promoted entities per RE key (most-missed first)",
    )
    p.add_argument(
        "--convergence-report", default=None,
        help="convergence-report.json from the previous run: "
        "coordinates whose nonconverged_frac is at/above "
        "--nonconverged-threshold retrain, healthy ones freeze",
    )
    p.add_argument(
        "--nonconverged-threshold", type=float, default=0.05,
        help="nonconverged_frac at/above which a coordinate retrains "
        "(default 0.05)",
    )


def _add_trigger(p: argparse.ArgumentParser) -> None:
    p.add_argument(
        "--always", action="store_true",
        help="trigger unconditionally (the photon-obs drift exit-code "
        "/ cron integration)",
    )
    p.add_argument(
        "--current-fp", default=None,
        help="directory holding the CURRENT traffic quality "
        "fingerprint; compared against the newest export's baseline "
        "fingerprint — fires on PSI alarm, and re-checked post-reload "
        "as the verify stage",
    )
    p.add_argument(
        "--baseline-fp", default=None,
        help="override the baseline fingerprint directory (default: "
        "the newest manifest-bearing export under --watch-root)",
    )
    p.add_argument(
        "--psi-alarm", type=float, default=0.25,
        help="PSI threshold for the fingerprint trigger (default 0.25)",
    )


def _add_cycle_knobs(p: argparse.ArgumentParser) -> None:
    p.add_argument(
        "--max-stage-attempts", type=int, default=2,
        help="in-cycle retries per stage before the cycle fails "
        "(default 2)",
    )
    p.add_argument(
        "--stage-backoff-s", type=float, default=0.05,
        help="base backoff between stage retries (doubles per attempt)",
    )
    p.add_argument(
        "--cycle-backoff-s", type=float, default=1.0,
        help="base backoff after a failed cycle (doubles per "
        "consecutive failure, capped by --max-cycle-backoff-s)",
    )
    p.add_argument(
        "--max-cycle-backoff-s", type=float, default=600.0,
        help="cycle backoff ceiling (default 600)",
    )


def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="photon_ml_tpu_torch.cli.retrain",
        description="Drift-triggered continual retrain: warm-started "
        "incremental GAME retrain, manifest-gated export, hot-reload "
        "under the serving breaker (docs/LIFECYCLE.md).",
    )
    sub = p.add_subparsers(dest="cmd", required=True)

    plan = sub.add_parser(
        "plan",
        help="print what a cycle would do (JSON), without training",
    )
    _add_plan_inputs(plan)

    once = sub.add_parser("once", help="run one lifecycle cycle")
    watch = sub.add_parser(
        "watch", help="poll the trigger forever (cron-less mode)"
    )
    for q in (once, watch):
        q.add_argument(
            "--config", required=True,
            help="GameDriverParams JSON for the retrain (output_dir, "
            "initial_model_dir, and freeze_coordinates are overridden "
            "per cycle)",
        )
        _add_plan_inputs(q)
        _add_trigger(q)
        _add_cycle_knobs(q)
        q.add_argument(
            "--device", default=None,
            help="torch device of the retrain (default: cuda, which raises "
            "without a card)",
        )
    once.add_argument(
        "--force", action="store_true",
        help="ignore a latched failure backoff and cycle now",
    )
    watch.add_argument(
        "--poll-s", type=float, default=30.0,
        help="seconds between trigger probes (default 30)",
    )
    watch.add_argument(
        "--max-cycles", type=int, default=None,
        help="stop after N probes (default: run until SIGTERM)",
    )
    return p


def _make_trigger(args):
    """Resolve the trigger choice; the SAME check doubles as the
    post-reload verify stage (the retrain must clear the alarm)."""
    if args.always:
        return (lambda: {"source": "forced"}), None

    if not args.current_fp:
        raise SystemExit(
            "choose a trigger: --always, or --current-fp DIR "
            "(see docs/LIFECYCLE.md)"
        )

    def check():
        base_dir = args.baseline_fp or _baseline_dir(
            latest_version_dir(args.watch_root)
        )
        if base_dir is None:
            return None  # nothing serving yet: nothing to drift from
        return fingerprint_drift_trigger(
            base_dir, args.current_fp, psi_alarm=args.psi_alarm
        )()

    def verify():
        # post-reload the newest export IS the retrained model, so a
        # successful retrain makes this comparison quiet; returning the
        # (possibly alarming) report lets the orchestrator fail the
        # cycle when drift survived the retrain
        base_dir = args.baseline_fp or _baseline_dir(
            latest_version_dir(args.watch_root)
        )
        if base_dir is None:
            return None
        reason = fingerprint_drift_trigger(
            base_dir, args.current_fp, psi_alarm=args.psi_alarm
        )()
        return reason  # None (no alarm) passes the verify stage

    return check, verify


def _baseline_dir(export_dir):
    """The directory holding an export's baseline fingerprint: its root,
    or where the root holds none, its model directory (a GAME driver's
    export keeps the fingerprint beside its ``best/`` model)."""
    from photon_ml_tpu_torch.io.models import resolve_game_dirs
    from photon_ml_tpu_torch.obs.quality import QUALITY_FINGERPRINT

    if export_dir is None or os.path.exists(
        os.path.join(export_dir, QUALITY_FINGERPRINT)
    ):
        return export_dir
    try:
        return resolve_game_dirs(export_dir)[0]
    except FileNotFoundError:
        return export_dir


def _game_retrain_fn(config_path: str, watch_root: str, device=None):
    """The default retrain leg: one warm-started GAME driver run on
    ``device`` into the next version directory under the watch root."""

    def retrain(plan):
        from photon_ml_tpu_torch.cli.config import GameDriverParams, load_params
        from photon_ml_tpu_torch.cli.game_train import run_game_training
        from photon_ml_tpu_torch.io.models import resolve_game_dirs

        params = load_params(config_path, GameDriverParams)
        out = next_version_dir(watch_root)
        overrides = {"output_dir": out, "overwrite": True}
        if plan.warm_start_dir:
            # the retrain.warm_start seam and the finiteness gate: a
            # poisoned prior export fails the stage before any training
            load_warm_start(plan.warm_start_dir)
            # run_game_training reads coordinate directories: a
            # training-output root warm-starts from its model directory
            # (best/)
            overrides["initial_model_dir"] = resolve_game_dirs(
                plan.warm_start_dir
            )[0]
            if plan.retrain_coordinates is not None:
                # convergence-targeted incremental refit: healthy
                # coordinates carry warm-started and bit-identical
                overrides["freeze_coordinates"] = list(
                    plan.freeze_coordinates
                )
        params = dataclasses.replace(params, **overrides)
        run_game_training(params, device=device)
        # provenance: what this cycle decided and why, next to the model
        with open(os.path.join(out, "retrain-plan.json"), "w") as f:
            json.dump(plan.to_dict(), f, indent=2)
        return out

    return retrain


def _publish_reload_fn(export_dir: str):
    """Publish-is-the-reload: the serving process's own --watch-root
    poll swaps to the manifest-bearing directory with the breaker in
    its loop; this leg only confirms the publish is loadable."""
    from photon_ml_tpu_torch.io.models import verify_model_manifest

    verify_model_manifest(export_dir)
    return os.path.basename(export_dir.rstrip(os.sep))


def _build_orchestrator(args) -> RetrainOrchestrator:
    trigger, verify = _make_trigger(args)
    return RetrainOrchestrator(
        trigger,
        _game_retrain_fn(args.config, args.watch_root, args.device),
        _publish_reload_fn,
        verify_fn=verify,
        watch_root=args.watch_root,
        admission_log_path=args.admission_log,
        admission_min_misses=args.min_misses,
        admission_max_per_key=args.max_admitted_per_key,
        convergence_report_path=args.convergence_report,
        nonconverged_threshold=args.nonconverged_threshold,
        max_stage_attempts=args.max_stage_attempts,
        stage_backoff_s=args.stage_backoff_s,
        cycle_backoff_s=args.cycle_backoff_s,
        max_cycle_backoff_s=args.max_cycle_backoff_s,
    )


def _print_result(result) -> None:
    out = {
        "ok": result.ok,
        "triggered": result.triggered,
        "skipped": result.skipped,
        "failed_stage": result.stage,
        "export_dir": result.export_dir,
        "version": result.version,
        "cycle_s": round(result.cycle_s, 3),
        "next_retry_s": result.next_retry_s,
        "stages": [
            {
                "name": s.name,
                "ok": s.ok,
                "attempts": s.attempts,
                "seconds": round(s.seconds, 3),
                "error": s.error,
            }
            for s in result.stages
        ],
    }
    if result.plan is not None:
        out["plan"] = result.plan.to_dict()
    print(json.dumps(out, indent=2))


def main(argv=None) -> None:
    args = build_arg_parser().parse_args(argv)
    if args.cmd == "plan":
        admitted = load_admission_candidates(
            args.admission_log,
            min_misses=args.min_misses,
            max_per_key=args.max_admitted_per_key,
        )
        report = None
        if args.convergence_report and os.path.exists(
            args.convergence_report
        ):
            try:
                with open(args.convergence_report) as f:
                    report = json.load(f)
            except (OSError, ValueError):
                report = None
        targets = select_retrain_targets(
            report, nonconverged_threshold=args.nonconverged_threshold
        )
        print(
            json.dumps(
                {
                    "warm_start_dir": latest_version_dir(
                        args.watch_root
                    ),
                    "next_export_dir": next_version_dir(
                        args.watch_root
                    ),
                    "admitted": admitted,
                    "retrain_coordinates": targets["retrain"],
                    "freeze_coordinates": targets["freeze"],
                    "worst_entities": targets["worst_entities"],
                },
                indent=2,
            )
        )
        return

    orch = _build_orchestrator(args)
    if args.cmd == "once":
        result = orch.run_cycle(force=args.force)
        _print_result(result)
        # exit contract mirrors photon-obs drift: 0 = healthy outcome
        # (retrained, or nothing to do), 1 = the cycle failed and the
        # alarm is still latched
        sys.exit(0 if result.ok else 1)

    from photon_ml_tpu_torch.resilience import GracefulShutdown

    shutdown = GracefulShutdown()
    retrains = orch.watch(
        poll_s=args.poll_s,
        max_cycles=args.max_cycles,
        shutdown=shutdown,
    )
    last = orch.last_result
    if last is not None:
        _print_result(last)
    print(f"watch done: {retrains} successful retrain(s)", file=sys.stderr)
    sys.exit(0 if (last is None or last.ok or not last.triggered) else 1)


if __name__ == "__main__":
    main()
