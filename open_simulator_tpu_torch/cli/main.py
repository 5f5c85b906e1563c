"""CLI of the port: ``python -m open_simulator_tpu_torch.cli apply -f <config>``,
``... explain -f <config>``, ``... replay --cluster-config <dir> --trace
<file>`` (``--frontier <specs>``: the cost frontier), ``... tune
--cluster-config <dir>`` and ``... campaign {run --fleet <dir>, report
[<id>], audit <dump>}``.

The reference's ``simon-tpu apply``, ``explain``, ``replay``, ``tune`` and
``campaign`` (``open_simulator_tpu/cli/main.py``) on the port's engine:
the same flags for what is ported, the same report on stdout and the same
exit codes (apply: 0 when a plan is found, 1 for FAILED; explain, replay
and tune: 0; campaign run: 0 while a cluster completed, audit: 0 when it
passes; all: 1 for any error, with ``error: <message>`` on stderr), plus
``--device`` (default: the card; ``cpu`` runs the plain torch step). The
reference's other options are accepted and refused with the ROADMAP item
that ports them. ``--no-waves`` turns wave scheduling off for the process
(``SIMON_WAVES=0``), as in the reference.
"""

from __future__ import annotations

import argparse
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="open_simulator_tpu_torch.cli",
        description="Kubernetes cluster-capacity simulator on PyTorch and CUDA",
    )
    sub = p.add_subparsers(dest="command")
    ap = sub.add_parser("apply", help="run a capacity-planning simulation")
    ap.add_argument("-f", "--simon-config", required=True, help="simon/v1alpha1 Config file")
    ap.add_argument("--output-file", default="", help="redirect the report to a file")
    ap.add_argument("--use-greed", action="store_true",
                    help="sort app pods by dominant share (big rocks first)")
    ap.add_argument("--extended-resources", default="", help="comma list, e.g. gpu")
    ap.add_argument("--max-new-nodes", type=int, default=128,
                    help="sweep upper bound for added nodes")
    ap.add_argument("--sweep-mode", choices=("bisect", "exhaustive"), default="bisect",
                    help="bisect (default): galloping bisection over the monotone "
                         "node-count axis, a few fixed-width lane rounds; "
                         "exhaustive: one lane per candidate count")
    ap.add_argument("--device", default=None,
                    help="torch device to run on (default: the CUDA card; 'cpu' "
                         "runs the plain torch step)")
    # the reference's options that are not ported yet: refused with the
    # ROADMAP item that ports them
    ap.add_argument("-i", "--interactive", action="store_true",
                    help="not ported yet (ROADMAP queue 1, item 15)")
    ap.add_argument("--default-scheduler-config", default="",
                    help="KubeSchedulerConfiguration file: Score plugin enable/disable/"
                         "weights and NodeResourcesFit scoringStrategy are applied; "
                         "Filter enable/disable is ignored with a warning")
    ap.add_argument("--compile-cache-dir", default="",
                    help="not ported yet (ROADMAP queue 1, item 8)")
    ap.add_argument("--resume", default="", metavar="SWEEP_ID",
                    help="not ported yet (ROADMAP queue 1, item 8)")
    ap.add_argument("--trace-out", default="",
                    help="not ported yet (ROADMAP queue 1, item 11)")
    ap.add_argument("--ledger-dir", default="",
                    help="not ported yet (ROADMAP queue 1, item 11)")
    ap.add_argument("--no-waves", action="store_true",
                    help="disable wave scheduling (SIMON_WAVES=0 equivalent; results are "
                         "bit-identical either way)")

    ex = sub.add_parser(
        "explain",
        help="per-pod scheduling explanation: why this node / why unschedulable",
        description="Run one simulation with per-op failure accounting and "
                    "top-k score recording on, then report per pod: the "
                    "chosen node with each score plugin's weighted "
                    "contribution at the top-k candidates, or the "
                    "per-filter-op node elimination counts ('0/N nodes "
                    "are available: ...') with the first failing op.")
    ex.add_argument("-f", "--simon-config", required=True, help="simon/v1alpha1 Config file")
    ex.add_argument("--pod", action="append", default=[], metavar="NS/NAME",
                    help="only explain this pod key (repeatable; default all)")
    ex.add_argument("--top-k", type=int, default=3,
                    help="candidate nodes to report per pod")
    ex.add_argument("--use-greed", action="store_true",
                    help="sort app pods by dominant share, like apply")
    ex.add_argument("--json", action="store_true", help="emit the report as JSON")
    ex.add_argument("--output-file", default="")
    ex.add_argument("--device", default=None,
                    help="torch device to run on (default: the CUDA card; 'cpu' "
                         "runs the plain torch step)")
    ex.add_argument("--default-scheduler-config", default="",
                    help="KubeSchedulerConfiguration file (same semantics as apply)")
    ex.add_argument("--trace-out", default="",
                    help="not ported yet (ROADMAP queue 1, item 11)")
    ex.add_argument("--no-waves", action="store_true",
                    help="disable wave scheduling for this run (SIMON_WAVES=0 equivalent)")

    rp = sub.add_parser(
        "replay",
        help="time-stepped trace replay: arrivals, departures, chaos, autoscaler loops",
        description="Execute a ReplayTrace (ordered timed events: pod-batch "
                    "arrivals, departures, node add/remove, the chaos fault "
                    "kinds) as a closed loop over the scan — one encode for the "
                    "whole trajectory, pods pinned where they landed, pending "
                    "pods retried every step. --controller registers autoscaler "
                    "/ descheduler loops that run between events until "
                    "convergence. With a checkpoint directory "
                    "(SIMON_CHECKPOINT_DIR, or SIMON_LEDGER_DIR/checkpoints) "
                    "every settled step is journaled and --resume continues a "
                    "killed trajectory to a bit-identical digest.")
    rp.add_argument("--cluster-config", required=True, help="cluster YAML dir (the t=0 state)")
    rp.add_argument("--trace", required=True, metavar="FILE",
                    help="trace file (YAML or JSON): {events: [{t, kind, ...}], "
                         "max_new_nodes, node_template, zone_key}")
    rp.add_argument("--controller", action="append", default=[], metavar="NAME[:k=v,...]",
                    help="register a step controller, repeatable — autoscaler[:scale_step=N,"
                         "idle_steps=N,up_cooldown=N,down_cooldown=N,max_nodes=N] or "
                         "descheduler[:period=N]")
    rp.add_argument("--resume", default="", metavar="REPLAY_ID",
                    help="resume a checkpointed replay after a crash: replay-id prefix "
                         "(or 'last'); settled steps replay from the journal and the "
                         "trajectory digest is identical to an uninterrupted run")
    rp.add_argument("--no-fast-path", action="store_true",
                    help="disable the carry-threaded arrival fast path (results are "
                         "bit-identical either way — this is a perf/debug switch)")
    rp.add_argument("--no-waves", action="store_true",
                    help="disable wave scheduling (SIMON_WAVES=0 equivalent)")
    rp.add_argument("--json", action="store_true", help="emit the report as JSON")
    rp.add_argument("--output-file", default="")
    rp.add_argument("--device", default=None,
                    help="torch device to run on (default: the CUDA card; 'cpu' "
                         "runs the plain torch step)")
    rp.add_argument("--frontier", default="", metavar="SPECS",
                    help="node-spec mix file ({specs: [{name, cost, max_count, spec_yaml}], "
                         "max_total}): report the Pareto set over every mix instead of "
                         "replaying the timeline")
    rp.add_argument("--lane-width", type=int, default=8,
                    help="frontier mixes swept per launch")
    rp.add_argument("--max-mixes", type=int, default=2048,
                    help="frontier mix-grid guardrail")
    rp.add_argument("--compile-cache-dir", default="",
                    help="not ported yet (ROADMAP queue 1, item 8)")
    rp.add_argument("--ledger-dir", default="",
                    help="not ported yet (ROADMAP queue 1, item 11)")
    rp.add_argument("--trace-out", default="",
                    help="not ported yet (ROADMAP queue 1, item 11)")

    tn = sub.add_parser(
        "tune",
        help="scheduler-policy search on the lane axis: Pareto set over score-plugin "
             "weight vectors",
        description="Search the Score-plugin weight space (the "
                    "KubeSchedulerConfiguration v1beta2 weight table) over ONE "
                    "workload, each variant a lane of one launch with its own weight "
                    "row. Each variant is scored on (unplaced, cost, disruption), all "
                    "minimized, disruption measured against the baseline vector's "
                    "placements, and the report is the Pareto set under the "
                    "frontier's dominance rule.")
    tn.add_argument("--cluster-config", required=True,
                    help="cluster YAML dir (the workload's initial state)")
    tn.add_argument("--apps", default="", metavar="DIR",
                    help="optional workload apps (manifest dir) deployed on top of the "
                         "cluster's own pods")
    tn.add_argument("--mode", choices=("grid", "cem"), default="grid",
                    help="grid: coordinate grid around the baseline (deterministic, "
                         "exhaustive over its grid); cem: cross-entropy-style "
                         "mutation/selection rounds (seeded, deterministic)")
    tn.add_argument("--variants", type=int, default=8, help="policy lanes per launch (W)")
    tn.add_argument("--rounds", type=int, default=0,
                    help="cem generations (0 = 4); for grid, a cap on the rounds (0 = the "
                         "whole grid; a capped grid reports grid_truncated)")
    tn.add_argument("--seed", type=int, default=0, help="cem sampling seed")
    tn.add_argument("--grid-values", default="", metavar="V,V,...",
                    help="comma list of grid weight values (default 0,0.5,1,2,4)")
    tn.add_argument("--elite-frac", type=float, default=0.25, help="cem selection fraction")
    tn.add_argument("--sigma", type=float, default=0.75, help="cem initial mutation scale")
    tn.add_argument("--max-weight", type=float, default=8.0,
                    help="weight-space clip ceiling")
    tn.add_argument("--scheduler-config", default="", metavar="FILE",
                    help="KubeSchedulerConfiguration file: its score weights become the "
                         "search center and the disruption baseline; filter disables "
                         "apply as static engine gates")
    tn.add_argument("--json", action="store_true",
                    help="emit the full report (points, Pareto set) as JSON")
    tn.add_argument("--output-file", default="")
    tn.add_argument("--device", default=None,
                    help="torch device to run on (default: the CUDA card; 'cpu' "
                         "runs the plain torch step)")
    tn.add_argument("--no-waves", action="store_true",
                    help="accepted for symmetry: tune rounds run the scan (no wave plan)")
    tn.add_argument("--compile-cache-dir", default="",
                    help="not ported yet (ROADMAP queue 1, item 8)")
    tn.add_argument("--ledger-dir", default="",
                    help="not ported yet (ROADMAP queue 1, item 11)")
    tn.add_argument("--trace-out", default="",
                    help="not ported yet (ROADMAP queue 1, item 11)")

    cp = sub.add_parser(
        "campaign",
        help="fault-isolated fleet campaigns over recorded cluster dumps",
        description="Stream a fleet (directory or manifest of recorded API dumps) through "
                    "the engine with per-cluster fault isolation: a malformed dump, a "
                    "crashed encode, or an audit violation quarantines THAT cluster with a "
                    "structured record while the campaign continues; same-bucket clusters "
                    "run as the lanes of one launch. One fsynced journal line per settled "
                    "cluster makes `run --resume <id|last>` after a kill produce a fleet "
                    "report digest bit-identical to an uninterrupted run.")
    cp_sub = cp.add_subparsers(dest="campaign_command")
    cp_run = cp_sub.add_parser("run", help="run (or resume) a campaign over a fleet of dumps")
    cp_run.add_argument("--fleet", required=True, metavar="DIR|MANIFEST",
                        help="directory of recorded dumps (*.json/*.yaml, subdirs = manifest "
                             "dirs) or a manifest file listing cluster paths")
    cp_run.add_argument("--apps", default="", metavar="DIR",
                        help="optional scenario apps (manifest dir) deployed to EVERY cluster")
    cp_run.add_argument("--scenario", default="replay",
                        help="scenario-set name stamped on journal records (default: replay)")
    cp_run.add_argument("--max-clusters", type=int, default=0,
                        help="only the first N clusters (0 = whole fleet)")
    cp_run.add_argument("--retries", type=int, default=2,
                        help="transient-failure retries per cluster (full-jitter backoff)")
    cp_run.add_argument("--resume", default="", metavar="CAMPAIGN_ID",
                        help="resume a checkpointed campaign after a crash: campaign-id "
                             "prefix (or 'last'); settled clusters replay from the journal "
                             "and the report digest matches an uninterrupted run")
    cp_run.add_argument("--no-audit", action="store_true",
                        help="skip the per-cluster placement invariant audit "
                             "(campaign/audit.py) — not recommended")
    cp_run.add_argument("--ledger-dir", default="",
                        help="not ported yet (ROADMAP queue 1, item 11)")
    cp_run.add_argument("--compile-cache-dir", default="",
                        help="not ported yet (ROADMAP queue 1, item 8)")
    cp_run.add_argument("--no-waves", action="store_true",
                        help="disable wave scheduling for every cluster (SIMON_WAVES=0 "
                             "equivalent)")
    cp_run.add_argument("--json", action="store_true", help="emit the fleet report as JSON")
    cp_run.add_argument("--output-file", default="")
    cp_run.add_argument("--device", default=None,
                        help="torch device to run on (default: the CUDA card; 'cpu' runs the "
                             "plain torch step)")
    cp_rep = cp_sub.add_parser("report", help="rebuild a fleet report from a campaign journal")
    cp_rep.add_argument("campaign", metavar="CAMPAIGN", nargs="?", default="last",
                        help="campaign-id prefix or 'last' (default)")
    cp_rep.add_argument("--ledger-dir", default="",
                        help="not ported yet (ROADMAP queue 1, item 11); the journal is read "
                             "from SIMON_CHECKPOINT_DIR")
    cp_rep.add_argument("--json", action="store_true", help="emit the report as JSON")
    cp_rep.add_argument("--output-file", default="")
    cp_aud = cp_sub.add_parser("audit",
                               help="standalone placement invariant audit of one cluster")
    cp_aud.add_argument("cluster", metavar="DUMP|DIR",
                        help="recorded API dump file or manifest dir")
    cp_aud.add_argument("--json", action="store_true", help="emit the audit report as JSON")
    cp_aud.add_argument("--no-waves", action="store_true",
                        help="disable wave scheduling for the audited run")
    cp_aud.add_argument("--output-file", default="")
    cp_aud.add_argument("--device", default=None,
                        help="torch device to run on (default: the CUDA card; 'cpu' runs the "
                             "plain torch step)")
    return p


def _emit(text: str, output_file: str) -> None:
    if output_file:
        with open(output_file, "w", encoding="utf-8") as f:
            f.write(text + "\n")
    else:
        print(text)


def _load_trace_file(path: str) -> dict:
    """A trace file (YAML or JSON): malformed YAML is a structured E_SPEC."""
    import yaml

    from open_simulator_tpu_torch.errors import SimulationError

    try:
        with open(path, "r", encoding="utf-8") as f:
            doc = yaml.safe_load(f)
    except yaml.YAMLError as e:
        raise SimulationError(f"{path} is not valid YAML/JSON: {e}", code="E_SPEC",
                              ref="replay_trace", field="trace") from None
    if not isinstance(doc, dict):
        raise SimulationError(f"{path} must hold a mapping, got {type(doc).__name__}",
                              code="E_SPEC", ref="replay_trace", field="trace")
    return doc


def _replay(args) -> int:
    """``replay``: the reference's report, text or JSON; exit 1 with
    ``error: <message>`` for any error."""
    import json

    try:
        if args.compile_cache_dir:
            raise NotImplementedError(
                "--compile-cache-dir is not ported yet (ROADMAP queue 1, item 8)")
        if args.ledger_dir or args.trace_out:
            raise NotImplementedError(
                "--ledger-dir and --trace-out are not ported yet (ROADMAP queue 1, item 11)")
        from open_simulator_tpu_torch.k8s.loader import load_resources_from_directory
        from open_simulator_tpu_torch.replay import (
            ReplayOptions,
            ReplayTrace,
            capacity_frontier,
            controller_from_arg,
            format_frontier,
            format_report,
            parse_specs,
            run_replay,
        )

        cluster = load_resources_from_directory(args.cluster_config)
        trace = ReplayTrace.from_dict(_load_trace_file(args.trace))
        trace.validate()
        if args.frontier:
            # the static mix question over the trace's full workload
            # (every arrival batch as an app)
            from open_simulator_tpu_torch.replay.engine import arrival_apps

            spec_doc = _load_trace_file(args.frontier)
            result = capacity_frontier(
                cluster, arrival_apps(trace), parse_specs(spec_doc.get("specs")),
                max_total=spec_doc.get("max_total"), lane_width=args.lane_width,
                max_mixes=args.max_mixes, device=args.device)
            _emit(json.dumps(result, indent=2) if args.json else format_frontier(result),
                  args.output_file)
            return 0
        controllers = [controller_from_arg(a) for a in args.controller]
        report = run_replay(cluster, trace, ReplayOptions(
            controllers=controllers, resume=args.resume, fast_path=not args.no_fast_path),
            device=args.device)
        _emit(json.dumps(report, indent=2) if args.json else format_report(report),
              args.output_file)
        return 0
    except Exception as e:  # trace, cluster, resume and unported-path errors -> exit 1
        print(f"error: {e}", file=sys.stderr)
        return 1


def _tune(args) -> int:
    """``tune``: the reference's report, text or JSON; every malformed knob
    or scheduler config is an ``error:`` exit 1, never a traceback."""
    import json

    body = {"mode": args.mode, "variants": args.variants, "rounds": args.rounds,
            "seed": args.seed, "elite_frac": args.elite_frac, "sigma": args.sigma,
            "max_weight": args.max_weight}
    if args.grid_values:
        body["grid_values"] = [v.strip() for v in args.grid_values.split(",") if v.strip()]
    try:
        if args.compile_cache_dir:
            raise NotImplementedError(
                "--compile-cache-dir is not ported yet (ROADMAP queue 1, item 8)")
        if args.ledger_dir or args.trace_out:
            raise NotImplementedError(
                "--ledger-dir and --trace-out are not ported yet (ROADMAP queue 1, item 11)")
        if args.scheduler_config:
            with open(args.scheduler_config, "r", encoding="utf-8") as f:
                body["scheduler_config"] = f.read()
        from open_simulator_tpu_torch.k8s.loader import load_resources_from_directory
        from open_simulator_tpu_torch.tune import TuneOptions, format_tune, tune_search

        opts = TuneOptions.from_body(body)
        cluster = load_resources_from_directory(args.cluster_config)
        apps = []
        if args.apps:
            from open_simulator_tpu_torch.core import AppResource

            apps = [AppResource(name="tune",
                                resources=load_resources_from_directory(args.apps))]
        report = tune_search(cluster, apps, opts, device=args.device)
    except Exception as e:  # knobs, config, cluster and unported-path errors -> exit 1
        print(f"error: {e}", file=sys.stderr)
        return 1
    _emit(json.dumps(report, indent=2) if args.json else format_tune(report), args.output_file)
    return 0


def _explain(args) -> int:
    """``explain``: the reference's report, text or JSON, on stdout or in
    --output-file; exit 1 with ``error: <message>`` for any error."""
    import json

    from open_simulator_tpu_torch.telemetry.explain import format_explain, run_explain

    try:
        if args.trace_out:
            raise NotImplementedError("--trace-out is not ported yet (ROADMAP queue 1, item 11)")
        report = run_explain(args.simon_config,
                             default_scheduler_config=args.default_scheduler_config,
                             top_k=args.top_k, pods=args.pod or None,
                             use_greed=args.use_greed, device=args.device)
    except Exception as e:  # config, admission and unported-path errors -> exit 1
        print(f"error: {e}", file=sys.stderr)
        return 1
    _emit(json.dumps(report, indent=2) if args.json else format_explain(report),
          args.output_file)
    return 0


def _campaign(args) -> int:
    """``campaign {run, report, audit}``: the reference's fleet surface; a
    quarantined cluster does not fail the run (exit 0 while one
    completed)."""
    import json

    if not args.campaign_command:
        print("error: pick a subcommand: campaign {run, report, audit}", file=sys.stderr)
        return 2
    try:
        if getattr(args, "compile_cache_dir", ""):
            raise NotImplementedError(
                "--compile-cache-dir is not ported yet (ROADMAP queue 1, item 8)")
        if getattr(args, "ledger_dir", ""):
            raise NotImplementedError(
                "--ledger-dir is not ported yet (ROADMAP queue 1, item 11)")
        if args.campaign_command == "run":
            from open_simulator_tpu_torch.campaign import (
                CampaignOptions,
                format_report,
                run_campaign,
            )

            report = run_campaign(CampaignOptions(
                fleet=args.fleet, apps_dir=args.apps, scenario=args.scenario,
                max_clusters=args.max_clusters, retries=args.retries, resume=args.resume,
                audit=not args.no_audit, device=args.device))
            _emit(json.dumps(report, indent=2) if args.json else format_report(report),
                  args.output_file)
            return 0 if report["totals"]["completed"] > 0 else 1
        if args.campaign_command == "report":
            from open_simulator_tpu_torch.campaign import (
                format_report,
                report_from_journal,
                resolve_campaign,
            )

            journal = resolve_campaign(args.campaign)
            report = report_from_journal(journal)
            if journal.done is None:
                report["unfinished"] = True
            _emit(json.dumps(report, indent=2) if args.json
                  else format_report(report)
                  + ("\n(journal has no done marker — the campaign is unfinished; resume it "
                     f"with campaign run --resume {journal.campaign_id})"
                     if journal.done is None else ""), args.output_file)
            return 0
        from open_simulator_tpu_torch.campaign import format_audit, run_audit

        rep, info = run_audit(args.cluster, device=args.device)
        _emit(json.dumps({**info, **rep.to_dict()}, indent=2) if args.json
              else format_audit(rep, name=info["cluster"]), args.output_file)
        return 0 if rep.ok else 1
    except Exception as e:  # fleet, journal, source and unported-path errors -> exit 1
        print(f"error: {e}", file=sys.stderr)
        return 1


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if getattr(args, "no_waves", False):
        # one switch for the process: make_config folds SIMON_WAVES into
        # EngineConfig.wave_scheduling for every entry point
        import os

        from open_simulator_tpu_torch.engine.waves import WAVES_ENV

        os.environ[WAVES_ENV] = "0"
    if args.command == "campaign":
        return _campaign(args)
    if args.command == "explain":
        return _explain(args)
    if args.command == "replay":
        return _replay(args)
    if args.command == "tune":
        return _tune(args)
    if args.command != "apply":
        build_parser().print_help()
        return 2
    from open_simulator_tpu_torch.apply.applier import Applier, ApplyOptions

    try:
        if args.trace_out or args.ledger_dir:
            raise NotImplementedError(
                "--trace-out and --ledger-dir are not ported yet (ROADMAP queue 1, item 11)")
        opts = ApplyOptions(
            config_path=args.simon_config,
            default_scheduler_config=args.default_scheduler_config,
            output_file=args.output_file,
            use_greed=args.use_greed,
            interactive=args.interactive,
            extended_resources=[s for s in args.extended_resources.split(",") if s],
            max_new_nodes=args.max_new_nodes,
            sweep_mode=args.sweep_mode,
            compile_cache_dir=args.compile_cache_dir,
            resume=args.resume,
            device=args.device,
        )
        return Applier(opts).run()
    except Exception as e:  # config, admission and unported-path errors -> exit 1
        print(f"error: {e}", file=sys.stderr)
        return 1
