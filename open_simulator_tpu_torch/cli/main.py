"""CLI of the port: ``python -m open_simulator_tpu_torch.cli apply -f <config>``
and ``python -m open_simulator_tpu_torch.cli explain -f <config>``.

The reference's ``simon-tpu apply`` and ``simon-tpu explain``
(``open_simulator_tpu/cli/main.py``) on the port's engine: the same flags
for what is ported, the same report on stdout and the same exit codes
(apply: 0 when a plan is found, 1 for FAILED; explain: 0; both: 1 for any
error, with ``error: <message>`` on stderr), plus ``--device`` (default:
the card; ``cpu`` runs the plain torch step). The reference's other
options are accepted and refused with the ROADMAP item that ports them.
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
                    help="not ported yet (ROADMAP queue 1, item 15)")
    ap.add_argument("--compile-cache-dir", default="",
                    help="not ported yet (ROADMAP queue 1, item 8)")
    ap.add_argument("--resume", default="", metavar="SWEEP_ID",
                    help="not ported yet (ROADMAP queue 1, item 8)")
    ap.add_argument("--trace-out", default="",
                    help="not ported yet (ROADMAP queue 1, item 11)")
    ap.add_argument("--ledger-dir", default="",
                    help="not ported yet (ROADMAP queue 1, item 11)")

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
                    help="not ported yet (ROADMAP queue 1, item 15)")
    ex.add_argument("--trace-out", default="",
                    help="not ported yet (ROADMAP queue 1, item 11)")
    return p


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
    text = json.dumps(report, indent=2) if args.json else format_explain(report)
    if args.output_file:
        with open(args.output_file, "w", encoding="utf-8") as f:
            f.write(text + "\n")
    else:
        print(text)
    return 0


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.command == "explain":
        return _explain(args)
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
