"""CLI of the port: ``python -m open_simulator_tpu_torch.cli apply -f <config>``.

The reference's ``simon-tpu apply`` (``open_simulator_tpu/cli/main.py``)
on the port's engine: the same flags for what is ported, the same report
on stdout and the same exit codes (0 when a plan is found; 1 for FAILED
and for any error, with ``error: <message>`` on stderr), plus
``--device`` (default: the card; ``cpu`` runs the plain torch step). The
reference's other options are accepted and refused with the ROADMAP item
that ports them.
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
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
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
