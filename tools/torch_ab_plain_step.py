#!/usr/bin/env python3
"""Time two builds of the port's ``plain_step`` kernel in one process, on
one card: this tree's ``csrc/plain_step.cu`` and another source of it
(for example a parent commit's), on the same inputs, in turns.

    python3 tools/torch_ab_plain_step.py --other <dir> [--rich] [--topk K [--prefix PODS]]

`<dir>` holds the other ``plain_step.cu``, or is a checkout of another
commit (``git archive <rev> | tar -x -C <dir>``). Both sources are
compiled with the package's nvcc flags into ``build/torch_ab/``. The
inputs are the north-star cluster (``--rich``: the rich one; 5,120 nodes
x 51,200 pods, 64 new-node slots), launched as one lane (every real node)
and as 64 lanes (the capacity sweep's counts), constant weights, reasons
off, each carry set from the template before its launch, the converted
inputs reused: each launch between CUDA events, in the order other,
this, this, other, ``--rounds`` times; the minimum and median of each
side are printed with the card's name and power limit, and the two
builds' placements must be equal.

``--topk K`` times the explain builds instead (both sources compiled
again with ``-DPLAIN_STEP_EXPLAIN=1``): one lane, each side launched with
``explain_topk`` = K and with it off (the library without explain), over
every pod and over the first ``--prefix`` pods; the top-k's cost is the
launch with it minus the launch without, and the two sources' top-k
tensors must be equal. ``--cycles`` adds one launch of each side and
mode over every pod with the kernel's per-phase cycle counts on
(``kernels/step.PHASES``, thread 0 of block 0, lane 0), printed as
cycles a pod. The other source's ``StepArgs`` must be a prefix
of this tree's (fields are only ever appended), so one argument block
serves both; a source without the top-k's key rows (before they were
added) is planned without them. Needs the card.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import statistics
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)


def other_source(path: str) -> str:
    """The other plain_step.cu: in `path`, or in the package of the
    checkout at `path`."""
    for cand in (os.path.join(path, "plain_step.cu"),
                 os.path.join(path, "open_simulator_tpu_torch", "csrc", "plain_step.cu")):
        if os.path.exists(cand):
            return os.path.abspath(cand)
    raise SystemExit(f"no plain_step.cu in {path}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", required=True,
                    help="directory holding the other plain_step.cu, or another checkout")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--nodes", type=int, default=5120)
    ap.add_argument("--pods", type=int, default=51200)
    ap.add_argument("--lanes", type=int, default=64)
    ap.add_argument("--rich", action="store_true", help="the rich north-star cluster")
    ap.add_argument("--topk", type=int, default=0, help="time the explain builds at this K")
    ap.add_argument("--prefix", type=int, default=2048,
                    help="with --topk, also time the first this many pods")
    ap.add_argument("--cycles", action="store_true",
                    help="then one more launch of each side and mode with the per-phase "
                         "cycle counts on: cycles a pod in each phase (lane 0, block 0)")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_ab_plain_step: needs the card", file=sys.stderr)
        return 1
    from open_simulator_tpu_torch.engine import scheduler as sched
    from open_simulator_tpu_torch.kernels import build, step
    from open_simulator_tpu_torch.parallel.sweep import active_masks_for_counts
    from open_simulator_tpu_torch.testing.synthetic import synthetic_snapshot

    out_dir = os.path.join(HERE, "build", "torch_ab")
    os.makedirs(out_dir, exist_ok=True)
    sources = {"other": other_source(args.other), "this": str(build.CSRC_DIR / "plain_step.cu")}
    kinds = {"plain": ()}
    if args.topk:
        kinds["explain"] = build.VARIANTS["plain_step_explain"][1]
    procs = {(name, kind): subprocess.Popen(
        [build.nvcc_path(), *build.NVCC_FLAGS, *extra, "-o",
         os.path.join(out_dir, f"{name}-{kind}.so"), src],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name, src in sources.items() for kind, extra in kinds.items()}
    libs = {"other": {}, "this": {}}
    for (name, kind), proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            print(f"nvcc failed for {sources[name]} ({kind}):\n{log}", file=sys.stderr)
            return 1
        lib = ctypes.CDLL(os.path.join(out_dir, f"{name}-{kind}.so"))
        args_p = ctypes.POINTER(step.StepArgs)
        lib.plain_step_launch.argtypes = [args_p, ctypes.c_void_p]
        lib.plain_step_launch.restype = ctypes.c_int
        lib.plain_step_clusters.argtypes = [args_p, ctypes.POINTER(ctypes.c_int)]
        lib.plain_step_clusters.restype = ctypes.c_int
        lib.plain_step_smem.argtypes = [args_p]
        lib.plain_step_smem.restype = ctypes.c_int
        libs[name][kind] = lib
    # a source from before the top-k's key rows lays out no such rows
    with open(sources["other"], encoding="utf-8") as f:
        other_keys = "kTopkPass" in f.read()

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    snap = synthetic_snapshot(args.nodes, args.pods, max_new=args.lanes, rich=args.rich)
    cfg = sched.make_config(snap)._replace(fail_reasons=False)
    dev = torch.device("cuda")
    arrs = sched.device_arrays(snap.arrays, dev)
    inv = sched.inv_alloc_of(arrs.alloc)
    counts = [min(i % (args.lanes + 1), args.lanes) for i in range(args.lanes)]
    cases = {"1 lane": active_masks_for_counts(snap, [0])}
    if not args.topk:
        cases[f"{args.lanes} lanes"] = active_masks_for_counts(snap, counts)
    real_library, real_widths = step._library, step.smem_widths

    def use(name):
        step._library = lambda explain=False, wide=False, lib=libs[name]: lib[
            "explain" if explain else "plain"]
        keyless = name == "other" and not other_keys and "keys" in step.SmemWidths._fields
        step.smem_widths = (lambda *a, **k: real_widths(*a, **k)._replace(keys=0)) if keyless \
            else real_widths

    try:
        for label, masks_np in cases.items():
            masks = torch.from_numpy(masks_np).to(dev)
            hoist = sched.hoist_of(arrs, masks)
            tmpl = sched.init_state(arrs, cfg)
            if cfg.forced_prefix:
                tmpl = sched.apply_forced_prefix(arrs, cfg, tmpl, cfg.forced_prefix)
            p0 = cfg.forced_prefix
            spans = {"all": snap.n_pods}
            if args.topk:
                spans[f"first {args.prefix}"] = min(snap.n_pods, p0 + args.prefix)
            modes = {"off": cfg}
            if args.topk:
                modes["on"] = cfg._replace(explain_topk=args.topk)
            for span, p1 in spans.items():
                times = {(n, m): [] for n in ("other", "this") for m in modes}
                outs, inputs = {}, {k: {} for k in times}
                for _ in range(args.rounds):
                    for name in ("other", "this", "this", "other"):
                        use(name)
                        for mode, c in modes.items():
                            carry = sched.lane_carry(tmpl, len(masks_np))
                            step.copy_template(carry, tmpl)
                            ev0 = torch.cuda.Event(enable_timing=True)
                            ev1 = torch.cuda.Event(enable_timing=True)
                            ev0.record()
                            out = step.plain_step_cuda(arrs, masks, hoist, inv, carry, c, p0, p1,
                                                       inputs=inputs[name, mode])
                            ev1.record()
                            torch.cuda.synchronize()
                            times[name, mode].append(ev0.elapsed_time(ev1))
                            outs[name, mode] = out
                for mode in modes:
                    a, b = outs["other", mode], outs["this", mode]
                    fields = ("node",) + (("topk_node", "topk_score", "topk_parts")
                                          if mode == "on" else ())
                    if not all(torch.equal(getattr(a, f), getattr(b, f)) for f in fields):
                        print(f"{label}, {span}, {mode}: the two builds differ", file=sys.stderr)
                        return 1
                mins = {k: min(v) for k, v in times.items()}
                meds = {k: statistics.median(v) for k, v in times.items()}
                for mode in modes:
                    print(f"{label}, {span} pods, {mode}: other min {mins['other', mode]:.3f} ms "
                          f"median {meds['other', mode]:.3f} ms; this min {mins['this', mode]:.3f} "
                          f"ms median {meds['this', mode]:.3f} ms "
                          f"({mins['this', mode] / mins['other', mode] - 1:+.4f} by the minima); "
                          f"runs other {[round(t, 3) for t in times['other', mode]]} this "
                          f"{[round(t, 3) for t in times['this', mode]]}; outputs equal",
                          flush=True)
                if args.cycles and span == "all":
                    for name in ("other", "this"):
                        use(name)
                        for mode, c in modes.items():
                            carry = sched.lane_carry(tmpl, len(masks_np))
                            cyc = torch.zeros((len(masks_np), len(step.PHASES)),
                                              dtype=torch.int64, device=dev)
                            step.plain_step_cuda(arrs, masks, hoist, inv, carry, c, p0, p1,
                                                 template=tmpl, phase_cycles=cyc)
                            per = (cyc[0].double() / (p1 - p0)).tolist()
                            print(f"{label}, {name}, {mode}: cycles a pod by phase "
                                  + ", ".join(f"{ph} {v:.1f}" for ph, v in zip(step.PHASES, per))
                                  + f"; total {sum(per):.1f}", flush=True)
                if args.topk:
                    n = p1 - p0
                    cost = {s: mins[s, "on"] - mins[s, "off"] for s in ("other", "this")}
                    print(f"{label}, {span} pods ({n}), the top-k at K = {args.topk} (on minus "
                          f"off, minima): other {cost['other']:.3f} ms "
                          f"({cost['other'] * 1e3 / n:.3f} us a pod), this {cost['this']:.3f} ms "
                          f"({cost['this'] * 1e3 / n:.3f} us a pod)", flush=True)
    finally:
        step._library, step.smem_widths = real_library, real_widths
    return 0


if __name__ == "__main__":
    sys.exit(main())
