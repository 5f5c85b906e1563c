#!/usr/bin/env python3
"""Time two builds of the port's ``plain_step`` kernel in one process, on
one card: this tree's ``csrc/plain_step.cu`` and another source of it
(for example a parent commit's), on the same inputs, in turns.

    python3 tools/torch_ab_plain_step.py --other <dir holding plain_step.cu>

Both sources are compiled with the package's nvcc flags into
``build/torch_ab/``. The inputs are the north-star cluster (5,120 nodes x
51,200 pods, 64 new-node slots), launched as one lane (every real node)
and as 64 lanes (the capacity sweep's counts), constant weights, reasons
off, each carry set from the template before its launch, the converted
inputs reused: each launch between CUDA events, in the order other,
this, this, other, ``--rounds`` times; the minimum and median of each
side are printed with the card's name and power limit, and the two
builds' placements must be equal. The other source's ``StepArgs`` must be
a prefix of this tree's (fields are only ever appended), so one argument
block serves both. Needs the card.
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", required=True, help="directory holding the other plain_step.cu")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--nodes", type=int, default=5120)
    ap.add_argument("--pods", type=int, default=51200)
    ap.add_argument("--lanes", type=int, default=64)
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
    sources = {"other": os.path.join(os.path.abspath(args.other), "plain_step.cu"),
               "this": str(build.CSRC_DIR / "plain_step.cu")}
    procs = {name: subprocess.Popen([build.nvcc_path(), *build.NVCC_FLAGS, "-o",
                                     os.path.join(out_dir, f"{name}.so"), src],
                                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for name, src in sources.items()}
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            print(f"nvcc failed for {sources[name]}:\n{log}", file=sys.stderr)
            return 1
        lib = ctypes.CDLL(os.path.join(out_dir, f"{name}.so"))
        args_p = ctypes.POINTER(step.StepArgs)
        lib.plain_step_launch.argtypes = [args_p, ctypes.c_void_p]
        lib.plain_step_launch.restype = ctypes.c_int
        lib.plain_step_clusters.argtypes = [args_p, ctypes.POINTER(ctypes.c_int)]
        lib.plain_step_clusters.restype = ctypes.c_int
        lib.plain_step_smem.argtypes = [args_p]
        lib.plain_step_smem.restype = ctypes.c_int
        libs[name] = lib

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    snap = synthetic_snapshot(args.nodes, args.pods, max_new=args.lanes)
    cfg = sched.make_config(snap)._replace(fail_reasons=False)
    dev = torch.device("cuda")
    arrs = sched.device_arrays(snap.arrays, dev)
    inv = sched.inv_alloc_of(arrs.alloc)
    counts = [min(i % (args.lanes + 1), args.lanes) for i in range(args.lanes)]
    cases = {"1 lane": active_masks_for_counts(snap, [0]),
             f"{args.lanes} lanes": active_masks_for_counts(snap, counts)}
    real_library = step._library
    try:
        for label, masks_np in cases.items():
            masks = torch.from_numpy(masks_np).to(dev)
            hoist = sched.hoist_of(arrs, masks)
            tmpl = sched.init_state(arrs, cfg)
            if cfg.forced_prefix:
                tmpl = sched.apply_forced_prefix(arrs, cfg, tmpl, cfg.forced_prefix)
            times = {"other": [], "this": []}
            nodes, inputs = {}, {"other": {}, "this": {}}
            for _ in range(args.rounds):
                for name in ("other", "this", "this", "other"):
                    step._library = lambda explain=False, wide=False, lib=libs[name]: lib
                    carry = sched.lane_carry(tmpl, len(masks_np))
                    step.copy_template(carry, tmpl)
                    ev0 = torch.cuda.Event(enable_timing=True)
                    ev1 = torch.cuda.Event(enable_timing=True)
                    ev0.record()
                    out = step.plain_step_cuda(arrs, masks, hoist, inv, carry, cfg,
                                               cfg.forced_prefix, snap.n_pods,
                                               inputs=inputs[name])
                    ev1.record()
                    torch.cuda.synchronize()
                    times[name].append(ev0.elapsed_time(ev1))
                    nodes[name] = out.node.cpu().numpy()
            if not np.array_equal(nodes["other"], nodes["this"]):
                print(f"{label}: the two builds placed pods differently", file=sys.stderr)
                return 1
            mins = {k: min(v) for k, v in times.items()}
            meds = {k: statistics.median(v) for k, v in times.items()}
            print(f"{label}: other min {mins['other']:.3f} ms median {meds['other']:.3f} ms; "
                  f"this min {mins['this']:.3f} ms median {meds['this']:.3f} ms "
                  f"({mins['this'] / mins['other'] - 1:+.4f} by the minima); runs "
                  f"{ {k: [round(t, 3) for t in v] for k, v in times.items()} }; placements "
                  "equal", flush=True)
    finally:
        step._library = real_library
    return 0


if __name__ == "__main__":
    sys.exit(main())
