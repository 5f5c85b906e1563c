#!/usr/bin/env python3
"""Time two builds of the port's ``plain_step`` kernel in one process, on
one card: this tree's ``csrc/plain_step.cu`` and another source of it
(for example a parent commit's), on the same inputs, in turns.

    python3 tools/torch_ab_plain_step.py --other <dir> [--rich | --devres] [--weights]
        [--topk K [--prefix PODS]] [--cycles] [--variant NAME=PLACEMENT ...]
        [--also NAME=SOURCE ...] [--seed S] [--ext PODS | --fleet LANES | --waves]

`<dir>` holds the other ``plain_step.cu``, or is a checkout of another
commit (``git archive <rev> | tar -x -C <dir>``). Both sources are
compiled with the package's nvcc flags into ``build/torch_ab/`` (named by
a hash of source and flags, so a second run in the same checkout reuses
them). The inputs are the north-star cluster (``--rich``: the rich one;
``--devres``: the device-resource one, the capacity-devres-64 snapshot
with its GPU slots; 5,120 nodes x 51,200 pods, 64 new-node slots),
launched as one lane (every real node) and as 64 lanes (the capacity
sweep's counts), constant weights, reasons off, each carry set from the
template before its launch, the converted inputs reused: each launch
between CUDA events, in the order other, this, this, other, ``--rounds``
times; the minimum and median of each side are printed with the card's
name and power limit, each side's launch plan (``kernels/step.LaunchPlan``:
cluster size, threads, nodes a thread, resident clusters, the staged
regions, warps an SM), and the builds' placements must be equal.

``--weights`` runs the traced weights instead (tune-rich-64's weighted
launch): every lane the cluster's own nodes (no new-node slots), a
different [9] weight row a lane (lane 0 the config's own vector, the
others scaled from a seed), one lane and 64.

``--variant NAME=PLACEMENT`` (repeatable) adds this tree's build under a
placement that ``plan_launch`` is made to take (``kernels/step.
PLACEMENT_NAMES``: which regions are staged in shared memory), timed in
the same turns as the other two; ``--also NAME=SOURCE`` (repeatable) adds
another plain_step.cu with this tree's layout and plan (a variant of this
tree's source, such as a copy at other launch bounds). Each added
source's ptxas line is printed (the scan builds' registers and spills).

``--ext PODS`` times the extension loop instead (northstar-ext: one lane,
the five ``synthetic_extensions`` ops, one launch a pod), over the first
PODS pods (``ext_ab``): the loop's host time a pod, in turns, of this
tree's graph path (``engine/scheduler._extension_scan``), its eager loop,
its graph path with the one-pod launches' headroom rows in shared memory
(a variant: the parent's plan) and the other source's loop (a pod slice cut with a host
index, ``StepArgs`` patched a pod, as a source without the device cursor
ran it); each side's launches alone (us of device a launch and a one-element
add, back to back between CUDA events, the stream primed), the graph's replays (us of
device a pod), and with ``--cycles`` each side's cycles a pod by phase in
one-pod launches beside the scan's over the same pods and rows. This
tree's extension launches run the library ``plain_step_ext``.

``--fleet LANES`` times fleet-16's batched launch instead: LANES of
``write_synthetic_fleet``'s 1,024 x 10,240 clusters through the
campaign's host pipeline (``campaign/lanes._prepare``), each side's fleet
kernel (``kernels/step.plain_step_fleet_cuda``) over every pod after the
forced prefix, the kernel alone between CUDA events, in turns; every
lane's placements and carry must be equal.

``--waves`` times the wave path instead, on the reference bench's pools
preset (1,024 nodes x 10,240 pods in 32 pools: one GRID of 320 waves of
32), at one lane and at 64 lanes (``waves_ab``): each side's frozen
launches and this tree's merges, every wave between CUDA events with the
stream primed every 16 waves (device us a launch), in turns; each side's
launch plan (cluster size, group size, clusters a launch, resident
clusters, rounds); at one lane this tree's launches with the plan held
to each cluster size (a second pass, the first converting the inputs);
the wave loop's wall a wave, in turns, of this tree's
graph path (``engine/scheduler._run_wave_plan``), its eager loop and the
parent's loop (each wave a ``plain_step`` call on the other source, a
merge and the eight slice copies), then the graph's replays alone (wall
and device time a wave, the card's idle share); with ``--cycles`` each side's cycles a
pod by phase of the lane's first cluster (a source whose frozen form has
no cycle counts is skipped); and this tree's plan for each frozen build
at 64 lanes on ``wave_pools_snapshot`` clusters of the preset's size.

``--topk K`` times the explain builds instead (both sources compiled
again with ``-DPLAIN_STEP_EXPLAIN=1``): one lane, each side launched with
``explain_topk`` = K and with it off (the library without explain), over
every pod and over the first ``--prefix`` pods; the top-k's cost is the
launch with it minus the launch without, and the two sources' top-k
tensors must be equal. ``--seed S`` adds the tie-break jitter of seed S
to the explain launch (with ``--topk 0``, northstar-tiebreak's launch:
the jitter alone). ``--cycles`` adds one launch of each side and
mode over every pod with the kernel's per-phase cycle counts on
(``kernels/step.PHASES``, thread 0 of block 0, lane 0), printed as
cycles a pod. The other source's ``StepArgs`` must be a prefix
of this tree's (fields are only ever appended), so one argument block
serves both; a source without the top-k's key rows (before they were
added) is planned without them, and a source without the staged regions
with every region unstaged. Needs the card.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import os
import re
import statistics
import subprocess
import sys
import time

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


def ptxas_lines(log: str) -> str:
    """The scan builds' registers and spills from one nvcc -Xptxas=-v log."""
    out, name = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            k = re.search(r"plain_step_kernelILb([01])ELb([01])ELb([01])ELb([01])", m.group(1))
            name = f"<{k.group(1)},{k.group(2)}>" if k and k.group(3) + k.group(4) == "00" else None
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and name:
            out.append(f"{name} spill stores {m.group(1)} B loads {m.group(2)} B")
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out.append(f"{name} {m.group(1)} registers")
    return "; ".join(out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", required=True,
                    help="directory holding the other plain_step.cu, or another checkout")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--nodes", type=int, default=5120)
    ap.add_argument("--pods", type=int, default=51200)
    ap.add_argument("--lanes", type=int, default=64)
    kind = ap.add_mutually_exclusive_group()
    kind.add_argument("--rich", action="store_true", help="the rich north-star cluster")
    kind.add_argument("--devres", action="store_true",
                      help="the device-resource cluster (capacity-devres-64's snapshot)")
    ap.add_argument("--weights", action="store_true",
                    help="the traced weights: a different score-weight row a lane")
    ap.add_argument("--topk", type=int, default=0, help="time the explain builds at this K")
    ap.add_argument("--prefix", type=int, default=2048,
                    help="with --topk, also time the first this many pods")
    ap.add_argument("--cycles", action="store_true",
                    help="then one more launch of each side and mode with the per-phase "
                         "cycle counts on: cycles a pod in each phase (lane 0, block 0)")
    ap.add_argument("--variant", action="append", default=[], metavar="NAME=PLACEMENT",
                    help="also time this tree's build with plan_launch held to a placement")
    ap.add_argument("--also", action="append", default=[], metavar="NAME=SOURCE",
                    help="also time another plain_step.cu with this tree's layout")
    ap.add_argument("--seed", type=int, default=0,
                    help="the explain builds with the tie-break jitter of this seed")
    ap.add_argument("--ext", type=int, default=0, metavar="PODS",
                    help="time the extension loop's one-pod launches over this many pods")
    ap.add_argument("--fleet", type=int, default=0, metavar="LANES",
                    help="time fleet-16's batched launch of this many clusters")
    ap.add_argument("--waves", action="store_true",
                    help="time the wave path (frozen launches, merges, the loop) on pools")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_ab_plain_step: needs the card", file=sys.stderr)
        return 1
    from open_simulator_tpu_torch.engine import scheduler as sched
    from open_simulator_tpu_torch.kernels import build, step
    from open_simulator_tpu_torch.parallel.sweep import active_masks_for_counts
    from open_simulator_tpu_torch.testing.synthetic import (
        device_resource_snapshot,
        synthetic_snapshot,
    )

    out_dir = os.path.join(HERE, "build", "torch_ab")
    os.makedirs(out_dir, exist_ok=True)
    this_src = str(build.CSRC_DIR / "plain_step.cu")
    sources = {"other": other_source(args.other), "this": this_src}
    for v in args.also:
        name, _, src = v.partition("=")
        sources[name] = other_source(src) if os.path.isdir(src) else os.path.abspath(src)
    variants = {}
    for v in args.variant:
        name, _, placement = v.partition("=")
        if placement not in step.PLACEMENT_NAMES:
            raise SystemExit(f"--variant {v}: placements are {sorted(step.PLACEMENT_NAMES)}")
        variants[name] = step.PLACEMENT_NAMES[placement]
    kinds = {"plain": ()}
    explain = bool(args.topk or args.seed)
    if explain or args.waves:
        kinds["explain"] = build.VARIANTS["plain_step_explain"][1]
    if args.ext:
        kinds["ext"] = build.VARIANTS["plain_step_ext"][1]
    # a source with the extension rows in builds of their own (and the
    # device cursor) takes its extension launches from that library
    with_ext = {}
    for name, src in sources.items():
        with open(src, encoding="utf-8") as f:
            with_ext[name] = "PLAIN_STEP_EXT" in f.read()
    procs = {}
    for name, src in sources.items():
        for kd, extra in kinds.items():
            if kd == "ext" and not with_ext[name]:
                continue
            flags = (*build.NVCC_FLAGS, *extra)
            with open(src, "rb") as f:
                digest = hashlib.sha256(f.read() + " ".join(flags).encode()).hexdigest()[:12]
            so = os.path.join(out_dir, f"{name}-{kd}-{digest}.so")
            if os.path.exists(so):
                procs[name, kd] = (so, None)
                continue
            procs[name, kd] = (so, subprocess.Popen(
                [build.nvcc_path(), *flags, "-o", so, src],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {name: {} for name in sources}
    for (name, kd), (so, proc) in procs.items():
        if proc is not None:
            log, _ = proc.communicate()
            if proc.returncode:
                print(f"nvcc failed for {sources[name]} ({kd}):\n{log}", file=sys.stderr)
                return 1
            if name not in ("other", "this"):
                print(f"{name} ({sources[name]}), ptxas: {ptxas_lines(log)}", flush=True)
        lib = ctypes.CDLL(so)
        args_p = ctypes.POINTER(step.StepArgs)
        lib.plain_step_launch.argtypes = [args_p, ctypes.c_void_p]
        lib.plain_step_launch.restype = ctypes.c_int
        lib.plain_step_clusters.argtypes = [args_p, ctypes.POINTER(ctypes.c_int)]
        lib.plain_step_clusters.restype = ctypes.c_int
        lib.plain_step_smem.argtypes = [args_p]
        lib.plain_step_smem.restype = ctypes.c_int
        libs[name][kd] = lib
    # a source from before the top-k's key rows lays out no such rows, and
    # one from before the staged regions stages none
    with open(sources["other"], encoding="utf-8") as f:
        other_text = f.read()
    other_keys = "kTopkPass" in other_text
    other_stages = "pod_pack" in other_text

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    snap = None
    if not (args.fleet or args.waves):  # those clusters are fleet_ab's and waves_ab's
        if args.devres:
            snap = device_resource_snapshot(args.nodes, args.pods, max_new=args.lanes)
        else:
            snap = synthetic_snapshot(args.nodes, args.pods,
                                      max_new=0 if args.weights or args.ext else args.lanes,
                                      rich=args.rich)
        cfg = sched.make_config(snap)._replace(fail_reasons=False, traced_weights=args.weights)
        dev = torch.device("cuda")
        arrs = sched.device_arrays(snap.arrays, dev)
        inv = sched.inv_alloc_of(arrs.alloc)
        if args.weights:
            # tune_search's lanes: the cluster as it is in every lane
            cases = {"1 lane": np.asarray(snap.arrays.active, dtype=bool)[None]}
            if not explain:
                cases[f"{args.lanes} lanes"] = np.tile(cases["1 lane"], (args.lanes, 1))
            base = sched.weight_vector(cfg)
            rng = np.random.RandomState(0)
            wmat = (base[None] * rng.uniform(0.0, 2.0, (args.lanes, len(base)))).astype(np.float32)
            wmat[0] = base
        elif not args.ext:
            counts = [min(i % (args.lanes + 1), args.lanes) for i in range(args.lanes)]
            cases = {"1 lane": active_masks_for_counts(snap, [0])}
            if not explain:
                cases[f"{args.lanes} lanes"] = active_masks_for_counts(snap, counts)
    real_library, real_widths, real_places = step._library, step.smem_widths, step.PLACEMENTS
    real_plan_for, real_fire = step.plan_for, step._fire
    # a source from before the frozen form's groups runs one pod a cluster,
    # unstaged, laid out as the scan (its own plan), and takes no device
    # cursor: its launch runs the pods from p0, where the cursor points
    other_groups = "int grp, npod, poff;" in other_text

    def fire_without_cursor(lib, args_, plan, dev_, what):
        if args_.frozen:
            args_.cursor = None
        real_fire(lib, args_, plan, dev_, what)

    def one_pod_plan_for(arrs_, cfg_, flags, n_lanes, occupancy, fleet=False, one_pod=False,
                         frozen=False, n_pods=1):
        if not frozen:
            return real_plan_for(arrs_, cfg_, flags, n_lanes, occupancy, fleet, one_pod)
        wide = step.needs_wide(arrs_, cfg_, flags)
        return step.plan_launch(
            n_lanes * n_pods, arrs_.alloc.shape[0], step.smem_widths(arrs_, cfg_, flags),
            occupancy, step.max_threads(flags, fleet, wide, step.explain_on(cfg_)),
            step.placements_for(wide, True, flags))._replace(wide=wide)
    sides = ["other", "this", *variants, *[n for n in sources if n not in ("other", "this")]]
    order = sides + sides[::-1][1:-1] + ["other"] if len(sides) > 2 else [
        "other", "this", "this", "other"]

    def use(name):
        src = "this" if name in variants else name
        step._library = lambda explain=False, wide=False, ext=False, lib=libs[src]: lib[
            "ext" if ext and "ext" in lib else ("explain" if explain else "plain")]
        # the other source's layout: no key rows before the top-k had them,
        # no pod region before the staged regions
        drop = {}
        if name == "other" and not other_keys:
            drop["keys"] = 0
        if name == "other" and not other_stages:
            drop["pod"] = 0
        step.smem_widths = (lambda *a, **k: real_widths(*a, **k)._replace(**drop)) if drop \
            else real_widths
        step.PLACEMENTS = real_places
        step.plan_for = (one_pod_plan_for if name == "other" and not other_groups
                         else real_plan_for)
        step._fire = (fire_without_cursor if name == "other" and not other_groups
                      else real_fire)
        if name in variants:
            step.PLACEMENTS = step.placements_held_to(variants[name])
        elif name == "other" and not other_stages:
            step.PLACEMENTS = step.placements_held_to(step.UNSTAGED)

    def describe(plan, n_lanes):
        per = -(-plan.slice_len // plan.threads)
        blocks = min(n_lanes, plan.resident) * plan.cluster
        warps = plan.threads // 32 * max(1, blocks // n_sm)
        return (f"C={plan.cluster} threads={plan.threads} nodes/thread={per} "
                f"slice={plan.slice_len} resident_clusters={plan.resident} "
                f"staged={step.placement_name(plan)} smem={plan.smem} warps/SM={warps}")

    try:
        if args.ext:
            return ext_ab(args, torch, sched, step, snap, use, with_ext["this"])
        if args.waves:
            return waves_ab(args, torch, sched, step, sides, order, use, other_text)
        if args.fleet:
            # a source from before the staged regions (or the device
            # cursor) reads a StepArgs that ends where their pointers begin
            # (fields are only appended)
            record = (ctypes.sizeof(step.StepArgs) if "int32_t* cursor;" in other_text
                      else step.StepArgs.cursor.offset if other_stages
                      else step.StepArgs.pod_pack.offset)
            return fleet_ab(args, torch, sched, step, sides, order, use, record)
        for label, masks_np in cases.items():
            masks = torch.from_numpy(masks_np).to(dev)
            w_t = torch.from_numpy(wmat[:len(masks_np)]).to(dev) if args.weights else None
            hoist = sched.hoist_of(arrs, masks)
            tmpl = sched.init_state(arrs, cfg)
            if cfg.forced_prefix:
                tmpl = sched.apply_forced_prefix(arrs, cfg, tmpl, cfg.forced_prefix)
            p0 = cfg.forced_prefix
            spans = {"all": snap.n_pods}
            if explain:
                spans[f"first {args.prefix}"] = min(snap.n_pods, p0 + args.prefix)
            modes = {"off": cfg}
            if explain:
                modes["on"] = cfg._replace(explain_topk=args.topk, tie_break_seed=args.seed)
            for span, p1 in spans.items():
                times = {(n, m): [] for n in sides for m in modes}
                outs, inputs, plans = {}, {k: {} for k in times}, {}
                for _ in range(args.rounds):
                    for name in order:
                        use(name)
                        for mode, c in modes.items():
                            carry = sched.lane_carry(tmpl, len(masks_np))
                            step.copy_template(carry, tmpl)
                            ev0 = torch.cuda.Event(enable_timing=True)
                            ev1 = torch.cuda.Event(enable_timing=True)
                            ev0.record()
                            out = step.plain_step_cuda(arrs, masks, hoist, inv, carry, c, p0, p1,
                                                       inputs=inputs[name, mode], weights=w_t)
                            ev1.record()
                            torch.cuda.synchronize()
                            times[name, mode].append(ev0.elapsed_time(ev1))
                            outs[name, mode] = (out, carry)
                            plans[name, mode] = step.LAST_PLAN
                for mode in modes:
                    a = outs["other", mode]
                    fields = ("node",) + (("topk_node", "topk_score", "topk_parts")
                                          if mode == "on" else ())
                    for name in sides[1:]:
                        b = outs[name, mode]
                        same = all(torch.equal(getattr(a[0], f), getattr(b[0], f))
                                   for f in fields) and all(
                            torch.equal(getattr(a[1], f), getattr(b[1], f))
                            for f in sched.STATE_FIELDS)
                        if not same:
                            print(f"{label}, {span}, {mode}: {name} and other differ",
                                  file=sys.stderr)
                            return 1
                mins = {k: min(v) for k, v in times.items()}
                meds = {k: statistics.median(v) for k, v in times.items()}
                for mode in modes:
                    for name in sides:
                        print(f"{label}, {span} pods, {mode}, {name}: min "
                              f"{mins[name, mode]:.3f} ms median {meds[name, mode]:.3f} ms "
                              f"({mins[name, mode] / mins['other', mode] - 1:+.4f} against "
                              f"other by the minima); runs "
                              f"{[round(t, 3) for t in times[name, mode]]}; plan "
                              f"{describe(plans[name, mode], len(masks_np))}; outputs and "
                              "carry equal", flush=True)
                if args.cycles and span == "all":
                    for name in sides:
                        use(name)
                        for mode, c in modes.items():
                            carry = sched.lane_carry(tmpl, len(masks_np))
                            cyc = torch.zeros((len(masks_np), len(step.PHASES)),
                                              dtype=torch.int64, device=dev)
                            step.plain_step_cuda(arrs, masks, hoist, inv, carry, c, p0, p1,
                                                 template=tmpl, phase_cycles=cyc, weights=w_t)
                            per = (cyc[0].double() / (p1 - p0)).tolist()
                            print(f"{label}, {name}, {mode}: cycles a pod by phase "
                                  + ", ".join(f"{ph} {v:.1f}" for ph, v in zip(step.PHASES, per))
                                  + f"; total {sum(per):.1f}; plan "
                                  + describe(step.LAST_PLAN, len(masks_np)), flush=True)
                if explain:
                    n = p1 - p0
                    cost = {s: mins[s, "on"] - mins[s, "off"] for s in sides}
                    print(f"{label}, {span} pods ({n}), the explain launch at K = {args.topk}, "
                          f"seed {args.seed} (on minus "
                          "off, minima): " + ", ".join(
                              f"{s} {cost[s]:.3f} ms ({cost[s] * 1e3 / n:.3f} us a pod)"
                              for s in sides), flush=True)
    finally:
        step._library, step.smem_widths = real_library, real_widths
        step.PLACEMENTS, step.plan_for = real_places, real_plan_for
    return 0


class _IntSlice(dict):
    """Pod p's slice cut with a host index, as a loop without the device
    cursor cut it (a read-only view of each column's row p)."""

    def __init__(self, cols, p):
        super().__init__()
        self._cols, self._p = cols, p

    def __getitem__(self, key):
        return self._cols[key][self._p]

    def __iter__(self):
        return iter(self._cols)

    def __len__(self):
        return len(self._cols)


def patched_launcher(torch, step, arrs, active, hoist, inv, state, cfg, out, cycles=None):
    """The per-pod launch of a source without the device cursor: the
    StepArgs built at the first pod, then each pod's p0, p1, output rows
    and extension rows patched in, one launch a pod on the current stream
    (its own loop's protocol, on its own library)."""
    import math

    lib = step._library(step.explain_on(cfg), False, False)
    flags = step._flags(cfg, state, False)
    words = [math.prod(t.shape[2:]) for t in out]
    built = {}

    def launch(p, ok, raw):
        if not built:
            args, tensors = step._launch_args(arrs, active, hoist, inv, state, cfg, p, p + 1,
                                              None, cycles, None, None, False, {}, None, ok,
                                              raw, out=out)
            plan = step.plan_for(arrs, cfg, flags, 1, step._card_occupancy(lib, args),
                                 one_pod=True)
            step._set_geometry(args, plan)
            built.update(args=args, tensors=tensors, plan=plan,
                         base={f: getattr(args, f) for f in step._OUT_PTRS})
        args = built["args"]
        args.p0, args.p1 = p, p + 1
        for f, w in zip(step._OUT_PTRS, words):
            b = built["base"][f]
            setattr(args, f, None if b is None else b + 4 * w * p)
        args.ext_ok, args.ext_raw = ok.data_ptr(), raw.data_ptr()
        err = lib.plain_step_launch(ctypes.byref(args),
                                    ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
        if err:
            raise RuntimeError(f"other launch failed: CUDA error {err}")
        step.LAST_PLAN = built["plan"]
    return launch


def ext_ab(args, torch, sched, step, snap, use, cursor) -> int:
    """--ext: northstar-ext's extension loop over the first PODS pods,
    each way in turns: this tree's graph path (the first pod eager, one
    pod captured, the graph replayed), this tree's eager loop, the same
    graph path with the one-pod launches' headroom rows in shared memory
    where they fit (the parent's plan, a variant), and the other source's
    loop (a pod slice cut with a host index, StepArgs patched a pod): host
    us a pod (the loop's wall, synchronised). Then each side's launches
    alone, from rows recorded against the live carry, back to back with a
    one-element add after each (the cursor's step; the other side's
    launch does not read it) between two CUDA events, the stream primed
    (device us a launch), the graph's replays from
    the template with the stream primed, in turns with the variant's
    (device us a pod: the callables' kernels, the launch, the cursor's
    step) and the profiler's kernel times by name over the same replays,
    and with --cycles each side's
    cycles a pod by phase in one-pod launches beside the scan's (one
    launch over the same pods with the same rows). The other source's
    one-pod launches take the plan it took (the headroom rows in shared
    memory where they fit)."""
    from open_simulator_tpu_torch.testing.synthetic import synthetic_extensions

    dev = torch.device("cuda")
    cfg = sched.make_config(snap, extensions=synthetic_extensions())
    arrs = sched.device_arrays(snap.arrays, dev)
    active = torch.from_numpy(snap.arrays.active).to(dev)[None]
    hoist, inv = sched.hoist_of(arrs, active), sched.inv_alloc_of(arrs.alloc)
    tmpl = sched.init_state(arrs, cfg)
    n = min(args.ext, snap.n_pods)
    rows_of = sched.extension_rows_fn(cfg)
    cols = sched.pod_columns(arrs, cfg, None, None)
    real_placements = step.placements_for

    def hr_shared(wide, one_pod=False, flags=0, headroom=True):
        return real_placements(wide, one_pod, flags)  # the headroom rows where they fit

    def this_loop(graph, hrs=False):
        use("this")
        step.placements_for = hr_shared if hrs else real_placements
        carry = sched.lane_carry(tmpl, 1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs = sched._extension_scan(arrs, active, hoist, inv, carry, tmpl, cfg, 0, n, None,
                                     None, None, graph=graph)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        step.placements_for = real_placements
        return wall, outs[0], carry

    def other_loop():
        use("other")
        step.placements_for = hr_shared  # the other source's plan
        carry = sched.lane_carry(tmpl, 1)
        step.copy_template(carry, tmpl)
        out = sched.ExtensionLoop(arrs, active, hoist, inv, carry, tmpl, cfg, 0, n, None, None,
                                  None, plain=True).outs  # buffers only
        launch = patched_launcher(torch, step, arrs, active, hoist, inv, carry, cfg, out)
        fields = tuple(getattr(carry, f) for f in sched.STATE_FIELDS)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for p in range(n):
            ok, raw = rows_of(fields, arrs, _IntSlice(cols, p))
            launch(p, ok[:, None], raw[:, None])
        torch.cuda.synchronize()
        step.placements_for = real_placements
        return time.perf_counter() - t0, out[0], carry

    loops = {"this, graph": lambda: this_loop(True), "this, eager": lambda: this_loop(False),
             "this, graph, headroom in shared memory": lambda: this_loop(True, True),
             "other, its loop": other_loop}
    if not cursor:
        raise SystemExit("--ext: this tree's plain_step.cu has no device cursor")
    names = list(loops)
    turns = names + names[::-1]
    walls = {k: [] for k in names}
    ref = None
    for _ in range(args.rounds):
        for k in turns:
            wall, node, carry = loops[k]()
            walls[k].append(wall)
            got = (node.clone(), [getattr(carry, f).clone() for f in sched.STATE_FIELDS])
            if ref is None:
                ref = got
            elif not (torch.equal(ref[0], got[0])
                      and all(torch.equal(a, b) for a, b in zip(ref[1], got[1]))):
                print(f"extension loop: {k} differs", file=sys.stderr)
                return 1
    for k in names:
        t = min(walls[k])
        print(f"extension loop, {n} pods, {k}: host {t * 1e6 / n:.3f} us a pod (min of "
              f"{len(walls[k])}; runs {[round(x * 1e6 / n, 3) for x in walls[k]]}); outputs "
              "and carry equal", flush=True)

    # the launches alone: rows recorded once against the live carry
    use("this")
    carry = sched.lane_carry(tmpl, 1)
    loop = sched.ExtensionLoop(arrs, active, hoist, inv, carry, tmpl, cfg, 0, n, None, None,
                               None)
    rec = []
    for p in range(n):
        ok, raw = rows_of(loop.fields, arrs, loop.x)
        rec.append((ok[:, None].clone(), raw[:, None].clone()))
        loop.launch(p, *rec[-1])
        loop.cursor.add_(1)
    torch.cuda.synchronize()

    def alone(name, hrs=False, cycles=None):
        use(name)
        step.placements_for = hr_shared if hrs else real_placements
        c = sched.lane_carry(tmpl, 1)
        step.copy_template(c, tmpl)
        out = sched.ExtensionLoop(arrs, active, hoist, inv, c, tmpl, cfg, 0, n, None, None,
                                  None, plain=True).outs
        cur = torch.zeros((1,), dtype=torch.int32, device=dev)
        if name == "other":
            launch = patched_launcher(torch, step, arrs, active, hoist, inv, c, cfg, out, cycles)
        else:
            launch = step.pod_launcher(arrs, active, hoist, inv, c, cfg, out, 0, cur,
                                       phase_cycles=cycles)
        per = torch.zeros((len(step.PHASES),), dtype=torch.float64)
        ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        torch.cuda._sleep(int(1.0 * n * 1_980_000))  # the launches queue behind the spin
        ev0.record()
        for p in range(n):
            launch(p, *rec[p])
            cur.add_(1)  # the cursor's step (the other side's launch does not read it)
            if cycles is not None:
                torch.cuda.synchronize()
                per += cycles[0].double().cpu()
        ev1.record()
        torch.cuda.synchronize()
        step.placements_for = real_placements
        return ev0.elapsed_time(ev1), per / n, out[0], step.LAST_PLAN

    sides = {"this": ("this", False), "this, headroom in shared memory": ("this", True),
             "other": ("other", True)}
    times = {k: [] for k in sides}
    plans = {}
    for _ in range(args.rounds):
        for k in list(sides) + list(sides)[::-1]:
            ms, _, node, plans[k] = alone(*sides[k])
            times[k].append(ms)
            if not torch.equal(node, ref[0]):
                print(f"extension launches: {k} differs", file=sys.stderr)
                return 1
    for k in sides:
        t, pl = min(times[k]), plans[k]
        print(f"extension launches alone, {n} one-pod launches and cursor steps back to "
              f"back, {k}: {t * 1e3 / n:.3f} us a "
              f"launch ({t / min(times['other']) - 1:+.4f} against other); runs "
              f"{[round(x * 1e3 / n, 3) for x in times[k]]}; plan C={pl.cluster} "
              f"threads={pl.threads} headroom_in_smem={pl.headroom} "
              f"staged={step.placement_name(pl)} smem={pl.smem}; outputs equal", flush=True)

    # the graph's replays from the template, the stream primed, each plan
    # in turns; then the profiler's kernel times over the same replays
    # (CUPTI; "not measured" where it sees no device time)
    from torch.profiler import ProfilerActivity, profile

    graphs = {}
    for k, hrs in (("this", False), ("this, headroom in shared memory", True)):
        use("this")
        step.placements_for = hr_shared if hrs else real_placements
        c = sched.lane_carry(tmpl, 1)
        lp = sched.ExtensionLoop(arrs, active, hoist, inv, c, tmpl, cfg, 0, n, None, None, None)
        lp.pod(0)
        graphs[k] = (lp, c, lp.capture(1))
        step.placements_for = real_placements
    pods = {k: [] for k in graphs}
    for _ in range(args.rounds):
        for k in list(graphs) + list(graphs)[::-1]:
            lp, c, graph = graphs[k]
            step.copy_template(c, tmpl)
            lp.cursor.fill_(0)
            torch.cuda.synchronize()
            torch.cuda._sleep(int(0.05 * n * 1_980_000))
            ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            ev0.record()
            for _ in range(n):
                graph.replay()
            ev1.record()
            torch.cuda.synchronize()
            pods[k].append(ev0.elapsed_time(ev1))
            if not torch.equal(lp.outs.node, ref[0]):
                print(f"extension graph replays differ ({k})", file=sys.stderr)
                return 1
    for k, (lp, c, graph) in graphs.items():
        print(f"extension graph, {k}, {n} replays from the template, the stream primed: "
              f"{min(pods[k]) * 1e3 / n:.3f} us of device a pod (runs "
              f"{[round(x * 1e3 / n, 3) for x in pods[k]]}); outputs equal", flush=True)
        step.copy_template(c, tmpl)
        lp.cursor.fill_(0)
        torch.cuda.synchronize()
        try:
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(n):
                    graph.replay()
                torch.cuda.synchronize()
            kernels = sorted(((e.key, e.count, getattr(e, "device_time_total", 0.0))
                              for e in prof.key_averages()), key=lambda x: -x[2])
        except RuntimeError as err:  # the sandboxed card may refuse CUPTI
            kernels = []
            print(f"extension graph: the profiler failed ({err})", flush=True)
        busy = sum(x[2] for x in kernels)
        if not busy:
            print("extension graph, kernel times by name: not measured (the profiler saw no "
                  "device time)", flush=True)
        else:
            print(f"extension graph, {k}, kernel times by name over {n} replays: "
                  f"{busy / n:.3f} us of kernels a pod, {len(kernels)} names; "
                  + "; ".join(f"{name[:60]} x{cnt / n:g} {t / n:.3f} us a pod"
                              for name, cnt, t in kernels[:24]), flush=True)
    del graphs

    if args.cycles:
        for k, (name, hrs) in sides.items():
            cyc = torch.zeros((1, len(step.PHASES)), dtype=torch.int64, device=dev)
            _, per, _, _ = alone(name, hrs, cyc)
            print(f"extension launches, {k}: cycles a one-pod launch by phase "
                  + ", ".join(f"{ph} {v:.1f}" for ph, v in zip(step.PHASES, per.tolist()))
                  + f"; total {float(per.sum()):.1f}", flush=True)
        use("this")
        c = sched.lane_carry(tmpl, 1)
        cyc = torch.zeros((1, len(step.PHASES)), dtype=torch.int64, device=dev)
        ok = torch.cat([r[0] for r in rec], 1)
        raw = torch.cat([r[1] for r in rec], 1)
        step.plain_step_cuda(arrs, active, hoist, inv, c, cfg, 0, n, template=tmpl,
                             phase_cycles=cyc, ext_ok=ok, ext_raw=raw)
        per = (cyc[0].double() / n).tolist()
        print(f"extension scan (one launch over the {n} pods, the same rows), this: cycles a "
              "pod by phase " + ", ".join(f"{ph} {v:.1f}" for ph, v in zip(step.PHASES, per))
              + f"; total {sum(per):.1f}; plan C={step.LAST_PLAN.cluster} "
              f"threads={step.LAST_PLAN.threads}", flush=True)
    return 0


def waves_ab(args, torch, sched, step, sides, order, use, other_text) -> int:
    """--waves: the wave path on the pools preset, at one lane (reasons
    on, as simulate() runs it) and at 64 lanes (reasons off, as the
    bench's schedule_lanes runs it)."""
    import numpy as np

    from open_simulator_tpu_torch.engine import waves as waves_mod
    from open_simulator_tpu_torch.kernels import wave
    from open_simulator_tpu_torch.testing.synthetic import (
        synthetic_snapshot,
        wave_pools_snapshot,
    )

    dev = torch.device("cuda")
    snap = synthetic_snapshot(1024, 10240, pools=32)
    n_pods = snap.n_pods
    arrs = sched.device_arrays(snap.arrays, dev)
    inv = sched.inv_alloc_of(arrs.alloc)
    looped = hasattr(sched, "WAVE_LOOP")  # this tree's loop replays a CUDA graph
    for label, n_lanes, reasons in (("1 lane", 1, True), ("64 lanes", 64, False)):
        cfg = sched.make_config(snap, fail_reasons=reasons)
        plan = waves_mod.waves_for(snap.arrays, cfg)
        (lo, hi, kind, w), = plan.segments
        assert kind == waves_mod.GRID and lo == 0 and hi == n_pods, plan.segments
        n_waves = (hi - lo) // w
        masks_np = np.ones((n_lanes, snap.n_nodes), bool)
        masks = torch.from_numpy(masks_np).to(dev)
        hoist = sched.hoist_of(arrs, masks)
        tmpl = sched.init_state(arrs, cfg)
        frozen = {n: [] for n in sides}
        merges, outs, plans, inputs = [], {}, {}, {n: {} for n in sides}
        merge_inputs: dict = {}
        for _ in range(args.rounds):
            for name in order:
                use(name)
                st = sched.lane_carry(tmpl, n_lanes)
                step.copy_template(st, tmpl)
                evs = [[torch.cuda.Event(enable_timing=True) for _ in range(3)]
                       for _ in range(n_waves)]
                nodes = []
                for j, w0 in enumerate(range(lo, hi, w)):
                    if j % 16 == 0:
                        torch.cuda.synchronize()
                        torch.cuda._sleep(int(10 * 1_980_000))
                    evs[j][0].record()
                    out = step.plain_step_cuda(arrs, masks, hoist, inv, st, cfg, w0, w0 + w,
                                               frozen=True, inputs=inputs[name])
                    evs[j][1].record()
                    wave.wave_merge_cuda(arrs, cfg, st, w0, w0 + w, out[0], None,
                                         inputs=merge_inputs)
                    evs[j][2].record()
                    nodes.append(out[0])
                torch.cuda.synchronize()
                frozen[name].append(sum(a.elapsed_time(b) for a, b, _ in evs) / n_waves)
                merges.append(sum(b.elapsed_time(c) for _, b, c in evs) / n_waves)
                outs[name] = (torch.cat(nodes, 1), [getattr(st, f).clone()
                                                    for f in sched.STATE_FIELDS])
                plans[name] = step.LAST_PLAN
        for name in sides[1:]:
            a, b = outs["other"], outs[name]
            if not (torch.equal(a[0], b[0]) and all(torch.equal(x, y)
                                                    for x, y in zip(a[1], b[1]))):
                print(f"waves, {label}: {name} and other differ", file=sys.stderr)
                return 1
        for name in sides:
            pl = plans[name]
            grp = getattr(pl, "group", 1)
            clusters = n_lanes * -(-w // grp)
            t = min(frozen[name])
            print(f"waves, {label}, {n_waves} waves of {w}, frozen launch, {name}: "
                  f"{t * 1e3:.3f} us a launch (min of {len(frozen[name])} runs, each the mean "
                  f"of its {n_waves} launches; {t / min(frozen['other']) - 1:+.4f} against "
                  f"other); runs {[round(x * 1e3, 3) for x in frozen[name]]}; plan "
                  f"C={pl.cluster} threads={pl.threads} G={grp} clusters={clusters} "
                  f"resident_clusters={pl.resident} rounds={-(-clusters // max(pl.resident, 1))} "
                  f"staged={step.placement_name(pl)} smem={pl.smem}; outputs and carry equal",
                  flush=True)
        print(f"waves, {label}, merge (this tree's wave_merge): {min(merges) * 1e3:.3f} us a "
              f"launch (min of {len(merges)} runs)", flush=True)
        if n_lanes == 1:
            # this tree's frozen launches with the plan held to each cluster
            # size (the plan takes the smallest whose threads hold a node
            # each and whose clusters all fit at once)
            use("this")
            real_sizes = step.CLUSTER_SIZES
            try:
                for c in real_sizes:
                    step.CLUSTER_SIZES = (c,)
                    ins = {}
                    # (a first pass converts the inputs and builds the plan)
                    for _ in range(2):
                        st = sched.lane_carry(tmpl, n_lanes)
                        step.copy_template(st, tmpl)
                        ms, nodes = [], []
                        for j, w0 in enumerate(range(lo, hi, w)):
                            if j % 16 == 0:
                                torch.cuda.synchronize()
                                torch.cuda._sleep(int(10 * 1_980_000))
                            ev0 = torch.cuda.Event(enable_timing=True)
                            ev1 = torch.cuda.Event(enable_timing=True)
                            ev0.record()
                            out = step.plain_step_cuda(arrs, masks, hoist, inv, st, cfg, w0,
                                                       w0 + w, frozen=True, inputs=ins)
                            ev1.record()
                            wave.wave_merge_cuda(arrs, cfg, st, w0, w0 + w, out[0], None,
                                                 inputs=merge_inputs)
                            ms.append((ev0, ev1))
                            nodes.append(out[0])
                        torch.cuda.synchronize()
                    same = torch.equal(torch.cat(nodes, 1), outs["this"][0])
                    pl = step.LAST_PLAN
                    print(f"waves, {label}, this, clusters held to {c} blocks: "
                          f"{sum(a.elapsed_time(b) for a, b in ms) / n_waves * 1e3:.3f} us a "
                          f"launch; plan C={pl.cluster} threads={pl.threads} "
                          f"nodes/thread={-(-pl.slice_len // pl.threads)} "
                          f"resident_clusters={pl.resident}; outputs equal: {same}",
                          flush=True)
            finally:
                step.CLUSTER_SIZES = real_sizes
        if args.cycles:
            for name in sides:
                use(name)
                st = sched.lane_carry(tmpl, n_lanes)
                step.copy_template(st, tmpl)
                tot = torch.zeros((len(step.PHASES),), dtype=torch.float64)
                pods = 0
                try:
                    for w0 in range(lo, hi, w):
                        cyc = torch.zeros((n_lanes, len(step.PHASES)), dtype=torch.int64,
                                          device=dev)
                        step.plain_step_cuda(arrs, masks, hoist, inv, st, cfg, w0, w0 + w,
                                             frozen=True, phase_cycles=cyc)
                        tot += cyc[0].double().cpu()
                        pods += min(getattr(step.LAST_PLAN, "group", 1), w)
                except RuntimeError as err:  # a frozen form without the cycle counts
                    print(f"waves, {label}, {name}: no cycle counts ({err})", flush=True)
                    continue
                per = (tot / pods).tolist()
                print(f"waves, {label}, {name}: cycles a pod by phase (the lane's first "
                      f"cluster, {pods // n_waves} pods of it a wave) "
                      + ", ".join(f"{ph} {v:.1f}" for ph, v in zip(step.PHASES, per))
                      + f"; total {sum(per):.1f}", flush=True)
        # the wave loop's wall a wave, in turns: this tree's graph path, its
        # eager loop, the parent's loop (the other source's frozen launches,
        # a merge and the slice copies a wave)
        def this_loop(graph):
            use("this")
            carry = sched.lane_carry(tmpl, n_lanes)
            kw = {"graph": graph} if looped else {}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = sched._run_wave_plan(arrs, masks, hoist, inv, carry, tmpl, cfg, plan, 0,
                                       n_pods, **kw)
            torch.cuda.synchronize()
            return time.perf_counter() - t0, got[0], carry

        def parent_loop():
            # the parent's _run_wave_plan on a GRID: a plain_step call, a
            # merge and the eight slice copies (put) a wave
            use("other")
            carry = sched.lane_carry(tmpl, n_lanes)
            step.copy_template(carry, tmpl)
            g_w, lw = step.pick_widths(arrs, cfg)
            k_top, c_parts = sched.topk_widths(arrs, cfg)
            i32 = torch.int32
            fail = (torch.empty((n_lanes, n_pods, cfg.n_ops), dtype=i32, device=dev)
                    if cfg.fail_reasons else None)
            bufs = [torch.empty((n_lanes, n_pods), dtype=i32, device=dev), fail,
                    torch.empty((n_lanes, n_pods), dtype=i32, device=dev),
                    torch.empty((n_lanes, n_pods, g_w), dtype=i32, device=dev),
                    torch.empty((n_lanes, n_pods, lw), dtype=i32, device=dev),
                    torch.empty((n_lanes, n_pods, k_top), dtype=i32, device=dev),
                    torch.empty((n_lanes, n_pods, k_top), dtype=torch.float32, device=dev),
                    torch.empty((n_lanes, n_pods, c_parts, k_top), dtype=torch.float32,
                                device=dev)]
            ins, m_ins = {}, {}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for w0 in range(lo, hi, w):
                out = step.plain_step_cuda(arrs, masks, hoist, inv, carry, cfg, w0, w0 + w,
                                           frozen=True, inputs=ins)
                wave.wave_merge_cuda(arrs, cfg, carry, w0, w0 + w, out[0], None,
                                     inputs=m_ins)
                for i, (dst, src) in enumerate(zip(bufs, out)):
                    if i != 1 or cfg.fail_reasons:
                        dst[:, w0:w0 + w] = src
            torch.cuda.synchronize()
            return time.perf_counter() - t0, bufs[0], carry

        loops = {"this, eager": lambda: this_loop(False), "other, its loop": parent_loop}
        if looped:
            loops = {"this, graph": lambda: this_loop(True), **loops}
        names = list(loops)
        walls = {k: [] for k in names}
        ref = None
        for _ in range(args.rounds):
            for k in names + names[::-1]:
                wall, node, carry = loops[k]()
                walls[k].append(wall)
                got = (node.clone(), [getattr(carry, f).clone() for f in sched.STATE_FIELDS])
                if ref is None:
                    ref = got
                elif not (torch.equal(ref[0], got[0])
                          and all(torch.equal(x, y) for x, y in zip(ref[1], got[1]))):
                    print(f"wave loop, {label}: {k} differs", file=sys.stderr)
                    return 1
        for k in names:
            t = min(walls[k])
            print(f"wave loop, {label}, {n_waves} waves, {k}: {t * 1e3 / n_waves:.3f} ms of "
                  f"wall a wave (min of {len(walls[k])}; runs "
                  f"{[round(x * 1e3 / n_waves, 3) for x in walls[k]]}); outputs and carry equal",
                  flush=True)
        if looped:
            # the graph's replays alone: the host's wall a wave (synchronised
            # at the end), then the device's (the stream primed), and the
            # card's idle share in the replays
            use("this")
            carry = sched.lane_carry(tmpl, n_lanes)
            step.copy_template(carry, tmpl)
            runs = sched.WaveRuns(arrs, masks, hoist, inv, carry, cfg, 0, n_pods)
            runs.cursor.fill_(lo)
            runs.wave(w)
            graph = runs.capture(w)
            n = n_waves - 1
            r_walls, devs = [], []
            for _ in range(args.rounds):
                step.copy_template(carry, tmpl)
                runs.cursor.fill_(lo + w)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(n):
                    graph.replay()
                torch.cuda.synchronize()
                r_walls.append((time.perf_counter() - t0) / n)
                step.copy_template(carry, tmpl)
                runs.cursor.fill_(lo + w)
                torch.cuda.synchronize()
                torch.cuda._sleep(int(0.02 * n * 1_980_000))
                ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                ev0.record()
                for _ in range(n):
                    graph.replay()
                ev1.record()
                torch.cuda.synchronize()
                devs.append(ev0.elapsed_time(ev1) / n)
            wall, dev_ms = min(r_walls), min(devs)
            print(f"wave loop, {label}, this, the graph's {n} replays: {wall * 1e6:.3f} us of "
                  f"wall a wave, {dev_ms * 1e3:.3f} us of device a wave (the stream primed); "
                  f"the card idles {1 - dev_ms * 1e-3 / wall:.4f} of the replays; runs "
                  f"wall {[round(x * 1e6, 3) for x in r_walls]} device "
                  f"{[round(x * 1e3, 3) for x in devs]}", flush=True)
    # this tree's plan for each frozen build at 64 lanes, on clusters of the
    # preset's size
    use("this")
    for over, name in (({}, "<0,0>"), ({"interpod": True}, "<1,0>"), ({"gpu": True}, "<0,1>"),
                       ({"gpu": True, "interpod": True}, "<1,1>")):
        wsnap = wave_pools_snapshot(1024, 2048, 32, **over)
        wcfg = sched.make_config(wsnap, fail_reasons=False)
        for mode, c in (("", wcfg), ("+explain", wcfg._replace(explain_topk=3))):
            warrs = sched.device_arrays(wsnap.arrays, dev)
            wmask = torch.ones((64, wsnap.n_nodes), dtype=torch.bool, device=dev)
            st = sched.lane_carry(sched.init_state(warrs, c), 64)
            step.copy_template(st, sched.init_state(warrs, c))
            step.plain_step_cuda(warrs, wmask, sched.hoist_of(warrs, wmask),
                                 sched.inv_alloc_of(warrs.alloc), st, c, 0, 32, frozen=True)
            torch.cuda.synchronize()
            pl = step.LAST_PLAN
            grp = getattr(pl, "group", 1)
            clusters = 64 * -(-32 // grp)
            print(f"frozen build {step.instantiation(c, st, frozen=True)} ({name}{mode}), 64 "
                  f"lanes x 32 pods: C={pl.cluster} threads={pl.threads} G={grp} "
                  f"clusters={clusters} resident_clusters={pl.resident} "
                  f"rounds={-(-clusters // max(pl.resident, 1))} "
                  f"staged={step.placement_name(pl)} smem={pl.smem}", flush=True)
    return 0


class _DeviceBytes:
    """`n` bytes of device memory at `ptr`, for ``torch.as_tensor``."""

    def __init__(self, ptr: int, n: int):
        self.__cuda_array_interface__ = {"shape": (n,), "typestr": "|u1", "data": (ptr, False),
                                         "version": 2}


def fleet_ab(args, torch, sched, step, sides, order, use, record) -> int:
    """--fleet: fleet-16's batched launch of each side, the kernel alone
    between CUDA events, in turns; the other side's lanes read as StepArgs
    of `record` bytes each."""
    import shutil

    import numpy as np

    from open_simulator_tpu_torch.campaign import fleet as fleet_mod
    from open_simulator_tpu_torch.campaign import lanes as lanes_mod
    from open_simulator_tpu_torch.campaign import runner

    dev = torch.device("cuda")
    root = os.path.join(HERE, "build", "torch_ab", "fleet")
    shutil.rmtree(root, ignore_errors=True)
    # alternate clusters are the large ones: LANES large, LANES - 1 small
    fleet_mod.write_synthetic_fleet(root, n_clusters=2 * args.fleet - 1, nodes=1024, pods=10240)
    opts = runner.CampaignOptions(fleet=root, checkpoint=False)
    apps = runner._scenario_apps(opts)
    preps = [lanes_mod._prepare(e, apps, opts) for e in fleet_mod.discover_fleet(root)]
    n_pods = max(p.arrs.req.shape[0] for p in preps)
    preps = [p for p in preps if p.arrs.req.shape[0] == n_pods]
    cfg, lanes = preps[0].cfg, []
    k = cfg.forced_prefix
    for p in preps:
        arrs = sched.device_arrays(p.arrs, dev)
        active = torch.from_numpy(np.asarray(p.arrs.active).copy()).to(dev)[None]
        tmpl = sched.init_state(arrs, cfg)
        if k:
            tmpl = sched.apply_forced_prefix(arrs, cfg, tmpl, k)
        tmpl = sched.SimState(**{f: getattr(tmpl, f).contiguous() for f in sched.STATE_FIELDS})
        lanes.append(step.FleetLane(arrs, active, sched.hoist_of(arrs, active),
                                    sched.inv_alloc_of(arrs.alloc), sched.lane_carry(tmpl, 1),
                                    tmpl))
    full = ctypes.sizeof(step.StepArgs)
    real_fire = step._fire
    times, outs, plans = {name: [] for name in sides}, {}, {}

    def timed_fire(cut):
        def fire(lib, a, plan, dev_, what):
            keep = None
            if cut < full:
                blob = torch.as_tensor(_DeviceBytes(a.lanes, a.s * full), device=dev_)
                keep = blob.view(a.s, full)[:, :cut].contiguous()
                a.lanes = keep.data_ptr()
            ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            ev0.record()
            real_fire(lib, a, plan, dev_, what)
            ev1.record()
            torch.cuda.synchronize()
            fire.ms = ev0.elapsed_time(ev1)
            del keep
        return fire

    try:
        for _ in range(args.rounds):
            for name in order:
                use(name)
                step._fire = fire = timed_fire(record if name == "other" else full)
                out = step.plain_step_fleet_cuda(lanes, cfg, k, n_pods)
                times[name].append(fire.ms)
                outs[name] = ([o.node.clone() for o in out],
                              [[getattr(ln.state, f).clone() for f in sched.STATE_FIELDS]
                               for ln in lanes])
                plans[name] = step.LAST_PLAN
    finally:
        step._fire = real_fire
    a = outs["other"]
    for name in sides[1:]:
        b = outs[name]
        if not (all(torch.equal(x, y) for x, y in zip(a[0], b[0]))
                and all(torch.equal(x, y) for la, lb in zip(a[1], b[1]) for x, y in zip(la, lb))):
            print(f"fleet launch: {name} and other differ", file=sys.stderr)
            return 1
    for name in sides:
        t, pl = min(times[name]), plans[name]
        print(f"fleet launch, {len(lanes)} lanes x {n_pods - k} pods (1,024 nodes), {name}: min "
              f"{t:.3f} ms median {statistics.median(times[name]):.3f} ms "
              f"({t / min(times['other']) - 1:+.4f} against other by the minima); runs "
              f"{[round(x, 3) for x in times[name]]}; plan C={pl.cluster} threads={pl.threads} "
              f"slice={pl.slice_len} staged={step.placement_name(pl)} smem={pl.smem}; "
              "placements and carries equal", flush=True)
    shutil.rmtree(root, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
