#!/usr/bin/env python3
"""Time two builds of the port's ``plain_step`` kernel in one process, on
one card: this tree's ``csrc/plain_step.cu`` and another source of it
(for example a parent commit's), on the same inputs, in turns.

    python3 tools/torch_ab_plain_step.py --other <dir> [--rich | --devres] [--weights]
        [--topk K [--prefix PODS]] [--cycles] [--variant NAME=PLACEMENT ...]
        [--also NAME=SOURCE ...] [--seed S] [--ext PODS | --fleet LANES]

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

``--ext PODS`` times the extension loop's launches instead (northstar-ext:
one lane, the five ``synthetic_extensions`` ops, one launch a pod through
``kernels/step.pod_launcher``): the first PODS pods' extension rows are
recorded against the live carry once, then each side replays their PODS
launches from the template with the stream primed (the device alone),
in turns; printed as us of device a launch.

``--fleet LANES`` times fleet-16's batched launch instead: LANES of
``write_synthetic_fleet``'s 1,024 x 10,240 clusters through the
campaign's host pipeline (``campaign/lanes._prepare``), each side's fleet
kernel (``kernels/step.plain_step_fleet_cuda``) over every pod after the
forced prefix, the kernel alone between CUDA events, in turns; every
lane's placements and carry must be equal.

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
    if explain:
        kinds["explain"] = build.VARIANTS["plain_step_explain"][1]
    procs = {}
    for name, src in sources.items():
        for kd, extra in kinds.items():
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
    other_stages = "RES_STAGE_POD" in other_text

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    snap = None
    if not args.fleet:  # the fleet's clusters are fleet_ab's
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
    sides = ["other", "this", *variants, *[n for n in sources if n not in ("other", "this")]]
    order = sides + sides[::-1][1:-1] + ["other"] if len(sides) > 2 else [
        "other", "this", "this", "other"]

    def use(name):
        src = "this" if name in variants else name
        step._library = lambda explain=False, wide=False, lib=libs[src]: lib[
            "explain" if explain else "plain"]
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
            return ext_ab(args, torch, sched, step, snap, sides, order, use)
        if args.fleet:
            # a source from before the staged regions reads a StepArgs that
            # ends where their pointers begin (fields are only appended)
            record = (ctypes.sizeof(step.StepArgs) if other_stages
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
        step.PLACEMENTS = real_places
    return 0


def ext_ab(args, torch, sched, step, snap, sides, order, use) -> int:
    """--ext: the extension loop's launches of each side, replayed from the
    recorded rows with the stream primed, in turns."""
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
    launchers, outs, carries, rec = {}, {}, {}, []
    for name in sides:
        use(name)
        carries[name] = sched.lane_carry(tmpl, 1)
        step.copy_template(carries[name], tmpl)
        outs[name] = step.StepOutputs(*(torch.empty((1, n) + shape, dtype=dt, device=dev)
                                        for shape, dt in (((), torch.int32),
                                                          ((cfg.n_ops,), torch.int32),
                                                          ((), torch.int32), ((0,), torch.int32),
                                                          ((0,), torch.int32), ((0,), torch.int32),
                                                          ((0,), torch.float32),
                                                          ((0, 0), torch.float32))))
        launchers[name] = step.pod_launcher(arrs, active, hoist, inv, carries[name], cfg,
                                            outs[name], 0, inputs={})
    use("other")
    fields = tuple(getattr(carries["other"], f) for f in sched.STATE_FIELDS)
    for p in range(n):  # the rows, against the other side's live carry
        ok, raw = rows_of(fields, arrs, sched.PodSlice(cols, p))
        rec.append((ok[:, None], raw[:, None]))
        launchers["other"](p, *rec[-1])
    torch.cuda.synchronize()
    times = {name: [] for name in sides}
    plans = {}
    for _ in range(args.rounds):
        for name in order:
            use(name)
            step.copy_template(carries[name], tmpl)
            torch.cuda.synchronize()
            ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(int(0.1 * n * 1_980_000))  # the launches queue behind the spin
            ev0.record()
            for p in range(n):
                launchers[name](p, *rec[p])
            ev1.record()
            torch.cuda.synchronize()
            times[name].append(ev0.elapsed_time(ev1))
            plans[name] = step.LAST_PLAN
    for name in sides[1:]:
        if not torch.equal(outs[name].node, outs["other"].node):
            print(f"extension launches: {name} and other differ", file=sys.stderr)
            return 1
    for name in sides:
        t = min(times[name])
        print(f"extension loop, {n} one-pod launches, {name}: min {t:.3f} ms "
              f"({t * 1e3 / n:.3f} us a launch; {t / min(times['other']) - 1:+.4f} against "
              f"other); runs {[round(x, 3) for x in times[name]]}; plan C={plans[name].cluster} "
              f"threads={plans[name].threads} staged={step.placement_name(plans[name])}; "
              "outputs equal", flush=True)
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
