#!/usr/bin/env python3
"""Smoke run of open_simulator_tpu_torch on one NVIDIA card.

    python3 chip_smoke.py

Builds the package's CUDA kernels from ``open_simulator_tpu_torch/csrc``,
holds each kernel bit for bit against its plain torch version on the card,
then drives the main paths — ``core.simulate()`` on the north-star cluster
(5,120 nodes x 51,200 pods, the reference's ``synthetic_snapshot`` shape)
and on its rich twin (the reference's ``northstar-rich``: host ports, pod
affinity, anti-affinity, hard and hostname spread, the interpod
preference, taints) — and checks that each ran through the kernels and
that its answer is right.

Phases, in order (any failure exits nonzero; each prints its wall time):

1. the card's name and power limit (nvidia-smi);
2. the kernel build, one nvcc per source, started together;
3. kernel vs plain step, exact equality of node, fail counts, feasible
   counts and the final carry (headroom, dom_count, group_count,
   ports_used, term_block, pref_paint), on: the synthetic cluster at
   1,024 x 10,240 with mid-sequence forced pods (dom_count carry); a
   512 x 4,096 cluster with hostname and zone soft spread, taints,
   unschedulable nodes, host ports and a leading nodeName run
   (group_count carry); that cluster as one 4-lane launch with a
   different active mask per lane; the rich cluster at 1,024 x 10,240
   with 10% of the pods pre-bound; the rich cluster at 512 x 4,096 in the
   dense form (slot_paint off); and the rich cluster at 512 x 1,024 as one
   4-lane launch;
4. the main paths, non-rich then rich: launch counts reset, ``simulate()``
   at full size, counts read; then the kernel timed on the path's arrays
   (its placements must equal simulate()'s), the kernel and the plain
   step compared over the first 2,048 pods from a fresh carry and over the
   last 2,048 from the kernel's own carry, and on the rich path a host
   check that no pod shares its node with a pod its hostname
   anti-affinity term names;
5. one JSON line describing each kernel, then the device line.

Needs CUDA: without it, or run alone outside the repository, it exits
nonzero and prints no result.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, fp32 non-tensor FLOP/s
PEAK_BYTES_S = 3.35e12
PEAK_F32_S = 67e12
# pods of the main paths' kernel-vs-plain comparison (the plain step costs
# milliseconds a pod on the card)
PARITY_PREFIX = 2048


_T0 = time.perf_counter()


def log(msg: str) -> None:
    print(f"[{time.perf_counter() - _T0:7.1f}s] {msg}", flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def lanes_state(sched, arrs, cfg, n_lanes):
    """Fresh carry with the forced prefix folded in, stacked for n_lanes."""
    st = sched.init_state(arrs, cfg)
    if cfg.forced_prefix:
        st = sched.apply_forced_prefix(arrs, cfg, st, cfg.forced_prefix)
    return sched.SimState(**{f: getattr(st, f)[None].repeat(
        (n_lanes,) + (1,) * getattr(st, f).dim()).contiguous()
        for f in sched.STATE_FIELDS})


def clone_state(sched, st):
    return sched.SimState(**{f: getattr(st, f).clone() for f in sched.STATE_FIELDS})


CARRY = ("headroom", "dom_count", "group_count", "ports_used", "term_block", "pref_paint")


def compare(torch, out_k, out_p, st_k, st_p):
    """(all equal, max abs difference over outputs and carry)."""
    equal, err = True, 0.0
    pairs = list(zip(out_k, out_p)) + [(getattr(st_k, f), getattr(st_p, f)) for f in CARRY]
    for a, b in pairs:
        equal &= torch.equal(a, b)
        if a.numel():
            err = max(err, float((a.float() - b.float()).abs().max()))
    return equal, err


def parity(torch, sched, step, label, arrs_np, cfg, active_np, n_pods=None, start=None):
    """Kernel vs plain step on the card, from the same carry, over the pods
    after the forced prefix (the first `n_pods` of them if set). The carry
    is fresh, or with `start` = (first pod, lane-stacked state) that state.
    Returns (plain seconds, kernel seconds, max abs error, kernel outputs)."""
    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    arrs = sched.device_arrays(arrs_np, dev)
    active = torch.from_numpy(active_np).to(dev)
    if active.dim() == 1:
        active = active[None]
    hoist = sched.hoist_of(arrs, active)
    inv = sched.inv_alloc_of(arrs.alloc)
    if start is None:
        p0, base = cfg.forced_prefix, lanes_state(sched, arrs, cfg, active.shape[0])
    else:
        p0, base = start
    p1 = arrs.req.shape[0] if n_pods is None else min(p0 + n_pods, arrs.req.shape[0])
    st_k, st_p = clone_state(sched, base), clone_state(sched, base)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out_k = step.plain_step_cuda(arrs, active, hoist, inv, st_k, cfg, p0, p1)
    torch.cuda.synchronize()
    t_k = time.perf_counter() - t0
    t0 = time.perf_counter()
    out_p = step.plain_step_torch(arrs, active, hoist, inv, st_p, cfg, p0, p1)
    torch.cuda.synchronize()
    t_p = time.perf_counter() - t0
    equal, err = compare(torch, out_k, out_p, st_k, st_p)
    n_sched = int((out_k[0] >= 0).sum())
    log(f"parity {label}: lanes={active.shape[0]} pods={p1 - p0} (after a {p0}-pod "
        f"prefix) scheduled={n_sched} fail_counts_sum={int(out_k[1].sum())} "
        f"kernel_s={t_k:.4f} plain_s={t_p:.2f} equal={equal} max_abs_err={err} "
        f"phase_s={time.perf_counter() - t_phase:.1f}")
    if not equal:
        raise SystemExit(f"parity {label}: kernel and plain step disagree")
    return t_p, t_k, err, out_k


def step_work(sched, a, cfg, p0, p1, out):
    """(bytes, operations) the step function needs for pods [p0, p1) of
    one lane, given that run's outputs `out` = (node [P'], fail counts
    [P', OPS], feasible counts [P']) as numpy.

    Bytes: every input read once and every output written once — node
    rows, pod rows and term lists, the hoisted eligibility tables, the
    carry read and written, the outputs. Operations: counted from the
    kernel's source for this run's data, under the launch's gates.
    Per (pod, node): one add per carry column phase 0b reads (the
    non-hostname columns, plus hostname affinity and hard-spread
    columns), the node-affinity and taint normalizer updates, the
    selectHost compare. Per node that reaches a filter (the feasible
    nodes plus those charged to that filter or a later one): one test per
    gated row, per pod port, per resource, per affinity, anti-affinity
    and hit term, three per hard-spread constraint; a node that fails a
    filter is charged only what its first failing term needs. Per
    feasible (pod, node): the resource score (4, + 7 balanced, + 6 least,
    + 12 most), the count, and per live score row its raw value, its two
    normalizer updates and its final add — interpod: one add per hit
    preferred term and three per valid term, + 2 + 4; soft spread: four
    per constraint + 2 (a node that holds every key does three more adds
    and two normalizer updates, not counted); Simon: 4R + 1 + 2 + 4;
    node affinity 3, taint 4. Per pod: D compares per hard-spread minimum
    taken over domains. Per bound pod: R subtractions, and per painted
    term one compare per node plus one add per node of the bound node's
    domain (a hostname-keyed term: one add)."""
    import numpy as np

    node, fail, feas = (np.asarray(x, dtype=np.int64) for x in out)
    sl = slice(p0, p1)
    steps = p1 - p0
    n, r = a.alloc.shape
    c = a.class_affinity.shape[0]
    k1, _, d = a.topo_onehot.shape
    sg, pt = a.match_groups.shape[1], a.ports.shape[1]
    cs, k = a.spread_group.shape[1], a.has_key.shape[0]
    aw, bw, ap = a.aff_group.shape[1], a.anti_group.shape[1], a.pref_group.shape[1]
    t, t2 = a.own_terms.shape[1], a.hit_pref.shape[1]
    gcb = _gc_bytes(cfg)
    use_na, use_tt, use_ip, use_sp, use_si = sched.score_rows(cfg)
    gc_path = cfg.needs_group_count

    def rows(x, on=True):
        return x[sl].reshape(steps, -1).sum(1).astype(np.int64) if on else np.zeros(steps, np.int64)

    def reach(op):
        return feas + fail[:, op:].sum(1)

    hard_m = a.spread_valid & a.spread_hard & cfg.enable_spread_hard
    soft_m = a.spread_valid & ~a.spread_hard & use_sp
    col_reads = np.zeros(steps, np.int64)
    if gc_path:
        col_reads = (rows(a.aff_valid, cfg.enable_pod_affinity)
                     + rows(a.anti_valid & (a.anti_key > 0), cfg.enable_anti_affinity)
                     + rows((soft_m & (a.spread_key > 0)) | hard_m)
                     + rows(a.pref_valid & (a.pref_key > 0), use_ip))
    dom_mins = rows(hard_m & ((a.spread_key > 0) | (not gc_path)))
    aff_v = rows(a.aff_valid, cfg.enable_pod_affinity)
    anti_v = rows(a.anti_valid, cfg.enable_anti_affinity)
    hits = rows(a.hit_terms, cfg.enable_anti_affinity)
    hard, soft = rows(hard_m), rows(soft_m)
    pref_v, pref_hits = rows(a.pref_valid, use_ip), rows(a.hit_pref, use_ip)

    per_pod = n * (col_reads + use_na + use_tt + 1) + d * dom_mins
    filters = (reach(0) * cfg.enable_unsched + reach(1) * cfg.enable_class_aff
               + reach(2) * cfg.enable_class_taint
               + reach(3) * rows(a.ports, cfg.enable_ports)
               + sum((i + 1) * fail[:, 4 + i] for i in range(r)) + r * reach(4 + r)
               + (aff_v * reach(5 + r) + fail[:, 4 + r]) * cfg.enable_pod_affinity
               + ((anti_v + hits) * reach(6 + r) + fail[:, 5 + r]) * cfg.enable_anti_affinity
               + 3 * (hard * feas + fail[:, 6 + r] * cfg.enable_spread_hard))
    per_feasible = (4 + 7 * bool(cfg.w_balanced) + 6 * bool(cfg.w_least)
                    + 12 * bool(cfg.w_most) + 1 + 3 * use_na + 4 * use_tt
                    + (pref_hits + 3 * pref_v + 6) * use_ip + (4 * soft + 2) * use_sp
                    + (4 * r + 7) * use_si)

    # the bind's paints: a term under key k > 0 costs a compare per node and
    # an add per node of the bound node's domain; under the hostname key, one add
    has = a.topo_onehot.any(2)
    node_dom = np.where(has, a.topo_onehot.argmax(2), -1)              # [K1, N]
    dsize = a.topo_onehot.sum(1).astype(np.int64)                       # [K1, D]
    placed = node >= 0
    dom_at = node_dom[:, np.where(placed, node, 0)].T                    # [P', K1]
    size_at = np.where(dom_at >= 0, dsize[np.arange(k1)[None, :], np.maximum(dom_at, 0)], 0)
    cost = np.concatenate([np.ones((steps, 1), np.int64), n + size_at], 1)  # [P', K]
    paints = np.zeros(steps, np.int64)
    if cfg.enable_anti_affinity:
        own = a.own_terms[sl].astype(np.int64)
        paints += (own * cost[:, a.term_key.astype(np.int64)]).sum(1)
    if cfg.enable_pref:
        keys = a.pref_key[sl].astype(np.int64)
        paints += (a.pref_valid[sl] * np.take_along_axis(cost, keys, 1)).sum(1)
    ops = int((per_pod + filters + feas * per_feasible + placed * (r + paints)).sum())

    node_bytes = n * r * 4 + n + c * n * 10 + n * 4 + k1 * n * 4 + k * n + t * 4
    pod_bytes = (steps * (r * 4 + 12 + pt + sg + cs * 14 + aw * 10 + bw * 9 + ap * 17 + t2 + 8)
                 + 4 * int(hits.sum() + rows(a.own_terms, cfg.enable_anti_affinity).sum()))
    carry = (n * r * 4 + n * pt + k1 * d * sg * 4 + n * sg * gcb
             + (n * t * gcb if cfg.enable_anti_affinity else 0)
             + (n * t2 * 4 if cfg.enable_pref else 0))
    lane_bytes = n + k * 4 + c * n + c * k1 * d + c * k + 2 * carry
    out_bytes = steps * (4 + 4 + cfg.n_ops * 4)
    return node_bytes + pod_bytes + lane_bytes + out_bytes, ops


def _gc_bytes(cfg):
    if not cfg.needs_group_count:
        return 0
    return 2 if cfg.compact_carry else 4


def anti_affinity_violations(result):
    """Independent host check of simulate()'s placements: pairs (pod,
    other pod on its node) where the pod's required hostname anti-affinity
    term selects the other pod. Returns (violations, pods with a term)."""
    from open_simulator_tpu_torch.k8s.selectors import labels_match_selector

    bad, with_terms = 0, 0
    for ns in result.node_status:
        for pod in ns.pods:
            terms = [tm for tm in pod.pod_anti_affinity_required
                     if tm.topology_key == "kubernetes.io/hostname"]
            if not terms:
                continue
            with_terms += 1
            for other in ns.pods:
                if other is pod:
                    continue
                for tm in terms:
                    if (other.meta.namespace in tm.namespaces
                            and labels_match_selector(other.meta.labels, tm.selector)):
                        bad += 1
    return bad, with_terms


def main_path(torch, sched, step, simulate, cluster_of, label, rich):
    """Drive simulate() on one full-size cluster with the launch counts
    reset, then time and check the kernel on the path's arrays."""
    t_phase = time.perf_counter()
    cluster = cluster_of(rich)
    for name in step.LAUNCHES:
        step.LAUNCHES[name] = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    result = simulate(cluster, [], device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(step.LAUNCHES)
    snap = result.snapshot
    n_pods = snap.n_pods
    log(f"main path {label}: simulate() {snap.n_nodes} nodes x {n_pods} pods "
        f"wall_s={wall:.3f} pods_per_s={n_pods / wall:.1f} us_per_pod={wall / n_pods * 1e6:.2f} "
        f"scheduled={len(result.scheduled_pods)} unscheduled={len(result.unscheduled_pods)} "
        f"launches={launches}")
    if launches["plain_step"] != 1:
        raise SystemExit(f"main path {label}: plain_step launched {launches} times, not once")
    if len(result.scheduled_pods) + len(result.unscheduled_pods) != n_pods:
        raise SystemExit(f"main path {label}: simulate() lost pods")
    cfg = sched.make_config(snap)
    if rich and not (cfg.enable_pod_affinity and cfg.enable_anti_affinity and cfg.enable_pref
                     and cfg.enable_spread_hard and cfg.spread_hostname):
        raise SystemExit(f"main path {label}: the inter-pod gates are not all on")
    if rich:
        bad, with_terms = anti_affinity_violations(result)
        log(f"main path {label}: host anti-affinity check: {with_terms} placed pods with a "
            f"hostname term, {bad} violations")
        if bad or not with_terms:
            raise SystemExit(f"main path {label}: host anti-affinity check failed")

    # the kernel alone on the main path's arrays
    dev = torch.device("cuda")
    arrs = sched.device_arrays(snap.arrays, dev)
    active = torch.from_numpy(snap.arrays.active).to(dev)[None]
    hoist = sched.hoist_of(arrs, active)
    inv = sched.inv_alloc_of(arrs.alloc)
    base = lanes_state(sched, arrs, cfg, 1)
    p0, p1 = cfg.forced_prefix, n_pods
    times = []
    for _ in range(3):
        st_k = clone_state(sched, base)
        ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        ev0.record()
        out_k = step.plain_step_cuda(arrs, active, hoist, inv, st_k, cfg, p0, p1)
        ev1.record()
        torch.cuda.synchronize()
        times.append(ev0.elapsed_time(ev1))
    kernel_ms = min(times)
    placed = {sp.pod.key: sp.node_name for sp in result.scheduled_pods}
    kern_nodes = out_k[0][0].cpu().numpy()
    kern_placed = {snap.pods[i].key: snap.node_names[int(nd)]
                   for i, nd in enumerate(kern_nodes, start=p0) if nd >= 0}
    if kern_placed != placed:
        raise SystemExit(f"main path {label}: the timed kernel run and simulate() "
                         "placed pods differently")
    if not bool(torch.isfinite(st_k.headroom).all()) or bool((st_k.headroom < 0).any()):
        raise SystemExit(f"main path {label}: carry has non-finite or negative headroom")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sched.schedule_pods(snap.arrays, snap.arrays.active, cfg, device="cuda")
    torch.cuda.synchronize()
    engine_s = time.perf_counter() - t0
    log(f"main path {label}: schedule_pods() wall_s={engine_s:.3f} (transfer, prefix fold, "
        f"hoist, one kernel launch); simulate() outside it: {wall - engine_s:.3f}s")
    feasible_pairs = int(out_k[2].sum())
    log(f"main path {label}: kernel ms={kernel_ms:.3f} (min of {len(times)}: "
        f"{[round(t, 3) for t in times]}) us_per_pod={kernel_ms * 1e3 / (p1 - p0):.3f} "
        f"feasible_pairs={feasible_pairs}")
    full = bound_of(step_work(sched, snap.arrays, cfg, p0, p1, lane0(out_k)))

    # kernel vs plain over the first PARITY_PREFIX pods from a fresh carry,
    # both timed, and over the last PARITY_PREFIX pods from the kernel's carry
    plain_s, _, err, out_f = parity(torch, sched, step, f"{label}-first-{PARITY_PREFIX}",
                                    snap.arrays, cfg, snap.arrays.active, n_pods=PARITY_PREFIX)
    q1 = min(p0 + PARITY_PREFIX, p1)
    st_k = clone_state(sched, base)
    ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    ev0.record()
    step.plain_step_cuda(arrs, active, hoist, inv, st_k, cfg, p0, q1)
    ev1.record()
    torch.cuda.synchronize()
    prefix_ms = ev0.elapsed_time(ev1)
    prefix = bound_of(step_work(sched, snap.arrays, cfg, p0, q1, lane0(out_f)))
    q_last = max(p1 - PARITY_PREFIX, p0)
    st_mid = clone_state(sched, base)
    step.plain_step_cuda(arrs, active, hoist, inv, st_mid, cfg, p0, q_last)
    _, _, err_last, _ = parity(torch, sched, step, f"{label}-last-{p1 - q_last}",
                               snap.arrays, cfg, snap.arrays.active, start=(q_last, st_mid))
    for name, (nbytes, flops, bound_ms, bound_by) in (("whole run", full), ("first pods", prefix)):
        log(f"main path {label}: bound of the {name}: bytes={nbytes} "
            f"({nbytes / PEAK_BYTES_S * 1e3:.4f} ms) ops={flops} "
            f"({flops / PEAK_F32_S * 1e3:.4f} ms) -> {bound_ms:.4f} ms, {bound_by}")
    log(f"main path {label}: the first {q1 - p0} pods: kernel {prefix_ms:.3f} ms, plain step "
        f"{plain_s * 1e3:.1f} ms; kernel share of the simulate() wall "
        f"{kernel_ms / (wall * 1e3):.4f}; phase_s={time.perf_counter() - t_phase:.1f}")
    return {
        "launches": launches["plain_step"], "pods": p1 - p0, "ms": kernel_ms, "ms_runs": times,
        "us_per_pod": kernel_ms * 1e3 / (p1 - p0), "bound_ms": full[2], "bound_by": full[3],
        "max_abs_err": max(err, err_last), "simulate_s": wall, "engine_s": engine_s,
        "scheduled": len(result.scheduled_pods),
        "same_pods": {"pods": q1 - p0, "ms": prefix_ms, "plain_ms": plain_s * 1e3,
                      "bound_ms": prefix[2], "bound_by": prefix[3]},
    }


def lane0(out):
    """The kernel's (node, fail counts, feasible counts) of lane 0, as numpy."""
    return tuple(x[0].cpu().numpy() for x in out)


def bound_of(work):
    """(bytes, ops) -> (bytes, ops, bound ms, what binds): the larger of the
    bytes over the memory rate and the operations over the fp32 rate."""
    nbytes, flops = work
    t_bytes, t_ops = nbytes / PEAK_BYTES_S * 1e3, flops / PEAK_F32_S * 1e3
    return (nbytes, flops) + ((t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations"))


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke run needs the card", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    try:
        from open_simulator_tpu_torch.core import simulate
        from open_simulator_tpu_torch.engine import scheduler as sched
        from open_simulator_tpu_torch.k8s.loader import ClusterResources, make_valid_node
        from open_simulator_tpu_torch.k8s.objects import Node, Pod
        from open_simulator_tpu_torch.encode.snapshot import encode_cluster
        from open_simulator_tpu_torch.kernels import build, step
        from open_simulator_tpu_torch.testing.synthetic import (
            soft_spread_cluster, synthetic_objects, synthetic_snapshot)
    except ImportError as e:
        print(f"chip_smoke: the open_simulator_tpu_torch package is missing ({e})",
              file=sys.stderr)
        return 1
    import numpy as np

    dev_name = torch.cuda.get_device_name(0)
    print(card_line(), flush=True)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device {dev_name}")

    # ---- 2. build
    t0 = time.perf_counter()
    build.build_all()
    log(f"build: {time.perf_counter() - t0:.1f}s for {build.kernel_names()}")
    for name, text in build.BUILD_LOG.items():
        for line in text.splitlines():
            if any(w in line for w in ("registers", "spill", "smem", "entry function")):
                log(f"build {name}: {line.strip()}")

    # ---- 3. kernel vs plain on the card
    errs = []
    snap_a = synthetic_snapshot(1024, 10240, rich=False, bound=0.1)
    cfg_a = sched.make_config(snap_a)
    if not (cfg_a.maintain_dom_count
            and (snap_a.arrays.forced_node[cfg_a.forced_prefix:] >= 0).any()):
        raise SystemExit("parity input a is not the dom_count path with mid-sequence forced pods")
    errs.append(parity(torch, sched, step, "synthetic-1024x10240-dom_count",
                       snap_a.arrays, cfg_a, snap_a.arrays.active)[2])

    nd, pd = soft_spread_cluster(512, 4096)
    snap_b = encode_cluster([make_valid_node(Node.from_dict(x)) for x in nd],
                            [Pod.from_dict(x) for x in pd])
    cfg_b = sched.make_config(snap_b)
    if not (cfg_b.needs_group_count and cfg_b.compact_carry and cfg_b.forced_prefix
            and cfg_b.enable_ports and cfg_b.enable_unsched and cfg_b.enable_class_taint):
        raise SystemExit("parity input b is not the group_count path it should be")
    errs.append(parity(torch, sched, step, "inline-512x4096-group_count",
                       snap_b.arrays, cfg_b, snap_b.arrays.active)[2])

    rng = np.random.RandomState(7)
    n_b = snap_b.n_nodes
    lanes = np.stack([np.ones(n_b, bool), np.arange(n_b) % 4 != 1,
                      np.arange(n_b) >= n_b // 2, rng.rand(n_b) < 0.8])
    errs.append(parity(torch, sched, step, "inline-512x4096-4-lanes",
                       snap_b.arrays, cfg_b, lanes)[2])

    snap_r = synthetic_snapshot(1024, 10240, rich=True, bound=0.1)
    cfg_r = sched.make_config(snap_r)
    if not (cfg_r.enable_pod_affinity and cfg_r.enable_anti_affinity and cfg_r.enable_pref
            and cfg_r.enable_spread_hard and cfg_r.slot_paint and cfg_r.compact_carry):
        raise SystemExit("parity input rich is not the inter-pod path it should be")
    errs.append(parity(torch, sched, step, "rich-1024x10240-bound0.1",
                       snap_r.arrays, cfg_r, snap_r.arrays.active)[2])

    snap_d = synthetic_snapshot(512, 4096, rich=True)
    cfg_d = sched.make_config(snap_d, slot_paint=False)
    errs.append(parity(torch, sched, step, "rich-512x4096-dense",
                       snap_d.arrays, cfg_d, snap_d.arrays.active)[2])

    snap_l = synthetic_snapshot(512, 1024, rich=True)
    cfg_l = sched.make_config(snap_l)
    n_l = snap_l.n_nodes
    lanes_l = np.stack([np.ones(n_l, bool), np.arange(n_l) % 3 != 2,
                        np.arange(n_l) < (3 * n_l) // 4, rng.rand(n_l) < 0.7])
    out_l = parity(torch, sched, step, "rich-512x1024-4-lanes",
                   snap_l.arrays, cfg_l, lanes_l)
    errs.append(out_l[2])
    if len({tuple(row.tolist()) for row in out_l[3][0].cpu()}) != 4:
        raise SystemExit("rich 4-lane launch: the lanes did not place pods differently")

    # ---- 4. the main paths: simulate() at full size, through the kernel
    def cluster_of(rich):
        nodes, pods, _ = synthetic_objects(5120, 51200, rich=rich)
        return ClusterResources(nodes=nodes, pods=pods)

    paths = {}
    for label, rich in (("northstar", False), ("northstar-rich", True)):
        paths[label] = main_path(torch, sched, step, simulate, cluster_of, label, rich)

    # ---- 5. results
    # ms, plain_ms and bound_ms cover the same pods: the rich path's first
    # PARITY_PREFIX; each path's whole run is under "paths"
    rich_p = paths["northstar-rich"]
    same = rich_p["same_pods"]
    kernels = [{
        "name": "plain_step", "route": "cuda",
        "source": "open_simulator_tpu_torch/csrc/plain_step.cu",
        "replaces": "open_simulator_tpu/engine/scheduler.py:745",
        "launches": rich_p["launches"],
        "max_abs_err": max(errs + [p["max_abs_err"] for p in paths.values()]),
        "pods": same["pods"], "ms": same["ms"], "plain_ms": same["plain_ms"],
        "bound_ms": same["bound_ms"], "bound_by": same["bound_by"], "library_ms": None,
        "paths": paths,
        "parity": "bit-exact vs the plain step on synthetic 1024x10240, inline "
                  "512x4096, 4 lanes, rich 1024x10240 bound 0.1, rich 512x4096 dense, "
                  f"rich 512x1024 4 lanes, and the first and last {PARITY_PREFIX} pods "
                  "of both main paths",
    }]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": dev_name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
