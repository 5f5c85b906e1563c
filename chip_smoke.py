#!/usr/bin/env python3
"""Smoke run of open_simulator_tpu_torch on one NVIDIA card.

    python3 chip_smoke.py

Builds the package's CUDA kernels from ``open_simulator_tpu_torch/csrc``,
holds each kernel bit for bit against its plain torch version on the card,
then drives the main paths — ``core.simulate()`` on the north-star cluster
(5,120 nodes x 51,200 pods, the reference's ``synthetic_snapshot`` shape),
on its rich twin (the reference's ``northstar-rich``: host ports, pod
affinity, anti-affinity, hard and hostname spread, the interpod
preference, taints) and on the device-resource cluster
(``northstar-devres``: GPU share, open-local storage, WaitForFirstConsumer
PVs, EBS attach limits with shared claims), then the capacity plan on all
three (the reference bench's 64-lane north-star sweep, its bisection, and
the example plans through the CLI) — and checks that each ran through the
kernels and that its answer is right.

Phases, in order (any failure exits nonzero; each prints its wall time):

1. the card's name and power limit (nvidia-smi);
2. the kernel build, one nvcc per source, started together, with ptxas's
   registers and spills of each instantiation;
3. kernel vs plain step, exact equality of node, fail counts, feasible
   counts, GPU and PV picks and all twelve carry fields, each side
   starting its lanes from the template carry through its lane prologue,
   on: the synthetic cluster at 1,024 x 10,240 with mid-sequence forced
   pods (dom_count carry); a 512 x 4,096 cluster with hostname and zone
   soft spread, taints, unschedulable nodes, host ports and a leading
   nodeName run (group_count carry); the same as one 4-lane launch with a
   different active mask per lane; the rich cluster at 1,024 x 10,240
   with 10% of the pods pre-bound; the rich cluster at 512 x 4,096 in
   the dense form (slot_paint off); the rich cluster at 512 x 1,024 as
   one 4-lane launch; and the first 2,048 pods of the device-resource cluster at
   1,024 x 10,240 with 8 GPU node slots as one 4-lane launch (all six
   device-resource gates, pods bound mid-sequence with pinned GPUs); then
   the edges of the launch geometry (one thread-block cluster per lane):
   3 nodes (fewer than the cluster's blocks; rich and dom_count), the
   device-resource cluster at 1,000 nodes (a ragged last slice) and the
   rich cluster at 509 nodes as 3 lanes (an odd number of clusters); each
   parity line prints the launch's cluster size, block size and slice;
4. the simulate() paths, non-rich, rich, devres: launch counts reset,
   ``simulate()`` at full size, counts read; then the kernel timed on the
   path's arrays (its placements, and on devres its GPU allocations, must
   equal simulate()'s), one more launch with the kernel's per-phase cycle
   counts on (each phase's share printed), the kernel and the plain step
   compared over the first 2,048 pods from the template and over the last
   2,048 from the kernel's own carry; on the rich path a host check that
   no pod shares its node with a pod its hostname anti-affinity term
   names; on the devres path the six gates, every device-resource reason
   row but the missing-PV one refusing nodes, and host checks of the PV
   bindings, the GPU devices' memory and the nodes' EBS attachments;
5. the capacity paths, non-rich, rich, devres, at 5,120 + 64 nodes x
   51,200 pods (devres: 64 slots of ``examples/newnode/gpu.yaml``):
   launch counts reset, ``capacity_sweep`` over the bench's 64 counts,
   counts read (one 64-lane launch); the launch timed alone, with peak
   device memory, its geometry and its per-phase cycle shares; lanes at
   counts 0, 21, 42 and 63 against one-lane launches, bit for bit; the
   64-lane hoist and the forced-prefix fold (4,096 pods pinned where
   lane 63 put them; devres: the cluster's own nodeName prefix) timed and
   held equal to the kernel's carry after those pods; the kernel against the plain step over the first 2,048
   pods of lanes 0 and 63; ``capacity_bisect`` (8 lanes) against the
   sweep's answer under a CPU limit that puts it inside (0, 64); then the
   ``config``, ``constraints``, ``controlplane``, ``morepods``,
   ``gpushare`` (``--extended-resources gpu``, both sweep modes),
   ``openlocal`` and ``stateful`` plans through the CLI on the card and on
   the CPU, with the same output;
6. one JSON line describing each kernel (with each plain_step
   instantiation's registers, stack and spills; a launched one that
   spills fails the run), then the device line.

Needs CUDA: without it, or run alone outside the repository, it exits
nonzero and prints no result.
"""

from __future__ import annotations

import dataclasses
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
# the capacity phase: the reference bench's north-star sweep (64 lanes,
# 64 new-node slots) and the count its bisection is set to find
CAPACITY_LANES = 64
BISECT_TARGET = 37
# pods of the full-width forced-prefix fold (one fold chunk)
FOLD_PODS = 4096
# the full-size paths' nodes and pods
NODES, PODS = 5120, 51200
# (label, cluster kind) of the full-size paths
PATHS = (("northstar", "plain"), ("northstar-rich", "rich"), ("northstar-devres", "devres"))
# (config, extra arguments, sweep mode)
CLI_CONFIGS = (("config.yaml", (), "bisect"), ("constraints-config.yaml", (), "bisect"),
               ("controlplane-config.yaml", (), "bisect"), ("morepods-config.yaml", (), "bisect"),
               ("gpushare-config.yaml", ("--extended-resources", "gpu"), "bisect"),
               ("gpushare-config.yaml", ("--extended-resources", "gpu"), "exhaustive"),
               ("openlocal-config.yaml", (), "bisect"), ("stateful-config.yaml", (), "bisect"))


_T0 = time.perf_counter()


def log(msg: str) -> None:
    print(f"[{time.perf_counter() - _T0:7.1f}s] {msg}", flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def template_of(sched, arrs, cfg):
    """The template carry every lane starts from: the fresh carry with the
    forced prefix folded in (the kernel's lane prologue copies it into
    each lane's slice)."""
    st = sched.init_state(arrs, cfg)
    if cfg.forced_prefix:
        st = sched.apply_forced_prefix(arrs, cfg, st, cfg.forced_prefix)
    return sched.SimState(**{f: getattr(st, f).contiguous() for f in sched.STATE_FIELDS})


def clone_state(sched, st):
    return sched.SimState(**{f: getattr(st, f).clone() for f in sched.STATE_FIELDS})


def compare(torch, out_k, out_p, st_k, st_p):
    """(all equal, max abs difference over the outputs and the twelve carry
    fields)."""
    equal, err = True, 0.0
    pairs = list(zip(out_k, out_p)) + [(getattr(st_k, f), getattr(st_p, f))
                                       for f in type(st_k).__dataclass_fields__]
    for a, b in pairs:
        equal &= torch.equal(a, b)
        if a.numel():
            err = max(err, float((a.float() - b.float()).abs().max()))
    return equal, err


def parity(torch, sched, step, label, arrs_np, cfg, active_np, n_pods=None, start=None):
    """Kernel vs plain step on the card, from the same carry, over the pods
    after the forced prefix (the first `n_pods` of them if set). The carry
    is the template, written into new (unset) lane buffers by each side's
    lane prologue, or with `start` = (first pod, lane-stacked state) that
    state. Returns (plain seconds, kernel seconds, max abs error, kernel
    outputs)."""
    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    arrs = sched.device_arrays(arrs_np, dev)
    active = torch.from_numpy(active_np).to(dev)
    if active.dim() == 1:
        active = active[None]
    hoist = sched.hoist_of(arrs, active)
    inv = sched.inv_alloc_of(arrs.alloc)
    if start is None:
        p0, tmpl = cfg.forced_prefix, template_of(sched, arrs, cfg)
        st_k = sched.lane_carry(tmpl, active.shape[0])
        st_p = sched.lane_carry(tmpl, active.shape[0])
    else:
        (p0, base), tmpl = start, None
        st_k, st_p = clone_state(sched, base), clone_state(sched, base)
    p1 = arrs.req.shape[0] if n_pods is None else min(p0 + n_pods, arrs.req.shape[0])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out_k = step.plain_step_cuda(arrs, active, hoist, inv, st_k, cfg, p0, p1, template=tmpl)
    torch.cuda.synchronize()
    t_k = time.perf_counter() - t0
    t0 = time.perf_counter()
    out_p = step.plain_step_torch(arrs, active, hoist, inv, st_p, cfg, p0, p1, template=tmpl)
    torch.cuda.synchronize()
    t_p = time.perf_counter() - t0
    plan = step.LAST_PLAN
    equal, err = compare(torch, out_k, out_p, st_k, st_p)
    n_sched = int((out_k[0] >= 0).sum())
    log(f"parity {label}: lanes={active.shape[0]} pods={p1 - p0} (after a {p0}-pod "
        f"prefix) {geometry(plan)} scheduled={n_sched} fail_counts_sum={int(out_k[1].sum())} "
        f"kernel_s={t_k:.4f} plain_s={t_p:.2f} equal={equal} max_abs_err={err} "
        f"phase_s={time.perf_counter() - t_phase:.1f}")
    if not equal:
        raise SystemExit(f"parity {label}: kernel and plain step disagree")
    return t_p, t_k, err, out_k


# the instantiations plain_step<kInterpod, kDevRes> the main paths launch
# (<1,1> is built but no path sets both slices' gates)
LAUNCHED = ("<0,0>", "<1,0>", "<0,1>")


def instantiations(build_log):
    """{"<I,D>": {registers, stack_bytes, spill_store_bytes,
    spill_load_bytes}} of each plain_step instantiation, from ptxas's
    -v report in the build log."""
    import re

    out, name = {}, None
    for line in build_log.splitlines():
        m = re.search(r"plain_step_kernelILb([01])ELb([01])E", line)
        if m:
            name = f"<{m.group(1)},{m.group(2)}>"
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and name:
            out[name] = {"stack_bytes": int(m.group(1)), "spill_store_bytes": int(m.group(2)),
                         "spill_load_bytes": int(m.group(3))}
        m = re.search(r"Used (\d+) registers", line)
        if m and name in out:
            out[name]["registers"] = int(m.group(1))
    return out


def geometry_fields(plan):
    """One launch's geometry (kernels/step.LaunchPlan) as JSON fields."""
    return {"cluster": plan.cluster, "threads": plan.threads, "slice": plan.slice_len,
            "headroom_in_smem": plan.headroom, "smem_bytes": plan.smem,
            "resident_clusters": plan.resident}


def geometry(plan):
    """One launch's geometry as the log prints it."""
    return " ".join(f"{k}={v}" for k, v in geometry_fields(plan).items())


def step_work(sched, a, cfg, p0, p1, out):
    """(bytes, operations) the step function needs for pods [p0, p1) of
    one lane, given that run's outputs `out` = (node [P'], fail counts
    [P', OPS], feasible counts [P']) as numpy."""
    shared, lane, ops = _work_parts(sched, a, cfg, p0, p1, out)
    return shared + lane, ops


def lanes_work(sched, a, cfg, p0, p1, outs):
    """(bytes, operations) of one launch over several lanes, `outs` holding
    each lane's outputs as numpy: the node and pod rows and the template
    carry are read once for all lanes, each lane's tables, carry and
    outputs are its own, and the operations add up lane by lane."""
    parts = [_work_parts(sched, a, cfg, p0, p1, o) for o in outs]
    return parts[0][0] + sum(pt[1] for pt in parts), sum(pt[2] for pt in parts)


def _work_parts(sched, a, cfg, p0, p1, out):
    """(bytes shared by every lane, bytes of this lane, operations of this
    lane) for pods [p0, p1), from the lane's outputs `out`.

    Bytes: every input read once and every output written once — node
    rows, pod rows and term lists and the starting carry (shared), the
    lane's hoisted eligibility tables, its final carry and its outputs.
    Operations: counted from the
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

    placed = node >= 0
    paints = _paint_ops(a, cfg, sl, node, per_node_compare=True)
    ops = int((per_pod + filters + feas * per_feasible + placed * (r + paints)).sum())
    d_rows = _devres_work(a, cfg, sl, node, feas, reach).values()
    ops += sum(x[0] for x in d_rows)
    d_shared, d_carry, d_out = (sum(x[i] for x in d_rows) for i in (1, 2, 3))

    node_bytes = n * r * 4 + n + c * n * 10 + n * 4 + k1 * n * 4 + k * n + t * 4
    pod_bytes = (steps * (r * 4 + 12 + pt + sg + cs * 14 + aw * 10 + bw * 9 + ap * 17 + t2 + 8)
                 + 4 * int(hits.sum() + rows(a.own_terms, cfg.enable_anti_affinity).sum()))
    carry = (n * r * 4 + n * pt + k1 * d * sg * 4 + n * sg * gcb
             + (n * t * gcb if cfg.enable_anti_affinity else 0)
             + (n * t2 * 4 if cfg.enable_pref else 0)) + d_carry
    lane_bytes = n + k * 4 + c * n + c * k1 * d + c * k + carry
    out_bytes = steps * (4 + 4 + (cfg.n_ops * 4 if cfg.fail_reasons else 0)) + d_out
    return node_bytes + pod_bytes + d_shared + carry, lane_bytes + out_bytes, ops


def _devres_work(a, cfg, sl, node, feas, reach):
    """{row: (operations, node and pod bytes, carry bytes, output bytes)}
    of the device-resource ops for pods `sl`, counted from the kernel's
    source under the launch's gates, for the rows "gpu", "storage" and
    "volumes" (the static masks, the PV match and the attach limits) that
    are on. Only the work the pod's own request needs is counted.

    Per node that reaches a row (the feasible nodes plus those charged to
    that row or a later one): GPU, for a pod with a request, 6 per device
    + 4; storage, for a pod with an LVM or device request, 2 per VG + (V +
    3) per LVM volume + E + 4E per device claim; the static masks, 3 tests
    and the missing-PV test; the PV match, per claim 3 per admitted PV of
    the node walked (the mean list length; the walk may stop earlier) + 1;
    the attach limits, per key 2 + 3 per shared-volume slot (the PV walk
    counts the pod's valid claims over the kernel's lists, which keep only
    PVs a claim class can take). Per feasible node, for a pod with a GPU
    request: the raw score, 2 per device + 4, its two normalizer updates
    and its final add (4). Per bound pod: with a GPU request, the pick and
    debit, 8 per device; with a storage request, the plan again with its
    commit (+ V + E); the bound node's PV walk; the attach counts (as the
    filter) and the presence writes."""
    import numpy as np

    steps = len(node)
    n, r = a.alloc.shape
    g, v, e = a.gpu_slot.shape[1], a.vg_cap.shape[1], a.sdev_cap.shape[1]
    lv, ev, lw = a.lvm_req.shape[1], a.sdev_req.shape[1], a.wfc_ccid.shape[1]
    lk, lsv, nsv = a.vol_limit_cap.shape[1], a.svol_id.shape[1], a.svol_key.shape[0]
    n_pv, cc, cv = a.pv_node_ok.shape[0], a.pv_cand.shape[0], a.class_vol_node.shape[0]
    placed = (node >= 0).astype(np.int64)
    rows = {}
    if cfg.enable_gpu:
        gpu_pod = (a.gpu_cnt[sl] > 0).astype(np.int64)
        ops = gpu_pod * (reach(7 + r) * (6 * g + 4) + feas * (2 * g + 4 + 6) + placed * 8 * g)
        rows["gpu"] = (int(ops.sum()), n * 4 + n * g * 4 + steps * (9 + g * 4), n * g * 4,
                       steps * g * 4)
    if cfg.enable_storage:
        vols = (a.lvm_req[sl] > 0).sum(1).astype(np.int64)
        claims = (a.sdev_req[sl] > 0).sum(1).astype(np.int64)
        plan = ((vols + claims) > 0) * (2 * v + vols * (v + 3) + e + claims * 4 * e)
        ops = reach(8 + r) * plan + placed * (plan + ((vols + claims) > 0) * (v + e))
        rows["storage"] = (int(ops.sum()), n * v * 4 + n * e * 5 + steps * (lv * 4 + ev * 5),
                           n * v * 4 + n * e, 0)
    ops = np.zeros(steps, np.int64)
    shared = carry = out = 0
    if cfg.enable_vol_static:
        ops += reach(9 + r) * 3 + reach(12 + r)
        shared += 3 * cv * n + steps * 5
    if cfg.enable_pv_match:
        # the admitted lists hold only PVs some claim class can take, and
        # the walk runs for the pod's valid claims
        nnz = int((a.pv_node_ok & a.pv_cand.any(0)[:, None]).sum())
        walk = a.wfc_valid[sl].sum(1) * (3 * nnz / n + 1)
        ops += np.round(reach(11 + r) * walk + placed * walk).astype(np.int64)
        shared += (n + 1) * 4 + nnz * 4 + cc * n_pv + steps * lw * 5
        carry += n_pv
        out += steps * lw * 4
    if cfg.enable_vol_limits:
        per = lk * (2 + 3 * lsv)
        ops += reach(13 + r) * per + placed * (per + lsv)
        shared += n * lk * 4 + nsv * 4 + steps * (lk + lsv) * 4
        carry += n * lk * 4 + (n * nsv if cfg.enable_vol_dedup else 0)
    if cfg.enable_vol_static or cfg.enable_pv_match or cfg.enable_vol_limits:
        rows["volumes"] = (int(ops.sum()), shared, carry, out)
    return rows


def devres_row_bounds(a, cfg, p0, p1, outs):
    """{row: (bytes, ops, bound ms, what binds)} of each device-resource
    row of `_devres_work` alone, over one launch whose lanes' outputs are
    `outs` (numpy): the row's node and pod bytes and its starting carry
    read once, each lane's final carry and outputs written once, the
    operations added up lane by lane."""
    import numpy as np

    per = []
    for o in outs:
        node, fail, feas = (np.asarray(x, dtype=np.int64) for x in o)
        per.append(_devres_work(a, cfg, slice(p0, p1), node, feas,
                                lambda op, fail=fail, feas=feas: feas + fail[:, op:].sum(1)))
    return {k: bound_of((per[0][k][1] + per[0][k][2] + sum(pl[k][2] + pl[k][3] for pl in per),
                         sum(pl[k][0] for pl in per))) for k in per[0]}


def _paint_ops(a, cfg, sl, node, per_node_compare):
    """[P'] operations of each pod's anti-affinity and preferred-term
    paints: a term under a key k > 0 costs an add per node of the bound
    node's domain (and, in the kernel, a compare per node to find them);
    under the hostname key, one add."""
    import numpy as np

    n = a.alloc.shape[0]
    k1 = a.topo_onehot.shape[0]
    steps = len(node)
    has = a.topo_onehot.any(2)
    node_dom = np.where(has, a.topo_onehot.argmax(2), -1)              # [K1, N]
    dsize = a.topo_onehot.sum(1).astype(np.int64)                       # [K1, D]
    placed = node >= 0
    dom_at = node_dom[:, np.where(placed, node, 0)].T                    # [P', K1]
    size_at = np.where(dom_at >= 0, dsize[np.arange(k1)[None, :], np.maximum(dom_at, 0)], 0)
    cost = np.concatenate([np.ones((steps, 1), np.int64),
                           size_at + (n if per_node_compare else 0)], 1)  # [P', K]
    paints = np.zeros(steps, np.int64)
    if cfg.enable_anti_affinity:
        own = a.own_terms[sl].astype(np.int64)
        paints += (own * cost[:, a.term_key.astype(np.int64)]).sum(1)
    if cfg.enable_pref:
        keys = a.pref_key[sl].astype(np.int64)
        paints += (a.pref_valid[sl] * np.take_along_axis(cost, keys, 1)).sum(1)
    return paints


def fold_work(a, cfg, k):
    """(bytes, operations) of folding the first k pods (forced binds) into
    a carry — what ``apply_forced_prefix`` computes. Bytes: the k pods'
    forced node, requests, groups, ports, terms and preferred terms, the
    one-hot domain table and the carry, each read once, and the carry
    written once. Operations: the sequential binds' own — per bound pod R
    subtractions, one add per matched group (and per matched group and
    non-hostname key on the dom_count carry), one or per port, one add per
    attach-limit key, and the paints (an add per node of the bound node's domain, one under the
    hostname key)."""
    import numpy as np

    node = np.asarray(a.forced_node[:k], dtype=np.int64)
    n, r = a.alloc.shape
    k1, _, d = a.topo_onehot.shape
    sg, pt = a.match_groups.shape[1], a.ports.shape[1]
    t, t2, ap = a.own_terms.shape[1], a.hit_pref.shape[1], a.pref_group.shape[1]
    gcb = _gc_bytes(cfg)
    sl = slice(0, k)
    placed = node >= 0
    groups = a.match_groups[sl].sum(1).astype(np.int64)
    lk = a.vol_limit_cap.shape[1] if cfg.enable_vol_limits else 0
    per_pod = (r + groups * cfg.needs_group_count + groups * k1 * cfg.maintain_dom_count
               + a.ports[sl].sum(1).astype(np.int64) * cfg.enable_ports + lk
               + _paint_ops(a, cfg, sl, node, per_node_compare=False))
    ops = int((placed * per_pod).sum())
    carry = (n * r * 4 + n * pt + k1 * d * sg * 4 + n * sg * gcb
             + (n * t * gcb if cfg.enable_anti_affinity else 0)
             + (n * t2 * 4 if cfg.enable_pref else 0) + n * lk * 4)
    pod_bytes = k * (4 + r * 4 + sg + pt + t + ap * 13 + lk * 4)
    return pod_bytes + k1 * n * d * 4 + 2 * carry, ops


def hoist_work(a, n_lanes):
    """(bytes, operations) of ``hoist_active_stats`` for S lanes. Bytes:
    the one-hot domain table, key presence, class affinity and the masks
    read once; the domain counts, log_dom and the three eligibility
    tables written once. Operations, per lane: one add per node for the
    active count, one test per (non-hostname key, node) for the domain
    presence and one add per (key, domain) to count them, a log per key,
    two ands per (class, key, node) for the eligibility, an or per
    (class, non-hostname key, node) into domain_has and one per (class,
    key, node) into any_elig."""
    n = a.alloc.shape[0]
    k1, _, d = a.topo_onehot.shape
    c, k = a.class_affinity.shape[0], a.has_key.shape[0]
    per_lane = n + k1 * n + k1 * d + k + 2 * c * k * n + c * k1 * n + c * k * n
    nbytes = (k1 * n * d * 4 + k * n * 4 + c * n + n_lanes * n
              + n_lanes * (k * 8 + c * n + c * k1 * d + c * k))
    return nbytes, n_lanes * per_lane


def _gc_bytes(cfg):
    if not cfg.needs_group_count:
        return 0
    return 2 if cfg.compact_carry else 4


DEVRES_GATES = ("enable_gpu", "enable_storage", "enable_vol_static", "enable_pv_match",
                "enable_vol_limits", "enable_vol_dedup")
# the device-resource reason rows, after the R resources: GPU, storage,
# volume node affinity, zone, binding, missing PV, attach limits
DEVRES_ROWS = ("gpu", "storage", "vol_node", "vol_zone", "vol_bind", "pv_missing",
               "vol_limits")


def devres_checks(sched, snap, cfg, result, label):
    """The device-resource path's own checks of simulate()'s answer: all
    six gates on; every device-resource reason row but the missing-PV one
    refuses nodes; and, on the host, from the decoded placements alone:
    no PV bound twice and each bound local PV on its own node; no GPU
    device past its memory where no pinned pod sits; no node past its 25
    EBS attachments (unique claims)."""
    import numpy as np

    from open_simulator_tpu_torch.testing.synthetic import EBS_NITRO_LIMIT

    off = [g for g in DEVRES_GATES if not getattr(cfg, g)]
    if off:
        raise SystemExit(f"main path {label}: device-resource gates off: {off}")
    r = snap.arrays.alloc.shape[1]
    rows = result.fail_counts.sum(0)[7 + r:14 + r]
    counts = dict(zip(DEVRES_ROWS, (int(x) for x in rows)))
    log(f"main path {label}: first-fail refusals of the device-resource rows {counts}")
    if any(counts[k] == 0 for k in DEVRES_ROWS if k != "pv_missing"):
        raise SystemExit(f"main path {label}: a device-resource op refused no node")
    node_of = result.placements()
    pvs = list(result.volume_bindings.values())
    if len(set(pvs)) != len(pvs) or not pvs:
        raise SystemExit(f"main path {label}: a PV was bound twice (or none was bound)")
    claim_pod = {}
    for sp in result.scheduled_pods:
        for v in (sp.pod.raw.get("spec") or {}).get("volumes") or []:
            c = (v.get("persistentVolumeClaim") or {}).get("claimName")
            if c:
                claim_pod.setdefault(f"default/{c}", []).append(sp.pod.key)
    for claim, pv in result.volume_bindings.items():
        if not all(pv.startswith(f"local-{node_of[k]}-") for k in claim_pod[claim]):
            raise SystemExit(f"main path {label}: {claim} bound to {pv} off its node")
    pinned = {node_of[p.key] for p, f in zip(snap.pods, snap.arrays.gpu_has_forced)
              if f and p.key in node_of}
    used = {}
    for sp in result.scheduled_pods:
        mem, _ = sp.pod.gpu_request()
        for d in result.gpu_assignments.get(sp.pod.key, []):
            used[(sp.node_name, d)] = used.get((sp.node_name, d), 0) + mem
    caps = {ns.node.name: ns.node.gpu_info()[1] for ns in result.node_status}
    over = [(n, d) for (n, d), u in used.items() if n not in pinned and u > caps[n]]
    attach = {}
    for claim, keys in claim_pod.items():
        if claim.startswith("default/ebs-") or claim.startswith("default/heavy-"):
            for n in {node_of[k] for k in keys}:
                attach[n] = attach.get(n, 0) + 1
    log(f"main path {label}: host checks: {len(pvs)} PVs bound once each on their nodes; "
        f"{len(used)} GPU devices in use, {len(over)} over capacity (nodes with a pinned pod "
        f"skipped: {len(pinned)}); EBS attachments per node at most {max(attach.values())}")
    if over or max(attach.values()) > EBS_NITRO_LIMIT or not np.all(np.isfinite(rows)):
        raise SystemExit(f"main path {label}: host device-resource check failed")


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


def main_path(torch, sched, step, simulate, cluster_of, label, kind):
    """Drive simulate() on one full-size cluster (`kind` plain, rich or
    devres) with the launch counts reset, then time and check the kernel
    on the path's arrays."""
    t_phase = time.perf_counter()
    rich = kind == "rich"
    t0 = time.perf_counter()
    cluster = cluster_of(kind)
    log(f"main path {label}: cluster objects built in {time.perf_counter() - t0:.1f}s")
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
    if kind == "devres":
        devres_checks(sched, snap, cfg, result, label)

    # the kernel alone on the main path's arrays
    dev = torch.device("cuda")
    arrs = sched.device_arrays(snap.arrays, dev)
    active = torch.from_numpy(snap.arrays.active).to(dev)[None]
    hoist = sched.hoist_of(arrs, active)
    inv = sched.inv_alloc_of(arrs.alloc)
    tmpl = template_of(sched, arrs, cfg)
    st_k = sched.lane_carry(tmpl, 1)
    p0, p1 = cfg.forced_prefix, n_pods
    times = []
    for _ in range(3):
        ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        ev0.record()
        out_k = step.plain_step_cuda(arrs, active, hoist, inv, st_k, cfg, p0, p1, template=tmpl)
        ev1.record()
        torch.cuda.synchronize()
        times.append(ev0.elapsed_time(ev1))
    kernel_ms = min(times)
    plan = step.LAST_PLAN
    placed = {sp.pod.key: sp.node_name for sp in result.scheduled_pods}
    kern_nodes = out_k[0][0].cpu().numpy()
    kern_placed = {snap.pods[i].key: snap.node_names[int(nd)]
                   for i, nd in enumerate(kern_nodes, start=p0) if nd >= 0}
    kern_placed.update({snap.pods[i].key: snap.node_names[int(snap.arrays.forced_node[i])]
                        for i in range(p0)})  # the nodeName prefix, folded
    if kern_placed != placed:
        raise SystemExit(f"main path {label}: the timed kernel run and simulate() "
                         "placed pods differently")
    if not bool(torch.isfinite(st_k.headroom).all()) or bool((st_k.headroom < 0).any()):
        raise SystemExit(f"main path {label}: carry has non-finite or negative headroom")
    phases = phase_run(torch, step, label, lambda cyc: step.plain_step_cuda(
        arrs, active, hoist, inv, st_k, cfg, p0, p1, template=tmpl, phase_cycles=cyc),
        1, p1 - p0, out_k)
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
        f"feasible_pairs={feasible_pairs} {geometry(plan)}")
    full = bound_of(step_work(sched, snap.arrays, cfg, p0, p1, lane0(out_k)))
    rows = {}
    if kind == "devres":
        rows = devres_row_bounds(snap.arrays, cfg, p0, p1, [lane0(out_k)])
        log_rows(label, rows)
        gp = out_k[3][0].cpu().numpy()
        got = {snap.pods[i].key: [d for d in range(gp.shape[1]) for _ in range(int(gp[i - p0, d]))]
               for i in range(p0, p1) if gp[i - p0].any()}
        if got != result.gpu_assignments:
            raise SystemExit(f"main path {label}: the timed kernel run and simulate() "
                             "allocated GPUs differently")

    # kernel vs plain over the first PARITY_PREFIX pods from a fresh carry,
    # both timed, and over the last PARITY_PREFIX pods from the kernel's carry
    plain_s, _, err, out_f = parity(torch, sched, step, f"{label}-first-{PARITY_PREFIX}",
                                    snap.arrays, cfg, snap.arrays.active, n_pods=PARITY_PREFIX)
    q1 = min(p0 + PARITY_PREFIX, p1)
    ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    ev0.record()
    step.plain_step_cuda(arrs, active, hoist, inv, st_k, cfg, p0, q1, template=tmpl)
    ev1.record()
    torch.cuda.synchronize()
    prefix_ms = ev0.elapsed_time(ev1)
    prefix = bound_of(step_work(sched, snap.arrays, cfg, p0, q1, lane0(out_f)))
    q_last = max(p1 - PARITY_PREFIX, p0)
    st_mid = sched.lane_carry(tmpl, 1)
    step.plain_step_cuda(arrs, active, hoist, inv, st_mid, cfg, p0, q_last, template=tmpl)
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
        "scheduled": len(result.scheduled_pods), "phases": phases,
        "geometry": geometry_fields(plan), **row_fields(rows),
        "same_pods": {"pods": q1 - p0, "ms": prefix_ms, "plain_ms": plain_s * 1e3,
                      "bound_ms": prefix[2], "bound_by": prefix[3]},
    }


def capacity_path(torch, sched, step, sweep, snapshot_of, label, kind):
    """The reference's capacity-sweep preset at full width: 5,120 nodes x
    51,200 pods with 64 new-node slots, 64 lanes (counts min(i % 65, 64))
    in one ``capacity_sweep`` launch; then the launch timed alone, lane
    independence, the kernel against the plain step on two lanes, and the
    bisection against the sweep."""
    import numpy as np

    t_phase = time.perf_counter()
    snap = snapshot_of(kind)
    cfg = sched.make_config(snap)
    n_pods = snap.n_pods
    counts = [min(i % (CAPACITY_LANES + 1), CAPACITY_LANES) for i in range(CAPACITY_LANES)]
    log(f"capacity {label}: snapshot {snap.n_real_nodes}+{snap.n_nodes - snap.n_real_nodes} "
        f"nodes x {n_pods} pods built in {time.perf_counter() - t_phase:.1f}s")

    # the main path: one capacity_sweep, counts read just after
    for name in step.LAUNCHES:
        step.LAUNCHES[name] = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    plan = sweep.capacity_sweep(snap, cfg, counts, device="cuda")
    torch.cuda.synchronize()
    sweep_s = time.perf_counter() - t0
    launches = dict(step.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    if launches["plain_step"] != 1:
        raise SystemExit(f"capacity {label}: plain_step launched {launches} times, not once")
    if plan.nodes_per_scenario.shape != (CAPACITY_LANES, n_pods) or not all(plan.all_scheduled):
        raise SystemExit(f"capacity {label}: the sweep did not schedule every pod in every lane")

    # the launch alone, as the sweep makes it (fail_reasons off)
    scfg = cfg._replace(fail_reasons=False)
    dev = torch.device("cuda")
    arrs = sched.device_arrays(snap.arrays, dev)
    masks_np = sweep.active_masks_for_counts(snap, counts)
    masks = torch.from_numpy(masks_np).to(dev)
    hoist = sched.hoist_of(arrs, masks)
    inv = sched.inv_alloc_of(arrs.alloc)
    tmpl = template_of(sched, arrs, scfg)
    carry = sched.lane_carry(tmpl, CAPACITY_LANES)
    p0 = scfg.forced_prefix
    times = []
    for _ in range(3):
        ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        ev0.record()
        out = step.plain_step_cuda(arrs, masks, hoist, inv, carry, scfg, p0, n_pods,
                                   template=tmpl)
        ev1.record()
        torch.cuda.synchronize()
        times.append(ev0.elapsed_time(ev1))
    kernel_ms = min(times)
    plan_k = step.LAST_PLAN
    phases = phase_run(torch, step, f"capacity {label}", lambda cyc: step.plain_step_cuda(
        arrs, masks, hoist, inv, carry, scfg, p0, n_pods, template=tmpl, phase_cycles=cyc),
        CAPACITY_LANES, n_pods - p0, out)
    if not np.array_equal(out[0].cpu().numpy(), plan.nodes_per_scenario[:, p0:]):
        raise SystemExit(f"capacity {label}: the timed launch and the sweep disagree")
    lane_pods = CAPACITY_LANES * (n_pods - p0)
    log(f"capacity {label}: capacity_sweep wall_s={sweep_s:.3f} launches={launches} "
        f"kernel ms={kernel_ms:.3f} (min of {len(times)}: {[round(t, 3) for t in times]}) "
        f"lane_pods_per_s={lane_pods / (kernel_ms / 1e3):.1f} host share of the sweep "
        f"{1 - kernel_ms / (sweep_s * 1e3):.4f} peak device memory "
        f"{peak / 2**20:.1f} MiB {geometry(plan_k)}")

    # lane independence: lanes at counts 0, 21, 42, 63 against one-lane launches
    for s_i in (0, 21, 42, 63):
        one = sched.lane_carry(tmpl, 1)
        out1 = step.plain_step_cuda(arrs, masks[s_i:s_i + 1], sched.hoist_of(arrs, masks[s_i:s_i + 1]),
                                    inv, one, scfg, p0, n_pods, template=tmpl)
        same = all(torch.equal(a[s_i], b[0]) for a, b in zip(out, out1))
        same &= all(torch.equal(getattr(carry, f)[s_i], getattr(one, f)[0])
                    for f in sched.STATE_FIELDS)
        if not same:
            raise SystemExit(f"capacity {label}: lane {s_i} differs from its one-lane launch")
    log(f"capacity {label}: lanes at counts 0, 21, 42, 63 equal one-lane launches bit for bit "
        "(node, feasible, every carry field)")

    # the side work of the launch: the 64-lane hoist, and the forced-prefix
    # fold at full width — the first FOLD_PODS pods pinned to the nodes
    # lane 63 gave them (devres: the cluster's own nodeName prefix, whose
    # attach counts fold too), folded at once; its carry must equal the
    # kernel's after those pods, and its torch.matmul calls are replayed
    # alone
    hoist_ms = min(cuda_ms(torch, lambda: sched.hoist_of(arrs, masks)) for _ in range(3))
    hoist_b = bound_of(hoist_work(snap.arrays, CAPACITY_LANES))
    if kind == "devres":
        if not p0:
            raise SystemExit(f"capacity {label}: expected a nodeName prefix")
        n_fold, pinned = p0, snap.arrays
    else:
        if p0:
            raise SystemExit(f"capacity {label}: expected no nodeName prefix on the "
                             "synthetic cluster")
        n_fold = FOLD_PODS
        forced = snap.arrays.forced_node.copy()
        forced[:n_fold] = plan.nodes_per_scenario[-1, :n_fold]
        pinned = dataclasses.replace(snap.arrays, forced_node=forced)
    arrs_f = sched.device_arrays(pinned, dev)
    fcfg = scfg._replace(forced_prefix=n_fold)
    fresh = sched.init_state(arrs_f, fcfg)
    folded = []
    fold_ms = min(cuda_ms(torch, lambda: folded.append(
        sched.apply_forced_prefix(arrs_f, fcfg, fresh, n_fold))) for _ in range(3))
    log_mm = MatmulLog(torch)
    with log_mm:
        sched.apply_forced_prefix(arrs_f, fcfg, fresh, n_fold)
    mm_ms = min(cuda_ms(torch, log_mm.replay) for _ in range(3))
    one = sched.lane_carry(fresh, 1)
    step.plain_step_cuda(arrs, masks[-1:], sched.hoist_of(arrs, masks[-1:]), inv, one,
                         scfg._replace(forced_prefix=0), 0, n_fold, template=fresh)
    if not all(torch.equal(getattr(folded[-1], f), getattr(one, f)[0])
               for f in sched.STATE_FIELDS):
        raise SystemExit(f"capacity {label}: the fold of {n_fold} pods and the kernel's "
                         "carry after them differ")
    fold_b = bound_of(fold_work(pinned, fcfg, n_fold))
    del folded, log_mm
    log(f"capacity {label}: hoist_active_stats over {CAPACITY_LANES} lanes {hoist_ms:.3f} ms, "
        f"bound {hoist_b[2]:.4f} ms ({hoist_b[3]}: bytes={hoist_b[0]} ops={hoist_b[1]}); "
        f"apply_forced_prefix of {n_fold} pods {fold_ms:.3f} ms, its torch.matmul calls "
        f"alone {mm_ms:.3f} ms, bound {fold_b[2]:.5f} ms ({fold_b[3]}: bytes={fold_b[0]} "
        f"ops={fold_b[1]}); the fold equals the kernel's carry after those pods")

    # the bound: this run's filter and feasible counts, from a reasons-on
    # launch (its placements are the sweep's)
    rcfg = cfg._replace(fail_reasons=True)
    out_r = step.plain_step_cuda(arrs, masks, hoist, inv, sched.lane_carry(tmpl, CAPACITY_LANES),
                                 rcfg, p0, n_pods, template=tmpl)
    if not torch.equal(out_r[0], out[0]):
        raise SystemExit(f"capacity {label}: reasons on and off placed pods differently")
    outs = [tuple(x[s_i].cpu().numpy() for x in out_r[:3]) for s_i in range(CAPACITY_LANES)]
    del out_r
    bound = bound_of(lanes_work(sched, snap.arrays, scfg, p0, n_pods, outs))
    log(f"capacity {label}: bound of the 64-lane launch: bytes={bound[0]} ops={bound[1]} "
        f"-> {bound[2]:.4f} ms, {bound[3]}; feasible pairs "
        f"{sum(int(o[2].sum()) for o in outs)}")
    rows = devres_row_bounds(snap.arrays, scfg, p0, n_pods, outs) if kind == "devres" else {}
    log_rows(f"capacity {label}", rows)

    # kernel vs plain over the first pods of the lanes at counts 0 and 63
    two = masks_np[[0, CAPACITY_LANES - 1]]
    plain_s, kern_s, err, _ = parity(torch, sched, step, f"capacity-{label}-lanes-0-63",
                                     snap.arrays, scfg, two, n_pods=PARITY_PREFIX)

    # bisection: a CPU limit that puts the answer inside (0, 64)
    occ = plan.cpu_occupancy_pct
    limit = (occ[BISECT_TARGET - 1] + occ[BISECT_TARGET]) / 2
    want = min(c for c, o, ok in zip(plan.counts, occ, plan.all_scheduled) if ok and o <= limit)
    if not 0 < want < CAPACITY_LANES:
        raise SystemExit(f"capacity {label}: the limit {limit} does not put the answer inside")
    before = step.LAUNCHES["plain_step"]
    t0 = time.perf_counter()
    bis = sweep.capacity_bisect(snap, cfg, CAPACITY_LANES,
                                sweep.SweepThresholds(max_cpu_pct=limit), lanes=8, device="cuda")
    torch.cuda.synchronize()
    bis_s = time.perf_counter() - t0
    plan_b = step.LAST_PLAN
    rounds = step.LAUNCHES["plain_step"] - before
    row = bis.nodes_per_scenario[bis.counts.index(bis.best_count)] if bis.best_count else None
    if bis.best_count != want or not np.array_equal(row, plan.nodes_per_scenario[counts.index(want)]):
        raise SystemExit(f"capacity {label}: bisection found {bis.best_count}, the sweep {want}")
    log(f"capacity {label}: max_cpu_pct={limit!r} -> sweep best {want}; capacity_bisect(lanes=8) "
        f"best {bis.best_count} in {rounds} rounds, {len(bis.counts)} probes, wall_s={bis_s:.3f} "
        f"({bis_s / rounds:.3f} s per round) {geometry(plan_b)}; "
        f"phase_s={time.perf_counter() - t_phase:.1f}")
    return {
        "lanes": CAPACITY_LANES, "launches": launches["plain_step"], "pods": n_pods - p0,
        "ms": kernel_ms, "ms_runs": times, "bound_ms": bound[2], "bound_by": bound[3],
        "lane_pods_per_s": lane_pods / (kernel_ms / 1e3), "sweep_s": sweep_s,
        "peak_mem_bytes": peak, "max_abs_err": err, "phases": phases,
        "geometry": geometry_fields(plan_k), **row_fields(rows),
        "same_pods": {"lanes": 2, "pods": PARITY_PREFIX, "ms": kern_s * 1e3,
                      "plain_ms": plain_s * 1e3},
        "bisect": {"max_cpu_pct": limit, "best_count": bis.best_count, "rounds": rounds,
                   "probes": len(bis.counts), "wall_s": bis_s,
                   "geometry": geometry_fields(plan_b)},
        "hoist": {"lanes": CAPACITY_LANES, "ms": hoist_ms, "bound_ms": hoist_b[2],
                  "bound_by": hoist_b[3]},
        "prefix_fold": {"pods": n_fold, "ms": fold_ms, "library_ms": mm_ms,
                        "bound_ms": fold_b[2], "bound_by": fold_b[3]},
    }


def phase_run(torch, step, label, launch, n_lanes, n_pods, out):
    """One more launch with the kernel's per-phase cycle counts on
    (`launch(cycles)`); its outputs must equal `out`, the launch without
    them. Logs and returns each phase's share of the cycles (thread 0 of
    each block, summed over the pods and lanes), the cycles per pod and
    lane, and the launch's time with the counters on."""
    cyc = torch.zeros((n_lanes, len(step.PHASES)), dtype=torch.int64, device="cuda")
    got = []
    ms = cuda_ms(torch, lambda: got.append(launch(cyc)))
    if not all(torch.equal(a, b) for a, b in zip(got[0], out)):
        raise SystemExit(f"{label}: the launch with cycle counts placed pods differently")
    per = cyc.sum(0).tolist()
    total = sum(per)
    shares = {name: c / total for name, c in zip(step.PHASES, per)}
    log(f"{label}: phase shares of {total} cycles ({total / (n_lanes * n_pods):.1f} per pod "
        f"and lane; launch with counters {ms:.3f} ms): "
        + ", ".join(f"{k} {v:.4f}" for k, v in shares.items()))
    return {"shares": shares, "cycles_per_lane_pod": total / (n_lanes * n_pods),
            "ms_with_counters": ms}


def log_rows(label, rows):
    for name, (nbytes, flops, bound_ms, bound_by) in rows.items():
        log(f"{label}: bound of the {name} row alone: bytes={nbytes} ops={flops} "
            f"-> {bound_ms:.5f} ms, {bound_by} (its time alone is not measured)")


def row_fields(rows):
    """The device-resource rows' bounds as JSON fields (none off devres)."""
    if not rows:
        return {}
    return {"devres_rows": {k: {"bytes": b, "ops": o, "bound_ms": ms, "bound_by": by}
                            for k, (b, o, ms, by) in rows.items()}}


class MatmulLog:
    """Records the operands of every torch.matmul / @ issued while it is
    active, so the same products can be timed alone."""

    def __init__(self, torch):
        import torch.overrides

        class _Mode(torch.overrides.TorchFunctionMode):
            def __torch_function__(mode, func, types, args=(), kwargs=None):
                if func in (torch.matmul, torch.Tensor.matmul, torch.Tensor.__matmul__):
                    self.calls.append((args[0], args[1]))
                return func(*args, **(kwargs or {}))

        self.torch, self.calls, self._mode = torch, [], _Mode()

    def __enter__(self):
        self._mode.__enter__()
        return self

    def __exit__(self, *exc):
        return self._mode.__exit__(*exc)

    def replay(self):
        for x, y in self.calls:
            self.torch.matmul(x, y)


def cuda_ms(torch, fn):
    """Milliseconds of fn() on the card's current stream (CUDA events)."""
    ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    ev0.record()
    fn()
    ev1.record()
    torch.cuda.synchronize()
    return ev0.elapsed_time(ev1)


def cli_plans(torch, loader, cli_main):
    """The example capacity plans through the CLI, on the card and on the
    CPU: the same stdout and exit code."""
    import contextlib
    import io

    for name, extra, mode in CLI_CONFIGS:
        path = os.path.join(HERE, "examples", name)
        runs = []
        for device in ("cuda", "cpu"):
            loader._RAND.seed(20260729)  # the new-node names' generator
            buf = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                rc = cli_main(["apply", "-f", path, "--max-new-nodes", "16", "--sweep-mode", mode,
                               "--device", device, *extra])
            torch.cuda.synchronize()
            runs.append((rc, buf.getvalue(), time.perf_counter() - t0))
        (rc_k, out_k, s_k), (rc_c, out_c, s_c) = runs
        log(f"cli {name} {mode} {' '.join(extra)}: rc={rc_k}/{rc_c} card {s_k:.2f}s "
            f"cpu {s_c:.2f}s: {out_k.splitlines()[0] if out_k else ''}")
        if rc_k != 0 or (rc_k, out_k) != (rc_c, out_c):
            raise SystemExit(f"cli {name}: the card and the CPU printed different plans")
        if extra and "=== GPU ===" not in out_k:
            raise SystemExit(f"cli {name}: no GPU table in the report")


def lane0(out):
    """The kernel's (node, fail counts, feasible counts) of lane 0, as numpy."""
    return tuple(x[0].cpu().numpy() for x in out[:3])


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
        from open_simulator_tpu_torch.cli.main import main as cli_main
        from open_simulator_tpu_torch.k8s import loader
        from open_simulator_tpu_torch.kernels import build, step
        from open_simulator_tpu_torch.parallel import sweep
        from open_simulator_tpu_torch.testing.synthetic import (
            device_resource_cluster, device_resource_snapshot, soft_spread_cluster,
            synthetic_objects, synthetic_snapshot)
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
    insts = instantiations(build.BUILD_LOG.get("plain_step", ""))
    log(f"build plain_step instantiations: {insts}")
    spilled = [k for k in LAUNCHED if k not in insts or insts[k]["spill_store_bytes"]]
    if spilled:
        raise SystemExit(f"build: plain_step {spilled} spill registers (or were not reported)")

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

    # the device-resource cluster with mid-sequence pods bound by nodeName
    # that carry pinned GPUs, as one launch of 4 lanes over 8 GPU slots
    snap_g = device_resource_snapshot(1024, 10240, max_new=8)
    cfg_g = sched.make_config(snap_g)
    if not (all(getattr(cfg_g, g) for g in DEVRES_GATES) and cfg_g.forced_prefix
            and (snap_g.arrays.forced_node[cfg_g.forced_prefix:] >= 0).any()):
        raise SystemExit("parity input devres is not the device-resource path it should be")
    n_g, r_g = snap_g.n_nodes, snap_g.n_real_nodes
    lanes_g = np.stack([np.arange(n_g) < r_g, np.ones(n_g, bool), np.arange(n_g) < r_g + 3,
                        np.concatenate([rng.rand(r_g) < 0.8, np.ones(n_g - r_g, bool)])])
    errs.append(parity(torch, sched, step, "devres-1024x10240-4-lanes", snap_g.arrays, cfg_g,
                       lanes_g, n_pods=PARITY_PREFIX)[2])

    # the edges of the launch geometry: fewer nodes than blocks in a
    # cluster (empty slices), slices that leave a ragged last block, and an
    # odd number of lanes (an odd number of clusters)
    for label, snap_e, lanes_of, n_e in (
            ("tiny-3-nodes-rich", synthetic_snapshot(3, 64, rich=True), 1, None),
            ("tiny-3-nodes-dom_count", synthetic_snapshot(3, 64), 1, None),
            ("ragged-devres-1000x2048", device_resource_snapshot(1000, 2048), 1, 1024),
            ("odd-lanes-3-rich-509x1024", synthetic_snapshot(509, 1024, rich=True), 3, None)):
        cfg_e = sched.make_config(snap_e)
        n_e_nodes = snap_e.n_nodes
        masks_e = np.stack([np.ones(n_e_nodes, bool), np.arange(n_e_nodes) % 3 != 1,
                            rng.rand(n_e_nodes) < 0.75])[:lanes_of]
        errs.append(parity(torch, sched, step, f"geometry-{label}", snap_e.arrays, cfg_e,
                           masks_e, n_pods=n_e)[2])
        plan_e = step.LAST_PLAN
        short = n_e_nodes - (plan_e.cluster - 1) * plan_e.slice_len
        if label.startswith("tiny") and not plan_e.cluster > n_e_nodes:
            raise SystemExit(f"geometry {label}: cluster {plan_e.cluster} has no empty slice")
        if label.startswith("ragged") and not 0 < short < plan_e.slice_len:
            raise SystemExit(f"geometry {label}: the last slice is not ragged ({plan_e})")
        if label.startswith("odd") and plan_e.cluster < 2:
            raise SystemExit(f"geometry {label}: the 3 lanes ran without clusters ({plan_e})")

    # ---- 4. the main paths: simulate() at full size, through the kernel
    def cluster_of(kind):
        if kind == "devres":
            return device_resource_cluster(NODES, PODS)
        nodes, pods, _ = synthetic_objects(NODES, PODS, rich=kind == "rich")
        return ClusterResources(nodes=nodes, pods=pods)

    def snapshot_of(kind):
        if kind == "devres":
            return device_resource_snapshot(NODES, PODS, max_new=CAPACITY_LANES)
        return synthetic_snapshot(NODES, PODS, max_new=CAPACITY_LANES, rich=kind == "rich")

    paths = {}
    for label, kind in PATHS:
        paths[label] = main_path(torch, sched, step, simulate, cluster_of, label, kind)

    # ---- 5. the capacity plan: 64-lane sweeps and their bisection, then
    # the example plans through the CLI on the card and on the CPU
    for label, kind in PATHS:
        paths[f"capacity-{label}-64"] = capacity_path(torch, sched, step, sweep,
                                                      snapshot_of, label, kind)
    t0 = time.perf_counter()
    cli_plans(torch, loader, cli_main)
    log(f"cli: {len(CLI_CONFIGS)} plans on the card and on the CPU agree "
        f"({time.perf_counter() - t0:.1f}s)")

    # ---- 6. results
    # ms, plain_ms and bound_ms cover the same pods: the rich path's first
    # PARITY_PREFIX; each path's whole run is under "paths"
    rich_p = paths["northstar-rich"]
    same = rich_p["same_pods"]
    kernels = [{
        "name": "plain_step", "route": "cuda",
        "source": "open_simulator_tpu_torch/csrc/plain_step.cu",
        "replaces": "open_simulator_tpu/engine/scheduler.py:745",
        "lane_prologue_replaces": "open_simulator_tpu/engine/exec_cache.py:491",
        "launches": rich_p["launches"],
        "instantiations": {k: {**v, "launched": k in LAUNCHED} for k, v in insts.items()},
        "max_abs_err": max(errs + [p["max_abs_err"] for p in paths.values()]),
        "pods": same["pods"], "ms": same["ms"], "plain_ms": same["plain_ms"],
        "bound_ms": same["bound_ms"], "bound_by": same["bound_by"], "library_ms": None,
        "paths": paths,
        "parity": "bit-exact vs the plain step on synthetic 1024x10240, inline "
                  "512x4096, the same in 4 lanes, rich 1024x10240 bound 0.1, rich "
                  "512x4096 dense, "
                  f"rich 512x1024 4 lanes, the first {PARITY_PREFIX} pods of devres "
                  "1024x10240 in 4 lanes (8 GPU slots), the geometry edges (3 nodes rich "
                  "and dom_count, the first 1024 pods of devres 1000x2048, rich 509x1024 "
                  "in 3 lanes), "
                  f"the first and last {PARITY_PREFIX} pods of the northstar, "
                  "northstar-rich and northstar-devres main paths, and the first "
                  f"{PARITY_PREFIX} pods of lanes 0 and 63 of the capacity-northstar-64, "
                  "capacity-northstar-rich-64 and capacity-northstar-devres-64 sweeps",
    }]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": dev_name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
