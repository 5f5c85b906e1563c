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
PVs, EBS attach limits with shared claims), under the DefaultPreemption
pass (``northstar-preempt``: priority classes, a disruption budget and
critical pods that must evict) and through a ``Simulator`` session, then
the wave path on the reference bench's ``pools`` preset (1,024 nodes x
10,240 pods in 32 pools, which the wave planner runs as 320 waves), then
the capacity plan on the first three (the reference bench's 64-lane
north-star sweep, its bisection, and the example plans through the
CLI), and trace replay (``replay-day``: a day of arrivals, departures
and a node failure on 5,120 nodes with the autoscaler and the descheduler,
6,144 nodes x 29,696 pods in the universe; ``replay-resume``), policy
tuning (``tune-rich-64``: ``tune_search`` on the rich cluster, 64 weight
rows a launch), the cost frontier (``frontier-northstar``: 289 node
mixes as lanes) and a fleet campaign (``fleet-16``: sixteen recorded
dumps, 1,024 x 10,240 and 512 x 5,120 in two buckets, one torn, the
same-bucket clusters as the lanes of one launch of the step's fleet form)
— and checks that each ran through the kernels and that its answer is
right.

Phases, in order (any failure exits nonzero; each prints its wall time):

1. the card's name and power limit (nvidia-smi);
2. the kernel build, one nvcc per library (``plain_step``, its explain
   twin ``plain_step_explain``, the extension library's two,
   ``plain_step_ext`` and ``plain_step_ext_explain``, and the wide
   library's two, ``plain_step_wide`` and ``plain_step_wide_explain``,
   built from the same source, ``wave_merge``, ``forced_fold``), started
   together, with ptxas's registers and spills of each of the 24
   ``plain_step`` instantiations, the 8 fleet builds, the 16 extension
   builds and the wide library's 32, each of the 24 beside their counts
   before the fleet form (no build may spill);
3. kernel vs plain step, exact equality of node, fail counts, feasible
   counts, GPU and PV picks and all twelve carry fields, each side
   starting its lanes from the template carry through its lane prologue,
   on (each over its first pods, ``EARLIER_DEPTH`` or a multiple): the
   synthetic cluster at 1,024 x 10,240 with forced pods interleaved
   (dom_count carry); a 512 x 4,096 cluster with hostname and zone
   soft spread, taints, unschedulable nodes, host ports and a leading
   nodeName run (group_count carry); the same as one 4-lane launch with
   a different active mask per lane; the rich cluster at 1,024 x 10,240
   with 10% of the pods pre-bound; the rich cluster at 512 x 4,096 in
   the dense form (slot_paint off); the rich cluster at 512 x 1,024 as
   one 4-lane launch; the device-resource
   cluster at 1,024 x 10,240 with 8 GPU node slots as one 4-lane launch
   (all six device-resource gates, pods bound mid-sequence with pinned
   GPUs); the device-resource cluster at 1,024 x 2,048 with the inter-pod
   constraints (``plain_step<1,1>``, four times ``EARLIER_DEPTH``); the explain builds of both
   device-resource instantiations (the top-k and the seeded jitter on
   1,024 x 2,048 without and with the inter-pod
   constraints); the top-k's passes in each scan build's explain twin
   (K = 1, the pass width ``kernels/step.TOPK_PASS``, one past it and past
   two passes, over the first ``EARLIER_DEPTH // 4`` pods of the four
   <I,D> inputs; K = N on 3 nodes); the preemption columns (random
   victims and nominations from a seed, among them inactive nodes, forced
   pods, victims, -1 and out-of-range values) on a 512 x 1,024 input of
   each of the four instantiations (their "+columns" builds, then their
   "+columns+explain" twins with the top-k and the jitter); then
   the edges of the launch geometry (one thread-block cluster per lane):
   3 nodes (fewer than the cluster's blocks; rich and dom_count), the
   device-resource cluster at 1,000 nodes (a ragged last slice) and the
   rich cluster at 509 nodes as 3 lanes (an odd number of clusters); each
   parity line prints the launch's cluster size, block size and slice;
   then the wave form (``plain_step``'s frozen builds and ``wave_merge``)
   on 512 x 4,096 pools clusters with the inter-pod terms (``<1,0>``),
   GPU share (``<0,1>``) and both (``<1,1>``)
   (``testing/synthetic.wave_pools_snapshot``), 64 lanes: over the first
   waves, each frozen launch's outputs on lanes 0 and 63 against the
   plain step's frozen form and each merge against the plain merge on
   every lane and carry field; the same with the top-k and the jitter
   on ("+frozen+explain"), at the launch plan's group size; then one
   wave of every frozen build (``<0,0>`` too, and each explain twin) at
   one pod a cluster, at a group of 3 (straddling the 32-pod wave's end)
   and, with a weight row a lane, at the plan's; then the wide library: the device-resource
   cluster at 1,024 x 2,048 widened to 9 volume groups, 33 exclusive
   devices and 9 WaitForFirstConsumer claims a pod
   (``testing.widen_device_resources``; ``<0,1>`` and ``<1,1>``) against
   the plain step, and one zone past the shared-memory bound of a
   5,120-node lane (``testing.many_domain_snapshot``, the dom_count path
   and the group_count path: the dom_count replica and the column-read
   partials in global memory), timed over 1,024 pods beside the
   shared-memory form one zone below and held to the plain step over 32;
   then each of the eight fleet builds (three variants of a 512 x 1,024
   synthetic, rich, devres and devres-rich cluster, with and without the
   top-k and the jitter) against one plain_step launch per cluster and
   the plain fleet; then each build the extension rows reach (the four
   <I,D> inputs at 1,024 x 2,048, each without and with the preemption
   columns and the top-k and the jitter: the 16 scan builds, the rich
   ones with the group_count and the dom_count carries both live; the
   wide library's <0,1> and <1,1>), with seeded extension rows (a NaN
   score every third pod), over their first ``EXT_DEPTH`` pods against
   the plain step;
4. the simulate() paths, non-rich, rich, devres: launch counts reset,
   ``simulate()`` at full size, counts read; then the kernel timed on the
   path's arrays (its placements, and on devres its GPU allocations, must
   equal simulate()'s), one more launch with the kernel's per-phase cycle
   counts on (each phase's share printed), the kernel and the plain step
   compared over the first ``PARITY_PREFIX`` pods from the template and
   over the last ``PARITY_PREFIX`` from the kernel's own carry; on the rich path a host check that
   no pod shares its node with a pod its hostname anti-affinity term
   names; on the devres path the six gates, every device-resource reason
   row but the missing-PV one refusing nodes, and host checks of the PV
   bindings, the GPU devices' memory and the nodes' EBS attachments;
   then ``northstar-rich-explain``: ``simulate(config_overrides=
   {"explain_topk": 3})`` on the rich cluster (one launch of the explain
   build), host checks of the top-k tensors (the first candidate is the
   placed node, the parts sum to the score, fillers zeroed),
   ``explain_result`` timed, the launch timed against explain_topk = 0,
   the first ``PARITY_PREFIX`` pods against the plain step (all three top-k tensors)
   and the top-k of their masked scores through the plain ranking and
   ``torch.topk``; ``northstar-tiebreak``: ``simulate(config_overrides=
   {"tie_break_seed": 7})`` on the north-star cluster (one explain
   launch), timed against seed 0, placements that differ from seed 0
   counted (more than 0), the first ``PARITY_PREFIX`` pods against the plain step,
   the plain jitter timed; then ``northstar-ext``: ``simulate()`` on the
   north-star cluster with five torch extension ops
   (``testing.synthetic.synthetic_extensions``: a filter of the arrays,
   one of the pod slice, a "minmax", a "max" of the carry and a "none"
   score), launch counts and the loop's counters reset and read (one
   launch a pod, the loop one captured CUDA graph replayed for every pod
   after the first, never eager), its per-pod loop timed, the extension
   reason rows' totals and the placements' digest; the first
   ``PARITY_PREFIX`` pods again through the engine's loop, the graph's
   replays from the template with the stream primed (the device time a
   pod, the card's idle share), the launches alone back to back with the
   cursor's steps (the device time a launch), the kernel against the plain step through
   the same per-pod loop, and the same one-lane launch without
   extensions (a build without their code) timed;
   then ``northstar-preempt``: launch counts reset, ``simulate()`` on the
   north-star cluster with PriorityClasses (batch, prod for one pod in
   four, system), a minAvailable 90% budget over app=a0 and an app of
   ``PREEMPTORS`` system pods of 12 CPU, counts read (one launch per pass: the first
   without preemption columns, each rescan with them); each planning
   round's host time, the events and victims; the invariants (each
   preemptor on its nominated node, each victim -3 and decoded as
   preempted, no other pod bound in the first pass moved); each pass's
   kernel timed alone with its columns (and once with the cycle counters)
   and held to the pass's placements; the final rescan's first and last
   ``PARITY_PREFIX`` pods against the plain step with its columns, and with the
   top-k too (``<0,0>+columns+explain``); then a
   ``Simulator`` session on the same
   objects (``run_cluster``, one ``schedule_app`` per app), each call's
   wall, prior placements kept except the victims, the final placements
   equal to simulate()'s; then ``pools``: launch counts reset,
   ``simulate()`` at one lane, counts read (one frozen launch and one
   merge per wave, no scan launch, the wave loop one CUDA graph replayed
   for all but its first wave), the plan and its ``wave_id`` /
   ``wave_batched`` decode checked, the planner timed; the wave path's
   kernels timed (each launch between CUDA events, min of 3) beside the
   scan kernel over the same pods, outputs and every carry field equal
   to the scan's, placements equal to simulate()'s; the engine's wave
   loop (its graph against its eager loop: the wall a wave, the graph's
   replays' wall and device time a wave, the card's idle share in them);
   the first 16 waves against the plain versions; the bench's 64-lane
   ``schedule_lanes`` with the plan against the scan's (the one 64-lane
   frozen launch's bound, the loop again at 64 lanes); the same cluster with 64 new-node
   slots through ``capacity_sweep`` (64 lanes), the same sweep under the
   traced weights at the config's own vector (``pools-traced``: every
   frozen launch with the weight row, the constant sweep's plan digest) and
   ``capacity_bisect(lanes=8)``, and the wave form's parity (``<0,0>``)
   on its lanes 0 and 63; then ``pools-explain``: the same preset with
   explain_topk = 3 through ``simulate()`` (one frozen explain launch and
   one merge per wave), its first 16 waves against the plain versions,
   the whole run's top-k tensors against the scan's, and those 16 waves'
   frozen launches timed alone with and without the top-k; then
   ``replay-day``: launch counts reset, ``run_replay`` of
   ``replay.synthetic_replay_cluster(5120, 5120)`` with
   ``synthetic_trace_dict(n_batches=12, batch_pods=2048,
   max_new_nodes=1024)`` and the controllers ``autoscaler:scale_step=64``
   and ``descheduler:period=4`` on the card, counts read (``plain_step``
   and ``forced_fold`` launched); each step's wall, path (full scan or
   fast path) and its scan kernel and fold time (CUDA events); every fold
   chunk against its plain version; the first full scan's first
   ``PARITY_PREFIX`` pods from the hoisted carry against the plain step; one step's
   whole-mask fold timed beside its plain version and its torch.matmul
   calls; the same trace with the fast path off, the same digest; then
   ``replay-resume``: the trace with a checkpoint directory, stopped once
   step 8 is journaled, resumed from the journal, the same digest; then
   ``tune-rich-64``: ``tune_search`` on the rich cluster in grid mode and
   in CEM mode (64 variants, 2 rounds, seed 0; each round one
   ``plain_step`` launch with a [64, 9] weight row), counts read after
   each, the CEM search again (the same report digest); lane 0 of round 1
   the baseline vector, its placements equal a constant-config 64-lane
   launch; the weighted 64-lane launch timed against the constant one
   (CUDA events, in turns) with its bound; two lanes with different rows
   over the first ``EARLIER_DEPTH`` pods against the plain step; then
   ``frontier-northstar``: ``capacity_frontier`` on the north-star cluster
   with the north-star node template and one of twice its CPU and memory
   (16 of each at most: 289 mixes, 64 lanes a launch), twice (the same
   Pareto set), counts read, each round's launch time, round 2's lanes 0
   and 63 over the first ``EARLIER_DEPTH`` pods against the plain step;
   then ``fleet-16``: ``write_synthetic_fleet(n_clusters=16, nodes=1024,
   pods=10240, malformed=1)``, ``run_campaign`` with the fleet lanes on
   (lanes of 8: two fleet launches and the torn dump's serial quarantine)
   and off (sixteen serial clusters), counts read after each, the same
   report digest; each fleet launch between CUDA events, each lane's
   forced-prefix fold, the walls, clusters a second and peak device
   memory; every cluster of each bucket against its lone plain_step
   launch over every pod, and two against the plain fleet over the first
   ``FLEET_PLAIN_DEPTH``;
5. the capacity paths, non-rich, rich, devres, at 5,120 + 64 nodes x
   51,200 pods (devres: 64 slots of ``examples/newnode/gpu.yaml``):
   launch counts reset, ``capacity_sweep`` over the bench's 64 counts,
   counts read (one 64-lane launch); the launch timed alone, with peak
   device memory, its geometry and its per-phase cycle shares (on the
   north-star snapshot, then ``capacity-northstar-ext-64``: the extension
   ops through ``capacity_sweep`` over its first ``EXT_SWEEP_PODS`` pods,
   64 lanes, one launch a pod through the captured graph, lanes 0 and 63 over the first
   ``EXT_SWEEP_PARITY`` pods against the plain step and the sweep); lanes at
   counts 0, 21, 42 and 63 against one-lane launches, bit for bit; the
   64-lane hoist and the forced-prefix fold (4,096 pods pinned where
   lane 63 put them; devres: the cluster's own nodeName prefix; one
   ``forced_fold`` launch pair a chunk) timed beside its plain version
   and its torch.matmul calls and held equal to the kernel's carry after
   those pods; the kernel against
   the plain step over the first ``PARITY_PREFIX`` pods of lanes 0 and 63;
   ``capacity_bisect`` (8 lanes) against the sweep's answer under a CPU
   limit that puts it inside (0, 64); then the
   ``config``, ``constraints``, ``controlplane``, ``morepods``,
   ``gpushare`` (``--extended-resources gpu``, both sweep modes),
   ``openlocal`` and ``stateful`` plans through the CLI on the card and on
   the CPU, with the same output, ``explain -f examples/config.yaml
   --json`` on both, with the same report, ``replay --cluster-config
   examples/cluster/demo --trace <a synthetic trace> --controller
   autoscaler --json`` on both, with the same report, and ``tune`` (CEM, 4
   lanes) and ``replay --frontier`` on the same cluster on both, with the
   same reports;
6. one JSON line describing each kernel (``plain_step``, its frozen
   form ``plain_step_frozen``, ``wave_merge``, ``forced_fold``, and the
   explain builds
   ``plain_step_explain`` and ``plain_step_frozen_explain``, and the
   per-lane weight row ``plain_step_weights``, and the fleet form
   ``plain_step_fleet``, and the extension rows ``plain_step_ext``, with
   its 16 builds of the libraries ``plain_step_ext`` and
   ``plain_step_ext_explain``), with each plain_step instantiation's registers,
   stack and spills, and their change against the builds before the fleet
   form), then the
   device line.

Needs CUDA: without it, or run alone outside the repository, it exits
nonzero and prints no result.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import gc
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
# milliseconds a pod on the card; 2,048 until the tuning paths were added,
# 1,024 until the fleet path was, 512 until the extension paths were, 256
# until a run on a slow host took 1,286 s)
PARITY_PREFIX = 128
# the capacity phase: the reference bench's north-star sweep (64 lanes,
# 64 new-node slots) and the count its bisection is set to find
CAPACITY_LANES = 64
BISECT_TARGET = 37
# pods of the full-width forced-prefix fold (one fold chunk)
FOLD_PODS = 4096
# the replay-day path (replay.synthetic_replay_cluster and
# synthetic_trace_dict at full width: 5,120 nodes with 5,120 running pods,
# twelve arrivals of 2,048 pods, a departure every third, a kill_node
# before the seventh, 1,024 template slots) and its controllers
REPLAY = {"nodes": 5120, "base_pods": 5120, "batches": 12, "batch_pods": 2048,
          "max_new": 1024, "controllers": ("autoscaler:scale_step=64", "descheduler:period=4")}
# replay-resume stops once this step's row is journaled
RESUME_AFTER = 8
# the full-size paths' nodes and pods
NODES, PODS = 5120, 51200
# the pools path: the reference bench's wave-showcase preset (bench.py:351)
POOLS = {"nodes": 1024, "pods": 10240, "pools": 32}
# torch.cuda._sleep's cycles per millisecond (the H100 SXM's 1.98 GHz
# boost clock; a slower clock only spins longer)
SPIN_CYCLES_PER_MS = 1_980_000
# waves of each wave parity input compared with the plain versions, and
# waves of the one-lane pools run whose kernels are timed beside theirs
WAVE_PARITY_WAVES, WAVE_SAME = 4, 16
# how long the stream spins before each WAVE_SAME waves of a run whose
# kernels are timed alone: longer than the host takes to queue their
# launches (about 0.25 ms a wave)
PRIME_MS = 10
# the northstar-preempt path's last app: system pods of 12 CPU, more than
# any node of the 16-CPU north-star cluster has free without evictions
# (cut from 32 to 16, to 8, then to 4, as later paths were added)
PREEMPTORS, SYSTEM_CPU = 4, "12"
# the depth (pods) of the parity inputs of phase 3 and of the tuning and
# frontier paths, cut so that the later paths fit the time limit (1,024,
# then 512, then 256, then 128, then 64): the 4-lane group_count input, the
# explain and geometry inputs and the tuning and frontier lanes at this
# depth; the rich 1,024-node, dense rich and group_count inputs at twice
# it; the dom_count and devres-rich (<1,1>) inputs at four times; the
# column inputs at four times and the rich 4-lane input at eight (256 and
# 512 pods, as before the cut to 128: their checks that nominations hold
# and that the lanes place pods differently need that depth); the 4-lane
# device-resource input at half; the top-k's pass inputs at a quarter
EARLIER_DEPTH = 64
# explain: the candidates recorded per pod, and the tie-break seed of the
# northstar-tiebreak path
EXPLAIN_K, TIE_SEED = 3, 7
# (label, cluster kind) of the full-size paths
PATHS = (("northstar", "plain"), ("northstar-rich", "rich"), ("northstar-devres", "devres"))
# (config, extra arguments, sweep mode)
CLI_CONFIGS = (("config.yaml", (), "bisect"), ("constraints-config.yaml", (), "bisect"),
               ("controlplane-config.yaml", (), "bisect"), ("morepods-config.yaml", (), "bisect"),
               ("gpushare-config.yaml", ("--extended-resources", "gpu"), "bisect"),
               ("gpushare-config.yaml", ("--extended-resources", "gpu"), "exhaustive"),
               ("openlocal-config.yaml", (), "bisect"), ("stateful-config.yaml", (), "bisect"))


_T0 = time.perf_counter()
# the kernels' launch counters (kernels/step.LAUNCHES, kernels/wave.LAUNCHES),
# filled by main() once the package is imported
COUNTERS = []


def reset_counts() -> None:
    for counts in COUNTERS:
        for name in counts:
            counts[name] = 0


def read_counts() -> dict:
    return {name: n for counts in COUNTERS for name, n in counts.items()}


def log(msg: str) -> None:
    print(f"[{time.perf_counter() - _T0:7.1f}s] {msg}", flush=True)


class GcClock:
    """The cyclic garbage collector's pauses on the host clock (its
    ``gc.callbacks``): ``since(mark())`` says how much of a wall the
    collector took, and in how many full (generation-2) passes."""

    def __init__(self) -> None:
        self.s, self.full, self._t0 = 0.0, 0, 0.0

    def __call__(self, phase: str, info: dict) -> None:
        if phase == "start":
            self._t0 = time.perf_counter()
        else:
            self.s += time.perf_counter() - self._t0
            self.full += info["generation"] == 2

    def mark(self):
        return self.s, self.full

    def since(self, mark) -> str:
        return f"gc pauses {self.s - mark[0]:.3f} s ({self.full - mark[1]} full)"


GC = GcClock()


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
    fields); a NaN (an extension's score) must stand where the other side
    has one."""
    equal, err = True, 0.0
    pairs = list(zip(out_k, out_p)) + [(getattr(st_k, f), getattr(st_p, f))
                                       for f in type(st_k).__dataclass_fields__]
    for a, b in pairs:
        if a.dtype.is_floating_point:
            equal &= torch.equal(a.isnan(), b.isnan())
            a, b = a.nan_to_num(0.0), b.nan_to_num(0.0)
        equal &= torch.equal(a, b)
        if a.numel():
            err = max(err, float((a.float() - b.float()).abs().max()))
    return equal, err


def parity(torch, sched, step, label, arrs_np, cfg, active_np, n_pods=None, start=None,
           columns=None, weights=None, ext_seed=0):
    """Kernel vs plain step on the card, from the same carry, over the pods
    after the forced prefix (the first `n_pods` of them if set). The carry
    is the template, written into new (unset) lane buffers by each side's
    lane prologue, or with `start` = (first pod, lane-stacked state) that
    state. `columns` = (disabled, nominated) numpy [P] are the preemption
    columns both sides read (`cfg.forced_prefix` 0: the columns turn the
    fold off); `weights` (numpy [S, K], under ``cfg.traced_weights``) the
    lanes' weight rows; under ``cfg.extensions`` both sides take the same
    seeded extension rows (``testing.synthetic.random_extension_rows``
    with `ext_seed`, a NaN score every third pod). Returns (plain
    seconds, kernel seconds, max abs error, kernel outputs)."""
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
    cols = column_tensors(torch, columns)
    if weights is not None:
        cols["weights"] = torch.from_numpy(weights).to(dev)
    if cfg.extensions:
        from open_simulator_tpu_torch.testing.synthetic import random_extension_rows

        ok, raw = random_extension_rows(cfg, active.shape[0], p1 - p0, arrs.alloc.shape[0],
                                        seed=ext_seed, nan=True)
        cols.update(ext_ok=None if ok is None else ok.to(dev),
                    ext_raw=None if raw is None else raw.to(dev))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out_k = step.plain_step_cuda(arrs, active, hoist, inv, st_k, cfg, p0, p1, template=tmpl,
                                 **cols)
    torch.cuda.synchronize()
    t_k = time.perf_counter() - t0
    t0 = time.perf_counter()
    out_p = step.plain_step_torch(arrs, active, hoist, inv, st_p, cfg, p0, p1, template=tmpl,
                                  **cols)
    torch.cuda.synchronize()
    t_p = time.perf_counter() - t0
    plan = step.LAST_PLAN
    equal, err = compare(torch, out_k, out_p, st_k, st_p)
    n_sched = int((out_k[0] >= 0).sum())
    extra = ""
    if columns is not None:
        extra = (f"victims={int(columns[0][p0:p1].sum())} nominated="
                 f"{int((columns[1][p0:p1] >= 0).sum())} ")
    log(f"parity {label}: lanes={active.shape[0]} pods={p1 - p0} (after a {p0}-pod "
        f"prefix) {extra}{geometry(plan)} scheduled={n_sched} "
        f"fail_counts_sum={int(out_k[1].sum())} "
        f"kernel_s={t_k:.4f} plain_s={t_p:.2f} equal={equal} max_abs_err={err} "
        f"phase_s={time.perf_counter() - t_phase:.1f}")
    if not equal:
        raise SystemExit(f"parity {label}: kernel and plain step disagree")
    return t_p, t_k, err, out_k


def column_tensors(torch, columns):
    """(disabled, nominated) numpy -> the kernel wrappers' keyword
    arguments on the card ({} for None)."""
    import numpy as np

    if columns is None:
        return {}
    dis, nom = columns
    dev = torch.device("cuda")
    return {"disabled": torch.from_numpy(np.ascontiguousarray(dis, dtype=bool)).to(dev),
            "nominated": torch.from_numpy(np.ascontiguousarray(nom, dtype=np.int32)).to(dev)}


# the instantiations plain_step<kInterpod, kDevRes, kCols, kFrozen,
# kExplain> the run launches (<1,1>: the device-resource cluster with the
# inter-pod constraints, a parity input of phase 3; "+columns": a launch
# with the preemption columns, the column parity inputs and
# northstar-preempt's rescans; "+frozen": the wave form, the pools path and
# the wave parity inputs; "+explain": the explain library's twin of each,
# under explain_topk or tie_break_seed)
# ptxas's registers of the 24 builds before the fleet form (PERF.md §6): the build
# phase prints each build's change against them (the fleet form and the
# wide library leave them as they were)
BASE_REGISTERS = {"<0,0>": 112, "<1,0>": 110, "<0,1>": 163, "<1,1>": 151,
                 "<0,0>+columns": 128, "<1,0>+columns": 110, "<0,1>+columns": 153,
                 "<1,1>+columns": 149, "<0,0>+frozen": 118, "<1,0>+frozen": 102,
                 "<0,1>+frozen": 154, "<1,1>+frozen": 158,
                 "<0,0>+explain": 114, "<1,0>+explain": 120, "<0,1>+explain": 141,
                 "<1,1>+explain": 151, "<0,0>+columns+explain": 114,
                 "<1,0>+columns+explain": 118, "<0,1>+columns+explain": 139,
                 "<1,1>+columns+explain": 149, "<0,0>+frozen+explain": 106,
                 "<1,0>+frozen+explain": 116, "<0,1>+frozen+explain": 168,
                 "<1,1>+frozen+explain": 164}
LAUNCHED = tuple(f"<{i},{d}>{c}{x}" for x in ("", "+explain")
                 for c in ("", "+columns", "+frozen")
                 for i, d in ((0, 0), (1, 0), (0, 1), (1, 1)))
# the fleet builds (plain_step_fleet_kernel<kInterpod, kDevRes, kExplain>)
FLEET_BUILDS = tuple(f"<{i},{d}>+fleet{x}" for x in ("", "+explain")
                     for i, d in ((0, 0), (1, 0), (0, 1), (1, 1)))
# the scan builds with the extension rows (kExt), in the libraries
# plain_step_ext and plain_step_ext_explain
EXT_BUILDS = tuple(f"<{i},{d}>{c}{x}+ext" for x in ("", "+explain") for c in ("", "+columns")
                   for i, d in ((0, 0), (1, 0), (0, 1), (1, 1)))


def instantiations(build_log, suffix=""):
    """{"<I,D>", "<I,D>+columns", "<I,D>+frozen" or "<I,D>+fleet", each
    with "+explain" in the explain libraries, and `suffix` ("+wide" for the
    wide libraries, "+ext" for the extension libraries): {registers,
    stack_bytes, spill_store_bytes, spill_load_bytes}} of each plain_step
    instantiation, from ptxas's -v report in the build log (the sixth
    flag, kExt, is the library's)."""
    import re

    out, name = {}, None
    for line in build_log.splitlines():
        m = re.search(r"plain_step_kernelILb([01])ELb([01])ELb([01])ELb([01])ELb([01])ELb[01]E",
                      line)
        if m:
            name = (f"<{m.group(1)},{m.group(2)}>" + ("+columns" if m.group(3) == "1" else "")
                    + ("+frozen" if m.group(4) == "1" else "")
                    + ("+explain" if m.group(5) == "1" else "") + suffix)
            continue
        m = re.search(r"plain_step_fleet_kernelILb([01])ELb([01])ELb([01])E", line)
        if m:
            name = (f"<{m.group(1)},{m.group(2)}>+fleet"
                    + ("+explain" if m.group(3) == "1" else "") + suffix)
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
    from open_simulator_tpu_torch.kernels.step import placement_name

    return {"cluster": plan.cluster, "threads": plan.threads, "slice": plan.slice_len,
            "headroom_in_smem": plan.headroom, "staged": placement_name(plan),
            "smem_bytes": plan.smem, "resident_clusters": plan.resident, "group": plan.group}


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
    node affinity 3, taint 4. The live rows are the launch's: under the
    traced weights every enabled row and all three resource terms, a zero
    weight included. Per pod: D compares per hard-spread minimum
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
    use_bal, use_least, use_most = sched.resource_terms(cfg)
    per_feasible = (4 + 7 * use_bal + 6 * use_least + 12 * use_most + 1 + 3 * use_na + 4 * use_tt
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


def fold_work(a, cfg, node):
    """(bytes, operations) of folding pods into a carry at `node` (one
    entry a pod of the first len(node) pods, negative: not folded) — what
    ``apply_forced_prefix`` (every node set) and ``apply_forced_mask``
    compute. Bytes: the node column and the folded pods' requests, groups,
    ports, terms and preferred terms, the domain table and the carry, each
    read once, and the carry written once. Operations: the sequential
    binds' own — per folded pod R subtractions, one add per matched group
    (and per matched group and non-hostname key on the dom_count carry),
    one or per port, one add per attach-limit key, and the paints (an add
    per node of the bound node's domain, one under the hostname key)."""
    import numpy as np

    node = np.asarray(node, dtype=np.int64)
    k = len(node)
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
               + _paint_ops(a, cfg, sl, np.maximum(node, 0), per_node_compare=False))
    ops = int((placed * per_pod).sum())
    carry = (n * r * 4 + n * pt + k1 * d * sg * 4 + n * sg * gcb
             + (n * t * gcb if cfg.enable_anti_affinity else 0)
             + (n * t2 * 4 if cfg.enable_pref else 0) + n * lk * 4)
    pod_bytes = k * 4 + int(placed.sum()) * (r * 4 + sg + pt + t + ap * 13 + lk * 4)
    return pod_bytes + k1 * n * 4 + 2 * carry, ops


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
    log(f"main path {label}: cluster objects ready in {time.perf_counter() - t0:.1f}s")
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    result = simulate(cluster, [], device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
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


def preempt_objects(n_nodes, n_pods):
    """(cluster, apps) of the northstar-preempt path: the north-star
    cluster (``synthetic_objects``) with three PriorityClasses — batch (0,
    the global default), prod (1,000; one base pod in four) and system
    (1,000,000) — a PodDisruptionBudget of minAvailable 90% over app=a0,
    and one app of PREEMPTORS system pods of SYSTEM_CPU CPU each, more
    than any node has free without evictions."""
    from open_simulator_tpu_torch.core import AppResource
    from open_simulator_tpu_torch.k8s.loader import ClusterResources
    from open_simulator_tpu_torch.k8s.objects import Pod, PodDisruptionBudget, PriorityClass
    from open_simulator_tpu_torch.testing.synthetic import synthetic_objects

    nodes, pods, _ = synthetic_objects(n_nodes, n_pods)
    for i, p in enumerate(pods):
        if i % 4 == 0:
            p.priority_class_name = "prod"
    classes = [PriorityClass.from_dict({
        "apiVersion": "scheduling.k8s.io/v1", "kind": "PriorityClass", "metadata": {"name": n},
        "value": v, "globalDefault": n == "batch"})
        for n, v in (("batch", 0), ("prod", 1000), ("system", 1_000_000))]
    pdb = PodDisruptionBudget.from_dict({
        "apiVersion": "policy/v1", "kind": "PodDisruptionBudget",
        "metadata": {"name": "a0-budget", "namespace": "default"},
        "spec": {"minAvailable": "90%", "selector": {"matchLabels": {"app": "a0"}}}})
    system = [Pod.from_dict({
        "metadata": {"name": f"system-{i}", "namespace": "default", "labels": {"app": "system"}},
        "spec": {"priorityClassName": "system", "containers": [{
            "name": "c", "resources": {"requests": {"cpu": SYSTEM_CPU, "memory": "4Gi"}}}]}})
        for i in range(PREEMPTORS)]
    cluster = ClusterResources(nodes=nodes, pods=pods, priority_classes=classes, pdbs=[pdb])
    return cluster, [AppResource(name="system", resources=ClusterResources(pods=system))]


class PassRecorder:
    """While active: records each schedule_pods() call simulate() makes
    (its preemption columns, copied, and its node output), the host clock
    of each planning round, and run_with_preemption's result."""

    def __init__(self, core, preemption):
        self.core, self.preemption = core, preemption
        self.passes, self.rounds, self.pre = [], [], None

    def __enter__(self):
        core, pre_mod = self.core, self.preemption
        self._orig = (core.schedule_pods, pre_mod.plan_preemptions, pre_mod.run_with_preemption)
        sp, plan, run = self._orig

        def schedule_pods(*a, disabled=None, nominated=None, **kw):
            out = sp(*a, disabled=disabled, nominated=nominated, **kw)
            self.passes.append((None if disabled is None else disabled.copy(),
                                None if nominated is None else nominated.copy(),
                                out.node.cpu().numpy()))
            return out

        def plan_preemptions(*a, **kw):
            t0 = time.perf_counter()
            events = plan(*a, **kw)
            self.rounds.append((time.perf_counter() - t0, len(events)))
            return events

        def run_with_preemption(*a, **kw):
            out, self.pre = run(*a, **kw)
            return out, self.pre

        core.schedule_pods = schedule_pods
        pre_mod.plan_preemptions = plan_preemptions
        pre_mod.run_with_preemption = run_with_preemption
        return self

    def __exit__(self, *exc):
        (self.core.schedule_pods, self.preemption.plan_preemptions,
         self.preemption.run_with_preemption) = self._orig


def preempt_path(torch, sched, step, core, preemption, label):
    """simulate() under the DefaultPreemption pass at full size (the
    first pass without columns, each rescan with them), with the launch
    counts reset; then each pass's kernel timed alone with its columns,
    the invariants, and the final rescan's first and last pods against
    the plain step with the same columns."""
    import numpy as np

    t_phase = time.perf_counter()
    cluster, apps = preempt_objects(NODES, PODS)
    log(f"main path {label}: cluster objects built in {time.perf_counter() - t_phase:.1f}s")
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with PassRecorder(core, preemption) as rec:
        result = core.simulate(cluster, apps, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    snap = result.snapshot
    n_pods = snap.n_pods
    events = rec.pre.events
    victims = sorted(v for ev in events for v in ev.victim_indices)
    plan_s = [r[0] for r in rec.rounds]
    log(f"main path {label}: simulate() {snap.n_nodes} nodes x {n_pods} pods wall_s={wall:.3f} "
        f"passes={len(rec.passes)} launches={launches} planning rounds (s, events)={rec.rounds} "
        f"events={len(events)} victims={len(victims)} victims per event "
        f"{[len(ev.victim_indices) for ev in events]} scheduled={len(result.scheduled_pods)} "
        f"unscheduled={len(result.unscheduled_pods)}")
    if launches["plain_step"] != len(rec.passes) or len(rec.passes) < 2:
        raise SystemExit(f"main path {label}: {launches} launches for {len(rec.passes)} passes")
    if not events:
        raise SystemExit(f"main path {label}: no preemption event")

    # the invariants: each preemptor on its nominated node, each victim -3
    # and decoded as preempted, no other pod bound in the first pass moved
    first, final = rec.passes[0][2], rec.passes[-1][2]
    off = [ev.preemptor_index for ev in events if final[ev.preemptor_index] != ev.node_index]
    reasons = {u.pod.key: u.reason for u in result.unscheduled_pods}
    bad_victims = [v for v in victims if final[v] != -3 or not reasons.get(
        snap.pods[v].key, "").startswith("preempted to admit higher-priority pod")]
    keep = np.ones(n_pods, bool)
    keep[victims] = False
    moved = int(np.sum(keep & (first >= 0) & (final != first)))
    placed_sys = sum(1 for p in snap.pods if p.meta.labels.get("app") == "system"
                     and p.key in result.placements())
    log(f"main path {label}: invariants: preemptors off their nominated node {len(off)}, "
        f"victims not -3 or not decoded as preempted {len(bad_victims)}, bound pods moved "
        f"{moved}; system pods placed {placed_sys} of {PREEMPTORS}; preempted_pod_keys "
        f"{len(result.preempted_pod_keys)}")
    if off or bad_victims or moved or len(result.preempted_pod_keys) != len(victims):
        raise SystemExit(f"main path {label}: a preemption invariant failed")

    # each pass's kernel alone, with its columns (CUDA events)
    cfg = sched.make_config(snap)
    dev = torch.device("cuda")
    arrs = sched.device_arrays(snap.arrays, dev)
    active = torch.from_numpy(snap.arrays.active).to(dev)[None]
    hoist = sched.hoist_of(arrs, active)
    inv = sched.inv_alloc_of(arrs.alloc)
    pass_ms, pass_phases = [], []
    for i, (dis, nom, node) in enumerate(rec.passes):
        cols = None if dis is None and nom is None else (dis, nom)
        pcfg = cfg if cols is None else cfg._replace(forced_prefix=0)
        tmpl = template_of(sched, arrs, pcfg)
        st = sched.lane_carry(tmpl, 1)
        kw = column_tensors(torch, cols)
        got = []
        times = [cuda_ms(torch, lambda: got.append(step.plain_step_cuda(
            arrs, active, hoist, inv, st, pcfg, pcfg.forced_prefix, n_pods, template=tmpl,
            **kw))) for _ in range(2)]
        if not np.array_equal(got[-1][0][0].cpu().numpy(), node[pcfg.forced_prefix:]):
            raise SystemExit(f"main path {label}: pass {i}'s kernel alone placed pods differently")
        pass_ms.append(min(times))
        pass_phases.append(phase_run(torch, step, f"{label} pass {i}", lambda cyc: (
            step.plain_step_cuda(arrs, active, hoist, inv, st, pcfg, pcfg.forced_prefix, n_pods,
                                 template=tmpl, phase_cycles=cyc, **kw)), 1,
            n_pods - pcfg.forced_prefix, got[-1]))
    log(f"main path {label}: kernel ms per pass (min of 2; pass 0 without columns) "
        f"{[round(t, 3) for t in pass_ms]}; planner s per round {[round(t, 3) for t in plan_s]}; "
        f"host share of the wall {1 - sum(pass_ms) / (wall * 1e3):.4f}")

    # the final rescan's first and last pods against the plain step
    dis, nom, _ = rec.passes[-1]
    cols = (dis, nom)
    pcfg = cfg._replace(forced_prefix=0)
    plain_s, kern_s, err, _ = parity(torch, sched, step, f"{label}-first-{PARITY_PREFIX}",
                                     snap.arrays, pcfg, snap.arrays.active,
                                     n_pods=PARITY_PREFIX, columns=cols)
    q_last = n_pods - PARITY_PREFIX
    tmpl = template_of(sched, arrs, pcfg)
    st_mid = sched.lane_carry(tmpl, 1)
    step.plain_step_cuda(arrs, active, hoist, inv, st_mid, pcfg, 0, q_last, template=tmpl,
                         **column_tensors(torch, cols))
    _, _, err_last, _ = parity(torch, sched, step, f"{label}-last-{PARITY_PREFIX}", snap.arrays,
                               pcfg, snap.arrays.active, start=(q_last, st_mid), columns=cols)
    # the column build under explain (+columns+explain) on the same rescan
    xcfg = pcfg._replace(explain_topk=EXPLAIN_K)
    if step.instantiation(xcfg, tmpl, columns=True) != "<0,0>+columns+explain":
        raise SystemExit(f"main path {label}: the explain rescan runs another instantiation")
    _, _, err_x, _ = parity(torch, sched, step, f"{label}-explain-first-{PARITY_PREFIX}",
                            snap.arrays, xcfg, snap.arrays.active, n_pods=PARITY_PREFIX,
                            columns=cols)
    err_last = max(err_last, err_x)
    # the rescan's work: the normalizers and fail counts still see every
    # feasible node (the uncut mask: the active nodes no filter charged),
    # victims need none; plus the columns, one [P] read each and one
    # scalar gather a pod
    node_r, fail_r, _ = lane0(got[-1])
    feas_r = np.where(dis, 0, int(snap.arrays.active.sum()) - fail_r.sum(1))
    nbytes, ops = step_work(sched, snap.arrays, pcfg, 0, n_pods, (node_r, fail_r, feas_r))
    full = bound_of((nbytes + 5 * n_pods, ops + n_pods))
    log(f"main path {label}: bound of the final rescan: bytes={full[0]} ops={full[1]} -> "
        f"{full[2]:.4f} ms, {full[3]}; the first {PARITY_PREFIX} pods: kernel "
        f"{kern_s * 1e3:.3f} ms, plain step {plain_s * 1e3:.1f} ms; "
        f"phase_s={time.perf_counter() - t_phase:.1f}")
    return {
        "launches": launches["plain_step"], "pods": n_pods, "ms": pass_ms[-1],
        "pass_ms": pass_ms, "pass_phases": pass_phases, "planner_s": plan_s,
        "events": len(events), "victims": len(victims),
        "simulate_s": wall, "bound_ms": full[2], "bound_by": full[3],
        "max_abs_err": max(err, err_last), "scheduled": len(result.scheduled_pods),
        "placements": result.placements(),
        "same_pods": {"pods": PARITY_PREFIX, "ms": kern_s * 1e3, "plain_ms": plain_s * 1e3},
    }


def session_path(torch, step, Simulator, label, reference):
    """A Simulator session on the card: run_cluster on the base pods, then
    schedule_app per app of the northstar-preempt path, the launch counts
    reset before it; each call's wall; prior placements kept except the
    victims, and the final placements equal to `reference`, simulate()'s
    on the same objects."""
    t_phase = time.perf_counter()
    cluster, apps = preempt_objects(NODES, PODS)
    reset_counts()
    sim = Simulator(cluster, device="cuda")
    walls = []
    t0 = time.perf_counter()
    before = sim.run_cluster().placements()
    torch.cuda.synchronize()
    walls.append(time.perf_counter() - t0)
    for app in apps:
        t0 = time.perf_counter()
        sim.schedule_app(app)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    launches = read_counts()
    full = sim.cluster_status()
    sim.close()
    victims = set(full.preempted_pod_keys)
    after = full.placements()
    moved = [k for k, n in before.items() if k not in victims and after.get(k) != n]
    same = after == reference
    log(f"session {label}: {NODES} nodes x {PODS} pods + {PREEMPTORS} system pods: "
        f"run_cluster wall_s={walls[0]:.3f}, schedule_app wall_s "
        f"{[round(w, 3) for w in walls[1:]]}, launches={launches}, victims={len(victims)}, "
        f"prior placements moved {len(moved)}, final placements equal simulate()'s: {same}; "
        f"phase_s={time.perf_counter() - t_phase:.1f}")
    if moved or not victims or not launches["plain_step"] or not same:
        raise SystemExit(f"session {label}: the session lost prior placements or preempted "
                         "nothing, or differs from simulate()")
    return {"nodes": NODES, "pods": PODS, "launches": launches["plain_step"],
            "walls_s": walls, "victims": len(victims)}


def capacity_path(torch, sched, step, sweep, built, label, kind, keep=None):
    """The reference's capacity-sweep preset at full width: 5,120 nodes x
    51,200 pods with 64 new-node slots, 64 lanes (counts min(i % 65, 64))
    in one ``capacity_sweep`` launch; then the launch timed alone, lane
    independence, the kernel against the plain step on two lanes, and the
    bisection against the sweep. `built` is (the snapshot, the seconds it
    took to encode beside the kernel build)."""
    import numpy as np

    t_phase = time.perf_counter()
    snap, built_s = built
    if keep is not None:
        keep["snapshot"] = snap  # the extension sweep reuses it
    cfg = sched.make_config(snap)
    n_pods = snap.n_pods
    counts = [min(i % (CAPACITY_LANES + 1), CAPACITY_LANES) for i in range(CAPACITY_LANES)]
    log(f"capacity {label}: snapshot {snap.n_real_nodes}+{snap.n_nodes - snap.n_real_nodes} "
        f"nodes x {n_pods} pods built in {built_s:.1f}s (beside the kernel build)")

    # the main path: one capacity_sweep, counts read just after
    reset_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    plan = sweep.capacity_sweep(snap, cfg, counts, device="cuda")
    torch.cuda.synchronize()
    sweep_s = time.perf_counter() - t0
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated()
    if launches["plain_step"] != 1:
        raise SystemExit(f"capacity {label}: plain_step launched {launches} times, not once")
    if plan.nodes_per_scenario.shape != (CAPACITY_LANES, n_pods) or not all(plan.all_scheduled):
        raise SystemExit(f"capacity {label}: the sweep did not schedule every pod in every lane")

    # the sweep's wave planner alone, past its cache (the sweep ran it once)
    from open_simulator_tpu_torch.engine import buckets, waves as waves_mod

    scfg = cfg._replace(fail_reasons=False)
    t0 = time.perf_counter()
    wplan = waves_mod.compute_wave_plan(snap.arrays, scfg, n_pods_total=buckets.bucket_pods(n_pods))
    planner_s = time.perf_counter() - t0

    # the launch alone, as the sweep makes it (fail_reasons off)
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
        f"{peak / 2**20:.1f} MiB {geometry(plan_k)}; wave planner_s={planner_s:.4f} "
        f"plan {wplan.stats()}")

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
    from open_simulator_tpu_torch.kernels import wave

    fresh = sched.init_state(arrs_f, fcfg)
    folded = []
    folds0 = wave.LAUNCHES["forced_fold"]
    fold_ms = min(cuda_ms(torch, lambda: folded.append(
        sched.apply_forced_prefix(arrs_f, fcfg, fresh, n_fold))) for _ in range(3))
    fold_launches = (wave.LAUNCHES["forced_fold"] - folds0) // 3
    fold_dev_ms = min(cuda_ms(torch, lambda: sched.apply_forced_prefix(arrs_f, fcfg, fresh, n_fold),
                              prime_ms=PRIME_MS) for _ in range(3))
    plain_folds = []
    prefix_nodes = arrs_f.forced_node[:n_fold].int()
    fold_plain_ms = min(cuda_ms(torch, lambda: plain_folds.append(
        plain_fold(sched, wave, arrs_f, fcfg, fresh, prefix_nodes))) for _ in range(2))
    log_mm = MatmulLog(torch)
    with log_mm:
        plain_fold(sched, wave, arrs_f, fcfg, fresh, prefix_nodes)
    mm_ms = min(cuda_ms(torch, log_mm.replay) for _ in range(3))
    mm_dev_ms = min(cuda_ms(torch, log_mm.replay, prime_ms=PRIME_MS) for _ in range(3))
    one = sched.lane_carry(fresh, 1)
    step.plain_step_cuda(arrs, masks[-1:], sched.hoist_of(arrs, masks[-1:]), inv, one,
                         scfg._replace(forced_prefix=0), 0, n_fold, template=fresh)
    if not all(torch.equal(getattr(folded[-1], f), getattr(one, f)[0])
               and torch.equal(getattr(plain_folds[-1], f), getattr(one, f)[0])
               for f in sched.STATE_FIELDS):
        raise SystemExit(f"capacity {label}: the fold of {n_fold} pods (kernel or plain) and "
                         "the kernel's carry after them differ")
    if fold_launches != -(-n_fold // FOLD_PODS):
        raise SystemExit(f"capacity {label}: the fold launched forced_fold {fold_launches} "
                         "times, not once a chunk")
    fold_b = bound_of(fold_work(pinned, fcfg, pinned.forced_node[:n_fold]))
    del folded, plain_folds, log_mm
    log(f"capacity {label}: hoist_active_stats over {CAPACITY_LANES} lanes {hoist_ms:.3f} ms, "
        f"bound {hoist_b[2]:.4f} ms ({hoist_b[3]}: bytes={hoist_b[0]} ops={hoist_b[1]}); "
        f"apply_forced_prefix of {n_fold} pods {fold_ms:.3f} ms ({fold_launches} forced_fold "
        f"launch pair(s); the device alone, the stream primed: {fold_dev_ms:.3f} ms), the "
        f"plain merge's fold {fold_plain_ms:.3f} ms, its torch.matmul calls alone {mm_ms:.3f} ms "
        f"(primed {mm_dev_ms:.3f} ms), bound {fold_b[2]:.5f} ms ({fold_b[3]}: bytes={fold_b[0]} "
        f"ops={fold_b[1]}); the folds equal the kernel's carry after those pods")

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
        "planner_s": planner_s, "peak_mem_bytes": peak, "max_abs_err": err, "phases": phases,
        "geometry": geometry_fields(plan_k), **row_fields(rows),
        "same_pods": {"lanes": 2, "pods": PARITY_PREFIX, "ms": kern_s * 1e3,
                      "plain_ms": plain_s * 1e3},
        "bisect": {"max_cpu_pct": limit, "best_count": bis.best_count, "rounds": rounds,
                   "probes": len(bis.counts), "wall_s": bis_s,
                   "geometry": geometry_fields(plan_b)},
        "hoist": {"lanes": CAPACITY_LANES, "ms": hoist_ms, "bound_ms": hoist_b[2],
                  "bound_by": hoist_b[3]},
        "prefix_fold": {"pods": n_fold, "ms": fold_ms, "device_ms": fold_dev_ms,
                        "launches": fold_launches, "plain_ms": fold_plain_ms,
                        "library_ms": mm_ms, "library_device_ms": mm_dev_ms,
                        "bound_ms": fold_b[2], "bound_by": fold_b[3]},
    }


def frozen_work(sched, a, cfg, lo, hi, outs):
    """(bytes, operations) of the frozen step over pods [lo, hi) of every
    lane in `outs` (each lane's (node, fail counts, feasible counts) as
    numpy): the step's work as ``lanes_work`` counts it, without the bind
    (the frozen form binds nothing; the merge does)."""
    import numpy as np

    return lanes_work(sched, a, cfg, lo, hi,
                      [(np.full_like(o[0], -1),) + tuple(o[1:]) for o in outs])


def merge_work(a, cfg, n_lanes, lo, hi, gpu):
    """(bytes, operations) of one ``wave_merge`` over pods [lo, hi) of
    `n_lanes` lanes. Bytes: each merged carry cell read and written once
    per lane, the wave's node row (and GPU picks) per lane, the pods' rows
    (requests, groups, ports, attachments, terms, preferred slots, GPU
    memory) and the node-domain table once. Operations: one node compare
    per (lane, cell, pod)."""
    c = hi - lo
    n, r = a.alloc.shape
    k1, _, d = a.topo_onehot.shape
    sg, pt, lk = a.match_groups.shape[1], a.ports.shape[1], a.vol_limit_cap.shape[1]
    t, t2, g, ap = a.own_terms.shape[1], a.hit_pref.shape[1], a.gpu_slot.shape[1], \
        a.pref_group.shape[1]
    gcb = _gc_bytes(cfg)
    tb = (2 if cfg.compact_carry else 4)
    chans = [(n * r, 4)]
    if cfg.needs_group_count:
        chans.append((n * sg, gcb))
    if cfg.maintain_dom_count:
        chans.append((k1 * d * sg, 4))
    if cfg.enable_ports:
        chans.append((n * pt, 1))
    if cfg.enable_vol_limits:
        chans.append((n * lk, 4))
    if cfg.enable_anti_affinity:
        chans.append((n * t, tb))
    if cfg.enable_pref:
        chans.append((n * t2, 4))
    if gpu:
        chans.append((n * g, 4))
    cells = sum(x for x, _ in chans)
    carry = sum(x * b for x, b in chans)
    groups = a.match_gid.shape[1] * 4 if cfg.slot_paint else sg
    terms = a.own_tid.shape[1] * 4 if cfg.slot_paint else t
    pod_bytes = c * (r * 4 + groups + pt + lk * 4 + terms + ap * 13 + 4)
    nbytes = (n_lanes * (2 * carry + c * 4 + (c * g * 4 if gpu else 0)) + pod_bytes
              + k1 * n * 4 + t * 4)
    return nbytes, n_lanes * cells * c


class HeldGroup:
    """The frozen form's group size held to `g` (``kernels/step.
    frozen_group``) inside the block (None: the plan's own)."""

    def __init__(self, step, g):
        self.step, self.g = step, g

    def __enter__(self):
        self.real = self.step.frozen_group
        if self.g is not None:
            self.step.frozen_group = lambda *a, **k: self.g

    def __exit__(self, *exc):
        self.step.frozen_group = self.real


def wave_parity(torch, sched, step, wave, waves_mod, label, snap, cfg, masks_np, n_waves,
                group=None, weights=None):
    """The wave form on the card against its plain versions, over the first
    `n_waves` waves of the plan's first GRID on every lane of `masks_np`:
    each frozen launch's outputs on the first and last lane against the
    plain step's frozen form on those two lanes (and the carry left as it
    was), then the merge kernel against the plain merge on every lane and
    carry field. `group` holds the frozen form's group size (None: the
    plan's); `weights` ([S, K] f32 on the card, under the traced weights)
    is every launch's weight row. Returns the instantiation, the group
    size, the wave width, the pods and lanes, the kernels' and plain
    versions' times over those waves and the largest difference."""
    dev = torch.device("cuda")
    t_phase = time.perf_counter()
    plan = waves_mod.waves_for(snap.arrays, cfg)
    lo, _, kind, w = plan.segments[0]
    if kind != waves_mod.GRID or lo or plan.start or cfg.forced_prefix:
        raise SystemExit(f"wave parity {label}: the plan {plan.segments[:3]} does not open "
                         "with a GRID at pod 0")
    arrs = sched.device_arrays(snap.arrays, dev)
    active = torch.from_numpy(masks_np).to(dev)
    n_lanes = active.shape[0]
    hoist = sched.hoist_of(arrs, active)
    inv = sched.inv_alloc_of(arrs.alloc)
    tmpl = template_of(sched, arrs, cfg)
    st = sched.lane_carry(tmpl, n_lanes)
    step.copy_template(st, tmpl)
    inst = step.instantiation(cfg, st, frozen=True)
    ends = [0, n_lanes - 1]
    sub_hoist = type(hoist)(*(x[ends] for x in hoist))
    inputs, merge_inputs = {}, {}
    ms_k = ms_p = ms_m = ms_mp = err = 0.0
    equal = True
    groups = set()
    for w0 in range(lo, lo + n_waves * w, w):
        w1 = w0 + w
        sub = sched.SimState(**{f: getattr(st, f)[ends].clone() for f in sched.STATE_FIELDS})
        got = []
        with HeldGroup(step, group):
            ms_k += cuda_ms(torch, lambda: got.append(step.plain_step_cuda(
                arrs, active, hoist, inv, st, cfg, w0, w1, frozen=True, inputs=inputs,
                weights=weights)), prime_ms=2)
        groups.add(step.LAST_PLAN.group)
        out_k = got[0]
        t0 = time.perf_counter()
        out_p = step.plain_step_torch(arrs, active[ends], sub_hoist, inv, sub, cfg, w0, w1,
                                      frozen=True,
                                      weights=None if weights is None else weights[ends])
        torch.cuda.synchronize()
        ms_p += (time.perf_counter() - t0) * 1e3
        ok, e = compare(torch, [x[ends] for x in out_k], out_p,
                        sched.SimState(**{f: getattr(st, f)[ends] for f in sched.STATE_FIELDS}),
                        sub)
        equal &= ok
        err = max(err, e)
        st_p = clone_state(sched, st)
        pick = out_k[3] if cfg.enable_gpu else None
        ms_m += cuda_ms(torch, lambda: wave.wave_merge_cuda(arrs, cfg, st, w0, w1, out_k[0], pick,
                                                            inputs=merge_inputs), prime_ms=2)
        t0 = time.perf_counter()
        wave.wave_merge_torch(arrs, cfg, st_p, w0, w1, out_k[0], pick)
        torch.cuda.synchronize()
        ms_mp += (time.perf_counter() - t0) * 1e3
        ok, e = compare(torch, [], [], st, st_p)
        equal &= ok
        err = max(err, e)
    placed = int((st.headroom != tmpl.headroom[None]).any(2).sum())
    if group is not None and groups != {group}:
        raise SystemExit(f"wave parity {label}: the launches took groups {groups}, not {group}")
    log(f"wave parity {label} {inst}: lanes={n_lanes} waves={n_waves} of width {w} "
        f"weights={weights is not None} {geometry(step.LAST_PLAN)} frozen kernel {ms_k:.3f} ms, "
        f"plain (lanes 0 and "
        f"{n_lanes - 1}) {ms_p:.1f} ms; merge kernel {ms_m:.3f} ms, plain merge {ms_mp:.1f} ms; "
        f"nodes with binds {placed} equal={equal} max_abs_err={err} "
        f"phase_s={time.perf_counter() - t_phase:.1f}")
    if not equal:
        raise SystemExit(f"wave parity {label}: the wave kernels and their plain versions "
                         "disagree")
    if not placed:
        raise SystemExit(f"wave parity {label}: no wave bound a pod")
    return {"instantiation": inst, "group": step.LAST_PLAN.group, "lanes": n_lanes,
            "waves": n_waves, "width": w, "weights": weights is not None,
            "pods": n_waves * w, "frozen_ms": ms_k, "frozen_plain_ms": ms_p, "merge_ms": ms_m,
            "merge_plain_ms": ms_mp, "max_abs_err": err}


def wave_loop_timing(torch, sched, step, arrs, act, hst, inv, tmpl, cfg, plan, n_pods, label):
    """The engine's wave loop (``engine/scheduler._run_wave_plan``) over the
    plan's one GRID on `act`'s lanes: its wall a wave with the CUDA graph
    and eagerly (host clock, synchronised; in turns, two runs each; the
    outputs and carry equal), then one captured wave's replays
    (``WaveRuns``): their wall a wave (host clock) and their device time a
    wave (CUDA events, the stream primed), and the card's idle share in
    the replays (1 - device / wall)."""
    (lo, hi, kind, w), = plan.segments
    n_waves, n_lanes = (hi - lo) // w, act.shape[0]
    walls, got = {True: [], False: []}, {}
    for graph in (True, False, False, True):
        carry = sched.lane_carry(tmpl, n_lanes)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs = sched._run_wave_plan(arrs, act, hst, inv, carry, tmpl, cfg, plan, 0, n_pods,
                                    graph=graph)
        torch.cuda.synchronize()
        walls[graph].append(time.perf_counter() - t0)
        got[graph] = (outs, carry)
    equal, err = compare(torch, got[True][0][:5], got[False][0][:5], got[True][1], got[False][1])
    if not equal:
        raise SystemExit(f"main path {label}: the wave loop's graph and its eager loop disagree")
    carry = sched.lane_carry(tmpl, n_lanes)
    step.copy_template(carry, tmpl)
    runs = sched.WaveRuns(arrs, act, hst, inv, carry, cfg, 0, n_pods)
    runs.cursor.fill_(lo)
    runs.wave(w)
    replayed = runs.capture(w)
    n = n_waves - 1
    rep_wall, rep_dev = [], []
    for _ in range(2):
        step.copy_template(carry, tmpl)
        runs.cursor.fill_(lo + w)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            replayed.replay()
        torch.cuda.synchronize()
        rep_wall.append((time.perf_counter() - t0) * 1e3 / n)
        step.copy_template(carry, tmpl)
        runs.cursor.fill_(lo + w)
        rep_dev.append(cuda_ms(torch, lambda: [replayed.replay() for _ in range(n)],
                               prime_ms=PRIME_MS * 2) / n)
    out = {"waves": n_waves, "graph_ms_per_wave": min(walls[True]) * 1e3 / n_waves,
           "eager_ms_per_wave": min(walls[False]) * 1e3 / n_waves,
           "replay_wall_ms_per_wave": min(rep_wall), "replay_device_ms_per_wave": min(rep_dev),
           "idle_share": 1 - min(rep_dev) / min(rep_wall), "equal": equal}
    log(f"main path {label}: the wave loop, {n_lanes} lane(s), {n_waves} waves: graph "
        f"{out['graph_ms_per_wave']:.4f} ms of wall a wave (runs "
        f"{[round(x * 1e3 / n_waves, 4) for x in walls[True]]}), eager "
        f"{out['eager_ms_per_wave']:.4f} ms (runs {[round(x * 1e3 / n_waves, 4) for x in walls[False]]}); "
        f"the graph's {n} replays {out['replay_wall_ms_per_wave'] * 1e3:.3f} us of wall a wave, "
        f"{out['replay_device_ms_per_wave'] * 1e3:.3f} us of device (the stream primed): the card "
        f"idles {out['idle_share']:.4f} of them; graph and eager outputs and carry equal: {equal}")
    return out


def pools_path(torch, sched, step, wave, waves_mod, buckets, simulate, sweep, cluster_cls,
               label):
    """The reference bench's wave-showcase preset at full size (1,024
    nodes x 10,240 pods in 32 pools, ``bench.py:351``): ``simulate()`` at
    one lane through the wave plan with the launch counts reset, the plan
    and the decode checked; the wave path's kernels timed beside the scan
    kernel over the same pods and every carry field held equal to the
    scan's; the first waves' kernels against their plain versions; the
    bench's 64-lane ``schedule_lanes``; then the same cluster with 64
    new-node slots through ``capacity_sweep`` (64 lanes) and
    ``capacity_bisect(lanes=8)``, and the wave form's parity on lanes 0
    and 63."""
    import numpy as np

    from open_simulator_tpu_torch.testing.synthetic import synthetic_objects, synthetic_snapshot

    t_phase, gc0 = time.perf_counter(), GC.mark()
    nodes, pods, _ = synthetic_objects(POOLS["nodes"], POOLS["pods"], pools=POOLS["pools"])
    cluster = cluster_cls(nodes=nodes, pods=pods)
    log(f"main path {label}: cluster objects built in {time.perf_counter() - t_phase:.1f}s, "
        f"{GC.since(gc0)}")
    reset_counts()
    torch.cuda.synchronize()
    t0, gc0 = time.perf_counter(), GC.mark()
    result = simulate(cluster, [], device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    gc_wall = GC.since(gc0)
    launches = read_counts()
    snap = result.snapshot
    n_pods = snap.n_pods
    cfg = sched.make_config(snap)
    n_total = buckets.bucket_pods(n_pods)
    t0 = time.perf_counter()
    fresh = waves_mod.compute_wave_plan(snap.arrays, cfg, n_pods_total=n_total)
    planner_s = time.perf_counter() - t0
    plan = waves_mod.waves_for(snap.arrays, cfg, n_pods_total=n_total)
    wid, wbat = plan.pod_waves()
    log(f"main path {label}: simulate() {snap.n_nodes} nodes x {n_pods} pods wall_s={wall:.3f} "
        f"({gc_wall}) scheduled={len(result.scheduled_pods)} launches={launches} plan "
        f"{plan.stats()} segments={plan.segments} planner_s={planner_s:.3f}")
    if tuple(fresh) != tuple(plan) or plan.segments != ((0, n_pods, waves_mod.GRID,
                                                         POOLS["pools"]),):
        raise SystemExit(f"main path {label}: not the one GRID of width {POOLS['pools']}")
    if (launches["plain_step_frozen"], launches["wave_merge"], launches["plain_step"]) != (
            plan.n_waves, plan.n_waves, 0):
        raise SystemExit(f"main path {label}: launches {launches}, not one frozen step and one "
                         f"merge for each of the {plan.n_waves} waves")
    if (launches["wave_graphs"], launches["wave_replays"]) != (1, plan.n_waves - 1):
        raise SystemExit(f"main path {label}: the wave loop did not replay one CUDA graph for "
                         f"all but its first wave ({launches})")
    if not (np.array_equal(result.wave_id, wid[:n_pods])
            and np.array_equal(result.wave_batched, wbat[:n_pods])):
        raise SystemExit(f"main path {label}: wave_id / wave_batched are not the plan's")
    if len(result.scheduled_pods) + len(result.unscheduled_pods) != n_pods:
        raise SystemExit(f"main path {label}: simulate() lost pods")

    # the wave path's kernels alone, one lane, against the scan kernel
    dev = torch.device("cuda")
    arrs = sched.device_arrays(snap.arrays, dev)
    active = torch.from_numpy(snap.arrays.active).to(dev)[None]
    hoist = sched.hoist_of(arrs, active)
    inv = sched.inv_alloc_of(arrs.alloc)
    tmpl = template_of(sched, arrs, cfg)
    w = POOLS["pools"]
    ctx = {}

    def wave_run(act, hst, run_cfg, primed=False):
        """The wave path's kernels over every pod on the lanes of `act`:
        (carry, outputs per wave, ms from the first launch to the last
        one's end, ms of each frozen launch, ms of each merge). Unprimed,
        the host's launch gaps are in the times. Primed, every WAVE_SAME
        waves the stream first spins PRIME_MS, so those waves' launches
        are queued before they run: the per-launch times are then the
        device's alone (the first-to-last span counts the spins too)."""
        n_lanes = act.shape[0]
        inputs, merge_inputs = ctx.setdefault((n_lanes, run_cfg), ({}, {}))
        st = sched.lane_carry(tmpl, n_lanes)
        step.copy_template(st, tmpl)
        evs = [[torch.cuda.Event(enable_timing=True) for _ in range(3)]
               for _ in range(plan.n_waves)]
        outs = []
        for j, w0 in enumerate(range(0, n_pods, w)):
            if primed and j % WAVE_SAME == 0:
                torch.cuda.synchronize()
                torch.cuda._sleep(int(PRIME_MS * SPIN_CYCLES_PER_MS))
            evs[j][0].record()
            out = step.plain_step_cuda(arrs, act, hst, inv, st, run_cfg, w0, w0 + w,
                                       frozen=True, inputs=inputs)
            evs[j][1].record()
            wave.wave_merge_cuda(arrs, run_cfg, st, w0, w0 + w, out[0], None,
                                 inputs=merge_inputs)
            evs[j][2].record()
            outs.append(out)
        torch.cuda.synchronize()
        return (st, outs, evs[0][0].elapsed_time(evs[-1][2]),
                [a.elapsed_time(b) for a, b, _ in evs], [b.elapsed_time(c) for _, b, c in evs])

    runs = [wave_run(active, hoist, cfg) for _ in range(3)]
    st_w, outs_w, wave_ms, _, _ = min(runs, key=lambda x: x[2])
    wave_runs = [x[2] for x in runs]
    del runs
    plan_1 = step.LAST_PLAN
    dev_runs = [wave_run(active, hoist, cfg, primed=True)[3:] for _ in range(3)]
    dev_runs = [(sum(f) + sum(m), f, m) for f, m in dev_runs]
    dev_ms, frozen_ms, merge_ms = min(dev_runs, key=lambda x: x[0])
    st_s = sched.lane_carry(tmpl, 1)
    scan_runs = []
    for _ in range(3):
        got = []
        scan_runs.append(cuda_ms(torch, lambda: got.append(step.plain_step_cuda(
            arrs, active, hoist, inv, st_s, cfg, 0, n_pods, template=tmpl))))
    out_s = got[0]
    out_w = tuple(torch.cat([o[i] for o in outs_w], 1) for i in range(5))
    equal, err = compare(torch, out_w, out_s, st_w, st_s)
    log(f"main path {label}: wave path, one lane: {wave_ms:.3f} ms between CUDA events with "
        f"the host launching (min of 3: {[round(t, 3) for t in wave_runs]}); the device alone "
        f"(the stream primed {PRIME_MS} ms every {WAVE_SAME} waves) {dev_ms:.3f} ms (min of 3: "
        f"{[round(t[0], 3) for t in dev_runs]}): {plan.n_waves} frozen launches "
        f"{sum(frozen_ms):.3f} ms ({sum(frozen_ms) / plan.n_waves * 1e3:.2f} us each, "
        f"{geometry(plan_1)}) + {plan.n_waves} merges {sum(merge_ms):.3f} ms "
        f"({sum(merge_ms) / plan.n_waves * 1e3:.2f} us each); the scan kernel over the same "
        f"pods {min(scan_runs):.3f} ms (min of 3: {[round(t, 3) for t in scan_runs]}, "
        f"{geometry(step.LAST_PLAN)}); outputs and every carry field equal: {equal} "
        f"(max_abs_err={err})")
    del dev_runs
    if not equal:
        raise SystemExit(f"main path {label}: the wave path and the scan disagree")
    placed = {sp.pod.key: sp.node_name for sp in result.scheduled_pods}
    kern = {snap.pods[i].key: snap.node_names[int(nd)]
            for i, nd in enumerate(out_w[0][0].cpu().numpy()) if nd >= 0}
    if kern != placed:
        raise SystemExit(f"main path {label}: the timed wave run and simulate() placed pods "
                         "differently")

    loop_1 = wave_loop_timing(torch, sched, step, arrs, active, hoist, inv, tmpl, cfg, plan,
                              n_pods, label)

    # the first WAVE_SAME waves, one lane: the kernels' outputs and the carry
    # after the last merge against their plain versions
    q = WAVE_SAME * w
    inputs, merge_inputs = ctx[(1, cfg)]
    st_k = sched.lane_carry(tmpl, 1)
    step.copy_template(st_k, tmpl)
    st_p = clone_state(sched, st_k)
    t_plain = t_mplain = 0.0
    outs_k, outs_p = [], []
    for w0 in range(0, q, w):
        outs_k.append(step.plain_step_cuda(arrs, active, hoist, inv, st_k, cfg, w0, w0 + w,
                                           frozen=True, inputs=inputs))
        wave.wave_merge_cuda(arrs, cfg, st_k, w0, w0 + w, outs_k[-1][0], None,
                             inputs=merge_inputs)
        t0 = time.perf_counter()
        outs_p.append(step.plain_step_torch(arrs, active, hoist, inv, st_p, cfg, w0, w0 + w,
                                            frozen=True))
        torch.cuda.synchronize()
        t_plain += time.perf_counter() - t0
        t0 = time.perf_counter()
        wave.wave_merge_torch(arrs, cfg, st_p, w0, w0 + w, outs_p[-1][0], None)
        torch.cuda.synchronize()
        t_mplain += time.perf_counter() - t0
    same_k = [x for o in outs_k for x in o]
    same_p = [x for o in outs_p for x in o]
    same_eq, same_err = compare(torch, same_k, same_p, st_k, st_p)
    if not same_eq:
        raise SystemExit(f"main path {label}: the first {q} pods' waves differ from the plain "
                         "versions")
    # the library yardstick of the merge: the plain merges' torch.matmul
    # calls (the reference's one-hot products) over the same waves, alone
    st_m = sched.lane_carry(tmpl, 1)
    step.copy_template(st_m, tmpl)
    log_mm = MatmulLog(torch)
    with log_mm:
        for j, w0 in enumerate(range(0, q, w)):
            wave.wave_merge_torch(arrs, cfg, st_m, w0, w0 + w, outs_p[j][0], None)
    merge_mm_ms = min(cuda_ms(torch, log_mm.replay) for _ in range(3))
    del log_mm, st_m
    outs_np = [tuple(torch.cat([o[i] for o in outs_w[:WAVE_SAME]], 1)[0].cpu().numpy()
                     for i in range(3))]
    fb = bound_of(frozen_work(sched, snap.arrays, cfg, 0, q, outs_np))
    mw = [merge_work(snap.arrays, cfg, 1, w0, w0 + w, False) for w0 in range(0, q, w)]
    mb = bound_of((sum(x[0] for x in mw), sum(x[1] for x in mw)))
    full_fb = bound_of(frozen_work(sched, snap.arrays, cfg, 0, n_pods,
                                   [tuple(x[0].cpu().numpy() for x in out_w[:3])]))
    log(f"main path {label}: the first {WAVE_SAME} waves ({q} pods): frozen kernel "
        f"{sum(frozen_ms[:WAVE_SAME]):.3f} ms, plain {t_plain * 1e3:.1f} ms, bound "
        f"{fb[2]:.5f} ms ({fb[3]}: bytes={fb[0]} ops={fb[1]}); merge kernel "
        f"{sum(merge_ms[:WAVE_SAME]):.3f} ms, plain {t_mplain * 1e3:.1f} ms, its "
        f"torch.matmul calls alone {merge_mm_ms:.3f} ms, bound "
        f"{mb[2]:.5f} ms ({mb[3]}: bytes={mb[0]} ops={mb[1]}); the whole run's frozen bound "
        f"{full_fb[2]:.5f} ms ({full_fb[3]})")

    # the bench's 64-lane schedule_lanes (bench.py:105-121; max_new 0, so
    # every lane has the cluster's mask), waves against the scan
    lcfg = cfg._replace(fail_reasons=False)
    lplan = waves_mod.waves_for(snap.arrays, lcfg)
    max_new = snap.n_nodes - snap.n_real_nodes
    counts = [min(i % (max_new + 1), max_new) for i in range(CAPACITY_LANES)]
    masks = sweep.active_masks_for_counts(snap, counts)
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lanes_w = sched.schedule_lanes(snap.arrays, masks, lcfg, device="cuda", waves=lplan)
    torch.cuda.synchronize()
    lanes_s = time.perf_counter() - t0
    lane_launches = read_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lanes_scan = sched.schedule_lanes(snap.arrays, masks, lcfg, device="cuda")
    torch.cuda.synchronize()
    lanes_scan_s = time.perf_counter() - t0
    eq64, err64 = compare(torch, lanes_w[:5], lanes_scan[:5], lanes_w.state, lanes_scan.state)
    if not eq64 or lane_launches["plain_step_frozen"] != lplan.n_waves:
        raise SystemExit(f"main path {label}: the 64-lane wave run is not the scan's")
    if lane_launches["wave_replays"] != lplan.n_waves - 1:
        raise SystemExit(f"main path {label}: the 64-lane wave loop ran eagerly "
                         f"({lane_launches})")
    # the bound of one 64-lane frozen launch (the first wave): each lane's
    # carry and tables read once, the pods' rows and the outputs
    fb64 = bound_of(frozen_work(sched, snap.arrays, lcfg, 0, w,
                                [tuple(x[s, :w].cpu().numpy() for x in lanes_w[:3])
                                 for s in range(CAPACITY_LANES)]))
    log(f"main path {label}: one {CAPACITY_LANES}-lane frozen launch (the first wave): bound "
        f"{fb64[2]:.5f} ms ({fb64[3]}: bytes={fb64[0]} ops={fb64[1]})")
    del lanes_w, lanes_scan
    masks_t = torch.from_numpy(masks).to(dev)
    hoist64 = sched.hoist_of(arrs, masks_t)
    dev64 = [wave_run(masks_t, hoist64, lcfg, primed=True)[3:] for _ in range(3)]
    dev64 = [(sum(f) + sum(m), f, m) for f, m in dev64]
    dev64_ms, frozen64, merge64 = min(dev64, key=lambda x: x[0])
    plan_64 = step.LAST_PLAN
    carry64 = sched.lane_carry(tmpl, CAPACITY_LANES)
    scan64 = [cuda_ms(torch, lambda: step.plain_step_cuda(
        arrs, masks_t, hoist64, inv, carry64, lcfg, 0, n_pods, template=tmpl)) for _ in range(3)]
    log(f"main path {label}: schedule_lanes {CAPACITY_LANES} lanes with the plan "
        f"{lplan.stats()}: wall_s={lanes_s:.3f} launches={lane_launches}; the scan's "
        f"schedule_lanes wall_s={lanes_scan_s:.3f}; every lane's outputs and carry equal: "
        f"{eq64} (max_abs_err={err64}); the device alone: waves {dev64_ms:.3f} ms (min of 3: "
        f"{[round(t[0], 3) for t in dev64]}; frozen {sum(frozen64):.3f} ms, "
        f"{sum(frozen64) / lplan.n_waves * 1e3:.2f} us each, {geometry(plan_64)}; merges "
        f"{sum(merge64):.3f} ms, {sum(merge64) / lplan.n_waves * 1e3:.2f} us each), the scan "
        f"kernel {min(scan64):.3f} ms (min of 3: {[round(t, 3) for t in scan64]}, "
        f"{geometry(step.LAST_PLAN)})")
    del dev64, carry64
    loop_64 = wave_loop_timing(torch, sched, step, arrs, masks_t, hoist64, inv, tmpl, lcfg, lplan,
                               n_pods, f"{label}-{CAPACITY_LANES}")

    # the same cluster with 64 new-node slots: capacity_sweep and its bisection
    snap_n = synthetic_snapshot(POOLS["nodes"], POOLS["pods"], max_new=CAPACITY_LANES,
                                pools=POOLS["pools"])
    cfg_n = sched.make_config(snap_n)
    counts = [min(i % (CAPACITY_LANES + 1), CAPACITY_LANES) for i in range(CAPACITY_LANES)]
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cap = sweep.capacity_sweep(snap_n, cfg_n, counts, device="cuda")
    torch.cuda.synchronize()
    sweep_s = time.perf_counter() - t0
    sweep_launches = read_counts()
    splan = waves_mod.waves_for(snap_n.arrays, cfg_n._replace(fail_reasons=False),
                                n_pods_total=n_total)
    if (sweep_launches["plain_step_frozen"] != splan.n_waves or not all(cap.all_scheduled)
            or sweep_launches["wave_replays"] != splan.n_waves - 1):
        raise SystemExit(f"capacity {label}: the sweep ran {sweep_launches} or left pods out")
    # pools-traced: the same sweep under the traced weights at the
    # config's own vector, every launch with the [64, K] weight row (the
    # frozen builds at full size): the constant sweep's plan
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cap_t = sweep.capacity_sweep(snap_n, cfg_n._replace(traced_weights=True), counts,
                                 device="cuda")
    torch.cuda.synchronize()
    traced_s = time.perf_counter() - t0
    traced_launches = read_counts()
    digest, digest_t = plan_digest(cap), plan_digest(cap_t)
    n_launch = traced_launches["plain_step"] + traced_launches["plain_step_frozen"]
    tplan = waves_mod.waves_for(snap_n.arrays, cfg_n._replace(fail_reasons=False,
                                                              traced_weights=True),
                                n_pods_total=n_total)
    if (digest_t != digest or traced_launches["plain_step_weights"] != n_launch
            or traced_launches["plain_step_frozen"] != tplan.n_waves
            or traced_launches["wave_replays"] != tplan.n_waves - 1):
        raise SystemExit(f"capacity {label}-traced: plan {digest_t} (constant {digest}), "
                         f"launches {traced_launches}")
    log(f"capacity {label}-traced-64: capacity_sweep traced_weights=True wall_s={traced_s:.3f} "
        f"(constant {sweep_s:.3f}) launches={traced_launches}; plan digest {digest_t} equals "
        f"the constant sweep's")
    occ = cap.cpu_occupancy_pct
    limit = (occ[BISECT_TARGET - 1] + occ[BISECT_TARGET]) / 2
    want = min(c for c, o, ok in zip(cap.counts, occ, cap.all_scheduled) if ok and o <= limit)
    reset_counts()
    t0 = time.perf_counter()
    bis = sweep.capacity_bisect(snap_n, cfg_n, CAPACITY_LANES,
                                sweep.SweepThresholds(max_cpu_pct=limit), lanes=8, device="cuda")
    torch.cuda.synchronize()
    bis_s = time.perf_counter() - t0
    bis_launches = read_counts()
    rounds = bis_launches["plain_step_frozen"] // splan.n_waves
    row = bis.nodes_per_scenario[bis.counts.index(bis.best_count)] if bis.best_count else None
    if bis.best_count != want or not np.array_equal(row, cap.nodes_per_scenario[counts.index(want)]):
        raise SystemExit(f"capacity {label}: bisection found {bis.best_count}, the sweep {want}")
    log(f"capacity {label}-64: capacity_sweep {CAPACITY_LANES} lanes wall_s={sweep_s:.3f} "
        f"launches={sweep_launches}; max_cpu_pct={limit!r} -> sweep best {want}; "
        f"capacity_bisect(lanes=8) best {bis.best_count} in {rounds} rounds, "
        f"{len(bis.counts)} probes, wall_s={bis_s:.3f} launches={bis_launches}")

    # the wave form against its plain versions on lanes 0 and 63 of the sweep
    masks_n = sweep.active_masks_for_counts(snap_n, counts)
    par = wave_parity(torch, sched, step, wave, waves_mod, f"{label}-64-lanes", snap_n,
                      cfg_n._replace(fail_reasons=False), masks_n, WAVE_PARITY_WAVES)
    log(f"main path {label}: phase_s={time.perf_counter() - t_phase:.1f}")
    return {
        "launches": {k: launches[k] for k in ("plain_step", "plain_step_frozen", "wave_merge")},
        "plan": plan.stats(), "planner_s": planner_s, "simulate_s": wall,
        "scheduled": len(result.scheduled_pods),
        "wave_ms": wave_ms, "wave_ms_runs": wave_runs, "device_ms": dev_ms,
        "frozen_ms": sum(frozen_ms), "merge_ms": sum(merge_ms),
        "frozen_geometry": geometry_fields(plan_1), "loop": loop_1,
        "scan_ms": min(scan_runs), "scan_ms_runs": scan_runs,
        "frozen_bound_ms": full_fb[2], "frozen_bound_by": full_fb[3],
        "max_abs_err": max(err, same_err, err64, par["max_abs_err"]),
        "same_pods": {"pods": q, "frozen_ms": sum(frozen_ms[:WAVE_SAME]),
                      "frozen_plain_ms": t_plain * 1e3, "frozen_bound_ms": fb[2],
                      "frozen_bound_by": fb[3], "merge_ms": sum(merge_ms[:WAVE_SAME]),
                      "merge_plain_ms": t_mplain * 1e3, "merge_library_ms": merge_mm_ms,
                      "merge_bound_ms": mb[2],
                      "merge_bound_by": mb[3]},
        "lanes_64": {"wall_s": lanes_s, "scan_wall_s": lanes_scan_s, "launches": lane_launches,
                     "device_ms": dev64_ms, "frozen_ms": sum(frozen64),
                     "merge_ms": sum(merge64), "scan_ms": min(scan64), "loop": loop_64,
                     "frozen_bound_ms": fb64[2], "frozen_bound_by": fb64[3],
                     "frozen_geometry": geometry_fields(plan_64)},
        "sweep_64": {"wall_s": sweep_s, "launches": sweep_launches, "plan_digest": digest},
        "sweep_64_traced": {"wall_s": traced_s, "launches": traced_launches,
                            "plan_digest": digest_t},
        "bisect": {"max_cpu_pct": limit, "best_count": bis.best_count, "rounds": rounds,
                   "probes": len(bis.counts), "wall_s": bis_s},
        "parity_64": par,
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


def cuda_ms(torch, fn, prime_ms=0.0):
    """Milliseconds of fn() on the card's current stream (CUDA events).
    With `prime_ms`, the stream first spins that long (``torch.cuda._sleep``)
    so that fn's launches are queued before the first event runs: the
    time is then the device's alone, without the host's launch overhead
    (which dominates kernels of a few microseconds)."""
    ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    if prime_ms:
        torch.cuda._sleep(int(prime_ms * SPIN_CYCLES_PER_MS))
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


def plain_fold(sched, wave, arrs, cfg, state, nodes):
    """The plain version of ``apply_forced_prefix`` / ``apply_forced_mask``
    on the card: pods [0, len(nodes)) at `nodes` (negative: not folded),
    in the scheduler's chunks, through the fold's plain version (the plain
    merge, fp32 ``torch.matmul``, over a one-lane view) on a copy of
    `state`."""
    state = clone_state(sched, state)
    chunk = sched._PREFIX_CHUNK
    for lo in range(0, nodes.shape[0], chunk):
        hi = min(lo + chunk, nodes.shape[0])
        wave.forced_fold_torch(arrs, cfg, state, lo, hi, nodes[lo:hi])
    return state


def topk_work(n_pods, n_nodes, k, c):
    """(bytes, operations) of the explain top-k over `n_pods` pods' masked
    final scores [P, N]: each score read once and each candidate's node,
    score and C weighted rows written once; per pod K rounds of one key
    (two operations) and one compare per node (the kernel's K cluster
    rounds over N keys)."""
    return n_pods * (n_nodes * 4 + k * (8 + 4 * c)), n_pods * k * n_nodes * 3


def jitter_work(n_elems, n_pods):
    """(bytes, operations) of the tie-break jitter over `n_elems` (pod,
    feasible node) pairs of `n_pods` pods: the jittered score written once
    per pair; per pair threefry2x32's 20 rounds of add, rotate and xor
    (60) and its 5 key injections (15), the float (4), the round and the
    add (2); per pod one more threefry2x32 (fold_in, 75)."""
    return n_elems * 4, n_elems * 81 + n_pods * 75


def record_masked_scores(torch, sched):
    """While active, the plain step's masked final score of every pod it
    ranks under explain_topk (the input of ``engine.scheduler.rank_desc``),
    in order, on the card."""
    class _Rec:
        def __enter__(self):
            self.rows, self._orig = [], sched.rank_desc

            def rank_desc(v):
                self.rows.append(v.clone())
                return self._orig(v)
            sched.rank_desc = rank_desc
            return self

        def __exit__(self, *exc):
            sched.rank_desc = self._orig
    return _Rec()


def explain_path(torch, sched, step, simulate, cluster_of, explain_mod, label):
    """northstar-rich-explain: ``simulate(config_overrides={"explain_topk":
    3})`` on the rich north-star cluster at full size, one lane, with the
    launch counts reset (one launch of the explain build); host checks of
    the top-k tensors (the first candidate is the placed node for every pod
    the step placed, the parts sum to the score in f32, fillers zeroed);
    ``explain_result`` timed over the result; the launch timed against the
    same path with explain_topk = 0 (off, on, on, off); the kernel against
    the plain step over the first PARITY_PREFIX pods (all three top-k
    tensors),
    and the top-k of those pods' masked scores through the plain ranking
    and through ``torch.topk``."""
    import numpy as np

    t_phase = time.perf_counter()
    cluster = cluster_of("rich")
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    result = simulate(cluster, [], device="cuda", config_overrides={"explain_topk": EXPLAIN_K})
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    snap = result.snapshot
    n_pods, n_nodes = snap.n_pods, snap.n_nodes
    cfg = sched.make_config(snap, explain_topk=EXPLAIN_K)
    names = sched.score_part_names(cfg)
    log(f"main path {label}: simulate() {n_nodes} nodes x {n_pods} pods wall_s={wall:.3f} "
        f"scheduled={len(result.scheduled_pods)} launches={launches} score parts {names}")
    if (launches["plain_step_explain"], launches["plain_step"]) != (1, 0):
        raise SystemExit(f"main path {label}: launches {launches}, not one explain launch")
    tn, ts, tparts = result.topk_node, result.topk_score, result.topk_parts
    if (tn.shape != (n_pods, EXPLAIN_K) or tparts.shape != (n_pods, len(names), EXPLAIN_K)
            or result.score_part_names != list(names)):
        raise SystemExit(f"main path {label}: top-k shapes {tn.shape} {tparts.shape}")
    node = np.full(n_pods, -1)
    index = {p.key: i for i, p in enumerate(snap.pods)}
    name_at = {nm: j for j, nm in enumerate(snap.node_names)}
    for sp in result.scheduled_pods:
        node[index[sp.pod.key]] = name_at[sp.node_name]
    stepped = (snap.arrays.forced_node == -1) & (node >= 0)
    feas = ts > -1e37
    total = tparts[:, 0, :].copy()
    for c in range(1, len(names)):
        total = (total + tparts[:, c, :]).astype(np.float32)
    checks = {
        "finite": bool(np.isfinite(ts).all() and np.isfinite(tparts).all()),
        "first candidate is the placed node": bool((tn[stepped, 0] == node[stepped]).all()),
        "scores descend": bool((np.diff(ts, axis=1) <= 0).all()),
        "parts sum to the score": bool((total[feas] == ts[feas]).all()),
        "fillers zeroed": bool((tparts[np.broadcast_to(~feas[:, None, :], tparts.shape)]
                                == 0).all()),
        "prefix constant": bool((tn[:cfg.forced_prefix] == -1).all()),
    }
    t0 = time.perf_counter()
    report = explain_mod.explain_result(result)
    explain_s = time.perf_counter() - t0
    with_cand = sum(1 for e in report["pods"] if e.get("candidates"))
    log(f"main path {label}: checks {checks}; explain_result over {len(report['pods'])} pods "
        f"{explain_s:.3f}s ({with_cand} with candidates)")
    if not all(checks.values()) or report["summary"]["scheduled"] != len(result.scheduled_pods):
        raise SystemExit(f"main path {label}: a top-k check failed")

    # the launch with and without the top-k, alternating
    dev = torch.device("cuda")
    arrs = sched.device_arrays(snap.arrays, dev)
    active = torch.from_numpy(snap.arrays.active).to(dev)[None]
    hoist = sched.hoist_of(arrs, active)
    inv = sched.inv_alloc_of(arrs.alloc)
    cfg0 = cfg._replace(explain_topk=0)
    tmpl = template_of(sched, arrs, cfg)
    st = sched.lane_carry(tmpl, 1)
    p0 = cfg.forced_prefix
    runs = {"off": [], "on": []}
    got = {}
    for mode in ("off", "on", "on", "off"):
        c = cfg0 if mode == "off" else cfg
        runs[mode].append(cuda_ms(torch, lambda: got.__setitem__(mode, step.plain_step_cuda(
            arrs, active, hoist, inv, st, c, p0, n_pods, template=tmpl))))
    ms_on, ms_off = min(runs["on"]), min(runs["off"])
    if not (np.array_equal(got["on"].node[0].cpu().numpy(), node[p0:])
            and torch.equal(got["on"].node, got["off"].node)
            and np.array_equal(got["on"].topk_node[0].cpu().numpy(), tn[p0:])):
        raise SystemExit(f"main path {label}: the timed launches and simulate() differ")
    log(f"main path {label}: kernel with the top-k {ms_on:.3f} ms, without {ms_off:.3f} ms "
        f"(min of 2 each: on {[round(t, 3) for t in runs['on']]}, off "
        f"{[round(t, 3) for t in runs['off']]}): the top-k costs {ms_on - ms_off:.3f} ms, "
        f"{(ms_on - ms_off) * 1e3 / (n_pods - p0):.3f} us a pod; {geometry(step.LAST_PLAN)}")

    # kernel vs plain over the first pods, the masked scores recorded
    with record_masked_scores(torch, sched) as rec:
        plain_s, kern_s, err, out_f = parity(torch, sched, step, f"{label}-first-{PARITY_PREFIX}",
                                             snap.arrays, cfg, snap.arrays.active,
                                             n_pods=PARITY_PREFIX)
    q1 = p0 + out_f.node.shape[1]
    scores = torch.stack(rec.rows[-(q1 - p0):])  # the plain step's, pod by pod
    del rec
    k_top = min(EXPLAIN_K, n_nodes)
    lib, plain_rank = [], []
    lib_ms = min(cuda_ms(torch, lambda: lib.append(torch.topk(scores, k_top, dim=1)))
                 for _ in range(3))
    rank_ms = min(cuda_ms(torch, lambda: plain_rank.append(
        sched.rank_desc(scores)[:, :k_top])) for _ in range(3))
    if not torch.equal(plain_rank[-1].int(), out_f.topk_node[0]):
        raise SystemExit(f"main path {label}: the plain ranking of the recorded scores is not "
                         "the kernel's top-k")
    if not torch.equal(lib[-1].values, out_f.topk_score[0]):
        raise SystemExit(f"main path {label}: torch.topk's scores are not the kernel's")
    prefix_ms = min(cuda_ms(torch, lambda: step.plain_step_cuda(
        arrs, active, hoist, inv, st, cfg, p0, q1, template=tmpl)) for _ in range(2))
    prefix_off = min(cuda_ms(torch, lambda: step.plain_step_cuda(
        arrs, active, hoist, inv, st, cfg0, p0, q1, template=tmpl)) for _ in range(2))
    tk = bound_of(topk_work(q1 - p0, n_nodes, k_top, len(names)))
    step_b = bound_of(step_work(sched, snap.arrays, cfg, p0, q1, lane0(out_f)))
    same = bound_of((step_b[0] + tk[0], step_b[1] + tk[1]))
    whole = bound_of(topk_work(n_pods - p0, n_nodes, k_top, len(names)))
    log(f"main path {label}: the first {q1 - p0} pods: kernel {prefix_ms:.3f} ms (without the "
        f"top-k {prefix_off:.3f} ms), plain step {plain_s * 1e3:.1f} ms; the top-k of their "
        f"masked scores [{q1 - p0}, {n_nodes}]: plain ranking {rank_ms:.3f} ms, torch.topk "
        f"{lib_ms:.3f} ms, bound {tk[2]:.5f} ms ({tk[3]}: bytes={tk[0]} ops={tk[1]}); the "
        f"whole run's top-k bound {whole[2]:.5f} ms ({whole[3]}); "
        f"phase_s={time.perf_counter() - t_phase:.1f}")
    return {
        "launches": launches["plain_step_explain"], "pods": n_pods - p0, "ms": ms_on,
        "ms_off": ms_off, "ms_runs": runs, "simulate_s": wall, "explain_result_s": explain_s,
        "max_abs_err": err, "checks": checks, "score_parts": list(names),
        "topk": {"k": k_top, "ms": ms_on - ms_off, "bound_ms": whole[2], "bound_by": whole[3],
                 "same_pods": {"pods": q1 - p0, "ms": prefix_ms - prefix_off,
                               "plain_ms": rank_ms, "library_ms": lib_ms,
                               "bound_ms": tk[2], "bound_by": tk[3]}},
        "same_pods": {"pods": q1 - p0, "ms": prefix_ms, "plain_ms": plain_s * 1e3,
                      "bound_ms": same[2], "bound_by": same[3]},
    }


def tiebreak_path(torch, sched, step, simulate, cluster_of, threefry, label):
    """northstar-tiebreak: ``simulate(config_overrides={"tie_break_seed":
    7})`` on the north-star cluster at full size (identical nodes: ties
    everywhere), one lane, launch counts reset (one launch of the explain
    build); the launch timed against seed 0 (0, 7, 7, 0): the seeded run
    places pods differently; the kernel against the plain step over the
    first PARITY_PREFIX pods; the plain jitter (``ops/threefry.py``) timed over
    those pods."""
    import numpy as np

    t_phase = time.perf_counter()
    cluster = cluster_of("plain")
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    result = simulate(cluster, [], device="cuda", config_overrides={"tie_break_seed": TIE_SEED})
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    snap = result.snapshot
    n_pods, n_nodes = snap.n_pods, snap.n_nodes
    log(f"main path {label}: simulate() {n_nodes} nodes x {n_pods} pods wall_s={wall:.3f} "
        f"scheduled={len(result.scheduled_pods)} launches={launches}")
    if (launches["plain_step_explain"], launches["plain_step"]) != (1, 0):
        raise SystemExit(f"main path {label}: launches {launches}, not one explain launch")
    if len(result.scheduled_pods) + len(result.unscheduled_pods) != n_pods:
        raise SystemExit(f"main path {label}: simulate() lost pods")
    cfg = sched.make_config(snap, tie_break_seed=TIE_SEED)
    cfg0 = cfg._replace(tie_break_seed=0)
    dev = torch.device("cuda")
    arrs = sched.device_arrays(snap.arrays, dev)
    active = torch.from_numpy(snap.arrays.active).to(dev)[None]
    hoist = sched.hoist_of(arrs, active)
    inv = sched.inv_alloc_of(arrs.alloc)
    tmpl = template_of(sched, arrs, cfg)
    st = sched.lane_carry(tmpl, 1)
    p0 = cfg.forced_prefix
    runs = {0: [], TIE_SEED: []}
    got = {}
    for seed in (0, TIE_SEED, TIE_SEED, 0):
        c = cfg0 if seed == 0 else cfg
        runs[seed].append(cuda_ms(torch, lambda: got.__setitem__(seed, step.plain_step_cuda(
            arrs, active, hoist, inv, st, c, p0, n_pods, template=tmpl))))
    placed = result.placements()
    n7 = got[TIE_SEED].node[0].cpu().numpy()
    n0 = got[0].node[0].cpu().numpy()
    kern = {snap.pods[p0 + i].key: snap.node_names[int(x)] for i, x in enumerate(n7) if x >= 0}
    kern.update({snap.pods[i].key: snap.node_names[int(snap.arrays.forced_node[i])]
                 for i in range(p0)})
    differ = int((n7 != n0).sum())
    ms7, ms0 = min(runs[TIE_SEED]), min(runs[0])
    log(f"main path {label}: kernel with seed {TIE_SEED} {ms7:.3f} ms, seed 0 {ms0:.3f} ms "
        f"(min of 2 each): the jitter costs {ms7 - ms0:.3f} ms, "
        f"{(ms7 - ms0) * 1e3 / (n_pods - p0):.3f} us a pod; placements that differ from seed "
        f"0: {differ} of {n_pods - p0}; both place {int((n7 >= 0).sum())} / "
        f"{int((n0 >= 0).sum())} pods")
    if kern != placed:
        raise SystemExit(f"main path {label}: the timed kernel run and simulate() differ")
    if not differ or (n7 >= 0).sum() != (n0 >= 0).sum():
        raise SystemExit(f"main path {label}: the seed moved no placement (or lost pods)")
    plain_s, kern_s, err, out_f = parity(torch, sched, step, f"{label}-first-{PARITY_PREFIX}",
                                         snap.arrays, cfg, snap.arrays.active,
                                         n_pods=PARITY_PREFIX)
    q1 = p0 + out_f.node.shape[1]
    jit = []
    jit_ms = cuda_ms(torch, lambda: jit.extend(
        threefry.tie_break_jitter(TIE_SEED, p, n_nodes, dev) for p in range(p0, q1)))
    if not all(bool(((j >= 0) & (j < 0.5)).all()) for j in jit):
        raise SystemExit(f"main path {label}: a jitter left [0, 0.5)")
    prefix_ms = min(cuda_ms(torch, lambda: step.plain_step_cuda(
        arrs, active, hoist, inv, st, cfg, p0, q1, template=tmpl)) for _ in range(2))
    prefix_0 = min(cuda_ms(torch, lambda: step.plain_step_cuda(
        arrs, active, hoist, inv, st, cfg0, p0, q1, template=tmpl)) for _ in range(2))
    n_el = int(out_f.feasible.sum())
    jb = bound_of(jitter_work(n_el, q1 - p0))
    n_all = int(got[TIE_SEED].feasible.sum())
    whole = bound_of(jitter_work(n_all, n_pods - p0))
    log(f"main path {label}: the first {q1 - p0} pods: kernel {prefix_ms:.3f} ms (seed 0 "
        f"{prefix_0:.3f} ms), plain step {plain_s * 1e3:.1f} ms; the plain jitter of those pods "
        f"({n_nodes} nodes each) {jit_ms:.3f} ms; bound of their jitter ({n_el} feasible "
        f"pairs) {jb[2]:.5f} ms ({jb[3]}); the whole run's ({n_all} pairs) {whole[2]:.5f} ms "
        f"({whole[3]}); phase_s={time.perf_counter() - t_phase:.1f}")
    return {
        "launches": launches["plain_step_explain"], "pods": n_pods - p0, "ms": ms7,
        "ms_seed0": ms0, "ms_runs": {str(k): v for k, v in runs.items()}, "simulate_s": wall,
        "differ_from_seed0": differ, "max_abs_err": err,
        "jitter": {"ms": ms7 - ms0, "bound_ms": whole[2], "bound_by": whole[3],
                   "pairs": n_all,
                   "same_pods": {"pods": q1 - p0, "ms": prefix_ms - prefix_0,
                                 "plain_ms": jit_ms, "library_ms": None,
                                 "bound_ms": jb[2], "bound_by": jb[3]}},
        "same_pods": {"pods": q1 - p0, "ms": prefix_ms, "plain_ms": plain_s * 1e3},
    }


def pools_explain_path(torch, sched, step, wave, waves_mod, buckets, simulate, cluster_cls,
                       label):
    """pools-explain: the pools preset with explain_topk = 3 through
    ``simulate()`` (one lane, one GRID of 320 waves: the frozen explain
    builds), launch counts reset; the first 16 waves against the plain
    versions (the frozen step's outputs, top-k included, and the merges);
    the whole run's top-k tensors against one scan launch of the explain
    build over the same pods."""
    import numpy as np

    from open_simulator_tpu_torch.testing.synthetic import synthetic_objects

    t_phase, gc0 = time.perf_counter(), GC.mark()
    nodes, pods, _ = synthetic_objects(POOLS["nodes"], POOLS["pods"], pools=POOLS["pools"])
    cluster = cluster_cls(nodes=nodes, pods=pods)
    log(f"main path {label}: cluster objects built in {time.perf_counter() - t_phase:.1f}s, "
        f"{GC.since(gc0)}")
    reset_counts()
    torch.cuda.synchronize()
    t0, gc0 = time.perf_counter(), GC.mark()
    result = simulate(cluster, [], device="cuda", config_overrides={"explain_topk": EXPLAIN_K})
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    gc_wall = GC.since(gc0)
    launches = read_counts()
    snap = result.snapshot
    n_pods = snap.n_pods
    cfg = sched.make_config(snap, explain_topk=EXPLAIN_K)
    plan = waves_mod.waves_for(snap.arrays, cfg, n_pods_total=buckets.bucket_pods(n_pods))
    log(f"main path {label}: simulate() {snap.n_nodes} nodes x {n_pods} pods wall_s={wall:.3f} "
        f"({gc_wall}) scheduled={len(result.scheduled_pods)} launches={launches} plan "
        f"{plan.stats()}")
    if (launches["plain_step_frozen_explain"], launches["wave_merge"],
            launches["plain_step_explain"], launches["plain_step"]) != (
            plan.n_waves, plan.n_waves, 0, 0) or plan.segments != (
            (0, n_pods, waves_mod.GRID, POOLS["pools"]),) or (
            launches["wave_graphs"], launches["wave_replays"]) != (1, plan.n_waves - 1):
        raise SystemExit(f"main path {label}: launches {launches}, not one frozen explain "
                         f"launch and one merge for each of the {plan.n_waves} waves, all but "
                         "the first replayed from one CUDA graph")
    par = wave_parity(torch, sched, step, wave, waves_mod, f"{label}-first-{WAVE_SAME}-waves",
                      snap, cfg, np.asarray(snap.arrays.active)[None], WAVE_SAME)
    if par["instantiation"] != "<0,0>+frozen+explain":
        raise SystemExit(f"main path {label}: ran {par['instantiation']}")
    dev = torch.device("cuda")
    arrs = sched.device_arrays(snap.arrays, dev)
    active = torch.from_numpy(snap.arrays.active).to(dev)[None]
    hoist = sched.hoist_of(arrs, active)
    inv = sched.inv_alloc_of(arrs.alloc)
    tmpl = template_of(sched, arrs, cfg)
    st = sched.lane_carry(tmpl, 1)
    got = []
    scan_ms = cuda_ms(torch, lambda: got.append(step.plain_step_cuda(
        arrs, active, hoist, inv, st, cfg, 0, n_pods, template=tmpl)))
    scan = got[0]
    same = {k: np.array_equal(getattr(scan, k)[0].cpu().numpy(), getattr(result, k))
            for k in ("topk_node", "topk_score", "topk_parts")}
    placed = {snap.pods[i].key: snap.node_names[int(x)]
              for i, x in enumerate(scan.node[0].cpu().numpy()) if x >= 0}
    same["placements"] = placed == result.placements()
    if not all(same.values()):
        raise SystemExit(f"main path {label}: the wave run's top-k tensors are not the scan's")
    # the first WAVE_SAME waves' frozen launches alone, warm, each after a
    # spin (the device's time), with and without the top-k
    w = POOLS["pools"]
    dev_ms = {}
    for mode, c in (("off", cfg._replace(explain_topk=0)), ("on", cfg)):
        inputs = {}
        st_w = sched.lane_carry(tmpl, 1)
        step.copy_template(st_w, tmpl)
        step.plain_step_cuda(arrs, active, hoist, inv, st_w, c, 0, w, frozen=True, inputs=inputs)
        dev_ms[mode] = [cuda_ms(torch, lambda: step.plain_step_cuda(
            arrs, active, hoist, inv, st_w, c, w0, w0 + w, frozen=True, inputs=inputs),
            prime_ms=2) for w0 in range(0, WAVE_SAME * w, w)]
    on_ms, off_ms = sum(dev_ms["on"]), sum(dev_ms["off"])
    log(f"main path {label}: the scan's explain launch over the same pods {scan_ms:.3f} ms; the "
        f"wave run's outputs equal the scan's: {same}; the first {WAVE_SAME} waves' frozen "
        f"launches, the device alone: with the top-k {on_ms:.3f} ms "
        f"({on_ms / WAVE_SAME * 1e3:.2f} us each), without {off_ms:.3f} ms "
        f"({off_ms / WAVE_SAME * 1e3:.2f} us each), {geometry(step.LAST_PLAN)}; "
        f"phase_s={time.perf_counter() - t_phase:.1f}")
    fb = bound_of(frozen_work(sched, snap.arrays, cfg, 0, par["pods"],
                              [tuple(x[:par["pods"]] for x in lane0(scan))]))
    tk = bound_of(topk_work(par["pods"], snap.n_nodes, EXPLAIN_K,
                            len(sched.score_part_names(cfg))))
    bound = bound_of((fb[0] + tk[0], fb[1] + tk[1]))
    return {"launches": launches, "simulate_s": wall, "scan_ms": scan_ms, "parity": par,
            "max_abs_err": par["max_abs_err"], "frozen_ms_without_topk": off_ms,
            "same_pods": {"pods": par["pods"], "ms": on_ms,
                          "plain_ms": par["frozen_plain_ms"], "bound_ms": bound[2],
                          "bound_by": bound[3]}}


def cli_explain(torch, cli_main):
    """``explain -f examples/config.yaml --json`` through the CLI on the card
    and on the CPU: the same JSON report and exit code."""
    import contextlib
    import io

    path = os.path.join(HERE, "examples", "config.yaml")
    runs = []
    for device in ("cuda", "cpu"):
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = cli_main(["explain", "-f", path, "--json", "--device", device])
        torch.cuda.synchronize()
        runs.append((rc, buf.getvalue(), time.perf_counter() - t0))
    (rc_k, out_k, s_k), (rc_c, out_c, s_c) = runs
    report = json.loads(out_k) if rc_k == 0 else {}
    log(f"cli explain config.yaml --json: rc={rc_k}/{rc_c} card {s_k:.2f}s cpu {s_c:.2f}s: "
        f"{report.get('summary')} score parts {report.get('score_parts')}")
    if rc_k != 0 or (rc_k, out_k) != (rc_c, out_c) or not report.get("pods"):
        raise SystemExit("cli explain: the card and the CPU printed different reports")
    return {"card_s": s_k, "cpu_s": s_c, "pods": len(report["pods"])}


class ReplayProbe:
    """Instruments one ``run_replay`` on the card, without changing what it
    launches: CUDA events around every ``plain_step`` and ``forced_fold``
    call (summed per settled step beside the step's wall), every fold
    checked against its plain version on a copy of the carry (all
    channels, bit for bit; the plain version counts no launch), the first
    full scan's inputs (the hoisted start carry) and the last whole-mask
    fold's inputs kept for the checks and timings after the run."""

    def __init__(self, torch, sched, step, wave, rengine, check_folds):
        self.torch, self.sched, self.step, self.wave, self.rengine = (
            torch, sched, step, wave, rengine)
        self.check_folds = check_folds
        self.scans, self.folds, self.steps = [], [], []
        self.fold_checks, self.fold_bad, self.fold_err = 0, 0, 0.0
        self.first_scan = None
        self.last_mask_fold = None

    def _events(self):
        ev = (self.torch.cuda.Event(enable_timing=True), self.torch.cuda.Event(enable_timing=True))
        ev[0].record()
        return ev

    def __enter__(self):
        torch, sched, step, wave, rengine = (self.torch, self.sched, self.step, self.wave,
                                             self.rengine)
        self.real = (step.plain_step, wave.forced_fold, rengine.settle_step,
                     sched.apply_forced_mask)
        real_step, real_fold, real_settle, real_mask = self.real

        def plain_step(arrs, active, hoist, inv, state, cfg, p0, p1, template=None, **kw):
            ev = self._events()
            out = real_step(arrs, active, hoist, inv, state, cfg, p0, p1, template=template, **kw)
            ev[1].record()
            self.scans.append(ev)
            if self.first_scan is None and template is not None and p0 == 0 and p1 >= PARITY_PREFIX:
                self.first_scan = (arrs, active, hoist, inv, cfg, template)
            return out

        def forced_fold(arrs, cfg, state, p0, p1, nodes, out=None, mask=None):
            before = clone_state(sched, state) if self.check_folds else None
            ev = self._events()
            real_fold(arrs, cfg, state, p0, p1, nodes, out, mask)
            ev[1].record()
            self.folds.append(ev)
            if before is not None:
                wave.forced_fold_torch(arrs, cfg, before, p0, p1, nodes, mask=mask)
                equal, err = compare(torch, [], [], out if out is not None else state, before)
                self.fold_checks += 1
                self.fold_bad += not equal
                self.fold_err = max(self.fold_err, err)

        def apply_forced_mask(arrs, cfg, state, mask):
            self.last_mask_fold = (arrs, cfg, state, mask)
            return real_mask(arrs, cfg, state, mask)

        def settle_step(prog, world, controllers, ev, i, **kw):
            torch.cuda.synchronize()
            n_scan, n_fold, paths = len(self.scans), len(self.folds), dict(rengine.STEPS_TOTAL)
            t0 = time.perf_counter()
            row = real_settle(prog, world, controllers, ev, i, **kw)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            took = {k: v - paths.get(k, 0) for k, v in rengine.STEPS_TOTAL.items()
                    if v != paths.get(k, 0)}
            self.steps.append({
                "step": i, "event": ev.kind, "path": took, "wall_s": wall,
                "scan_ms": sum(a.elapsed_time(b) for a, b in self.scans[n_scan:]),
                "scans": len(self.scans) - n_scan,
                "fold_ms": sum(a.elapsed_time(b) for a, b in self.folds[n_fold:]),
                "folds": len(self.folds) - n_fold,
                "placed": row["placed"], "pending": row["pending"],
                "active_nodes": row["active_nodes"],
                "actions": [a["kind"] for a in row["actions"]]})
            return row

        step.plain_step, wave.forced_fold = plain_step, forced_fold
        rengine.settle_step, sched.apply_forced_mask = settle_step, apply_forced_mask
        return self

    def __exit__(self, *exc):
        (self.step.plain_step, self.wave.forced_fold, self.rengine.settle_step,
         self.sched.apply_forced_mask) = self.real
        return False


def replay_objects(replay_mod):
    """The replay-day cluster, trace and controllers (new objects each run)."""
    cluster = replay_mod.synthetic_replay_cluster(n_nodes=REPLAY["nodes"],
                                                  n_initial_pods=REPLAY["base_pods"])
    trace = replay_mod.ReplayTrace.from_dict(replay_mod.synthetic_trace_dict(
        n_batches=REPLAY["batches"], batch_pods=REPLAY["batch_pods"],
        max_new_nodes=REPLAY["max_new"]))
    controllers = [replay_mod.controller_from_arg(a) for a in REPLAY["controllers"]]
    return cluster, trace, controllers


def replay_run(torch, replay_mod, **opts):
    """One run_replay of the replay-day objects on the card: (report,
    wall seconds)."""
    cluster, trace, controllers = replay_objects(replay_mod)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    report = replay_mod.run_replay(cluster, trace, replay_mod.ReplayOptions(
        controllers=controllers, **opts), device="cuda")
    torch.cuda.synchronize()
    return report, time.perf_counter() - t0


def replay_path(torch, sched, step, wave, replay_mod, rengine, label):
    """replay-day: a day of arrivals, departures and a node failure on a
    5,120-node cluster with 1,024 template slots, the autoscaler and the
    descheduler on (6,144 nodes x 29,696 pods in the universe), through
    ``run_replay`` on the card with the launch counts reset just before
    and read just after; each step's wall with its scan kernel and fold
    time (CUDA events); every fold held to its plain version; the first
    full scan's first PARITY_PREFIX pods from the hoisted carry against the plain
    step; one step's whole-mask fold timed beside its plain version and
    its torch.matmul calls; then the same trace with the fast path off,
    whose digest must be the same."""
    t_phase = time.perf_counter()
    reset_counts()
    rengine.STEPS_TOTAL.clear()
    with ReplayProbe(torch, sched, step, wave, rengine, check_folds=True) as probe:
        report, wall = replay_run(torch, replay_mod, checkpoint=False)
    launches = read_counts()
    paths = dict(rengine.STEPS_TOTAL)
    t = report["totals"]
    for row in probe.steps:
        log(f"{label}: step {row['step']:2d} {row['event']:<9} path={row['path']} "
            f"wall_s={row['wall_s']:.3f} scan kernel {row['scan_ms']:.1f} ms "
            f"({row['scans']} launch(es)) fold {row['fold_ms']:.3f} ms ({row['folds']} "
            f"chunk(s)) placed={row['placed']} pending={row['pending']} "
            f"nodes={row['active_nodes']} actions={row['actions']}")
    log(f"{label}: run_replay wall_s={wall:.3f} steps={t['steps']} full scans "
        f"{paths.get('full', 0)} fast-path scans {paths.get('slice', 0)} (noop "
        f"{paths.get('noop', 0)}) launches={launches} digest={report['digest']} "
        f"totals={t}; folds checked against the plain version: {probe.fold_checks}, "
        f"differing: {probe.fold_bad}")
    if launches["plain_step"] == 0 or launches["forced_fold"] == 0:
        raise SystemExit(f"{label}: the replay did not run through plain_step and "
                         f"forced_fold: {launches}")
    if probe.fold_bad or not probe.fold_checks:
        raise SystemExit(f"{label}: {probe.fold_bad} of {probe.fold_checks} folds differ from "
                         "the plain version")
    if not paths.get("slice"):
        raise SystemExit(f"{label}: the fast path never fired on this trace")
    if t["scale_ups"] == 0 or t["defrag_moves"] == 0 or t["evicted"] == 0:
        raise SystemExit(f"{label}: the autoscaler, the descheduler or the node failure did "
                         f"nothing: {t}")
    n_nodes = REPLAY["nodes"] + REPLAY["max_new"]
    n_pods = REPLAY["base_pods"] + REPLAY["batches"] * REPLAY["batch_pods"]
    if len(report["steps"]) != t["steps"] or t["placed"] + t["pending"] + t["lost"] <= 0:
        raise SystemExit(f"{label}: the report is malformed")

    # the first full scan's first PARITY_PREFIX pods, from the hoisted
    # start carry: the kernel against the plain step
    arrs, active, hoist, inv, cfg, tmpl = probe.first_scan
    st_k, st_p = sched.lane_carry(tmpl, 1), sched.lane_carry(tmpl, 1)
    out_k = step.plain_step_cuda(arrs, active, hoist, inv, st_k, cfg, 0, PARITY_PREFIX,
                                 template=tmpl)
    t0 = time.perf_counter()
    out_p = step.plain_step_torch(arrs, active, hoist, inv, st_p, cfg, 0, PARITY_PREFIX,
                                  template=tmpl)
    torch.cuda.synchronize()
    scan_plain_s = time.perf_counter() - t0
    scan_eq, scan_err = compare(torch, out_k, out_p, st_k, st_p)
    pinned = int((arrs.forced_node[:PARITY_PREFIX] == -4).sum())
    log(f"{label}: the first full scan's first {PARITY_PREFIX} pods ({pinned} hoisted pins "
        f"and sentinels among them) from the hoisted carry: kernel vs plain step equal={scan_eq} "
        f"max_abs_err={scan_err} (plain {scan_plain_s:.2f}s)")
    if not scan_eq:
        raise SystemExit(f"{label}: the hoisted scan differs from the plain step")

    # one step's whole-mask fold (the last full scan's pins): the kernel,
    # its plain version and the plain version's torch.matmul calls alone
    arrs_m, cfg_m, st_m, mask = probe.last_mask_fold
    chunks = -(-mask.shape[0] // sched._PREFIX_CHUNK)
    f0 = wave.LAUNCHES["forced_fold"]
    folded = []
    fold_ms = min(cuda_ms(torch, lambda: folded.append(
        sched.apply_forced_mask(arrs_m, cfg_m, st_m, mask))) for _ in range(3))
    fold_launches = (wave.LAUNCHES["forced_fold"] - f0) // 3
    fold_dev_ms = min(cuda_ms(torch, lambda: sched.apply_forced_mask(arrs_m, cfg_m, st_m, mask),
                              prime_ms=PRIME_MS) for _ in range(3))
    nodes = torch.where(mask, arrs_m.forced_node.int().clamp_min(0),
                        torch.full_like(arrs_m.forced_node.int(), -1))

    plain = []
    fold_plain_ms = min(cuda_ms(torch, lambda: plain.append(
        plain_fold(sched, wave, arrs_m, cfg_m, st_m, nodes))) for _ in range(2))
    log_mm = MatmulLog(torch)
    with log_mm:
        plain_fold(sched, wave, arrs_m, cfg_m, st_m, nodes)
    mm_ms = min(cuda_ms(torch, log_mm.replay) for _ in range(3))
    mm_dev_ms = min(cuda_ms(torch, log_mm.replay, prime_ms=PRIME_MS) for _ in range(3))
    fold_eq, mask_err = compare(torch, [], [], folded[-1], plain[-1])
    host = sched.SnapshotArrays(**{f: getattr(arrs_m, f).cpu().numpy()
                                   for f in sched.SnapshotArrays.__dataclass_fields__})
    fold_b = bound_of(fold_work(host, cfg_m, nodes.cpu().numpy()))
    log(f"{label}: one step's whole-mask fold ({int(mask.sum())} pinned pods of "
        f"{mask.shape[0]}, {n_nodes} nodes): forced_fold {fold_ms:.3f} ms ({fold_launches} "
        f"launch pair(s), {chunks} chunk(s); the device alone, the stream primed: "
        f"{fold_dev_ms:.3f} ms), the plain version {fold_plain_ms:.3f} ms, its torch.matmul "
        f"calls alone {mm_ms:.3f} ms (primed {mm_dev_ms:.3f} ms), bound {fold_b[2]:.5f} ms ({fold_b[3]}: "
        f"bytes={fold_b[0]} ops={fold_b[1]}); kernel and plain equal: {fold_eq}")
    if not fold_eq or fold_launches != chunks:
        raise SystemExit(f"{label}: the whole-mask fold differs from its plain version or "
                         f"launched {fold_launches} times for {chunks} chunks")
    step_rows, fold_err = probe.steps, max(probe.fold_err, mask_err)
    del folded, plain, log_mm, probe

    # the defining semantics alone: the fast path off, the same digest
    nofast, nofast_wall = replay_run(torch, replay_mod, checkpoint=False, fast_path=False)
    log(f"{label}: --no-fast-path run_replay wall_s={nofast_wall:.3f} digest="
        f"{nofast['digest']} equal to the fast path's: {nofast['digest'] == report['digest']}")
    if nofast["digest"] != report["digest"] or nofast["steps"] != report["steps"]:
        raise SystemExit(f"{label}: the fast path changed the trajectory")
    log(f"{label}: phase_s={time.perf_counter() - t_phase:.1f}")
    return {
        "nodes": n_nodes, "pods": n_pods, "launches": launches, "steps_run": paths,
        "wall_s": wall, "no_fast_path_wall_s": nofast_wall, "digest": report["digest"],
        "totals": t, "max_abs_err": scan_err, "fold_max_abs_err": fold_err,
        "step_times": [{k: row[k] for k in ("step", "event", "path", "wall_s", "scan_ms",
                                            "fold_ms", "folds")} for row in step_rows],
        "mask_fold": {"pods": int(mask.shape[0]), "pinned": int(mask.sum()), "ms": fold_ms,
                      "device_ms": fold_dev_ms, "launches_per_full_step": fold_launches,
                      "plain_ms": fold_plain_ms, "library_ms": mm_ms,
                      "library_device_ms": mm_dev_ms, "bound_ms": fold_b[2], "bound_by": fold_b[3]},
    }


def replay_resume_path(torch, replay_mod, rengine, digest, label):
    """replay-resume: the replay-day trace with a checkpoint directory,
    stopped once step RESUME_AFTER is journaled, then resumed from the
    journal (``resolve_replay("last")``): the resumed digest must be the
    uninterrupted run's."""
    import tempfile

    from open_simulator_tpu_torch.resilience import lifecycle

    class Stop(Exception):
        pass

    t_phase = time.perf_counter()
    real_append = rengine.ReplayJournal.append_step

    def append_then_stop(journal, row):
        real_append(journal, row)
        if len(journal.rows) > RESUME_AFTER:
            raise Stop

    prev = os.environ.get(lifecycle.CHECKPOINT_DIR_ENV)
    with tempfile.TemporaryDirectory(prefix="replay-resume-") as root:
        os.environ[lifecycle.CHECKPOINT_DIR_ENV] = root
        try:
            rengine.ReplayJournal.append_step = append_then_stop
            t0 = time.perf_counter()
            try:
                replay_run(torch, replay_mod)
                raise SystemExit(f"{label}: the run was not stopped")
            except Stop:
                pass
            stopped_s = time.perf_counter() - t0
            rengine.ReplayJournal.append_step = real_append
            journal = replay_mod.resolve_replay("last")
            if len(journal.rows) != RESUME_AFTER + 1 or journal.done is not None:
                raise SystemExit(f"{label}: the journal holds {len(journal.rows)} steps")
            resumed, resumed_s = replay_run(torch, replay_mod, resume="last")
        finally:
            rengine.ReplayJournal.append_step = real_append
            if prev is None:
                os.environ.pop(lifecycle.CHECKPOINT_DIR_ENV, None)
            else:
                os.environ[lifecycle.CHECKPOINT_DIR_ENV] = prev
    log(f"{label}: stopped after step {RESUME_AFTER} ({stopped_s:.1f}s), resumed "
        f"{resumed['resumed_steps']} settled steps from the journal ({resumed_s:.1f}s): digest "
        f"{resumed['digest']} equal to the uninterrupted run's: {resumed['digest'] == digest}; "
        f"phase_s={time.perf_counter() - t_phase:.1f}")
    if resumed["digest"] != digest or resumed["resumed_steps"] != RESUME_AFTER + 1:
        raise SystemExit(f"{label}: the resumed trajectory differs from the uninterrupted one")
    return {"stopped_after_step": RESUME_AFTER, "stopped_s": stopped_s, "resumed_s": resumed_s,
            "digest": resumed["digest"]}


def cli_replay(torch, cli_main):
    """``replay`` through the CLI on a small example cluster with a
    synthetic trace and the autoscaler, on the card and on the CPU: the
    same report (its run id and wall time aside) and exit code."""
    import contextlib
    import io
    import tempfile

    from open_simulator_tpu_torch.replay import synthetic_trace_dict

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="replay-cli-") as tmp:
        path = os.path.join(tmp, "trace.json")
        with open(path, "w", encoding="utf-8") as f:
            json.dump(synthetic_trace_dict(n_batches=4, batch_pods=6, chaos_target="worker-a-0",
                                           max_new_nodes=4), f)
        runs = []
        for device in ("cuda", "cpu"):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc = cli_main(["replay", "--cluster-config", os.path.join(HERE, "examples",
                                                                          "cluster", "demo"),
                               "--trace", path, "--controller", "autoscaler", "--json",
                               "--device", device])
            torch.cuda.synchronize()
            rep = json.loads(buf.getvalue()) if rc == 0 else {}
            for k in ("replay_id", "wall_s"):
                rep.pop(k, None)
            runs.append((rc, rep))
    (rc_k, rep_k), (rc_c, rep_c) = runs
    log(f"cli replay examples/cluster/demo: rc={rc_k}/{rc_c} digest {rep_k.get('digest')} / "
        f"{rep_c.get('digest')} totals {rep_k.get('totals')} ({time.perf_counter() - t0:.1f}s)")
    if rc_k != 0 or (rc_k, rep_k) != (rc_c, rep_c):
        raise SystemExit("cli replay: the card and the CPU printed different reports")
    return {"digest": rep_k["digest"], "steps": rep_k["totals"]["steps"]}


def cli_tune(torch, cli_main):
    """``tune --json`` (CEM, 4 lanes, 2 rounds) and ``replay --frontier
    --json`` (a 3 x 2 mix grid, 4 lanes a round) through the CLI on a small
    example cluster, on the card and on the CPU: the same report (the tune
    id and wall time aside) and exit code."""
    import contextlib
    import io
    import tempfile

    import yaml

    from open_simulator_tpu_torch.replay import synthetic_frontier_specs, synthetic_trace_dict

    t0 = time.perf_counter()
    demo = os.path.join(HERE, "examples", "cluster", "demo")
    out = {}
    with tempfile.TemporaryDirectory(prefix="tune-cli-") as tmp:
        trace, specs = os.path.join(tmp, "trace.json"), os.path.join(tmp, "specs.yaml")
        with open(trace, "w", encoding="utf-8") as f:
            json.dump(synthetic_trace_dict(n_batches=2, batch_pods=4,
                                           chaos_target="worker-a-0"), f)
        with open(specs, "w", encoding="utf-8") as f:
            yaml.safe_dump({"specs": synthetic_frontier_specs(max_small=2, max_big=1)}, f)
        for name, args in (
                ("tune", ["tune", "--cluster-config", demo, "--mode", "cem", "--variants", "4",
                          "--rounds", "2", "--seed", "3", "--json"]),
                ("frontier", ["replay", "--cluster-config", demo, "--trace", trace,
                              "--frontier", specs, "--lane-width", "4", "--json"])):
            runs = []
            for device in ("cuda", "cpu"):
                buf = io.StringIO()
                with contextlib.redirect_stdout(buf):
                    rc = cli_main(args + ["--device", device])
                torch.cuda.synchronize()
                rep = json.loads(buf.getvalue()) if rc == 0 else {}
                for k in ("tune_id", "wall_s"):
                    rep.pop(k, None)
                runs.append((rc, rep))
            (rc_k, rep_k), (rc_c, rep_c) = runs
            log(f"cli {name} examples/cluster/demo: rc={rc_k}/{rc_c} digest "
                f"{rep_k.get('digest')} / {rep_c.get('digest')} pareto "
                f"{len(rep_k.get('pareto', []))}")
            if rc_k != 0 or (rc_k, rep_k) != (rc_c, rep_c):
                raise SystemExit(f"cli {name}: the card and the CPU printed different reports")
            out[name] = {"digest": rep_k["digest"], "pareto": len(rep_k["pareto"])}
    log(f"cli tune and frontier: {time.perf_counter() - t0:.1f}s")
    return out


# the tuning and frontier paths: tune_search's lanes (grid and CEM rounds
# of TUNE_VARIANTS), and the frontier's node specs (the north-star
# template and one of twice its CPU and memory, up to FRONTIER_MAX of
# each: 289 mixes, FRONTIER_LANES lanes a round)
TUNE_VARIANTS, TUNE_ROUNDS = 64, 2
FRONTIER_MAX, FRONTIER_LANES = 16, 64


class LaneProbe:
    """Records each ``schedule_lanes`` call made while it is entered (the
    calls ``tune_search`` and ``capacity_frontier`` make): the host arrays,
    masks, config and weights, the call's time between CUDA events and on
    the host clock, and its placements."""

    def __init__(self, torch, sched):
        self.torch, self.sched, self.calls = torch, sched, []

    def __enter__(self):
        self.real = self.sched.schedule_lanes
        self.sched.schedule_lanes = self.call
        return self

    def __exit__(self, *exc):
        self.sched.schedule_lanes = self.real

    def call(self, arrs, masks, cfg, **kw):
        torch = self.torch
        ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ev0.record()
        out = self.real(arrs, masks, cfg, **kw)
        ev1.record()
        torch.cuda.synchronize()
        w = kw.get("weights")
        self.calls.append({"arrs": arrs, "masks": masks, "cfg": cfg,
                           "weights": None if w is None else w.copy(),
                           "ms": ev0.elapsed_time(ev1), "wall_s": time.perf_counter() - t0,
                           "node": out.node.cpu().numpy()})
        return out


def plan_digest(plan):
    """A CapacityPlan's digest (the reference ledger's ``plan_digest``): its
    counts, best count and verdicts, and every lane's placements."""
    import hashlib

    import numpy as np

    h = hashlib.sha256()
    h.update(repr((list(plan.counts), plan.best_count, list(plan.satisfied))).encode())
    h.update(np.ascontiguousarray(np.asarray(plan.nodes_per_scenario)).tobytes())
    return h.hexdigest()[:16]


def tune_path(torch, sched, step, tune_mod, cluster, label):
    """tune-rich-64: ``tune_search`` on the rich north-star cluster in grid
    mode and in CEM mode (TUNE_VARIANTS lanes, TUNE_ROUNDS rounds, seed 0),
    each round one ``plain_step`` launch with its [64, K] weight row, and
    the CEM search again for its digest. Lane 0 of round 1 is the baseline
    vector, and its placements equal a constant-config launch; two lanes
    with different rows equal the plain step; the weighted 64-lane launch
    is timed against the constant one of the same shape."""
    import numpy as np

    t_phase = time.perf_counter()
    reports, probes, runs = {}, {}, {}
    for mode, key in (("grid", "grid"), ("cem", "cem"), ("cem", "cem-again")):
        opts = tune_mod.TuneOptions(mode=mode, variants=TUNE_VARIANTS, rounds=TUNE_ROUNDS,
                                    seed=0)
        reset_counts()
        t0 = time.perf_counter()
        with LaneProbe(torch, sched) as probe:
            rep = tune_mod.tune_search(cluster, [], opts, device="cuda")
        wall = time.perf_counter() - t0
        counts = read_counts()
        if not (counts["plain_step"] == counts["plain_step_weights"] == rep["rounds_run"]
                == len(probe.calls)):
            raise SystemExit(f"{label} {key}: {rep['rounds_run']} rounds launched {counts}")
        reports[key], probes[key] = rep, probe.calls
        runs[key] = {"wall_s": wall, "launches": counts, "rounds": rep["rounds_run"],
                     "variants": rep["n_variants"], "pareto": len(rep["pareto"]),
                     "variants_per_s": rep["n_variants"] / wall, "digest": rep["digest"],
                     "round_ms": [c["ms"] for c in probe.calls],
                     "round_wall_s": [c["wall_s"] for c in probe.calls]}
        log(f"{label} {key}: tune_search wall_s={wall:.3f} rounds={rep['rounds_run']} "
            f"variants={rep['n_variants']} ({rep['n_variants'] / wall:.2f} variants/s) "
            f"pareto={len(rep['pareto'])} digest={rep['digest']} launches={counts}; each "
            f"round's schedule_lanes between CUDA events "
            f"{[round(c['ms'], 3) for c in probe.calls]} ms (host clock "
            f"{[round(c['wall_s'], 3) for c in probe.calls]} s)")
    if reports["cem"]["points"] != reports["cem-again"]["points"] or (
            reports["cem"]["digest"] != reports["cem-again"]["digest"]):
        raise SystemExit(f"{label}: two CEM runs with seed 0 gave different reports")
    if len({json.dumps(p["vector"]) for p in reports["cem"]["points"]}) < TUNE_VARIANTS:
        raise SystemExit(f"{label}: the CEM run evaluated too few distinct vectors")

    # round 1 of the grid: lane 0 is the baseline vector, and a constant
    # launch of the same shape places as it does
    first = probes["grid"][0]
    arrs_np, masks_np, cfg, wmat = first["arrs"], first["masks"], first["cfg"], first["weights"]
    if not (cfg.traced_weights and np.array_equal(wmat[0], sched.weight_vector(cfg))):
        raise SystemExit(f"{label}: lane 0 of round 1 is not the baseline vector")
    ccfg = cfg._replace(traced_weights=False)
    out_c = sched.schedule_lanes(arrs_np, masks_np, ccfg, device="cuda")
    node_c = out_c.node.cpu().numpy()
    del out_c
    if not (np.array_equal(node_c[0], first["node"][0])
            and (node_c == node_c[:1]).all()):
        raise SystemExit(f"{label}: the baseline lane and the constant launch disagree")
    log(f"{label}: lane 0 of round 1 = weight_vector(cfg) {wmat[0].tolist()}; its "
        f"{int((node_c[0] >= 0).sum())} placements equal the constant-config {len(wmat)}-lane "
        f"launch's "
        f"bit for bit; lanes placing otherwise than lane 0: "
        f"{int((first['node'] != first['node'][:1]).any(axis=1).sum())} of {len(wmat)}")

    # the weighted 64-lane launch against the constant one (the kernel
    # alone, in turns: weighted, constant, constant, weighted)
    dev = torch.device("cuda")
    arrs = sched.device_arrays(arrs_np, dev)
    masks = torch.from_numpy(masks_np).to(dev)
    hoist = sched.hoist_of(arrs, masks)
    inv = sched.inv_alloc_of(arrs.alloc)
    tmpl = template_of(sched, arrs, cfg)
    carry = sched.lane_carry(tmpl, len(wmat))
    w_t = torch.from_numpy(wmat).to(dev)
    p0, n_pods = cfg.forced_prefix, arrs_np.req.shape[0]
    times = {"weighted": [], "constant": []}
    for kind in ("weighted", "constant", "constant", "weighted"):
        kw = {"weights": w_t} if kind == "weighted" else {}
        c = cfg if kind == "weighted" else ccfg
        times[kind].append(cuda_ms(torch, lambda: step.plain_step_cuda(
            arrs, masks, hoist, inv, carry, c, p0, n_pods, template=tmpl, **kw)))
    plan_w = step.LAST_PLAN
    # the bound of the weighted launch, from a reasons-on launch (its
    # placements are the search's)
    rcfg = cfg._replace(fail_reasons=True)
    out_r = step.plain_step_cuda(arrs, masks, hoist, inv, carry, rcfg, p0, n_pods,
                                 template=tmpl, weights=w_t)
    if not np.array_equal(out_r[0].cpu().numpy(), first["node"][:, p0:]):
        raise SystemExit(f"{label}: the timed weighted launch and round 1 disagree")
    outs = [tuple(x[s_i].cpu().numpy() for x in out_r[:3]) for s_i in range(len(wmat))]
    del out_r, carry
    bound = bound_of(lanes_work(sched, arrs_np, cfg, p0, n_pods, outs))
    w_ms, c_ms = min(times["weighted"]), min(times["constant"])
    log(f"{label}: the {len(wmat)}-lane launch with the weight row {w_ms:.3f} ms against the "
        f"constant one {c_ms:.3f} ms ({w_ms / c_ms - 1:+.4f}; runs {times}), {geometry(plan_w)}; "
        f"bound of the weighted launch bytes={bound[0]} ops={bound[1]} -> {bound[2]:.4f} ms, "
        f"{bound[3]}")

    # two lanes with different rows over the first EARLIER_DEPTH pods
    # against the plain step (reasons on, for the bound of the same pods)
    other = next(i for i in range(1, len(wmat)) if not np.array_equal(wmat[i], wmat[0]))
    plain_s, kern_s, err, out_k = parity(torch, sched, step, f"{label}-lanes-0-{other}",
                                         arrs_np, rcfg, masks_np[[0, other]],
                                         n_pods=EARLIER_DEPTH, weights=wmat[[0, other]])
    same_b = bound_of(lanes_work(sched, arrs_np, rcfg, p0, p0 + out_k[0].shape[1],
                                 [tuple(x[s_i].cpu().numpy() for x in out_k[:3])
                                  for s_i in range(2)]))
    log(f"{label}: phase_s={time.perf_counter() - t_phase:.1f}")
    return {
        "runs": runs, "launches": runs["grid"]["launches"]["plain_step_weights"]
        + runs["cem"]["launches"]["plain_step_weights"],
        "lanes": len(wmat), "pods": n_pods - p0, "weighted_ms": w_ms, "constant_ms": c_ms,
        "ms_runs": times, "bound_ms": bound[2], "bound_by": bound[3],
        "geometry": geometry_fields(plan_w), "max_abs_err": err,
        "same_pods": {"lanes": 2, "pods": out_k[0].shape[1], "ms": kern_s * 1e3,
                      "plain_ms": plain_s * 1e3, "bound_ms": same_b[2], "bound_by": same_b[3]},
    }


def frontier_path(torch, sched, step, replay_mod, cluster, template, label):
    """frontier-northstar: ``capacity_frontier`` on the north-star cluster
    with two node specs (the north-star template and one of twice its CPU
    and memory, FRONTIER_MAX of each: 289 mixes), FRONTIER_LANES lanes a
    launch, twice (the same points and Pareto set); one round's first
    EARLIER_DEPTH pods on two lanes against the plain step."""
    import yaml

    t_phase = time.perf_counter()
    big = json.loads(json.dumps(template.raw))
    big["status"]["allocatable"].update({"cpu": "32", "memory": "128Gi"})
    specs = replay_mod.parse_specs([
        {"name": "std", "cost": 1.0, "max_count": FRONTIER_MAX,
         "spec_yaml": yaml.safe_dump(template.raw)},
        {"name": "big", "cost": 2.25, "max_count": FRONTIER_MAX,
         "spec_yaml": yaml.safe_dump(big)}])
    results, runs, probe_calls = [], [], None
    for _ in range(2):
        reset_counts()
        t0 = time.perf_counter()
        with LaneProbe(torch, sched) as probe:
            res = replay_mod.capacity_frontier(cluster, [], specs, lane_width=FRONTIER_LANES,
                                               device="cuda")
        wall = time.perf_counter() - t0
        counts = read_counts()
        rounds = -(-res["n_mixes"] // FRONTIER_LANES)
        if counts["plain_step"] != rounds or len(probe.calls) != rounds:
            raise SystemExit(f"{label}: {rounds} rounds launched {counts}")
        results.append(res)
        probe_calls = probe.calls
        runs.append({"wall_s": wall, "launches": counts, "rounds": rounds,
                     "round_ms": [c["ms"] for c in probe.calls],
                     "round_wall_s": [c["wall_s"] for c in probe.calls]})
        log(f"{label}: capacity_frontier wall_s={wall:.3f} mixes={res['n_mixes']} "
            f"rounds={rounds} pareto={len(res['pareto'])} digest={res['digest']} "
            f"launches={counts}; each round's schedule_lanes between CUDA events "
            f"{[round(c['ms'], 3) for c in probe.calls]} ms")
    if (results[0]["pareto"] != results[1]["pareto"]
            or results[0]["digest"] != results[1]["digest"]):
        raise SystemExit(f"{label}: two runs gave different Pareto sets")
    if results[0]["n_mixes"] != (FRONTIER_MAX + 1) ** 2:
        raise SystemExit(f"{label}: {results[0]['n_mixes']} mixes")
    rec = probe_calls[1]
    masks_np = rec["masks"]
    two = masks_np[[0, len(masks_np) - 1]]
    plain_s, kern_s, err, _ = parity(torch, sched, step, f"{label}-round-2-lanes-0-63",
                                     rec["arrs"], rec["cfg"], two, n_pods=EARLIER_DEPTH)
    pareto = [p["counts"] for p in results[0]["pareto"]]
    log(f"{label}: the Pareto set {pareto} in both runs; phase_s="
        f"{time.perf_counter() - t_phase:.1f}")
    return {"runs": runs, "mixes": results[0]["n_mixes"], "pareto": pareto,
            "digest": results[0]["digest"], "max_abs_err": err,
            "same_pods": {"lanes": 2, "pods": EARLIER_DEPTH, "ms": kern_s * 1e3,
                          "plain_ms": plain_s * 1e3}}


# the fleet-16 path: write_synthetic_fleet(n_clusters=16, nodes=1024,
# pods=10240, malformed=1): 8 dumps at 1,024 x 10,240, 7 at 512 x 5,120
# (padded to 512 x 6,144), one torn, as lanes of 8
FLEET = {"clusters": 16, "nodes": 1024, "pods": 10240, "malformed": 1, "lane_width": 8}
FLEET_BUCKETS = {"1024x10240": 8, "512x6144": 7}
# the fleet form's parity inputs: lanes, nodes and pods of each build's
# fleet, and the pods of their plain-fleet comparison
FLEET_PARITY = {"lanes": 3, "nodes": 512, "pods": 1024, "plain_pods": 24}
# the depth of fleet-16's plain-fleet comparison (cut from EARLIER_DEPTH)
FLEET_PLAIN_DEPTH = 64
# the nodes of the inputs past today's shared-memory bound, and their pods
# (the kernel timed over all of them; the plain step over the first 32)
BOUND_NODES, BOUND_PODS = 5120, 1024


class FleetProbe:
    """Records, while entered, each fleet launch's time between CUDA
    events around the kernel launch alone (``kernels/step._fire`` of the
    fleet form) with its geometry, and each per-lane forced-prefix fold's
    time between CUDA events (``apply_forced_prefix``, which
    ``run_fleet_batched`` calls once per lane)."""

    def __init__(self, torch, sched, step):
        self.torch, self.sched, self.step = torch, sched, step
        self.launches, self.folds = [], []

    def __enter__(self):
        self.real_fire, self.real_fold = self.step._fire, self.sched.apply_forced_prefix
        self.step._fire, self.sched.apply_forced_prefix = self.fire, self.fold
        return self

    def __exit__(self, *exc):
        self.step._fire, self.sched.apply_forced_prefix = self.real_fire, self.real_fold

    def _timed(self, fn):
        torch = self.torch
        ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        ev0.record()
        out = fn()
        ev1.record()
        torch.cuda.synchronize()
        return out, ev0.elapsed_time(ev1)

    def fire(self, lib, args, plan, dev, what):
        if what != "plain_step_fleet":
            return self.real_fire(lib, args, plan, dev, what)
        _, ms = self._timed(lambda: self.real_fire(lib, args, plan, dev, what))
        self.launches.append({"lanes": args.s, "pods": args.p1 - args.p0, "ms": ms,
                              "geometry": geometry_fields(plan)})
        return None

    def fold(self, arrs, cfg, state, k):
        out, ms = self._timed(lambda: self.real_fold(arrs, cfg, state, k))
        self.folds.append({"pods": k, "ms": ms})
        return out


def fleet_lanes(torch, sched, step, arrs_list, masks, cfg):
    """step.FleetLanes of host arrays (one cluster each) and their [N]
    masks on the card, each lane's template the fresh carry with its own
    forced prefix folded in (what run_fleet_batched builds)."""
    dev = torch.device("cuda")
    lanes = []
    for arrs_np, mask in zip(arrs_list, masks):
        arrs = sched.device_arrays(arrs_np, dev)
        active = torch.from_numpy(mask.copy()).to(dev)[None]
        tmpl = template_of(sched, arrs, cfg)
        lanes.append(step.FleetLane(arrs, active, sched.hoist_of(arrs, active),
                                    sched.inv_alloc_of(arrs.alloc), sched.lane_carry(tmpl, 1),
                                    tmpl))
    return lanes


def fleet_parity(torch, sched, step, label, arrs_list, masks, cfg, plain_pods, plain_lanes=2,
                 distinct=True):
    """The fleet kernel over every pod after the forced prefix against one
    plain_step launch per cluster (bit for bit), then over the first
    `plain_pods` pods of `plain_lanes` lanes against plain_step_fleet_torch
    (bit for bit), both timed; with `distinct`, the lanes must place their
    pods differently. Returns a dict of the times, the bound of the
    compared pods and the max abs error."""
    import numpy as np

    k, p = cfg.forced_prefix, arrs_list[0].req.shape[0]
    lanes = fleet_lanes(torch, sched, step, arrs_list, masks, cfg)
    torch.cuda.synchronize()
    ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    ev0.record()
    outs = step.plain_step_fleet_cuda(lanes, cfg, k, p)
    ev1.record()
    torch.cuda.synchronize()
    fleet_ms = ev0.elapsed_time(ev1)
    plan = step.LAST_PLAN
    full = [step_work(sched, arrs, cfg, k, p, lane0(o)) for arrs, o in zip(arrs_list, outs)]
    full_bound = bound_of((sum(w[0] for w in full), sum(w[1] for w in full)))
    err, lone_s = 0.0, 0.0
    for ln, out, lone_ln in zip(lanes, outs, fleet_lanes(torch, sched, step, arrs_list, masks,
                                                          cfg)):
        t0 = time.perf_counter()
        lone = step.plain_step_cuda(lone_ln.arrs, lone_ln.active, lone_ln.hoist,
                                    lone_ln.inv_alloc, lone_ln.state, cfg, k, p,
                                    template=lone_ln.template)
        torch.cuda.synchronize()
        lone_s += time.perf_counter() - t0
        equal, e = compare(torch, out, lone, ln.state, lone_ln.state)
        err = max(err, e)
        if not equal:
            raise SystemExit(f"fleet parity {label}: a fleet lane and its lone launch disagree")
    placed = [tuple(o[0][0].cpu().numpy().tolist()) for o in outs]
    if distinct and len(set(placed)) < 2:
        raise SystemExit(f"fleet parity {label}: the lanes placed their pods alike")
    # the plain fleet over the first pods, against a fleet launch over them
    n_l = min(plain_lanes, len(arrs_list))
    p1 = min(k + plain_pods, p)
    lanes_k = fleet_lanes(torch, sched, step, arrs_list[:n_l], masks[:n_l], cfg)
    lanes_p = fleet_lanes(torch, sched, step, arrs_list[:n_l], masks[:n_l], cfg)
    torch.cuda.synchronize()
    ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    ev0.record()
    out_k = step.plain_step_fleet_cuda(lanes_k, cfg, k, p1)
    ev1.record()
    torch.cuda.synchronize()
    ms = ev0.elapsed_time(ev1)
    t0 = time.perf_counter()
    out_p = step.plain_step_fleet_torch(lanes_p, cfg, k, p1)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    for ok, op, lk, lp in zip(out_k, out_p, lanes_k, lanes_p):
        equal, e = compare(torch, ok, op, lk.state, lp.state)
        err = max(err, e)
        if not equal:
            raise SystemExit(f"fleet parity {label}: the fleet kernel and the plain fleet "
                             "disagree")
    work = [step_work(sched, arrs, cfg, k, p1, lane0(o)) for arrs, o in zip(arrs_list, out_k)]
    bound = bound_of((sum(w[0] for w in work), sum(w[1] for w in work)))
    inst = step.instantiation(cfg, lanes[0].state, fleet=True)
    log(f"fleet parity {label} ({inst}): lanes={len(arrs_list)} pods={p - k} (after a {k}-pod "
        f"prefix) {geometry(plan)} fleet_ms={fleet_ms:.3f} (bound {full_bound[2]:.5f} ms, "
        f"{full_bound[3]}) lone launches {lone_s * 1e3:.1f} ms (host clock) equal=True; "
        f"{n_l} lanes x {p1 - k} pods: kernel {ms:.3f} ms plain {plain_ms:.1f} ms bound "
        f"{bound[2]:.5f} ms ({bound[3]}) equal=True max_abs_err={err}")
    return {"instantiation": inst, "lanes": len(arrs_list), "pods": p - k,
            "fleet_ms": fleet_ms, "fleet_bound_ms": full_bound[2],
            "fleet_bound_by": full_bound[3], "lone_ms": lone_s * 1e3,
            "compared_lanes": n_l, "compared_pods": p1 - k, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound[2], "bound_by": bound[3],
            "max_abs_err": err, "geometry": geometry_fields(plan)}


def fleet_build_parity(torch, sched, step, snapshots, explain_over):
    """One fleet of FLEET_PARITY["lanes"] variants (testing.fleet_variants)
    of each snapshot, with and without explain: each of the eight fleet
    builds against its lone launches and the plain fleet."""
    import numpy as np

    from open_simulator_tpu_torch.testing.synthetic import fleet_variants

    out = {}
    for seed, (inst, snap) in enumerate(snapshots):
        arrs_list = fleet_variants(snap.arrays, FLEET_PARITY["lanes"], seed=seed)
        rng = np.random.RandomState(seed)
        masks = [np.asarray(a.active) & (rng.rand(snap.n_nodes) < 0.9) for a in arrs_list]
        for over in ({}, explain_over):
            cfg = sched.make_config(snap, **over)
            got = fleet_parity(torch, sched, step, f"{inst}{'+explain' if over else ''}-"
                               f"{snap.n_nodes}x{snap.n_pods}", arrs_list, masks, cfg,
                               FLEET_PARITY["plain_pods"])
            want = inst + "+fleet" + ("+explain" if over else "")
            if got["instantiation"] != want:
                raise SystemExit(f"fleet parity {want}: ran {got['instantiation']}")
            out[want] = got
    return out


def fleet_path(torch, sched, step, campaign_mod, label):
    """fleet-16: a campaign over the synthetic fleet with the fleet lanes
    on (three launches: two batched, the torn dump's serial quarantine),
    then with them off (the serial boundary, one simulate() a cluster):
    the same report digest. Each batched launch's kernel time, the
    per-lane folds, the walls and the peak memory; then two clusters of
    each bucket against their lone launches at full width and the plain
    fleet over their first pods."""
    import shutil

    import numpy as np

    from open_simulator_tpu_torch.campaign import lanes as lanes_mod

    t_phase = time.perf_counter()
    root = os.path.join(HERE, "build", "fleet16")
    shutil.rmtree(root, ignore_errors=True)
    t0 = time.perf_counter()
    campaign_mod.write_synthetic_fleet(root, n_clusters=FLEET["clusters"], nodes=FLEET["nodes"],
                                       pods=FLEET["pods"], malformed=FLEET["malformed"])
    write_s = time.perf_counter() - t0
    kept = {}
    real_prepare = lanes_mod._prepare

    def keep(entry, apps, opts):
        prep = real_prepare(entry, apps, opts)
        kept.setdefault(prep.arrs.req.shape[0], []).append(prep)
        return prep

    runs = {}
    for lanes_on in (True, False):
        reset_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        lanes_mod._prepare = keep if lanes_on else real_prepare
        try:
            with FleetProbe(torch, sched, step) as probe:
                t0 = time.perf_counter()
                rep = campaign_mod.run_campaign(campaign_mod.CampaignOptions(
                    fleet=root, checkpoint=False, fleet_lanes=lanes_on,
                    lane_width=FLEET["lane_width"]))
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
        finally:
            lanes_mod._prepare = real_prepare
        runs[lanes_on] = {"wall_s": wall, "clusters_per_s": rep["totals"]["clusters"] / wall,
                          "launches": rep["launches"], "counts": read_counts(),
                          "peak_mib": torch.cuda.max_memory_allocated() / 2**20,
                          "digest": rep["digest"], "buckets": rep["buckets"],
                          "totals": rep["totals"], "kernel_launches": probe.launches,
                          "folds": probe.folds}
        log(f"{label} fleet_lanes={lanes_on}: {wall:.2f}s "
            f"({runs[lanes_on]['clusters_per_s']:.3f} clusters/s) launches={rep['launches']} "
            f"digest={rep['digest']} totals={rep['totals']} buckets={rep['buckets']} "
            f"quarantined={[(q['cluster'], q['error']['code']) for q in rep['quarantined']]} "
            f"peak={runs[lanes_on]['peak_mib']:.1f} MiB counts={runs[lanes_on]['counts']}")
    on, off = runs[True], runs[False]
    for launch in on["kernel_launches"]:
        log(f"{label} batched launch: {launch['lanes']} lanes x {launch['pods']} pods "
            f"{launch['ms']:.3f} ms (CUDA events) {launch['geometry']}")
    log(f"{label} per-lane folds (ms, CUDA events): {[round(f['ms'], 4) for f in on['folds']]}")
    if on["digest"] != off["digest"] or on["totals"] != off["totals"]:
        raise SystemExit(f"{label}: the fleet-lane and serial campaigns disagree")
    if (on["launches"], off["launches"]) != (3, FLEET["clusters"]):
        raise SystemExit(f"{label}: launches {on['launches']} / {off['launches']}, expected 3 / "
                         f"{FLEET['clusters']}")
    if on["buckets"] != FLEET_BUCKETS or on["totals"]["quarantined"] != 1:
        raise SystemExit(f"{label}: buckets {on['buckets']}, totals {on['totals']}")
    if (on["counts"]["plain_step_fleet"] != 2
            or sorted(x["lanes"] for x in on["kernel_launches"]) != [7, 8]
            or len(on["folds"]) != 15):
        raise SystemExit(f"{label}: the fleet lanes did not run through the fleet kernel "
                         f"({on['counts']}, {len(on['folds'])} folds)")
    # every cluster of each bucket against its lone launch, at full width
    parity_b = {}
    for n_pods, group in sorted(kept.items()):
        arrs_list = [p.arrs for p in group]
        masks = [np.asarray(a.active) for a in arrs_list]
        # (write_synthetic_fleet's clusters of one bucket differ only in
        # their names: their lanes place their pods alike)
        parity_b[f"{arrs_list[0].alloc.shape[0]}x{n_pods}"] = fleet_parity(
            torch, sched, step, f"{label}-{arrs_list[0].alloc.shape[0]}x{n_pods}", arrs_list,
            masks, group[0].cfg, FLEET_PLAIN_DEPTH, distinct=False)
    big = max(on["kernel_launches"], key=lambda x: x["lanes"])
    big_par = parity_b[f"{FLEET['nodes']}x{FLEET['pods']}"]
    big["bound_ms"], big["bound_by"] = big_par["fleet_bound_ms"], big_par["fleet_bound_by"]
    log(f"{label}: the 8-lane launch {big['ms']:.3f} ms, its bound {big['bound_ms']:.5f} ms "
        f"({big['bound_by']}); phase {time.perf_counter() - t_phase:.1f}s (writing the fleet "
        f"{write_s:.1f}s)")
    shutil.rmtree(root, ignore_errors=True)
    return {"fleet_lanes": on, "serial": off, "write_s": write_s, "parity": parity_b,
            "launch_8": big}


def smem_bound_inputs(torch, sched, step, many_domain_snapshot):
    """The shared-memory bound of a 5,120-node lane (C = 16 blocks): for the
    dom_count path and the group_count path of ``many_domain_snapshot``,
    the largest zone count D whose regions fit, and D + 1, which the plan
    puts in global memory (the dom_count replica; the column-read
    partials): the kernel over every pod at both (min of 3, CUDA events),
    and at D + 1 against the plain step over the first 32 pods."""
    import numpy as np

    out = {}
    dev = torch.device("cuda")
    for path, affinity in (("dom_count", False), ("group_count", True)):
        small = many_domain_snapshot(64, 16, 8, affinity=affinity)
        cfg_s = sched.make_config(small)
        arrs_s = sched.device_arrays(small.arrays, "cpu")
        flags = step._flags(cfg_s, sched.lane_carry(sched.init_state(arrs_s, cfg_s), 1), True)
        w = step.smem_widths(arrs_s, cfg_s, flags)
        sl = step.block_geometry(BOUND_NODES, step.CLUSTER_SIZES[0])[0]
        per_d = w.dom // w.d

        def fits(d):
            return step.smem_bytes(w._replace(d=d, dom=per_d * d), sl, False) <= step._SMEM_LIMIT

        d_max = max(d for d in range(1, 8192) if fits(d))
        got = {"d_max": d_max}
        for d in (d_max, d_max + 1):
            snap = many_domain_snapshot(BOUND_NODES, BOUND_PODS, d, affinity=affinity)
            cfg = sched.make_config(snap)
            arrs = sched.device_arrays(snap.arrays, dev)
            if arrs.topo_onehot.shape[2] != d:
                raise SystemExit(f"bound input {path}: {arrs.topo_onehot.shape[2]} zones, not {d}")
            active = torch.from_numpy(np.asarray(snap.arrays.active)).to(dev)[None]
            hoist, inv = sched.hoist_of(arrs, active), sched.inv_alloc_of(arrs.alloc)
            tmpl = template_of(sched, arrs, cfg)
            st = sched.lane_carry(tmpl, 1)
            static, times = {}, []
            for _ in range(4):
                times.append(cuda_ms(torch, lambda: step.plain_step_cuda(
                    arrs, active, hoist, inv, st, cfg, cfg.forced_prefix, snap.n_pods,
                    template=tmpl, inputs=static)))
            times = times[1:]  # the first converts the inputs
            plan = step.LAST_PLAN
            region = ("dom_count replica" if plan.dom_global else
                      "column-read partials" if plan.cols_global else "shared memory")
            if (d > d_max) != (plan.dom_global or plan.cols_global) or plan.wide != (d > d_max):
                raise SystemExit(f"bound input {path} D={d}: plan {plan}")
            key = "past" if d > d_max else "at"
            got[key] = {"d": d, "ms": min(times), "runs": times, "region": region,
                        "geometry": geometry_fields(plan)}
            log(f"bound {path} D={d} ({key} the bound): {region}, kernel over {snap.n_pods} "
                f"pods {min(times):.3f} ms (min of 3) {geometry(plan)}")
            if d > d_max:
                got["past"]["parity"] = parity(torch, sched, step, f"bound-{path}-D{d}",
                                               snap.arrays, cfg, snap.arrays.active,
                                               n_pods=32)[2]
                if not step.LAST_PLAN.wide:
                    raise SystemExit(f"bound input {path}: the parity launch was not wide")
        out[path] = got
    return out


# the extension paths: pods of each build's parity input, the 64-lane
# extension sweep's depth (the first pods of the capacity-northstar
# snapshot) and its plain comparison (lanes 0 and 63, the first pods)
EXT_DEPTH, EXT_SWEEP_PODS, EXT_SWEEP_PARITY = 32, 4096, 64


def ext_rows_work(n_lanes, n_pods, n_nodes, n_filters, n_scores):
    """(bytes, operations) of the extension rows alone: each lane's masks
    and raw scores read once (S x P x N x (Ef + 4 Es) bytes); per (lane,
    pod, node) one test per filter row and, per score row, its two
    normalizer updates and its (raw - lo) x inv x w and add (6)."""
    elems = n_lanes * n_pods * n_nodes
    return elems * (n_filters + 4 * n_scores), elems * (n_filters + 6 * n_scores)


def ext_build_parity(torch, sched, step, snapshots, ops, wide_snaps):
    """Each build the extension rows reach: the four <I,D> inputs, each
    without and with the preemption columns and without and with the
    top-k and the jitter (the 16 builds), then the wide library's scan
    builds, over their first EXT_DEPTH pods with seeded rows (a NaN score
    every third pod), kernel against the plain step. The rich inputs run
    with both the group_count and the dom_count carries live."""
    import numpy as np

    from open_simulator_tpu_torch.testing.synthetic import preemption_columns

    out = {}
    for seed, (inst, snap) in enumerate(snapshots):
        for cols in (False, True):
            for explain in (False, True):
                over = {"explain_topk": EXPLAIN_K, "tie_break_seed": TIE_SEED} if explain else {}
                cfg = sched.make_config(snap, extensions=ops, **over)
                arrs = sched.device_arrays(snap.arrays, torch.device("cuda"))
                st = sched.init_state(arrs, cfg)
                name = step.instantiation(cfg, st, columns=cols)
                want = inst + ("+columns" if cols else "") + ("+explain" if explain else "")
                flags = step._flags(cfg, st, False)
                del arrs, st
                if name != want:
                    raise SystemExit(f"extension input {want} runs {name}")
                if inst.startswith("<1,") and not (flags & step.F_GC and flags & step.F_DOM):
                    raise SystemExit(f"extension input {want}: group_count and dom_count "
                                     "are not both live")
                active = np.arange(snap.n_nodes) % 9 != 4
                columns = (preemption_columns(snap.arrays.forced_node, active, seed=seed)
                           if cols else None)
                t_p, t_k, err, out_k = parity(torch, sched, step, f"ext-{want}-1024x2048",
                                              snap.arrays, cfg, active, n_pods=EXT_DEPTH,
                                              columns=columns, ext_seed=seed)
                fc = out_k[1][0].cpu().numpy()
                if not fc[:, cfg.n_ops - 2:].any():
                    raise SystemExit(f"extension input {want}: no extension reason row charged")
                out[want] = {"pods": EXT_DEPTH, "ms": t_k * 1e3, "plain_ms": t_p * 1e3,
                             "max_abs_err": err, "gc_and_dom": bool(flags & step.F_GC
                                                                    and flags & step.F_DOM)}
    for inst, snap in wide_snaps:
        cfg = sched.make_config(snap, extensions=ops)
        t_p, t_k, err, _ = parity(torch, sched, step, f"ext-{inst}+wide-1024x2048", snap.arrays,
                                  cfg, snap.arrays.active, n_pods=EXT_DEPTH, ext_seed=7)
        if not step.LAST_PLAN.wide:
            raise SystemExit(f"extension input {inst}+wide did not run the wide library")
        out[inst + "+wide"] = {"pods": EXT_DEPTH, "ms": t_k * 1e3, "plain_ms": t_p * 1e3,
                               "max_abs_err": err}
    return out


def ext_scan(torch, sched, arrs_np, masks_np, cfg, n_pods, plain):
    """The engine's per-pod extension loop (``engine.scheduler.
    _extension_scan``) over the first `n_pods` pods of the lanes of
    `masks_np`, on the card: the kernel, or with `plain` the plain step
    through the same loop. Returns (outputs, carry, seconds)."""
    import numpy as np

    dev = torch.device("cuda")
    arrs = sched.device_arrays(sched.slice_pods(arrs_np, 0, n_pods), dev)
    masks = torch.from_numpy(np.ascontiguousarray(masks_np)).to(dev)
    hoist, inv = sched.hoist_of(arrs, masks), sched.inv_alloc_of(arrs.alloc)
    tmpl = sched.init_state(arrs, cfg)
    carry = sched.lane_carry(tmpl, masks.shape[0])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs = sched._extension_scan(arrs, masks, hoist, inv, carry, tmpl, cfg, 0, n_pods, None,
                                 None, None, plain=plain)
    torch.cuda.synchronize()
    return outs, carry, time.perf_counter() - t0


def graph_kernel_ms(torch, reset, graph, n):
    """The plain_step kernel's device ms over `n` replays of `graph` after
    `reset()`, from the profiler's kernel times (CUPTI); None where the
    profiler fails or sees no such kernel."""
    from torch.profiler import ProfilerActivity, profile

    reset()
    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                graph.replay()
            torch.cuda.synchronize()
        us = sum(getattr(e, "device_time_total", 0.0) for e in prof.key_averages()
                 if "plain_step_kernel" in e.key)
    except RuntimeError as err:
        log(f"profiler: {err}")
        return None
    return us / 1e3 if us else None


def graph_path(label, counts, n_pods):
    """The extension loop ran as one captured CUDA graph, replayed for
    every pod after the first, and never eagerly."""
    if (counts["graphs"], counts["replays"], counts["eager"]) != (1, n_pods - 1, 0):
        raise SystemExit(f"{label}: the extension loop did not run as one graph replayed for "
                         f"its {n_pods} pods: {counts}")


def ext_path(torch, sched, step, simulate, cluster_of, ops, label):
    """northstar-ext: simulate() on the north-star cluster with five torch
    extension ops (every kind: a filter of the arrays, one of the pod
    slice, a "minmax" score, a "max" score of the carry, a "none" score),
    launch counts and the loop's counters reset just before and read just
    after (one kernel launch a pod; one CUDA graph, replayed for every pod
    after the first, no eager loop), its per-pod loop timed inside it (the
    loop's wall a pod); the first PARITY_PREFIX pods again through the
    engine's loop (``ExtensionLoop``), then the graph's replays from the
    template with the stream primed (the device time a pod, and with the
    loop's wall the card's idle share), the launches alone, back to
    back with the cursor's steps, and the profiler's kernel times inside
    the replays (the device time a launch), the kernel's outputs and carry
    against the plain step through the same per-pod loop; the same
    one-lane launch without extensions (a build without their code) timed
    beside it."""
    import hashlib

    import numpy as np

    t_phase = time.perf_counter()
    cluster = cluster_of("plain")
    scan = sched._extension_scan
    scan_s = []

    def timed_scan(*a, **kw):  # the per-pod loop inside simulate()
        torch.cuda.synchronize()
        t = time.perf_counter()
        got = scan(*a, **kw)
        torch.cuda.synchronize()
        scan_s.append(time.perf_counter() - t)
        return got

    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sched._extension_scan = timed_scan
    try:
        result = simulate(cluster, [], device="cuda", config_overrides={"extensions": ops})
        torch.cuda.synchronize()
    finally:
        sched._extension_scan = scan
    wall = time.perf_counter() - t0
    launches = read_counts()
    snap = result.snapshot
    n_pods, n_nodes = snap.n_pods, snap.n_nodes
    log(f"{label}: simulate() {n_nodes} nodes x {n_pods} pods wall_s={wall:.3f} "
        f"scheduled={len(result.scheduled_pods)} unscheduled={len(result.unscheduled_pods)} "
        f"launches={launches}")
    if launches["plain_step_ext"] != n_pods or launches["plain_step"] != n_pods:
        raise SystemExit(f"{label}: {launches} launches, not one a pod")
    graph_path(label, launches, n_pods)
    if len(result.scheduled_pods) + len(result.unscheduled_pods) != n_pods:
        raise SystemExit(f"{label}: simulate() lost pods")
    cfg = sched.make_config(snap, extensions=ops)
    rows = step.extension_rows(cfg)
    fc = np.asarray(result.fail_counts)
    ext_totals = {name: int(fc[:, cfg.n_ops - len(rows.filters) + i].sum())
                  for i, name in enumerate(cfg.extension_op_names)}
    if not all(ext_totals.values()):
        raise SystemExit(f"{label}: an extension reason row was never charged: {ext_totals}")

    placed = {sp.pod.key: sp.node_name for sp in result.scheduled_pods}
    digest = hashlib.sha256(json.dumps(sorted(placed.items())).encode()).hexdigest()[:16]
    if len(scan_s) != 1:
        raise SystemExit(f"{label}: simulate() ran the per-pod loop {len(scan_s)} times")
    dev = torch.device("cuda")

    # the first PARITY_PREFIX pods through the engine's loop, its pieces
    # apart: the first pod eagerly, the second captured, the graph replayed
    # for the rest (host-timed); then the replays again from the template
    # with the stream primed (the device time a pod: the callables' kernels,
    # the launch, the cursor's step), and the launches alone, each pod's
    # rows recorded, back to back with the cursor's steps, the stream
    # primed, and the profiler's kernel times inside the replays (the
    # device time a launch)
    r = PARITY_PREFIX
    arrs = sched.device_arrays(snap.arrays, dev)
    active = torch.from_numpy(snap.arrays.active).to(dev)[None]
    hoist, inv = sched.hoist_of(arrs, active), sched.inv_alloc_of(arrs.alloc)
    tmpl = sched.init_state(arrs, cfg)
    carry = sched.lane_carry(tmpl, 1)
    loop = sched.ExtensionLoop(arrs, active, hoist, inv, carry, tmpl, cfg, 0, r, None, None, None)
    outs_k = loop.outs
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loop.pod(0)
    graph = loop.capture(1)
    if graph is None:
        raise SystemExit(f"{label}: the extension ops could not be captured")
    for _ in range(1, r):
        graph.replay()
    torch.cuda.synchronize()
    loop_s = time.perf_counter() - t0
    got = {snap.pods[i].key: snap.node_names[int(nd)]
           for i, nd in enumerate(outs_k.node[0].cpu().tolist()) if nd >= 0}
    if got != {k: v for k, v in placed.items() if k in {p.key for p in snap.pods[:r]}}:
        raise SystemExit(f"{label}: the loop's first {r} pods and simulate() placed pods "
                         "differently")
    st_k = clone_state(sched, carry)
    out_snap = [o.clone() for o in outs_k]
    pod_ms = []
    for _ in range(3):
        step.copy_template(carry, tmpl)
        loop.cursor.fill_(0)
        torch.cuda.synchronize()
        pod_ms.append(cuda_ms(torch, lambda: [graph.replay() for _ in range(r)],
                              prime_ms=0.05 * r))
    equal_replay, _ = compare(torch, outs_k, out_snap, carry, st_k)
    if not equal_replay:
        raise SystemExit(f"{label}: the graph replayed from pod 0 left other outputs or carry")
    # the rows recorded against the live carry, then the launches (and the
    # cursor's steps) back to back from the template
    step.copy_template(carry, tmpl)
    loop.cursor.fill_(0)
    rec = []
    for p in range(r):
        ok, raw = loop.rows_of(loop.fields, arrs, loop.x)
        rec.append((ok[:, None], raw[:, None]))
        loop.launch(p, *rec[-1])
        loop.cursor.add_(1)
    def back_to_back():
        for p in range(r):
            loop.launch(p, *rec[p])
            loop.cursor.add_(1)

    def reset():
        step.copy_template(carry, tmpl)
        loop.cursor.fill_(0)

    times = []
    for _ in range(3):
        reset()
        torch.cuda.synchronize()
        times.append(cuda_ms(torch, back_to_back, prime_ms=1.0 * r))
    equal_launch, _ = compare(torch, outs_k, out_snap, carry, st_k)
    if not equal_launch:
        raise SystemExit(f"{label}: the launches alone left other outputs or carry")
    # the launch's own device time: the profiler's kernel times inside the
    # graph's replays; where it sees none, the launches back to back (each
    # followed by the cursor's step, which costs the cluster launch more
    # than the graph does) stand for it
    kernel_ms = graph_kernel_ms(torch, reset, graph, r)
    device_ms, ms_method = ((kernel_ms, "the profiler's kernel time inside the graph's replays")
                            if kernel_ms else
                            (min(times), "the launches and cursor steps back to back"))
    del graph, loop
    # the plain step through the same per-pod loop
    outs_p, st_p, plain_s = ext_scan(torch, sched, snap.arrays, snap.arrays.active[None], cfg, r,
                                     plain=True)
    equal, err = compare(torch, outs_k, outs_p, st_k, st_p)
    log(f"{label}: the first {r} pods, kernel against the plain step through the same loop: "
        f"equal={equal} max_abs_err={err} plain_s={plain_s:.2f}")
    if not equal:
        raise SystemExit(f"{label}: kernel and plain step disagree")
    # the same one-lane launch without extensions, in this call
    cfg0 = sched.make_config(snap, forced_prefix=0)
    tmpl0 = sched.init_state(arrs, cfg0)
    st0 = sched.lane_carry(tmpl0, 1)
    plain_ms = []
    for _ in range(3):
        ev = cuda_ms(torch, lambda: step.plain_step_cuda(arrs, active, hoist, inv, st0, cfg0, 0,
                                                         n_pods, template=tmpl0))
        plain_ms.append(ev)
    work = step_work(sched, snap.arrays, cfg, 0, r, lane0(outs_k))
    ext_w = ext_rows_work(1, r, n_nodes, len(rows.filters), len(rows.scores))
    bound = bound_of((work[0] + ext_w[0], work[1] + ext_w[1]))
    rows_bound = bound_of(ext_w)
    device_pod_us = min(pod_ms) * 1e3 / r
    res = {
        "launches": launches["plain_step_ext"], "pods": n_pods, "simulate_s": wall,
        "graphs": launches["graphs"], "graph_replays": launches["replays"],
        "eager_loops": launches["eager"],
        "scan_s": scan_s[0], "host_us_per_pod": scan_s[0] / n_pods * 1e6,
        "device_us_per_pod": device_pod_us, "device_pod_ms_runs": pod_ms,
        "idle_share": 1.0 - device_pod_us * n_pods / (scan_s[0] * 1e6),
        "loop_us_per_pod": loop_s / r * 1e6, "device_us_per_launch": device_ms * 1e3 / r,
        "device_us_per_launch_by": ms_method,
        "back_to_back_us_per_launch": min(times) * 1e3 / r, "back_to_back_ms_runs": times,
        "no_ext_launch_ms": min(plain_ms),
        "no_ext_us_per_pod": min(plain_ms) * 1e3 / n_pods, "no_ext_runs": plain_ms,
        "digest": digest, "ext_reason_totals": ext_totals,
        "scheduled": len(result.scheduled_pods), "max_abs_err": err,
        "rows_bound_ms": rows_bound[2], "rows_bound_by": rows_bound[3],
        "same_pods": {"pods": r, "ms": device_ms, "plain_ms": plain_s * 1e3,
                      "bound_ms": bound[2], "bound_by": bound[3]},
    }
    log(f"{label}: " + " ".join(f"{k}={v}" for k, v in res.items() if k != "same_pods")
        + f" same_pods={res['same_pods']} phase_s={time.perf_counter() - t_phase:.1f}")
    return res


def ext_sweep_path(torch, sched, step, sweep, snap_full, ops, label):
    """capacity-northstar-ext-64: capacity_sweep with the extension ops on
    the capacity-northstar snapshot (5,120 + 64 nodes) over its first
    EXT_SWEEP_PODS pods, 64 lanes vmapped through the callables, launch
    counts reset just before and read just after (one launch a pod, the
    loop one graph replayed for every pod after the first); the device
    time a pod at 64 lanes (the loop's graph over the first
    EXT_SWEEP_PARITY pods replayed with the stream primed; against the
    sweep's wall, which holds more than the loop, an upper bound of the
    card's idle share); then lanes 0 and 63 over the first
    EXT_SWEEP_PARITY pods, the kernel against the plain step through the
    same per-pod loop, and against the sweep's own lanes."""
    import numpy as np

    t_phase = time.perf_counter()
    snap = dataclasses.replace(snap_full, arrays=sched.slice_pods(snap_full.arrays, 0,
                                                                   EXT_SWEEP_PODS),
                               pods=snap_full.pods[:EXT_SWEEP_PODS])
    cfg = sched.make_config(snap, extensions=ops)
    counts = [min(i % (CAPACITY_LANES + 1), CAPACITY_LANES) for i in range(CAPACITY_LANES)]
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plan = sweep.capacity_sweep(snap, cfg, counts, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    if launches["plain_step_ext"] != EXT_SWEEP_PODS:
        raise SystemExit(f"{label}: {launches} launches, not one a pod")
    graph_path(label, launches, EXT_SWEEP_PODS)
    # the device time a pod at 64 lanes: the loop's graph over the first
    # EXT_SWEEP_PARITY pods, replayed from the template with the stream primed
    dev = torch.device("cuda")
    arrs = sched.device_arrays(sched.slice_pods(snap.arrays, 0, EXT_SWEEP_PARITY), dev)
    active = torch.from_numpy(sweep.active_masks_for_counts(snap, counts)).to(dev)
    tmpl = sched.init_state(arrs, cfg)
    carry = sched.lane_carry(tmpl, CAPACITY_LANES)
    loop = sched.ExtensionLoop(arrs, active, sched.hoist_of(arrs, active),
                               sched.inv_alloc_of(arrs.alloc), carry, tmpl, cfg, 0,
                               EXT_SWEEP_PARITY, None, None, None)
    loop.pod(0)
    graph = loop.capture(1)
    if graph is None:
        raise SystemExit(f"{label}: the extension ops could not be captured")
    pod_ms = []
    for _ in range(3):
        step.copy_template(carry, tmpl)
        loop.cursor.fill_(0)
        torch.cuda.synchronize()
        pod_ms.append(cuda_ms(torch, lambda: [graph.replay() for _ in range(EXT_SWEEP_PARITY)],
                              prime_ms=0.05 * EXT_SWEEP_PARITY))
    device_pod_us = min(pod_ms) * 1e3 / EXT_SWEEP_PARITY
    del graph, loop, carry
    masks = sweep.active_masks_for_counts(snap, [counts[0], counts[-1]])
    outs_k, st_k, t_k = ext_scan(torch, sched, snap.arrays, masks, cfg, EXT_SWEEP_PARITY, False)
    outs_p, st_p, t_p = ext_scan(torch, sched, snap.arrays, masks, cfg, EXT_SWEEP_PARITY, True)
    equal, err = compare(torch, outs_k, outs_p, st_k, st_p)
    sweep_nodes = np.asarray(plan.nodes_per_scenario)[[0, -1], :EXT_SWEEP_PARITY]
    if not equal or not np.array_equal(outs_k[0].cpu().numpy(), sweep_nodes):
        raise SystemExit(f"{label}: lanes 0 and 63 disagree with the plain step or the sweep")
    res = {"launches": launches["plain_step_ext"], "lanes": CAPACITY_LANES,
           "pods": EXT_SWEEP_PODS, "sweep_s": wall, "graph_replays": launches["replays"],
           "host_us_per_pod": wall / EXT_SWEEP_PODS * 1e6,
           "device_us_per_pod": device_pod_us, "device_pod_ms_runs": pod_ms,
           "idle_share_upper": 1.0 - device_pod_us * EXT_SWEEP_PODS / (wall * 1e6),
           "best_count": plan.best_count,
           "parity": {"lanes": 2, "pods": EXT_SWEEP_PARITY, "ms": t_k * 1e3,
                      "plain_ms": t_p * 1e3, "max_abs_err": err}}
    log(f"{label}: {res} phase_s={time.perf_counter() - t_phase:.1f}")
    return res


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
    gc.callbacks.append(GC)
    try:
        from open_simulator_tpu_torch import core
        from open_simulator_tpu_torch.core import simulate
        from open_simulator_tpu_torch.engine import preemption
        from open_simulator_tpu_torch.simulator import Simulator
        from open_simulator_tpu_torch.engine import scheduler as sched
        from open_simulator_tpu_torch.k8s.loader import ClusterResources, make_valid_node
        from open_simulator_tpu_torch.k8s.objects import Node, Pod
        from open_simulator_tpu_torch.encode.snapshot import encode_cluster
        from open_simulator_tpu_torch.cli.main import main as cli_main
        from open_simulator_tpu_torch.k8s import loader
        from open_simulator_tpu_torch.engine import buckets
        from open_simulator_tpu_torch.engine import waves as waves_mod
        from open_simulator_tpu_torch.kernels import build, step, wave
        from open_simulator_tpu_torch.ops import threefry
        from open_simulator_tpu_torch.parallel import sweep
        from open_simulator_tpu_torch import replay as replay_mod
        from open_simulator_tpu_torch import tune as tune_mod
        from open_simulator_tpu_torch.replay import engine as rengine
        from open_simulator_tpu_torch.telemetry import explain as explain_mod
        from open_simulator_tpu_torch import campaign as campaign_mod
        from open_simulator_tpu_torch.testing.synthetic import (
            device_resource_cluster, device_resource_snapshot, many_domain_snapshot,
            preemption_columns, soft_spread_cluster, synthetic_extensions, synthetic_objects,
            synthetic_snapshot, wave_pools_snapshot, widen_device_resources)
    except ImportError as e:
        print(f"chip_smoke: the open_simulator_tpu_torch package is missing ({e})",
              file=sys.stderr)
        return 1
    import numpy as np

    COUNTERS.extend([step.LAUNCHES, wave.LAUNCHES, sched.EXTENSION_LOOP, sched.WAVE_LOOP])
    dev_name = torch.cuda.get_device_name(0)
    print(card_line(), flush=True)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device {dev_name}")

    def snapshot_of(kind):
        if kind == "devres":
            return device_resource_snapshot(NODES, PODS, max_new=CAPACITY_LANES)
        return synthetic_snapshot(NODES, PODS, max_new=CAPACITY_LANES, rich=kind == "rich")

    def cluster_of(kind):
        if kind == "devres":
            return device_resource_cluster(NODES, PODS)
        nodes, pods, _ = synthetic_objects(NODES, PODS, rich=kind == "rich")
        return ClusterResources(nodes=nodes, pods=pods)

    # ---- 2. build: every library's nvcc started together in a thread,
    # while the host encodes what needs no kernel on the cores nvcc leaves
    # idle: the capacity paths' three snapshots (phase 5 takes them), the
    # first inputs of phase 3 and the main paths' cluster objects
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(max_workers=1) as pool:
        built = pool.submit(build.build_all)
        capacity_snaps = {}
        for _, kind in PATHS:
            t_s = time.perf_counter()
            capacity_snaps[kind] = (snapshot_of(kind), time.perf_counter() - t_s)
        nd, pd = soft_spread_cluster(512, 4096)
        early = dict(
            a=synthetic_snapshot(1024, 10240, rich=False, bound=0.1),
            b=encode_cluster([make_valid_node(Node.from_dict(x)) for x in nd],
                             [Pod.from_dict(x) for x in pd]),
            r=synthetic_snapshot(1024, 10240, rich=True, bound=0.1),
            d=synthetic_snapshot(512, 4096, rich=True),
            l=synthetic_snapshot(512, 1024, rich=True),
            g=device_resource_snapshot(1024, 10240, max_new=8),
            x=device_resource_snapshot(1024, 2048, rich=True))
        del nd, pd
        main_clusters = {kind: cluster_of(kind) for _, kind in PATHS}
        host_s = time.perf_counter() - t0
        built.result()  # a failed build raises here
    log(f"build: {time.perf_counter() - t0:.1f}s for {build.kernel_names()} (the host encoded "
        f"the capacity snapshots, phase 3's first inputs and the main paths' clusters "
        f"beside it in {host_s:.1f}s)")
    for name, text in build.BUILD_LOG.items():
        for line in text.splitlines():
            if any(w in line for w in ("registers", "spill", "smem", "entry function")):
                log(f"build {name}: {line.strip()}")
    insts = {**instantiations(build.BUILD_LOG.get("plain_step", "")),
             **instantiations(build.BUILD_LOG.get("plain_step_explain", "")),
             **instantiations(build.BUILD_LOG.get("plain_step_wide", ""), "+wide"),
             **instantiations(build.BUILD_LOG.get("plain_step_wide_explain", ""), "+wide"),
             **instantiations(build.BUILD_LOG.get("plain_step_ext", ""), "+ext"),
             **instantiations(build.BUILD_LOG.get("plain_step_ext_explain", ""), "+ext")}
    log(f"build plain_step instantiations: {insts}")
    moved = {k: insts.get(k, {}).get("registers", 0) - r for k, r in BASE_REGISTERS.items()}
    log(f"build: registers against the builds before the fleet form: "
        f"{ {k: d for k, d in moved.items() if d} } (every other build unchanged)")
    every = LAUNCHED + FLEET_BUILDS
    every += tuple(k + "+wide" for k in every) + EXT_BUILDS
    spilled = [k for k in every if k not in insts or insts[k]["spill_store_bytes"]]
    if spilled:
        raise SystemExit(f"build: plain_step {spilled} spill registers (or were not reported)")

    # ---- 3. kernel vs plain on the card
    errs = []
    snap_a = early["a"]
    cfg_a = sched.make_config(snap_a)
    if not (cfg_a.maintain_dom_count
            and (snap_a.arrays.forced_node[cfg_a.forced_prefix:] >= 0).any()):
        raise SystemExit("parity input a is not the dom_count path with mid-sequence forced pods")
    errs.append(parity(torch, sched, step, "synthetic-1024x10240-dom_count",
                       snap_a.arrays, cfg_a, snap_a.arrays.active, n_pods=4 * EARLIER_DEPTH)[2])

    snap_b = early["b"]
    cfg_b = sched.make_config(snap_b)
    if not (cfg_b.needs_group_count and cfg_b.compact_carry and cfg_b.forced_prefix
            and cfg_b.enable_ports and cfg_b.enable_unsched and cfg_b.enable_class_taint):
        raise SystemExit("parity input b is not the group_count path it should be")
    errs.append(parity(torch, sched, step, "inline-512x4096-group_count",
                       snap_b.arrays, cfg_b, snap_b.arrays.active, n_pods=2 * EARLIER_DEPTH)[2])

    rng = np.random.RandomState(7)
    n_b = snap_b.n_nodes
    lanes = np.stack([np.ones(n_b, bool), np.arange(n_b) % 4 != 1,
                      np.arange(n_b) >= n_b // 2, rng.rand(n_b) < 0.8])
    errs.append(parity(torch, sched, step, "inline-512x4096-4-lanes",
                       snap_b.arrays, cfg_b, lanes, n_pods=EARLIER_DEPTH)[2])

    snap_r = early["r"]
    cfg_r = sched.make_config(snap_r)
    if not (cfg_r.enable_pod_affinity and cfg_r.enable_anti_affinity and cfg_r.enable_pref
            and cfg_r.enable_spread_hard and cfg_r.slot_paint and cfg_r.compact_carry):
        raise SystemExit("parity input rich is not the inter-pod path it should be")
    errs.append(parity(torch, sched, step, "rich-1024x10240-bound0.1",
                       snap_r.arrays, cfg_r, snap_r.arrays.active, n_pods=2 * EARLIER_DEPTH)[2])

    snap_d = early["d"]
    cfg_d = sched.make_config(snap_d, slot_paint=False)
    errs.append(parity(torch, sched, step, "rich-512x4096-dense",
                       snap_d.arrays, cfg_d, snap_d.arrays.active, n_pods=2 * EARLIER_DEPTH)[2])

    snap_l = early["l"]
    cfg_l = sched.make_config(snap_l)
    n_l = snap_l.n_nodes
    lanes_l = np.stack([np.ones(n_l, bool), np.arange(n_l) % 3 != 2,
                        np.arange(n_l) < (3 * n_l) // 4, rng.rand(n_l) < 0.7])
    out_l = parity(torch, sched, step, "rich-512x1024-4-lanes",
                   snap_l.arrays, cfg_l, lanes_l, n_pods=8 * EARLIER_DEPTH)
    errs.append(out_l[2])
    if len({tuple(row.tolist()) for row in out_l[3][0].cpu()}) != 4:
        raise SystemExit("rich 4-lane launch: the lanes did not place pods differently")

    # the device-resource cluster with mid-sequence pods bound by nodeName
    # that carry pinned GPUs, as one launch of 4 lanes over 8 GPU slots
    snap_g = early["g"]
    cfg_g = sched.make_config(snap_g)
    if not (all(getattr(cfg_g, g) for g in DEVRES_GATES) and cfg_g.forced_prefix
            and (snap_g.arrays.forced_node[cfg_g.forced_prefix:] >= 0).any()):
        raise SystemExit("parity input devres is not the device-resource path it should be")
    n_g, r_g = snap_g.n_nodes, snap_g.n_real_nodes
    lanes_g = np.stack([np.arange(n_g) < r_g, np.ones(n_g, bool), np.arange(n_g) < r_g + 3,
                        np.concatenate([rng.rand(r_g) < 0.8, np.ones(n_g - r_g, bool)])])
    errs.append(parity(torch, sched, step, "devres-1024x10240-4-lanes", snap_g.arrays, cfg_g,
                       lanes_g, n_pods=EARLIER_DEPTH // 2)[2])

    # plain_step<1,1>: the device-resource cluster with the inter-pod
    # constraints (every gate of both slices)
    snap_x = early.pop("x")
    cfg_x = sched.make_config(snap_x)
    arrs_x = sched.device_arrays(snap_x.arrays, torch.device("cuda"))
    if not (step.instantiation(cfg_x, sched.init_state(arrs_x, cfg_x)) == "<1,1>"
            and all(getattr(cfg_x, g) for g in DEVRES_GATES) and cfg_x.needs_group_count
            and cfg_x.enable_pod_affinity and cfg_x.enable_anti_affinity):
        raise SystemExit("parity input devres-rich does not run plain_step<1,1>")
    del arrs_x
    _, t_x, err_x, out_x = parity(torch, sched, step, "devres-rich-1024x2048-<1,1>",
                                  snap_x.arrays, cfg_x, snap_x.arrays.active,
                                  n_pods=4 * EARLIER_DEPTH)
    errs.append(err_x)
    bound_x = bound_of(step_work(sched, snap_x.arrays, cfg_x, cfg_x.forced_prefix,
                                 cfg_x.forced_prefix + 4 * EARLIER_DEPTH, lane0(out_x)))
    log(f"parity devres-rich-1024x2048-<1,1>: bound bytes={bound_x[0]} ops={bound_x[1]} -> "
        f"{bound_x[2]:.5f} ms, {bound_x[3]} (kernel {t_x * 1e3:.3f} ms, host clock)")

    # the explain builds of the device-resource instantiations: the top-k
    # and the jitter on the device-resource clusters, without and with the
    # inter-pod constraints (the first EARLIER_DEPTH pods)
    for inst, snap_v in (("<0,1>+explain", device_resource_snapshot(1024, 2048)),
                         ("<1,1>+explain", snap_x)):
        cfg_v = sched.make_config(snap_v, explain_topk=EXPLAIN_K, tie_break_seed=TIE_SEED)
        arrs_v = sched.device_arrays(snap_v.arrays, torch.device("cuda"))
        if step.instantiation(cfg_v, sched.init_state(arrs_v, cfg_v)) != inst:
            raise SystemExit(f"explain parity input {inst} runs another instantiation")
        del arrs_v
        errs.append(parity(torch, sched, step, f"explain-devres-1024x2048-{inst}", snap_v.arrays,
                           cfg_v, snap_v.arrays.active, n_pods=EARLIER_DEPTH)[2])

    # the top-k's passes (kernels/step.TOPK_PASS candidates a cluster
    # round) in each scan build's explain twin: K = 1, the pass width, one
    # past it and past two passes, over the first EARLIER_DEPTH // 4 pods;
    # K = N on three nodes
    for inst, snap_k in (("<0,0>", snap_a), ("<1,0>", snap_r),
                         ("<0,1>", device_resource_snapshot(1024, 2048)), ("<1,1>", snap_x)):
        for k in (1, step.TOPK_PASS, step.TOPK_PASS + 1, 2 * step.TOPK_PASS + 1):
            errs.append(parity(torch, sched, step, f"topk-{k}-{inst}+explain", snap_k.arrays,
                               sched.make_config(snap_k, explain_topk=k), snap_k.arrays.active,
                               n_pods=EARLIER_DEPTH // 4)[2])
    snap_t = synthetic_snapshot(3, 64, rich=True)
    errs.append(parity(torch, sched, step, "topk-N-tiny-3-nodes-<1,0>+explain", snap_t.arrays,
                       sched.make_config(snap_t, explain_topk=snap_t.n_nodes),
                       snap_t.arrays.active)[2])

    # the preemption columns in each instantiation: random victims and
    # nominations (feasible and inactive nodes, forced pods, victims, -1,
    # negative and past-the-end values) from a seed, no prefix fold
    column_inputs = (("<0,0>", synthetic_snapshot(512, 1024, bound=0.1)),
                     ("<1,0>", synthetic_snapshot(512, 1024, rich=True, bound=0.1)),
                     ("<0,1>", device_resource_snapshot(512, 1024)),
                     ("<1,1>", device_resource_snapshot(512, 1024, rich=True)))
    for seed, (inst, snap_c) in enumerate(column_inputs):
        cfg_c = sched.make_config(snap_c, forced_prefix=0)
        arrs_c = sched.device_arrays(snap_c.arrays, torch.device("cuda"))
        if (step.instantiation(cfg_c, sched.init_state(arrs_c, cfg_c), columns=True)
                != inst + "+columns"):
            raise SystemExit(f"column parity input {inst} runs another instantiation")
        del arrs_c
        active_c = np.arange(snap_c.n_nodes) % 9 != 4
        cols = preemption_columns(snap_c.arrays.forced_node, active_c, seed=seed)
        out_c = parity(torch, sched, step, f"columns-{inst}-512x1024", snap_c.arrays, cfg_c,
                       active_c, n_pods=4 * EARLIER_DEPTH, columns=cols)
        errs.append(out_c[2])
        node_c = out_c[3][0][0].cpu().numpy()
        dis_c, nom_c = cols[0][:len(node_c)], cols[1][:len(node_c)]
        held = (node_c == nom_c) & (nom_c >= 0) & (snap_c.arrays.forced_node[:len(node_c)] == -1)
        if not ((node_c[dis_c] == -3).all() and (node_c[~dis_c] != -3).all() and held.any()):
            raise SystemExit(f"column parity input {inst}: victims or nominations not applied")
        # the same columns through the column build's explain twin
        cfg_cx = cfg_c._replace(explain_topk=EXPLAIN_K, tie_break_seed=seed + 1)
        errs.append(parity(torch, sched, step, f"columns-{inst}+explain-512x1024", snap_c.arrays,
                           cfg_cx, active_c, n_pods=4 * EARLIER_DEPTH, columns=cols)[2])

    # the edges of the launch geometry: fewer nodes than blocks in a
    # cluster (empty slices), slices that leave a ragged last block, and an
    # odd number of lanes (an odd number of clusters)
    for label, snap_e, lanes_of, n_e in (
            ("tiny-3-nodes-rich", synthetic_snapshot(3, 64, rich=True), 1, None),
            ("tiny-3-nodes-dom_count", synthetic_snapshot(3, 64), 1, None),
            ("ragged-devres-1000x2048", device_resource_snapshot(1000, 2048), 1, EARLIER_DEPTH),
            ("odd-lanes-3-rich-509x1024", synthetic_snapshot(509, 1024, rich=True), 3,
             EARLIER_DEPTH)):
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

    # the staged regions (kernels/step.plan_launch): the rich cluster at 509
    # nodes (no class row starts 16-byte aligned) and the device-resource
    # one on 3 lanes, the plan held to each staging it can take (every
    # region, the node rows alone, none)
    real_placements = step.PLACEMENTS
    for label, snap_s, names in (
            ("rich-509x1024", synthetic_snapshot(509, 1024, rich=True), ("all", "node", "none")),
            # (the device-resource builds stage no class rows)
            ("devres-509x1024", device_resource_snapshot(509, 1024), ("node", "none"))):
        cfg_s = sched.make_config(snap_s)
        n_s = snap_s.n_nodes
        masks_s = np.stack([np.ones(n_s, bool), np.arange(n_s) % 3 != 1, rng.rand(n_s) < 0.75])
        for name in names:
            stage = step.PLACEMENT_NAMES[name]
            step.PLACEMENTS = step.placements_held_to(stage)
            try:
                errs.append(parity(torch, sched, step, f"staged-{name}-{label}", snap_s.arrays,
                                   cfg_s, masks_s, n_pods=EARLIER_DEPTH)[2])
            finally:
                step.PLACEMENTS = real_placements
            if step.LAST_PLAN.stage != stage:
                raise SystemExit(f"staged input {name}-{label}: the plan staged "
                                 f"{step.placement_name(step.LAST_PLAN)}")

    # the wave form of the three instantiations beside the pools path's
    # <0,0>: pools clusters with the inter-pod terms, with GPU share, and
    # with both, 64 lanes, the first waves against the plain versions at the
    # plan's group; then every frozen build (the four gate combinations and
    # their explain twins) at one pod a cluster and at a group of 3 (the
    # last of a 32-pod wave's groups holds 2), and at the plan's group with
    # a weight row a lane: one wave each
    wave_par, group_par = {}, []
    for inst, kw in (("<0,0>", {}), ("<1,0>", dict(interpod=True)), ("<0,1>", dict(gpu=True)),
                     ("<1,1>", dict(gpu=True, interpod=True))):
        snap_w = wave_pools_snapshot(512, 4096, 32, **kw)
        n_w = snap_w.n_nodes
        masks_w = np.stack([np.ones(n_w, bool)] + [rng.rand(n_w) < 0.9
                                                    for _ in range(CAPACITY_LANES - 1)])
        for over, name in (({}, inst + "+frozen"),
                           ({"explain_topk": EXPLAIN_K, "tie_break_seed": TIE_SEED},
                            inst + "+frozen+explain")):
            runs = [(None, False, WAVE_PARITY_WAVES)] if inst != "<0,0>" else []
            for group, traced, n_waves in runs + [(1, False, 1), (3, False, 1), (None, True, 1)]:
                cfg_g = sched.make_config(snap_w, traced_weights=traced, **over)
                w_g = None
                if traced:
                    w_g = torch.from_numpy(
                        (np.tile(sched.weight_vector(cfg_g), (CAPACITY_LANES, 1))
                         * rng.uniform(0.5, 1.5, (CAPACITY_LANES, 1))).astype(np.float32)
                    ).to("cuda")
                tag = "" if group is None and not traced else (
                    f"-G{group or 'plan'}" + ("-weights" if traced else ""))
                got = wave_parity(torch, sched, step, wave, waves_mod,
                                  f"pools-512x4096-{name}{tag}", snap_w, cfg_g, masks_w,
                                  n_waves, group=group, weights=w_g)
                if got["instantiation"] != name:
                    raise SystemExit(f"wave parity {name}: ran {got['instantiation']}")
                if tag:
                    group_par.append(got)
                else:
                    wave_par[got["instantiation"]] = got

    # the device-resource walks past their per-thread widths (the wide
    # library): the device-resource cluster widened to 9 volume groups, 33
    # exclusive devices and 9 WaitForFirstConsumer claims a pod
    wide_par = {}
    for inst, rich in (("<0,1>", False), ("<1,1>", True)):
        snap_v = device_resource_snapshot(1024, 2048, rich=rich)
        snap_v = dataclasses.replace(snap_v, arrays=widen_device_resources(snap_v.arrays))
        cfg_v = sched.make_config(snap_v)
        t_p, t_k, err_v, out_v = parity(torch, sched, step, f"walks-{inst}-1024x2048-wide",
                                        snap_v.arrays, cfg_v, snap_v.arrays.active,
                                        n_pods=EARLIER_DEPTH // 2)
        if not step.LAST_PLAN.wide:
            raise SystemExit(f"walk input {inst}: the launch did not run the wide library")
        errs.append(err_v)
        k_v = cfg_v.forced_prefix
        bound_v = bound_of(step_work(sched, snap_v.arrays, cfg_v, k_v,
                                     k_v + out_v[0].shape[1], lane0(out_v)))
        wide_par[inst + "+wide"] = {"pods": out_v[0].shape[1], "ms": t_k * 1e3,
                                    "plain_ms": t_p * 1e3, "bound_ms": bound_v[2],
                                    "bound_by": bound_v[3], "max_abs_err": err_v}
    # one zone past today's shared-memory bound of a 5,120-node lane
    bound_p = smem_bound_inputs(torch, sched, step, many_domain_snapshot)
    errs += [v["past"]["parity"] for v in bound_p.values()]
    # each of the eight fleet builds: 3 clusters of one shape as one fleet
    # launch, against their lone launches and the plain fleet
    fleet_par = fleet_build_parity(torch, sched, step, [
        ("<0,0>", synthetic_snapshot(FLEET_PARITY["nodes"], FLEET_PARITY["pods"], bound=0.2)),
        ("<1,0>", synthetic_snapshot(FLEET_PARITY["nodes"], FLEET_PARITY["pods"], rich=True,
                                     bound=0.2)),
        ("<0,1>", device_resource_snapshot(FLEET_PARITY["nodes"], FLEET_PARITY["pods"])),
        ("<1,1>", device_resource_snapshot(FLEET_PARITY["nodes"], FLEET_PARITY["pods"],
                                           rich=True))],
        {"explain_topk": EXPLAIN_K, "tie_break_seed": TIE_SEED})
    errs += [v["max_abs_err"] for v in fleet_par.values()]
    # each build the extension rows reach (the 16 scan builds and the wide
    # library's), with seeded rows, against the plain step
    ext_ops = synthetic_extensions()
    wide_x = [(inst, dataclasses.replace(s_, arrays=widen_device_resources(s_.arrays)))
              for inst, s_ in (("<0,1>", device_resource_snapshot(1024, 2048)), ("<1,1>", snap_x))]
    ext_par = ext_build_parity(torch, sched, step, [
        ("<0,0>", synthetic_snapshot(1024, 2048, bound=0.1)),
        ("<1,0>", synthetic_snapshot(1024, 2048, rich=True)),
        ("<0,1>", device_resource_snapshot(1024, 2048)), ("<1,1>", snap_x)], ext_ops, wide_x)
    del wide_x
    errs += [v["max_abs_err"] for v in ext_par.values()]

    # ---- 4. the main paths: simulate() at full size, through the kernel
    paths = {}
    for label, kind in PATHS:
        paths[label] = main_path(torch, sched, step, simulate,
                                 lambda k: main_clusters.pop(k), label, kind)

    # ---- 4a. explain and the seeded tie-break at full size: the explain
    # build inside simulate()
    explain_p = explain_path(torch, sched, step, simulate, cluster_of, explain_mod,
                             "northstar-rich-explain")
    tie_p = tiebreak_path(torch, sched, step, simulate, cluster_of, threefry,
                          "northstar-tiebreak")
    # out-of-tree extension ops: one launch a pod, the callables between
    ext_p = ext_path(torch, sched, step, simulate, cluster_of, ext_ops, "northstar-ext")

    # ---- 4b. preemption: simulate() under the DefaultPreemption pass at
    # full size, then a Simulator session on the same objects
    pre_p = preempt_path(torch, sched, step, core, preemption, "northstar-preempt")
    placements = pre_p.pop("placements")
    pre_p["session"] = session_path(torch, step, Simulator, "northstar-preempt", placements)
    paths["northstar-preempt"] = pre_p

    # ---- 4c. waves: the pools preset through simulate(), lanes, the
    # sweep and the bisection
    pools_p = pools_path(torch, sched, step, wave, waves_mod, buckets, simulate, sweep,
                         ClusterResources, "pools")
    par = pools_p.pop("parity_64")
    wave_par[par["instantiation"]] = par
    pools_x = pools_explain_path(torch, sched, step, wave, waves_mod, buckets, simulate,
                                 ClusterResources, "pools-explain")
    wave_par[pools_x["parity"]["instantiation"]] = pools_x["parity"]

    # ---- 4d. replay: a day of events through run_replay (the hoisted full
    # scans, the fast path, the forced fold), then stopped and resumed
    replay_p = replay_path(torch, sched, step, wave, replay_mod, rengine, "replay-day")
    resume_p = replay_resume_path(torch, replay_mod, rengine, replay_p["digest"],
                                  "replay-resume")

    # ---- 4e. tuning and the cost frontier: tune_search's weight-row lanes
    # on the rich cluster, capacity_frontier's mix lanes on the north-star
    rich_nodes, rich_pods, _ = synthetic_objects(NODES, PODS, rich=True)
    tune_p = tune_path(torch, sched, step, tune_mod,
                       ClusterResources(nodes=rich_nodes, pods=rich_pods), "tune-rich-64")
    del rich_nodes, rich_pods
    ns_nodes, ns_pods, ns_template = synthetic_objects(NODES, PODS)
    frontier_p = frontier_path(torch, sched, step, replay_mod,
                               ClusterResources(nodes=ns_nodes, pods=ns_pods), ns_template,
                               "frontier-northstar")
    del ns_nodes, ns_pods

    # ---- 4f. fleet campaigns: fleet-16 with the fleet lanes on and off
    fleet_p = fleet_path(torch, sched, step, campaign_mod, "fleet-16")

    # ---- 5. the capacity plan: 64-lane sweeps and their bisection, then
    # the example plans through the CLI on the card and on the CPU
    ext_sweep = None
    for label, kind in PATHS:
        keep = {} if kind == "plain" else None
        paths[f"capacity-{label}-64"] = capacity_path(torch, sched, step, sweep,
                                                      capacity_snaps.pop(kind), label, kind,
                                                      keep)
        if keep:
            # the extension ops through the 64-lane sweep, on its snapshot
            ext_sweep = ext_sweep_path(torch, sched, step, sweep, keep.pop("snapshot"), ext_ops,
                                       "capacity-northstar-ext-64")
    t0 = time.perf_counter()
    cli_plans(torch, loader, cli_main)
    log(f"cli: {len(CLI_CONFIGS)} plans on the card and on the CPU agree "
        f"({time.perf_counter() - t0:.1f}s)")
    cli_x = cli_explain(torch, cli_main)
    cli_r = cli_replay(torch, cli_main)
    cli_t = cli_tune(torch, cli_main)

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
        "parity": "bit-exact vs the plain step over the first pods (EARLIER_DEPTH = "
                  f"{EARLIER_DEPTH}, or a multiple) of synthetic 1024x10240, inline "
                  "512x4096, the same in 4 lanes, rich 1024x10240 bound 0.1, rich "
                  "512x4096 dense, rich 512x1024 4 lanes, devres 1024x10240 in 4 lanes "
                  "(8 GPU slots), the first 4 x EARLIER_DEPTH pods of devres-rich 1024x2048 "
                  "(<1,1>), "
                  "the preemption columns (random victims and nominations from a seed) on "
                  "512x1024 inputs of each instantiation (<0,0>, <1,0>, <0,1>, <1,1>, each "
                  "+columns), "
                  "the geometry edges (3 nodes rich "
                  f"and dom_count, the first {EARLIER_DEPTH} pods of devres 1000x2048 and of "
                  "rich 509x1024 in 3 lanes), "
                  f"the first and last {PARITY_PREFIX} pods of the northstar, "
                  "northstar-rich and northstar-devres main paths and of the final rescan "
                  "of northstar-preempt (its columns), and the first "
                  f"{PARITY_PREFIX} pods of lanes 0 and 63 of the capacity-northstar-64, "
                  "capacity-northstar-rich-64 and capacity-northstar-devres-64 sweeps",
    }]
    same_w = pools_p["same_pods"]
    frozen_insts = {k: {**v, "launched": k in LAUNCHED} for k, v in insts.items()
                    if k.endswith("+frozen")}
    kernels[0]["instantiations"] = {k: v for k, v in kernels[0]["instantiations"].items()
                                    if not any(x in k for x in ("+explain", "+fleet", "+wide"))}
    for k, v in wave_par.items():
        if "+explain" not in k:
            frozen_insts.setdefault(k, {})["parity"] = v
    kernels += [{
        "name": "plain_step_frozen", "route": "cuda",
        "source": "open_simulator_tpu_torch/csrc/plain_step.cu",
        "replaces": "open_simulator_tpu/engine/scheduler.py:581",
        "launches": pools_p["launches"]["plain_step_frozen"],
        "instantiations": frozen_insts,
        "max_abs_err": max([pools_p["max_abs_err"]] + [v["max_abs_err"] for v in wave_par.values()]
                           + [v["max_abs_err"] for v in group_par]),
        "pods": same_w["pods"], "ms": same_w["frozen_ms"], "plain_ms": same_w["frozen_plain_ms"],
        "bound_ms": same_w["frozen_bound_ms"], "bound_by": same_w["frozen_bound_by"],
        "library_ms": None, "paths": {"pools": pools_p},
        "group_parity": [{k: v[k] for k in ("instantiation", "group", "weights", "lanes",
                                            "pods", "max_abs_err")} for v in group_par],
        "parity": f"bit-exact vs the plain step's frozen form over the first {WAVE_SAME} waves "
                  "of the one-lane pools run and the first "
                  f"{WAVE_PARITY_WAVES} waves of lanes 0 and 63 of the pools sweep (<0,0>) and "
                  "of 64-lane pools 512x4096 with inter-pod terms (<1,0>), GPU share (<0,1>) "
                  "and both (<1,1>), at the plan's group; one wave of every frozen build at "
                  "groups of 1 and 3 and, with a weight row a lane, at the plan's; the pools "
                  "wave runs (graph and eager loops) equal the scan in every output and carry "
                  "field",
    }, {
        "name": "wave_merge", "route": "cuda",
        "source": "open_simulator_tpu_torch/csrc/wave_merge.cu",
        "replaces": "open_simulator_tpu/engine/scheduler.py:473",
        "launches": pools_p["launches"]["wave_merge"],
        "max_abs_err": max([pools_p["max_abs_err"]] + [v["max_abs_err"] for v in wave_par.values()]),
        "pods": same_w["pods"], "ms": same_w["merge_ms"], "plain_ms": same_w["merge_plain_ms"],
        "bound_ms": same_w["merge_bound_ms"], "bound_by": same_w["merge_bound_by"],
        "library_ms": same_w["merge_library_ms"],
        "parity": "bit-exact on every carry field vs the plain merge (fp32 torch.matmul) after "
                  "each wave of the frozen parity inputs",
    }]
    # the forced fold (ms, plain_ms, library_ms and bound_ms: one replay-day
    # step's whole-mask fold, ms and library_ms with the stream primed, the
    # device alone; host_ms with the host launching; the capacity paths'
    # 4,096-pod folds under "prefix_folds")
    fold_m = replay_p["mask_fold"]
    kernels += [{
        "name": "forced_fold", "route": "cuda",
        "source": "open_simulator_tpu_torch/csrc/forced_fold.cu",
        "replaces": "open_simulator_tpu/engine/scheduler.py:347",
        "prefix_replaces": "open_simulator_tpu/engine/scheduler.py:323",
        "launches": replay_p["launches"]["forced_fold"],
        "max_abs_err": replay_p["fold_max_abs_err"],
        "pods": fold_m["pods"], "pinned": fold_m["pinned"], "ms": fold_m["device_ms"],
        "host_ms": fold_m["ms"], "plain_ms": fold_m["plain_ms"], "bound_ms": fold_m["bound_ms"],
        "bound_by": fold_m["bound_by"], "library_ms": fold_m["library_device_ms"],
        "prefix_folds": {k: v["prefix_fold"] for k, v in paths.items() if "prefix_fold" in v},
        "paths": {"replay-day": replay_p, "replay-resume": resume_p, "cli_replay": cli_r},
        "parity": "bit-exact on every carry field vs its plain version (the plain merge, fp32 "
                  "torch.matmul) on every fold of the replay-day run, on the whole-mask "
                  "fold timed, and on the 4,096-pod prefix folds of the three capacity paths "
                  "(equal to the kernel's carry after those pods); the hoisted scan's first "
                  f"{PARITY_PREFIX} pods equal the plain step",
    }]
    # the explain builds: the step with the top-k candidates and the
    # seeded jitter inside its pod loop (ms, plain_ms and bound_ms: the
    # first PARITY_PREFIX pods of northstar-rich-explain; "topk" and
    # "jitter": each mode's own cost, bound and plain version)
    same_x = explain_p["same_pods"]
    explain_insts = {k: {**v, "launched": k in LAUNCHED} for k, v in insts.items()
                     if k.endswith("+explain") and "+frozen" not in k and "+fleet" not in k}
    frozen_x = {k: {**v, "launched": k in LAUNCHED} for k, v in insts.items()
                if k.endswith("+frozen+explain")}
    for k, v in wave_par.items():
        if k in frozen_x:
            frozen_x[k]["parity"] = v
    same_fx = pools_x["same_pods"]
    kernels += [{
        "name": "plain_step_explain", "route": "cuda",
        "source": "open_simulator_tpu_torch/csrc/plain_step.cu",
        "replaces": "open_simulator_tpu/engine/scheduler.py:1248",
        "jitter_replaces": "open_simulator_tpu/engine/scheduler.py:1238",
        "launches": explain_p["launches"] + tie_p["launches"],
        "instantiations": explain_insts,
        "max_abs_err": max(explain_p["max_abs_err"], tie_p["max_abs_err"]),
        "pods": same_x["pods"], "ms": same_x["ms"], "plain_ms": same_x["plain_ms"],
        "bound_ms": same_x["bound_ms"], "bound_by": same_x["bound_by"], "library_ms": None,
        "topk": explain_p["topk"], "jitter": tie_p["jitter"],
        "paths": {"northstar-rich-explain": explain_p, "northstar-tiebreak": tie_p},
        "cli_explain": cli_x,
        "parity": "bit-exact (node, counts, picks, carry and the three top-k tensors) vs the "
                  f"plain step over the first {PARITY_PREFIX} pods of northstar-rich-explain "
                  f"(<1,0>+explain) and northstar-tiebreak (<0,0>+explain), the first "
                  f"{EARLIER_DEPTH} pods of devres 1024x2048 (<0,1>+explain) and devres-rich "
                  "1024x2048 "
                  "(<1,1>+explain) with both modes, the column inputs with both modes "
                  "(+columns+explain) and the first pods of northstar-preempt's final rescan "
                  "with the top-k (<0,0>+columns+explain)",
    }, {
        "name": "plain_step_frozen_explain", "route": "cuda",
        "source": "open_simulator_tpu_torch/csrc/plain_step.cu",
        "replaces": "open_simulator_tpu/engine/scheduler.py:581",
        "launches": pools_x["launches"]["plain_step_frozen_explain"],
        "instantiations": frozen_x,
        "max_abs_err": max(v["max_abs_err"] for k, v in wave_par.items() if k in frozen_x),
        "pods": same_fx["pods"], "ms": same_fx["ms"], "plain_ms": same_fx["plain_ms"],
        "bound_ms": same_fx["bound_ms"], "bound_by": same_fx["bound_by"], "library_ms": None,
        "paths": {"pools-explain": pools_x},
        "parity": f"bit-exact vs the plain step's frozen form over the first {WAVE_SAME} waves "
                  "of pools-explain (<0,0>+frozen+explain) and the first "
                  f"{WAVE_PARITY_WAVES} waves of lanes 0 and 63 of 64-lane pools 512x4096 with "
                  "inter-pod terms, GPU share and both, the top-k and the jitter on; the "
                  "pools-explain wave run's top-k tensors equal the scan's",
    }]
    # the per-lane weight row (the traced weights): plain_step's launches
    # that carry w_lane (ms, plain_ms and bound_ms: the first EARLIER_DEPTH
    # pods of two tune-rich-64 lanes with different rows; the 64-lane
    # weighted launch against the constant one under "lanes_64")
    same_t = tune_p["same_pods"]
    kernels += [{
        "name": "plain_step_weights", "route": "cuda",
        "source": "open_simulator_tpu_torch/csrc/plain_step.cu",
        "replaces": "open_simulator_tpu/engine/exec_cache.py:521",
        "step_replaces": "open_simulator_tpu/engine/scheduler.py:1097",
        "launches": tune_p["launches"],
        "max_abs_err": max(tune_p["max_abs_err"], frontier_p["max_abs_err"]),
        "lanes": same_t["lanes"], "pods": same_t["pods"], "ms": same_t["ms"],
        "plain_ms": same_t["plain_ms"], "bound_ms": same_t["bound_ms"],
        "bound_by": same_t["bound_by"], "library_ms": None,
        "lanes_64": {"lanes": tune_p["lanes"], "pods": tune_p["pods"],
                     "weighted_ms": tune_p["weighted_ms"], "constant_ms": tune_p["constant_ms"],
                     "runs": tune_p["ms_runs"], "bound_ms": tune_p["bound_ms"],
                     "bound_by": tune_p["bound_by"], "geometry": tune_p["geometry"]},
        "paths": {"tune-rich-64": tune_p["runs"], "frontier-northstar": frontier_p,
                  "pools-traced-64": pools_p["sweep_64_traced"], "cli": cli_t},
        "parity": f"bit-exact vs the plain step over the first {EARLIER_DEPTH} pods of two "
                  "tune-rich-64 lanes with different weight rows; the baseline lane equals a "
                  "constant-config 64-lane launch; the traced pools sweep's plan equals the "
                  "constant sweep's; frontier-northstar's round 2, lanes 0 and 63 (constant "
                  "weights) equal the plain step",
    }]
    # the fleet form (ms, plain_ms and bound_ms: the first EARLIER_DEPTH
    # pods of two fleet-16 clusters at 1,024 x 10,240; the 8-lane launch of
    # the campaign under "launch_8"; each build's own parity input under
    # "instantiations")
    fleet_on, par_big = fleet_p["fleet_lanes"], fleet_p["parity"]["1024x10240"]
    kernels[0]["instantiations"].update(
        {k: {**insts[k], "launched": False, "parity": v} for k, v in wide_par.items()})
    kernels[0]["shared_memory_bound"] = bound_p
    kernels += [{
        "name": "plain_step_fleet", "route": "cuda",
        "source": "open_simulator_tpu_torch/csrc/plain_step.cu",
        "replaces": "open_simulator_tpu/engine/exec_cache.py:837",
        "launches": fleet_on["counts"]["plain_step_fleet"],
        "instantiations": {k: {**insts[k], "launched": k == "<0,0>+fleet",
                               "parity": fleet_par.get(k)} for k in FLEET_BUILDS},
        "max_abs_err": max([v["max_abs_err"] for v in fleet_par.values()]
                           + [v["max_abs_err"] for v in fleet_p["parity"].values()]),
        "lanes": par_big["compared_lanes"], "pods": par_big["compared_pods"],
        "ms": par_big["ms"], "plain_ms": par_big["plain_ms"], "bound_ms": par_big["bound_ms"],
        "bound_by": par_big["bound_by"], "library_ms": None,
        "launch_8": fleet_p["launch_8"],
        "paths": {"fleet-16": {"fleet_lanes": fleet_on, "serial": fleet_p["serial"],
                               "write_s": fleet_p["write_s"], "parity": fleet_p["parity"]}},
        "parity": "bit-exact (outputs and every carry field) vs one plain_step launch per "
                  "cluster over every pod of each fleet-16 bucket's clusters (8 at 1,024 x "
                  "10,240, 7 at 512 x 6,144) and of three variants of each build's input "
                  "(512 x 1,024: synthetic, rich, devres, devres-rich, each with and without "
                  "explain); vs plain_step_fleet_torch over the first pods of two lanes of "
                  f"each ({FLEET_PLAIN_DEPTH} of fleet-16, {FLEET_PARITY['plain_pods']} of the "
                  "build inputs); the fleet-16 campaign's digest equals the serial one's",
    }]
    # the extension rows (ms, plain_ms and bound_ms: the first
    # PARITY_PREFIX pods of northstar-ext, one launch a pod, the launches
    # timed with the stream primed; the plain step through the same loop)
    same_e = ext_p["same_pods"]
    kernels += [{
        "name": "plain_step_ext", "route": "cuda",
        "source": "open_simulator_tpu_torch/csrc/plain_step.cu",
        "replaces": "open_simulator_tpu/engine/scheduler.py:1051",
        "score_rows_replace": "open_simulator_tpu/engine/scheduler.py:1171",
        "add_order_replaces": "open_simulator_tpu/engine/scheduler.py:1214",
        "launches": ext_p["launches"],
        "instantiations": {(k if k.endswith("+wide") else k + "+ext"):
                           {**insts.get(k if k.endswith("+wide") else k + "+ext", {}),
                            "parity": v} for k, v in ext_par.items()},
        "max_abs_err": max([ext_p["max_abs_err"], ext_sweep["parity"]["max_abs_err"]]
                           + [v["max_abs_err"] for v in ext_par.values()]),
        "pods": same_e["pods"], "ms": same_e["ms"], "plain_ms": same_e["plain_ms"],
        "bound_ms": same_e["bound_ms"], "bound_by": same_e["bound_by"], "library_ms": None,
        "paths": {"northstar-ext": ext_p, "capacity-northstar-ext-64": ext_sweep},
        "parity": f"bit-exact (a NaN where the other side has one) vs the plain step over the "
                  f"first {EXT_DEPTH} pods of each build the rows reach (<I,D>, +columns, "
                  "+explain; the wide library's <0,1> and <1,1>) with seeded rows; over the "
                  f"first {PARITY_PREFIX} pods of northstar-ext and the first "
                  f"{EXT_SWEEP_PARITY} pods of lanes 0 and 63 of capacity-northstar-ext-64 "
                  "through the same per-pod loop",
    }]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": dev_name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
