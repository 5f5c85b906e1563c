"""simulate(): the one-call library API, on the torch engine.

The host path is the reference's (``open_simulator_tpu/core.py``): make
nodes valid, admit, expand workloads into the pod sequence, encode,
make_config; then ``engine.scheduler.schedule_pods`` runs on the card —
under the DefaultPreemption pass (``engine/preemption.py``) when pod
priorities differ — and ``decode_result`` turns the assignments and
reason counts into the reference's report.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from open_simulator_tpu_torch.encode.snapshot import ClusterSnapshot, EncodeOptions, encode_cluster
from open_simulator_tpu_torch.engine.buckets import bucket_pods
from open_simulator_tpu_torch.engine.queue import sort_pods_greedy
from open_simulator_tpu_torch.engine.scheduler import (
    ScheduleOutput,
    make_config,
    schedule_pods,
    score_part_names,
)
from open_simulator_tpu_torch.engine.waves import waves_for
from open_simulator_tpu_torch.k8s.loader import ClusterResources, make_valid_node
from open_simulator_tpu_torch.k8s.objects import ANNO_GPU_INDEX, Node, Pod
from open_simulator_tpu_torch.models.expand import expand_app_resources, expand_cluster_pods


@dataclass
class AppResource:
    """One app to deploy, in order (reference: core.go:62-65)."""

    name: str
    resources: ClusterResources


@dataclass
class UnscheduledPod:
    pod: Pod
    reason: str


@dataclass
class ScheduledPod:
    pod: Pod
    node_name: str


@dataclass
class NodeStatus:
    node: Node
    pods: List[Pod] = field(default_factory=list)


@dataclass
class SimulateResult:
    """reference: core.go:20-44."""

    unscheduled_pods: List[UnscheduledPod]
    scheduled_pods: List[ScheduledPod]
    node_status: List[NodeStatus]
    elapsed_s: float = 0.0
    snapshot: Optional[ClusterSnapshot] = None
    # WaitForFirstConsumer claim -> PV name chosen at bind (the PreBind
    # PVC.spec.volumeName write the reference's binder would do)
    volume_bindings: Dict[str, str] = field(default_factory=dict)
    # pod key -> GPU device ids (with multiplicity) the engine allocated —
    # the integer truth behind the gpu-index annotation (decode-side view of
    # the Reserve allocation, open-gpu-share.go:147-188)
    gpu_assignments: Dict[str, List[int]] = field(default_factory=dict)
    # telemetry/explain decode surface: the raw per-pod per-op failure
    # counts behind the reason strings, the op vocabulary they index, and
    # (when the engine ran with explain_topk) the top-k candidate tensors
    # with their score-plugin row names
    fail_counts: Optional[np.ndarray] = field(default=None, repr=False)
    op_names: List[str] = field(default_factory=list)
    n_active_nodes: int = 0
    topk_node: Optional[np.ndarray] = field(default=None, repr=False)
    topk_score: Optional[np.ndarray] = field(default=None, repr=False)
    topk_parts: Optional[np.ndarray] = field(default=None, repr=False)
    score_part_names: List[str] = field(default_factory=list)
    # keys of pods deleted as preemption victims (structured marker —
    # explain must not infer this from the reason string's wording)
    preempted_pod_keys: List[str] = field(default_factory=list)
    # wave-scheduling decode (engine/waves.py): per-pod wave id in
    # sequence order and whether the pod was placed through a batched
    # wave or the fallback scan; None when the run had no wave plan
    # (waves off, preemption columns, or nothing provably independent)
    wave_id: Optional[np.ndarray] = field(default=None, repr=False)
    wave_batched: Optional[np.ndarray] = field(default=None, repr=False)

    def placements(self) -> Dict[str, str]:
        return {sp.pod.key: sp.node_name for sp in self.scheduled_pods}


def format_failure_reason(counts: np.ndarray, op_names: List[str], n_active: int) -> str:
    """Reproduce the scheduler's diagnostic line
    ('0/4 nodes are available: 3 Insufficient cpu, 1 node(s) had taint ...')."""
    parts = [
        f"{int(c)} {op_names[i]}"
        for i, c in enumerate(counts)
        if int(c) > 0 and i < len(op_names)
    ]
    return f"0/{n_active} nodes are available: " + ", ".join(parts) + "."


def decode_result(
    snapshot: ClusterSnapshot,
    node_assign: np.ndarray,
    fail_counts: np.ndarray,
    active: np.ndarray,
    elapsed_s: float = 0.0,
    gpu_pick: Optional[np.ndarray] = None,
    preempted_by: Optional[Dict[int, int]] = None,
    vol_pick: Optional[np.ndarray] = None,
    extra_op_names: Optional[List[str]] = None,
    topk_node: Optional[np.ndarray] = None,
    topk_score: Optional[np.ndarray] = None,
    topk_parts: Optional[np.ndarray] = None,
    score_part_names: Optional[List[str]] = None,
) -> SimulateResult:
    op_names = snapshot.op_names + list(extra_op_names or [])
    n_active = int(np.sum(active))
    scheduled: List[ScheduledPod] = []
    unscheduled: List[UnscheduledPod] = []
    pods_by_node: Dict[int, List[Pod]] = {}
    volume_bindings: Dict[str, str] = {}
    gpu_assignments: Dict[str, List[int]] = {}
    preempted_keys: List[str] = []
    forced = snapshot.arrays.forced_node
    for i, pod in enumerate(snapshot.pods):
        ni = int(node_assign[i])
        if ni >= 0:
            if vol_pick is not None and i < len(snapshot.wfc_claim_keys):
                # claim -> PV binding the engine's Reserve chose (PreBind
                # would write PVC.spec.volumeName)
                for j, claim_key in enumerate(snapshot.wfc_claim_keys[i]):
                    if j < vol_pick.shape[1] and int(vol_pick[i, j]) >= 0:
                        volume_bindings[claim_key] = (
                            snapshot.pv_names[int(vol_pick[i, j])])
            if gpu_pick is not None and pod.gpu_request()[0] > 0:
                devs_int: List[int] = []
                for d in np.nonzero(gpu_pick[i])[0]:
                    devs_int += [int(d)] * int(gpu_pick[i][d])
                if devs_int:
                    gpu_assignments[pod.key] = devs_int
                if bool(snapshot.arrays.gpu_has_forced[i]):
                    # user-pinned gpu-index is honored verbatim (the check
                    # is encode-time truth, NOT the annotation dict — decode
                    # itself writes that annotation, and repeated decodes of
                    # the same snapshot must not treat it as a pin)
                    pass
                else:
                    # gpu-index assignment annotation, as the reference's
                    # Reserve writes back (open-gpu-share.go:147-188);
                    # counts > 1 repeat the device id ("0-0-1"), matching
                    # the two-pointer's candDevIdList order
                    if devs_int:
                        pod.meta.annotations[ANNO_GPU_INDEX] = "-".join(
                            str(d) for d in devs_int)
            scheduled.append(ScheduledPod(pod=pod, node_name=snapshot.node_names[ni]))
            pods_by_node.setdefault(ni, []).append(pod)
        else:
            if ni == -3 and preempted_by and i in preempted_by:
                # victim of DefaultPreemption: deleted to admit the preemptor
                pre = snapshot.pods[preempted_by[i]]
                reason = f'preempted to admit higher-priority pod "{pre.key}"'
                preempted_keys.append(pod.key)
            elif i in snapshot.pre_reasons:
                # unschedulable before any node was considered (PreFilter
                # UnschedulableAndUnresolvable — missing / Lost / unbound
                # immediate PVCs, volume_binding.go PreFilter)
                reason = snapshot.pre_reasons[i]
            elif int(forced[i]) == -2:  # nodeName pointed at a node that doesn't exist
                reason = f'node "{pod.node_name}" not found'
            else:
                reason = format_failure_reason(fail_counts[i], op_names, n_active)
            unscheduled.append(UnscheduledPod(pod=pod, reason=reason))
    node_status = [
        NodeStatus(node=snapshot.nodes[ni], pods=pods_by_node.get(ni, []))
        for ni in range(snapshot.n_nodes)
        if active[ni]
    ]
    return SimulateResult(
        unscheduled_pods=unscheduled,
        scheduled_pods=scheduled,
        node_status=node_status,
        elapsed_s=elapsed_s,
        snapshot=snapshot,
        volume_bindings=volume_bindings,
        gpu_assignments=gpu_assignments,
        fail_counts=np.asarray(fail_counts),
        op_names=list(op_names),
        n_active_nodes=n_active,
        topk_node=topk_node,
        topk_score=topk_score,
        topk_parts=topk_parts,
        score_part_names=list(score_part_names or []),
        preempted_pod_keys=preempted_keys,
    )


def _resolve_priorities(pods: List[Pod], cluster: ClusterResources, apps: List[AppResource]) -> None:
    """Stamp pod.priority from PriorityClass objects (name -> value, plus a
    globalDefault class), mirroring the admission defaulting the reference
    gets for free from its typed fixtures."""
    classes: Dict[str, int] = {}
    default = 0
    for src in [cluster] + [a.resources for a in apps]:
        for pc in src.priority_classes:
            classes[pc.meta.name] = pc.value
            if pc.global_default:
                default = pc.value
    for p in pods:
        if p.priority:
            continue
        if p.priority_class_name:
            p.priority = classes.get(p.priority_class_name, default)
        else:
            p.priority = default


def with_volume_objects(
    encode_options: Optional[EncodeOptions],
    cluster: ClusterResources,
    apps: List[AppResource],
) -> EncodeOptions:
    """Fill EncodeOptions with the PVC/PV/StorageClass objects from the
    cluster and every app (the reference creates app SCs in the fake
    clientset per app, simulator.go:244-258) so the VolumeBinding /
    VolumeZone ops see the full volume world. Caller-supplied objects on
    the options are kept and extended, not replaced."""
    import dataclasses

    opts = encode_options or EncodeOptions()
    srcs = [cluster] + [a.resources for a in apps]
    return dataclasses.replace(
        opts,
        pvcs=list(opts.pvcs) + [p for s in srcs for p in s.pvcs],
        pvs=list(opts.pvs) + [p for s in srcs for p in s.pvs],
        storage_classes=(list(opts.storage_classes)
                         + [p for s in srcs for p in s.storage_classes]),
        csi_nodes=(list(opts.csi_nodes)
                   + [c for s in srcs for c in getattr(s, "csi_nodes", [])]),
    )


def _priority_sort(pods: List[Pod]) -> List[Pod]:
    """PrioritySort queue plugin (vendored queuesort/priority_sort.go):
    higher priority pops first; stable keeps submission order among equals."""
    return sorted(pods, key=lambda p: -p.priority)


def build_pod_sequence(
    cluster: ClusterResources,
    apps: List[AppResource],
    use_greed: bool = False,
) -> List[Pod]:
    """Cluster pods first (placed + pending), then each app in config order
    (reference: core.go:93-131); each scheduling batch is priority-ordered
    like the activeQ. --use-greed additionally sorts each app's pods by
    descending dominant share (the reference parses but never wires this
    flag; here it works)."""
    nodes = cluster.nodes
    pods = expand_cluster_pods(cluster)
    totals: Dict[str, int] = {}
    for n in nodes:
        for r, v in n.allocatable.items():
            totals[r] = totals.get(r, 0) + v
    all_batches = [pods]
    for app in apps:
        app_pods = expand_app_resources(app.resources, nodes, app.name)
        if use_greed:
            app_pods = sort_pods_greedy(app_pods, totals)
        all_batches.append(app_pods)
    out: List[Pod] = []
    for batch in all_batches:
        _resolve_priorities(batch, cluster, apps)
        out.extend(_priority_sort(batch))
    return out


def simulate(
    cluster: ClusterResources,
    apps: List[AppResource],
    use_greed: bool = False,
    encode_options: Optional[EncodeOptions] = None,
    config_overrides: Optional[Dict] = None,
    preemption: bool = True,
    validate: bool = True,
    device=None,
) -> SimulateResult:
    """Run one full simulation on `device` (None = the card; "cpu" runs
    the plain torch step).

    preemption=True enables the DefaultPreemption PostFilter pass (a no-op
    unless some pods differ in priority): the first pass runs without
    preemption columns, and each rescan passes the victims and
    nominations. New-node template slots (``encode_options.max_new_nodes``)
    are encoded inactive, as in the reference: they are the capacity
    plan's lanes (``parallel/sweep.py``), and a plain simulate() leaves
    them empty.

    validate=True runs the admission pass first, so malformed specs raise
    a structured SimulationError instead of a traceback from encode."""
    t0 = time.perf_counter()
    config_overrides = dict(config_overrides or {})
    preemption = preemption and not config_overrides.pop("_disable_preemption", False)
    nodes = [make_valid_node(n) for n in cluster.nodes]
    cluster = _with_nodes(cluster, nodes)
    if validate:
        from open_simulator_tpu_torch.resilience.admission import admit

        admit(cluster, apps)
    pods = build_pod_sequence(cluster, apps, use_greed=use_greed)
    encode_options = with_volume_objects(encode_options, cluster, apps)
    snapshot = encode_cluster(nodes, pods, encode_options)
    cfg = make_config(snapshot, **config_overrides)
    # the wave plan over the reference's bucketed pod axis (its plan and
    # per-pod decode); None: every pod runs the scan
    wave_plan = waves_for(snapshot.arrays, cfg, n_pods_total=bucket_pods(snapshot.n_pods))
    active_np = np.asarray(snapshot.arrays.active)
    schedule_fn = host_schedule_fn(snapshot, active_np, cfg, device, wave_plan)
    preempted_by: Optional[Dict[int, int]] = None
    if preemption:
        from open_simulator_tpu_torch.engine.preemption import run_with_preemption

        pdbs = list(cluster.pdbs) + [p for a in apps for p in a.resources.pdbs]
        out, pre = run_with_preemption(snapshot, active_np, schedule_fn, pdbs)
        preempted_by = pre.preempted_by
    else:
        out = schedule_fn(None, None)
    result = decode_output(snapshot, out, active_np, cfg, time.perf_counter() - t0,
                           preempted_by)
    if wave_plan is not None and not preempted_by:
        # the rescans after a preemption carry the columns, which drop the
        # plan, so only a run without preemptions reports waves
        decode_waves(result, wave_plan, snapshot.n_pods)
    return result


def decode_waves(result: SimulateResult, plan, n_pods: int) -> None:
    """The per-pod wave decode of the explain surface: each pod's wave id
    and whether a batched wave placed it (the reference's ``wave_id`` /
    ``wave_batched``)."""
    wid, wbat = plan.pod_waves()
    result.wave_id = wid[:n_pods]
    result.wave_batched = wbat[:n_pods]


def host_schedule_fn(snapshot: ClusterSnapshot, active: np.ndarray, cfg, device, waves=None):
    """``schedule_fn(disabled, nominated)`` as ``run_with_preemption``
    calls it: one-lane ``schedule_pods`` on `device` with the preemption
    columns, its per-pod outputs brought to the host (the carry stays on
    the device). `waves` goes to the call without columns only (the first
    pass), as in the reference."""
    def schedule_fn(disabled, nominated) -> ScheduleOutput:
        plan = waves if disabled is None and nominated is None else None
        out = schedule_pods(snapshot.arrays, active, cfg, device=device, disabled=disabled,
                            nominated=nominated, waves=plan)
        return out._replace(**{f: getattr(out, f).cpu() for f in out._fields if f != "state"})
    return schedule_fn


def decode_output(snapshot: ClusterSnapshot, out: ScheduleOutput, active: np.ndarray, cfg,
                  elapsed_s: float = 0.0,
                  preempted_by: Optional[Dict[int, int]] = None) -> SimulateResult:
    """``decode_result`` of a host ``schedule_fn`` output (the GPU and PV
    picks where their gates are on, the top-k tensors under explain, the
    filter extensions' reason rows named after them)."""
    return decode_result(snapshot, out.node.numpy(), out.fail_counts.numpy(), active, elapsed_s,
                         out.gpu_pick.numpy() if cfg.enable_gpu else None,
                         preempted_by=preempted_by,
                         vol_pick=out.vol_pick.numpy() if cfg.enable_pv_match else None,
                         extra_op_names=list(cfg.extension_op_names),
                         **explain_decode_kwargs(cfg, out))


def explain_decode_kwargs(cfg, out) -> Dict:
    """The explain surface's decode keywords (the top-k tensors and the
    score rows' names; the reference's ``explain_decode_kwargs``), shared
    by simulate() and the Simulator; {} when explain_topk is off."""
    if not cfg.explain_topk:
        return {}
    return dict(topk_node=np.asarray(out.topk_node), topk_score=np.asarray(out.topk_score),
                topk_parts=np.asarray(out.topk_parts),
                score_part_names=list(score_part_names(cfg)))


def _with_nodes(cluster: ClusterResources, nodes: List[Node]) -> ClusterResources:
    import copy

    out = copy.copy(cluster)
    out.nodes = nodes
    return out
