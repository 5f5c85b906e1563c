"""Report tables for apply results.

Plain-text analogs of the reference's pterm tables
(pkg/apply/apply.go:307-612 report/reportCluster/reportNodes/reportGpu):
cluster-level occupancy, per-node usage, per-pod placement, GPU devices.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

from open_simulator_tpu_torch.core import SimulateResult
from open_simulator_tpu_torch.k8s.loader import sort_node_names
from open_simulator_tpu_torch.k8s.objects import (
    ANNO_GPU_INDEX,
    ANNO_WORKLOAD_KIND,
    ANNO_WORKLOAD_NAME,
    LABEL_APP_NAME,
    LABEL_NEW_NODE,
    Pod,
)
from open_simulator_tpu_torch.k8s.quantity import format_quantity


def format_table(headers: Sequence[str], rows: List[Sequence[str]], title: str = "") -> str:
    widths = [len(h) for h in headers]
    for row in rows:
        for i, cell in enumerate(row):
            widths[i] = max(widths[i], len(str(cell)))
    sep = "  "
    lines = []
    if title:
        lines.append(f"=== {title} ===")
    lines.append(sep.join(str(h).ljust(widths[i]) for i, h in enumerate(headers)))
    lines.append(sep.join("-" * widths[i] for i in range(len(headers))))
    for row in rows:
        lines.append(sep.join(str(c).ljust(widths[i]) for i, c in enumerate(row)))
    return "\n".join(lines)


def _pct(used: float, total: float) -> str:
    return f"{100.0 * used / total:.1f}%" if total else "-"


def report_cluster(result: SimulateResult) -> str:
    """Cluster-level totals per resource (apply.go reportCluster)."""
    totals: Dict[str, float] = {}
    used: Dict[str, float] = {}
    for ns in result.node_status:
        for r, v in ns.node.allocatable.items():
            totals[r] = totals.get(r, 0) + v
        for p in ns.pods:
            for r, v in p.requests().items():
                used[r] = used.get(r, 0) + v
    rows = []
    for r in sorted(totals, key=lambda x: ("cpu", "memory", "pods").index(x) if x in ("cpu", "memory", "pods") else 99):
        rows.append([
            r,
            format_quantity(int(totals.get(r, 0)), r),
            format_quantity(int(used.get(r, 0)), r),
            _pct(used.get(r, 0), totals.get(r, 0)),
        ])
    return format_table(["Resource", "Allocatable", "Requested", "Occupancy"], rows, "Cluster")


def report_nodes(result: SimulateResult) -> str:
    """Per-node usage table (apply.go reportNodes); simon- fake nodes last."""
    by_name = {ns.node.name: ns for ns in result.node_status}
    rows = []
    for name in sort_node_names(list(by_name)):
        ns = by_name[name]
        alloc = ns.node.allocatable
        cpu_used = sum(p.requests().get("cpu", 0) for p in ns.pods)
        mem_used = sum(p.requests().get("memory", 0) for p in ns.pods)
        is_new = LABEL_NEW_NODE in ns.node.meta.labels
        rows.append([
            name + (" (new)" if is_new else ""),
            format_quantity(alloc.get("cpu", 0), "cpu"),
            _pct(cpu_used, alloc.get("cpu", 0)),
            format_quantity(alloc.get("memory", 0), "memory"),
            _pct(mem_used, alloc.get("memory", 0)),
            f"{len(ns.pods)}/{alloc.get('pods', 0)}",
        ])
    return format_table(
        ["Node", "CPU Alloc", "CPU Req", "Mem Alloc", "Mem Req", "Pods"], rows, "Nodes"
    )


def _workload_of(pod: Pod) -> str:
    kind = pod.meta.annotations.get(ANNO_WORKLOAD_KIND, "Pod")
    name = pod.meta.annotations.get(ANNO_WORKLOAD_NAME, pod.meta.name)
    return f"{kind}/{name}"


def report_pods(result: SimulateResult, app_only: bool = False) -> str:
    """Pod placement table (apply.go reportPods)."""
    rows = []
    for sp in result.scheduled_pods:
        pod = sp.pod
        if app_only and LABEL_APP_NAME not in pod.meta.labels:
            continue
        req = pod.requests()
        rows.append([
            pod.key,
            _workload_of(pod),
            format_quantity(req.get("cpu", 0), "cpu"),
            format_quantity(req.get("memory", 0), "memory"),
            sp.node_name,
        ])
    for up in result.unscheduled_pods:
        if app_only and LABEL_APP_NAME not in up.pod.meta.labels:
            continue
        rows.append([up.pod.key, _workload_of(up.pod), "-", "-", "UNSCHEDULED"])
    return format_table(["Pod", "Workload", "CPU", "Memory", "Node"], rows, "Pods")


def report_gpu(result: SimulateResult) -> str:
    """GPU device occupancy (--extended-resources gpu; apply.go:399-446
    GPU Node Resource table incl. the per-device "Pod List" column).

    Occupancy comes from the engine's decoded integer allocations
    (result.gpu_assignments, the gpu_pick truth) — the annotation string is
    only a fallback for pods whose placement predates the decode (e.g. a
    user-pinned gpu-index on an already-bound pod)."""
    rows = []
    for ns in result.node_status:
        cnt, per_mem = ns.node.gpu_info()
        if cnt == 0:
            continue
        dev_used = [0] * cnt
        dev_pods: List[List[str]] = [[] for _ in range(cnt)]
        for p in ns.pods:
            mem, _n_dev = p.gpu_request()
            if not mem:
                continue
            devices = result.gpu_assignments.get(p.key)
            if devices is None:
                idx = p.meta.annotations.get(ANNO_GPU_INDEX, "")
                devices = [int(tok) for tok in str(idx).split("-") if tok.isdigit()]
            for d in devices:
                if 0 <= d < cnt:
                    dev_used[d] += mem
                    if p.key not in dev_pods[d]:
                        dev_pods[d].append(p.key)
        for d in range(cnt):
            rows.append([
                ns.node.name, f"gpu-{d}", str(per_mem), str(dev_used[d]),
                _pct(dev_used[d], per_mem), ", ".join(dev_pods[d]),
            ])
    if not rows:
        return ""
    return format_table(
        ["Node", "Device", "Mem Cap", "Mem Used", "Occupancy", "Pod List"], rows, "GPU"
    )


def report_unscheduled(result: SimulateResult) -> str:
    if not result.unscheduled_pods:
        return ""
    rows = [[up.pod.key, up.reason] for up in result.unscheduled_pods]
    return format_table(["Pod", "Reason"], rows, "Unscheduled")


def full_report(result: SimulateResult, extended_resources: Optional[List[str]] = None) -> str:
    parts = [report_cluster(result), report_nodes(result), report_pods(result)]
    if extended_resources and "gpu" in extended_resources:
        gpu = report_gpu(result)
        if gpu:
            parts.append(gpu)
    un = report_unscheduled(result)
    if un:
        parts.append(un)
    return "\n\n".join(parts)
