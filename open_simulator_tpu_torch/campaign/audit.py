"""Placement invariant auditor: post-hoc proof a result is self-consistent
(the reference's ``campaign/audit.py``).

A ``SimulateResult`` is the engine's word that a placement is valid. In a
fleet campaign that word feeds aggregates across thousands of clusters,
so the campaign does not take it on faith: this module re-derives, from
the decoded result and the encoded ``SnapshotArrays`` alone, that

  1. every bound pod's node **exists** in the snapshot and was **active**
     for the run (no phantom or dead-node bindings),
  2. per-node consumption never exceeds allocatable — every encoded
     resource column (cpu/memory/pods/extended), GPU device memory,
     open-local volume-group capacity, and attachable-volume limits,
  3. **forced binds were honored**: a pod recorded with ``nodeName``
     lands on exactly that node (preemption victims, the one legitimate
     exception, are excluded via the result's structured marker).

The checks are vectorized host numpy over the arrays the engine itself
ran on (float64 accumulation so audit rounding can never masquerade as a
violation) — O(P + N·R), microseconds next to a simulate. A violation
means the engine (or its decode) corrupted state: the campaign runner
quarantines the cluster with ``E_AUDIT`` instead of folding the lie into
fleet utilization numbers.

Also exposed standalone: ``simon-tpu campaign audit`` runs one cluster
end to end and prints the report.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np

from open_simulator_tpu_torch.errors import SimulationError

# consumption tolerance: requests/capacities are float32-exact in
# practice (k8s quantities are milli-ints and Mi multiples), but the
# engine subtracts in float32 — allow its worst-case rounding, nothing a
# real overcommit could hide inside
_RTOL = 1e-4
_ATOL = 1e-3
# violations kept verbatim per report; past this only the count grows
MAX_VIOLATIONS = 32


class AuditError(SimulationError):
    """An audit violation: engine corruption, not a workload property."""

    code = "E_AUDIT"

    def __init__(self, report: "AuditReport", ref: str = ""):
        first = report.violations[0]
        super().__init__(
            f"placement audit failed: {report.n_violations} violation(s); "
            f"first: [{first.kind}] {first.ref}: {first.detail}",
            ref=ref or first.ref,
            hint="this result violates the engine's own contracts — "
                 "quarantine it and file the cluster dump as a repro")
        self.report = report

    def to_dict(self) -> Dict[str, Any]:
        out = super().to_dict()
        out["audit"] = self.report.to_dict()
        return out


@dataclass
class AuditViolation:
    kind: str    # unknown_node | inactive_node | overcommit | forced_bind
    #              | gpu_device | gpu_overcommit | vg_overcommit | vol_limit
    ref: str     # "pod/<ns>/<name>" or "node/<name>"
    detail: str

    def to_dict(self) -> Dict[str, str]:
        return {"kind": self.kind, "ref": self.ref, "detail": self.detail}


@dataclass
class AuditReport:
    """Verdict + the derived consumption stats (the fleet report reuses
    them, so utilization numbers and the audit read one computation)."""

    violations: List[AuditViolation]
    n_violations: int                  # total, violations list is capped
    n_pods: int
    n_bound: int
    n_active_nodes: int
    checks: List[str]                  # which invariant families ran
    cpu_pct: float                     # active-node cpu/mem occupancy
    mem_pct: float
    node_usage: Optional[np.ndarray] = field(default=None, repr=False)

    @property
    def ok(self) -> bool:
        return self.n_violations == 0

    def to_dict(self) -> Dict[str, Any]:
        return {
            "ok": self.ok,
            "n_violations": self.n_violations,
            "violations": [v.to_dict() for v in self.violations],
            "n_pods": self.n_pods,
            "n_bound": self.n_bound,
            "n_active_nodes": self.n_active_nodes,
            "checks": list(self.checks),
            "cpu_pct": self.cpu_pct,
            "mem_pct": self.mem_pct,
        }


def _add(violations: List[AuditViolation], count: List[int], kind: str,
         ref: str, detail: str) -> None:
    count[0] += 1
    if len(violations) < MAX_VIOLATIONS:
        violations.append(AuditViolation(kind=kind, ref=ref, detail=detail))


def audit_result(result) -> AuditReport:
    """Audit one ``SimulateResult`` (must carry its snapshot)."""
    snap = result.snapshot
    if snap is None:
        raise ValueError("audit_result needs a result with .snapshot "
                         "(simulate() keeps it by default)")
    arrs = snap.arrays
    n_nodes, n_pods = snap.n_nodes, snap.n_pods
    name_to_idx = {nm: i for i, nm in enumerate(snap.node_names)}
    violations: List[AuditViolation] = []
    count = [0]
    checks = ["binding", "capacity", "forced"]

    # active mask as decode saw it: node_status rows exist per active node
    active = np.zeros(n_nodes, dtype=bool)
    for ns_ in result.node_status:
        i = name_to_idx.get(ns_.node.name)
        if i is not None:
            active[i] = True

    # ---- 1. binding validity + the assignment vector -------------------
    pod_idx = {id(p): i for i, p in enumerate(snap.pods)}
    key_idx: Dict[str, int] = {}
    for i, p in enumerate(snap.pods):
        key_idx.setdefault(p.key, i)
    assign = np.full(n_pods, -1, dtype=np.int64)
    for sp in result.scheduled_pods:
        pi = pod_idx.get(id(sp.pod), key_idx.get(sp.pod.key, -1))
        ni = name_to_idx.get(sp.node_name)
        if ni is None:
            _add(violations, count, "unknown_node", f"pod/{sp.pod.key}",
                 f"bound to node {sp.node_name!r} which does not exist "
                 f"in the snapshot")
            continue
        if not active[ni]:
            _add(violations, count, "inactive_node", f"pod/{sp.pod.key}",
                 f"bound to inactive node {sp.node_name!r}")
        if pi >= 0:
            assign[pi] = ni
    bound = assign >= 0

    # ---- 2a. resource capacity (every encoded column, float64) ---------
    alloc = np.asarray(arrs.alloc, dtype=np.float64)        # [N, R]
    req = np.asarray(arrs.req, dtype=np.float64)            # [P, R]
    usage = np.zeros_like(alloc)
    if bound.any():
        np.add.at(usage, assign[bound], req[bound])
    limit = alloc * (1.0 + _RTOL) + _ATOL
    for ni, ri in zip(*np.nonzero(usage > limit)):
        _add(violations, count, "overcommit",
             f"node/{snap.node_names[ni]}",
             f"{snap.resources[ri]} consumption {usage[ni, ri]:g} exceeds "
             f"allocatable {alloc[ni, ri]:g}")

    # ---- 2b. gpu device memory ----------------------------------------
    gpu_cnt = np.asarray(arrs.gpu_cnt)
    if bool(np.any(gpu_cnt > 0)) and result.gpu_assignments:
        checks.append("gpu")
        g = arrs.gpu_slot.shape[1]
        gpu_use = np.zeros((n_nodes, g), dtype=np.float64)
        gpu_mem = np.asarray(arrs.gpu_mem, dtype=np.float64)
        node_gpu_count = np.asarray(arrs.gpu_count)
        cap_mem = np.asarray(arrs.gpu_cap_mem, dtype=np.float64)
        for key, devs in result.gpu_assignments.items():
            pi = key_idx.get(key, -1)
            if pi < 0 or assign[pi] < 0:
                continue
            ni = int(assign[pi])
            for d in devs:
                if d >= int(node_gpu_count[ni]):
                    _add(violations, count, "gpu_device", f"pod/{key}",
                         f"assigned gpu device {d} but node "
                         f"{snap.node_names[ni]} has "
                         f"{int(node_gpu_count[ni])} device(s)")
                else:
                    gpu_use[ni, d] += gpu_mem[pi]
        over = gpu_use > cap_mem[:, None] * (1.0 + _RTOL) + _ATOL
        for ni, d in zip(*np.nonzero(over)):
            _add(violations, count, "gpu_overcommit",
                 f"node/{snap.node_names[ni]}",
                 f"gpu device {d} memory {gpu_use[ni, d]:g} exceeds "
                 f"capacity {cap_mem[ni]:g}")

    # ---- 2c. open-local volume groups (necessary condition: per-node
    # LVM demand within total VG capacity) -------------------------------
    vg_cap = np.asarray(arrs.vg_cap, dtype=np.float64)      # [N, V]
    if bool(np.any(vg_cap > 0)):
        checks.append("volume_groups")
        pod_lvm = np.asarray(arrs.lvm_req, dtype=np.float64).sum(axis=1)
        vg_use = np.zeros(n_nodes, dtype=np.float64)
        if bound.any():
            np.add.at(vg_use, assign[bound], pod_lvm[bound])
        vg_total = vg_cap.sum(axis=1)
        for ni in np.nonzero(vg_use > vg_total * (1.0 + _RTOL) + _ATOL)[0]:
            _add(violations, count, "vg_overcommit",
                 f"node/{snap.node_names[ni]}",
                 f"LVM demand {vg_use[ni]:g} MiB exceeds total VG "
                 f"capacity {vg_total[ni]:g} MiB")

    # ---- 2d. attachable-volume limits (exclusive claims; shared claims
    # attach once and are tracked by the engine's svol carry) ------------
    vol_req = np.asarray(arrs.vol_limit_req, dtype=np.float64)  # [P, Lk]
    if bool(np.any(vol_req > 0)):
        checks.append("volume_limits")
        vol_cap = np.asarray(arrs.vol_limit_cap, dtype=np.float64)
        vol_use = np.zeros_like(vol_cap)
        if bound.any():
            np.add.at(vol_use, assign[bound], vol_req[bound])
        for ni, ki in zip(*np.nonzero(vol_use > vol_cap + 0.5)):
            _add(violations, count, "vol_limit",
                 f"node/{snap.node_names[ni]}",
                 f"attachable-volume key #{ki} demand {vol_use[ni, ki]:g} "
                 f"exceeds the node limit {vol_cap[ni, ki]:g}")

    # ---- 3. forced binds honored --------------------------------------
    forced = np.asarray(arrs.forced_node)
    preempted = set(result.preempted_pod_keys)
    for pi in np.nonzero(forced >= 0)[0]:
        pod = snap.pods[pi]
        if pod.key in preempted:
            continue  # the one legitimate unbind (structured marker)
        if assign[pi] != forced[pi]:
            where = (f"bound to {snap.node_names[int(assign[pi])]!r}"
                     if assign[pi] >= 0 else "left unbound")
            _add(violations, count, "forced_bind", f"pod/{pod.key}",
                 f"nodeName pins it to "
                 f"{snap.node_names[int(forced[pi])]!r} but it was {where}")

    # ---- occupancy stats (shared with the fleet report) ----------------
    def occupancy(res_name: str) -> float:
        if res_name not in snap.resources:
            return 0.0
        ri = snap.resources.index(res_name)
        tot = float(alloc[active, ri].sum())
        return 100.0 * float(usage[active, ri].sum()) / tot if tot else 0.0

    return AuditReport(
        violations=violations,
        n_violations=count[0],
        n_pods=n_pods,
        n_bound=int(bound.sum()),
        n_active_nodes=int(active.sum()),
        checks=checks,
        cpu_pct=occupancy("cpu"),
        mem_pct=occupancy("memory"),
        node_usage=usage,
    )


def audit_assignment(snap, assign: np.ndarray, active: np.ndarray,
                     present: Optional[np.ndarray] = None) -> AuditReport:
    """Audit a raw assignment vector against an encoded snapshot — the
    trajectory-level variant of ``audit_result`` the digital-twin session
    engine runs on what-if forks (replay/session.py): ``assign[p]`` is a
    node index (< 0 = unbound), ``active`` the node liveness mask, and
    ``present`` masks pods that are live on the trajectory (departed /
    not-yet-arrived pods are exempt). Checks the same invariant families
    that matter for a trajectory: every bound pod's node exists and is
    active, and per-node consumption never exceeds allocatable over every
    encoded resource column (float64 accumulation). A violating fork is
    quarantined with ``E_AUDIT`` instead of being reported as a valid
    what-if answer."""
    arrs = snap.arrays
    n_nodes, n_pods = snap.n_nodes, snap.n_pods
    assign = np.asarray(assign, dtype=np.int64)[:n_pods]
    active = np.asarray(active, dtype=bool)[:n_nodes]
    live = (np.ones(n_pods, dtype=bool) if present is None
            else np.asarray(present, dtype=bool)[:n_pods])
    violations: List[AuditViolation] = []
    count = [0]

    bound = live & (assign >= 0)
    over_idx = bound & (assign >= n_nodes)
    for pi in np.nonzero(over_idx)[0]:
        _add(violations, count, "unknown_node", f"pod/{snap.pods[pi].key}",
             f"bound to node index {int(assign[pi])} but the snapshot "
             f"has {n_nodes} node(s)")
    bound = bound & ~over_idx
    dead = bound & ~active[np.maximum(np.minimum(assign, n_nodes - 1), 0)]
    for pi in np.nonzero(dead)[0]:
        _add(violations, count, "inactive_node", f"pod/{snap.pods[pi].key}",
             f"bound to inactive node "
             f"{snap.node_names[int(assign[pi])]!r}")

    alloc = np.asarray(arrs.alloc, dtype=np.float64)[:n_nodes]
    req = np.asarray(arrs.req, dtype=np.float64)[:n_pods]
    usage = np.zeros_like(alloc)
    if bound.any():
        np.add.at(usage, assign[bound], req[bound])
    limit = alloc * (1.0 + _RTOL) + _ATOL
    for ni, ri in zip(*np.nonzero(usage > limit)):
        _add(violations, count, "overcommit",
             f"node/{snap.node_names[ni]}",
             f"{snap.resources[ri]} consumption {usage[ni, ri]:g} exceeds "
             f"allocatable {alloc[ni, ri]:g}")

    def occupancy(res_name: str) -> float:
        if res_name not in snap.resources:
            return 0.0
        ri = snap.resources.index(res_name)
        tot = float(alloc[active, ri].sum())
        return 100.0 * float(usage[active, ri].sum()) / tot if tot else 0.0

    return AuditReport(
        violations=violations,
        n_violations=count[0],
        n_pods=int(live.sum()),
        n_bound=int(bound.sum()),
        n_active_nodes=int(active.sum()),
        checks=["binding", "capacity"],
        cpu_pct=occupancy("cpu"),
        mem_pct=occupancy("memory"),
        node_usage=usage,
    )


def format_audit(report: AuditReport, name: str = "") -> str:
    head = f"audit {name}: " if name else "audit: "
    lines = [head + ("PASS" if report.ok
                     else f"FAIL ({report.n_violations} violation(s))")]
    lines.append(
        f"  {report.n_bound}/{report.n_pods} pods bound on "
        f"{report.n_active_nodes} active node(s); cpu {report.cpu_pct:.1f}% "
        f"mem {report.mem_pct:.1f}%; checks: {', '.join(report.checks)}")
    for v in report.violations:
        lines.append(f"  [{v.kind}] {v.ref}: {v.detail}")
    if report.n_violations > len(report.violations):
        lines.append(f"  ... and "
                     f"{report.n_violations - len(report.violations)} more")
    return "\n".join(lines)
