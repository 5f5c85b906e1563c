"""DefaultPreemption — the PostFilter pass.

Reference semantics (vendor/.../plugins/defaultpreemption/default_preemption.go,
behavior summarized in SURVEY.md §2b "Default plugin set"): when a pod fails
filtering, dry-run the removal of lower-priority pods per candidate node
(selectVictimsOnNode: remove all lower-priority pods, verify the preemptor
fits, then "reprieve" victims highest-priority-first while it still fits,
attempting to reprieve PDB-violating victims first), pick the best candidate
(pickOneNodeForPreemption ordering: fewest PDB violations → lowest
highest-victim priority → smallest priority sum → fewest victims), delete the
victims, and nominate the node for the preemptor's retry.

A copy of the reference's module (``open_simulator_tpu/engine/preemption.py``),
names and behaviour unchanged. Preemption is an outer fixed-point on the
host — plan victims against the decoded assignment with numpy, mark them
`disabled` (deleted) and the preemptor `nominated`, and re-run the pod
loop (``engine.scheduler.schedule_pods`` with those two columns: on the
card, the ``plain_step`` kernel reads them per pod); repeat until no plan
changes or the round cap hits. The re-run is the same deterministic prefix
property the session API relies on, so un-preempted placements stay fixed
between rounds.

Scope notes (ROADMAP): victims free resources/ports/GPU memory; a preemptor
blocked purely by affinity/spread constraints is not preempted for (the
dominant real-world preemption trigger is resource pressure). Pods with a
preset nodeName (static/cluster pods) are unevictable here.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from open_simulator_tpu_torch.encode.snapshot import ClusterSnapshot
from open_simulator_tpu_torch.k8s.objects import LabelSelector, PodDisruptionBudget
from open_simulator_tpu_torch.k8s.selectors import labels_match_selector


@dataclass
class PreemptionEvent:
    preemptor_index: int
    node_index: int
    victim_indices: List[int]


@dataclass
class PreemptionResult:
    disabled: np.ndarray                       # [P] bool — deleted victims
    nominated: np.ndarray                      # [P] i32 — retry node per preemptor
    events: List[PreemptionEvent] = field(default_factory=list)

    @property
    def preempted_by(self) -> Dict[int, int]:
        out: Dict[int, int] = {}
        for ev in self.events:
            for v in ev.victim_indices:
                out[v] = ev.preemptor_index
        return out


class _PdbState:
    """Disruption budgets over the current assignment.

    allowed disruptions per PDB = healthy-matching-scheduled-pods minus
    minAvailable (or maxUnavailable directly); evicting beyond that counts a
    violation per excess victim — the same quantity the vendored
    filterPodsWithPDBViolation partitions victims by.
    """

    def __init__(self, snapshot: ClusterSnapshot, pdbs: List[PodDisruptionBudget],
                 assign: np.ndarray):
        self.members: List[np.ndarray] = []   # [P] bool per pdb
        self.allowed: List[int] = []
        pods = snapshot.pods
        for pdb in pdbs:
            spec = pdb.raw.get("spec") or {}
            sel = LabelSelector.from_dict(spec.get("selector"))
            ns = pdb.meta.namespace or "default"
            member = np.zeros(len(pods), dtype=bool)
            for i, p in enumerate(pods):
                member[i] = (
                    p.meta.namespace == ns
                    and sel is not None
                    and labels_match_selector(p.meta.labels, sel)
                )
            healthy = int(np.sum(member & (assign >= 0)))
            # Percentages resolve against the controller's *expected* pod
            # count, not the currently-healthy count (kube's PDB controller
            # reads scale subresources; the total matching-pod count is the
            # stand-in here) — resolving against healthy would shrink the
            # minAvailable floor in partially-scheduled states.
            expected = int(np.sum(member))
            if spec.get("minAvailable") is not None:
                allowed = healthy - _resolve_budget(spec["minAvailable"], expected)
            elif spec.get("maxUnavailable") is not None:
                # kube: disruptionsAllowed = currentHealthy − desiredHealthy,
                # desiredHealthy = expected − maxUnavailable — already-missing
                # pods consume the budget
                desired = expected - _resolve_budget(spec["maxUnavailable"], expected)
                allowed = healthy - desired
            else:
                allowed = healthy
            self.members.append(member)
            self.allowed.append(max(0, allowed))

    def violations(self, victims: List[int]) -> int:
        total = 0
        for member, allowed in zip(self.members, self.allowed):
            hits = sum(1 for v in victims if member[v])
            total += max(0, hits - allowed)
        return total

    def is_protected(self, v: int) -> bool:
        return any(member[v] and allowed == 0 for member, allowed in zip(self.members, self.allowed))

    def commit_evictions(self, victims: List[int]) -> None:
        for k, member in enumerate(self.members):
            hits = sum(1 for v in victims if member[v])
            self.allowed[k] = max(0, self.allowed[k] - hits)


def _resolve_budget(v, total: int) -> int:
    if isinstance(v, str) and v.endswith("%"):
        return int(np.ceil(float(v[:-1]) / 100.0 * total))
    return int(v)


def plan_preemptions(
    snapshot: ClusterSnapshot,
    assign: np.ndarray,
    active: np.ndarray,
    disabled: np.ndarray,
    nominated: np.ndarray,
    pdbs: Optional[List[PodDisruptionBudget]] = None,
    blocked: Optional[set] = None,
) -> List[PreemptionEvent]:
    """One planning round: walk unscheduled preemptors in queue order against
    a working copy of the occupancy model, emit victim/nomination events."""
    arrs = snapshot.arrays
    pods = snapshot.pods
    P = len(pods)
    n_nodes = arrs.alloc.shape[0]
    prio = np.array([p.priority for p in pods], dtype=np.int64)

    assign_w = np.array(assign, dtype=np.int64)
    # occupancy model: resources, host-ports, gpu memory per device
    used = np.zeros_like(arrs.alloc)
    ports_used = np.zeros((n_nodes, arrs.ports.shape[1]), dtype=bool)
    gpu_used = np.zeros_like(arrs.gpu_slot)
    for i in range(P):
        ni = assign_w[i]
        if ni >= 0:
            used[ni] += arrs.req[i]
            ports_used[ni] |= arrs.ports[i]
            gpu_used[ni] += np.asarray(_gpu_row(arrs, i))
    pdb_state = _PdbState(snapshot, pdbs or [], assign_w)

    events: List[PreemptionEvent] = []
    for i in range(P):
        if assign_w[i] >= 0 or disabled[i] or nominated[i] >= 0:
            continue
        if blocked and i in blocked:
            continue  # earlier preemption attempt failed on the rescan
        if arrs.forced_node[i] != -1:
            continue  # pinned pod on a missing node; not schedulable at all
        cand = _preempt_on_best_node(
            arrs, active, assign_w, used, ports_used, gpu_used, prio, pdb_state, i
        )
        if cand is None:
            continue
        node, victims = cand
        for v in victims:
            used[node] -= arrs.req[v]
            ports_used[node] &= ~arrs.ports[v]
            gpu_used[node] = np.maximum(gpu_used[node] - _gpu_row(arrs, v), 0.0)
            assign_w[v] = -3
        used[node] += arrs.req[i]
        ports_used[node] |= arrs.ports[i]
        gpu_used[node] += _gpu_row(arrs, i)
        assign_w[i] = node
        pdb_state.commit_evictions(victims)
        events.append(PreemptionEvent(i, int(node), victims))
    return events


def _gpu_row(arrs, i: int) -> np.ndarray:
    """[G] per-device memory this pod holds (pinned devices only are exact;
    unpinned multi-device picks are approximated first-fit for the host
    model — the scan re-picks exactly on the rerun)."""
    g = arrs.gpu_slot.shape[1]
    mem = float(arrs.gpu_mem[i])
    cnt = int(arrs.gpu_cnt[i])
    row = np.zeros(g, dtype=np.float32)
    if mem <= 0 or cnt <= 0:
        return row
    if arrs.gpu_has_forced[i]:
        # gpu_forced holds per-device multiplicities ("0-0-1" -> [2,1,...])
        row += np.asarray(arrs.gpu_forced[i], dtype=np.float32) * mem
    else:
        row[:cnt] = mem
    return row


def _preempt_on_best_node(
    arrs, active, assign_w, used, ports_used, gpu_used, prio, pdb_state, i
) -> Optional[Tuple[int, List[int]]]:
    n_nodes = arrs.alloc.shape[0]
    cid = int(arrs.class_id[i])
    static_ok = (
        np.asarray(active, dtype=bool)
        & ~np.asarray(arrs.unschedulable)
        & np.asarray(arrs.class_affinity[cid])
        & np.asarray(arrs.class_taint[cid])
    )
    req_i = arrs.req[i]
    ports_i = arrs.ports[i]
    best: Optional[Tuple[tuple, int, List[int]]] = None
    for n in range(n_nodes):
        if not static_ok[n]:
            continue
        lower = [
            int(j)
            for j in np.nonzero((assign_w == n) & (prio < prio[i]))[0]
            if arrs.forced_node[j] == -1
        ]
        if not lower:
            continue
        victims = _select_victims_on_node(
            arrs, used[n], ports_used[n], gpu_used[n], n, req_i, ports_i, i, lower, prio,
            pdb_state,
        )
        if victims is None:
            continue
        viol = pdb_state.violations(victims)
        key = (
            viol,
            max(prio[v] for v in victims),
            sum(int(prio[v]) for v in victims),
            len(victims),
            n,
        )
        if best is None or key < best[0]:
            best = (key, n, victims)
    if best is None:
        return None
    return best[1], best[2]


def _select_victims_on_node(
    arrs, used_n, ports_n, gpu_n, n, req_i, ports_i, i, lower, prio, pdb_state
) -> Optional[List[int]]:
    """selectVictimsOnNode: all lower-priority pods out, preemptor must fit;
    then reprieve PDB-protected victims first, then highest-priority-first."""
    alloc_n = arrs.alloc[n]
    base_used = used_n.copy()
    base_ports = ports_n.copy()
    base_gpu = gpu_n.copy()
    for v in lower:
        base_used = base_used - arrs.req[v]
        base_ports = base_ports & ~arrs.ports[v]
        base_gpu = np.maximum(base_gpu - _gpu_row(arrs, v), 0.0)

    def fits(u, pt, gp) -> bool:
        if np.any(u + req_i > alloc_n + 1e-6):
            return False
        if np.any(pt & ports_i):
            return False
        mem, cnt = float(arrs.gpu_mem[i]), int(arrs.gpu_cnt[i])
        if mem > 0 and cnt > 0:
            # capacity precheck + device presence apply to ALL GPU pods
            # (gpu_fit applies them to pinned pods too — skipping them here
            # would plan preemptions the rescan always rejects, permanently
            # blocking the preemptor)
            n_dev = float(np.sum(arrs.gpu_slot[n]))
            if n_dev <= 0 or float(arrs.gpu_cap_mem[n]) * n_dev < mem:
                return False
            # pinned (gpu-index) preemptors bypass only the two-pointer
            # allocation-feasibility check, mirroring gpu_fit's pinned
            # bypass (AllocateGpuId early return) — otherwise the host
            # model denies preemptions the rescan would admit
            if not bool(arrs.gpu_has_forced[i]):
                free = (arrs.gpu_cap_mem[n] - gp) * arrs.gpu_slot[n]
                # two-pointer feasibility: one device holds floor(idle/mem)
                # of the requested GPUs (gpu_share._slots_per_device mirror)
                slots = np.floor(np.clip(free + 1e-6, 0.0, None) / mem)
                if int(np.sum(slots)) < cnt:
                    return False
        return True

    if not fits(base_used, base_ports, base_gpu):
        return None
    # reprieve order: PDB-protected victims first (minimizes violations),
    # then by descending priority, stable on index
    order = sorted(
        lower, key=lambda v: (not pdb_state.is_protected(v), -prio[v], v)
    )
    victims = []
    for v in order:
        trial_used = base_used + arrs.req[v]
        trial_ports = base_ports | arrs.ports[v]
        trial_gpu = base_gpu + _gpu_row(arrs, v)
        if fits(trial_used, trial_ports, trial_gpu):
            base_used, base_ports, base_gpu = trial_used, trial_ports, trial_gpu
        else:
            victims.append(v)
    if not victims:
        return None  # preemptor fits without evicting anyone: not a preemption
    return sorted(victims)


def run_with_preemption(
    snapshot: ClusterSnapshot,
    active: np.ndarray,
    schedule_fn: Callable[[Optional[np.ndarray], Optional[np.ndarray]], "ScheduleOutput"],
    pdbs: Optional[List[PodDisruptionBudget]] = None,
    max_rounds: int = 4,
    init_disabled: Optional[np.ndarray] = None,
    init_nominated: Optional[np.ndarray] = None,
):
    """Fixed-point driver: scan → plan → mark victims/nominations → rescan.

    schedule_fn(disabled, nominated) -> ScheduleOutput runs the device scan.
    Returns (final ScheduleOutput, PreemptionResult).

    Bound pods are pinned (via `nominated`) on every rescan, so an eviction
    cannot migrate unrelated placements — only the preemptor and pods that
    genuinely lost feasibility re-decide, matching kube's
    bound-pods-never-move invariant. After each rescan every planned
    preemption is verified: if the preemptor did not land on its nominated
    node (e.g. an affinity the dry-run does not model still fails), the
    eviction is rolled back and that preemptor is blocked from re-planning.

    init_disabled/init_nominated carry state across incremental session
    calls (Simulator.schedule_app): previously deleted victims stay deleted
    and previous placements stay pinned.
    """
    P = len(snapshot.pods)
    disabled = np.zeros(P, dtype=bool)
    nominated = np.full(P, -1, dtype=np.int32)
    if init_disabled is not None:
        disabled[: len(init_disabled)] = init_disabled
    if init_nominated is not None:
        nominated[: len(init_nominated)] = init_nominated
    has_init = init_disabled is not None or init_nominated is not None
    result = PreemptionResult(disabled=disabled, nominated=nominated)
    out = schedule_fn(disabled if has_init else None, nominated if has_init else None)
    if len({p.priority for p in snapshot.pods}) <= 1:
        return out, result  # all priorities equal: nothing can outrank anything

    events_all: List[PreemptionEvent] = []
    blocked: set = set()
    for _ in range(max_rounds):
        assign = np.asarray(out.node)
        new_events = plan_preemptions(
            snapshot, assign, active, disabled, nominated, pdbs, blocked
        )
        if not new_events:
            break
        events_all.extend(new_events)
        # pin every currently-bound pod to its node; victims deleted;
        # preemptors nominated
        nominated = np.where(assign >= 0, assign, nominated).astype(np.int32)
        for ev in new_events:
            for v in ev.victim_indices:
                disabled[v] = True
                nominated[v] = -1
            nominated[ev.preemptor_index] = ev.node_index
        out = schedule_fn(disabled, nominated)
        # verify: every preemptor (old and new) must hold its nominated node
        for _v in range(len(events_all)):
            assign2 = np.asarray(out.node)
            failed = [
                ev for ev in events_all
                if assign2[ev.preemptor_index] != ev.node_index
            ]
            if not failed:
                break
            for ev in failed:
                for v in ev.victim_indices:
                    # reprieved victim: re-pin to the node it was bound to so
                    # the rollback rescan cannot migrate it
                    disabled[v] = False
                    nominated[v] = ev.node_index
                nominated[ev.preemptor_index] = -1
                blocked.add(ev.preemptor_index)
                events_all.remove(ev)
            out = schedule_fn(disabled, nominated)
    result.events = events_all
    result.disabled = disabled
    result.nominated = nominated
    return out, result
