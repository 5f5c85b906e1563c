"""The capacity sweep on lanes.

"How many nodes of spec X must I add so the app list schedules fully?"
Every candidate count is one lane of one ``schedule_lanes`` launch: the
snapshot holds the real nodes plus `max_new` inactive template slots, and
lane c activates the first c slots. The answer is the smallest count whose
lane satisfies (all pods scheduled) AND (the occupancy thresholds).

The port of the reference's ``parallel/sweep.py`` with the same plans:
``capacity_sweep`` runs one lane per candidate, ``capacity_bisect`` a
fixed number of lanes per round over a shrinking bracket, each with the
reference's wave plan (one plan for every lane). No bucketing: the kernel
takes any shape, so the unpadded arrays run as they are. Left
out, each raising NotImplementedError that names its ROADMAP item: the
device mesh, the sweep journals and resume, and the launch retries and
per-lane isolation.

Thresholds mirror the reference's satisfyResourceSetting
(apply.go:614-681): cluster-average CPU/memory occupancy percentages
must stay under MaxCPU/MaxMemory.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, NamedTuple, Optional, Sequence

import numpy as np

from open_simulator_tpu_torch.encode.snapshot import ClusterSnapshot
from open_simulator_tpu_torch.engine.buckets import bucket_pods
from open_simulator_tpu_torch.engine.scheduler import EngineConfig, schedule_lanes
from open_simulator_tpu_torch.engine.waves import waves_for


class SweepThresholds(NamedTuple):
    max_cpu_pct: float = 100.0
    max_memory_pct: float = 100.0
    max_vg_pct: float = 100.0  # open-local VG occupancy (MaxVG env, apply.go:614-681)


@dataclass
class CapacityPlan:
    """The sweep verdict (the reference's fields; the journal fields keep
    their no-journal values)."""

    counts: List[int]                  # candidate new-node counts, as swept
    all_scheduled: List[bool]          # per candidate
    cpu_occupancy_pct: List[float]
    mem_occupancy_pct: List[float]
    satisfied: List[bool]
    best_count: Optional[int]          # min satisfying count, None if none
    nodes_per_scenario: np.ndarray = field(repr=False, default=None)  # [S, P] i32
    fail_counts: np.ndarray = field(repr=False, default=None)         # [S, P, OPS]
    gpu_pick: Optional[np.ndarray] = field(repr=False, default=None)  # [S, P, G]
    vol_pick: Optional[np.ndarray] = field(repr=False, default=None)  # [S, P, Lw]
    trial_errors: Dict[int, str] = field(default_factory=dict)
    sweep_id: Optional[str] = None
    resumed_rounds: int = 0
    checkpointing_disabled: bool = False


def _refuse_unported(mesh=None, retries=None, backoff_s=None, isolate_trials=None,
                     resume=None, checkpoint=None) -> None:
    if mesh is not None:
        raise NotImplementedError(
            "sweeps over a device mesh are not ported yet (ROADMAP queue 1, item 13)")
    if retries is not None or backoff_s is not None or isolate_trials is not None:
        raise NotImplementedError(
            "launch retries and per-lane trial isolation are not ported yet "
            "(ROADMAP queue 1, item 8)")
    if resume or checkpoint:
        raise NotImplementedError(
            "sweep checkpoint journals and resume are not ported yet "
            "(ROADMAP queue 1, item 8)")


def active_masks_for_counts(snapshot: ClusterSnapshot, counts: Sequence[int]) -> np.ndarray:
    """[S, N] lane masks: all real nodes + the first c padded new-node slots."""
    n = snapshot.n_nodes
    n_real = snapshot.n_real_nodes
    max_new = n - n_real
    masks = np.zeros((len(counts), n), dtype=bool)
    for si, c in enumerate(counts):
        if c > max_new:
            raise ValueError(f"count {c} exceeds padded new-node slots ({max_new})")
        masks[si, :n_real] = True
        masks[si, n_real : n_real + c] = True
    return masks


class _LaneStats(NamedTuple):
    all_scheduled: bool
    cpu_pct: float
    mem_pct: float
    satisfied: bool


def _lane_stats(alloc, cpu_i, mem_i, vg_cap, has_storage, lane_active,
                nodes_row, headroom_row, vg_row, error,
                thresholds: SweepThresholds) -> _LaneStats:
    """Verdict for one lane from its hosted outputs — shared by the
    exhaustive sweep and the bisection so both apply one definition of
    "satisfied" (all pods scheduled AND occupancy under thresholds). The
    reference's numpy sums over the same arrays in the same order, so the
    occupancy floats are equal to the bit."""
    ok = error is None and bool(np.all(nodes_row >= 0))
    used = alloc - headroom_row                         # [N, R]

    def occupancy(ri) -> float:
        tot = float(np.sum(alloc[lane_active, ri]))
        u = float(np.sum(used[lane_active, ri]))
        return 100.0 * u / tot if tot else 0.0

    def vg_occupancy() -> float:
        """MaxVG is enforced per volume group: the WORST VG's occupancy
        across active nodes."""
        cap = vg_cap[lane_active]                       # [n, V]
        u = vg_row[lane_active]
        with np.errstate(invalid="ignore", divide="ignore"):
            pct = np.where(cap > 0, 100.0 * u / np.where(cap > 0, cap, 1.0), 0.0)
        return float(pct.max()) if pct.size else 0.0

    c_pct = occupancy(cpu_i)
    m_pct = occupancy(mem_i)
    v_pct = vg_occupancy() if has_storage else 0.0
    sat = (
        ok
        and c_pct <= thresholds.max_cpu_pct
        and m_pct <= thresholds.max_memory_pct
        and v_pct <= thresholds.max_vg_pct
    )
    return _LaneStats(ok, c_pct, m_pct, sat)


class _Lanes(NamedTuple):
    """One launch's lanes on the host (the state stays on the device)."""

    nodes: np.ndarray              # [S, P] i32
    fail: Optional[np.ndarray]     # [S, P, OPS], None without reasons
    headroom: np.ndarray           # [S, N, R]
    vg_used: np.ndarray            # [S, N, V]
    gpu_pick: Optional[np.ndarray]  # [S, P, G] under enable_gpu
    vol_pick: Optional[np.ndarray]  # [S, P, Lw] under enable_pv_match
    state: object


def _wave_plan(snapshot: ClusterSnapshot, sweep_cfg: EngineConfig):
    """The sweep's wave plan: over the sweep config and the reference's
    bucketed pod axis, one plan for every lane (it ignores the masks)."""
    return waves_for(snapshot.arrays, sweep_cfg, n_pods_total=bucket_pods(snapshot.n_pods))


def _run_lanes(snapshot: ClusterSnapshot, masks: np.ndarray, cfg: EngineConfig,
               device, carry=None, waves=None) -> _Lanes:
    """One launch over the lanes (a wave plan's launches, given one),
    hosted; the state is left on the device for the next round."""
    out = schedule_lanes(snapshot.arrays, masks, cfg, device=device, carry=carry, waves=waves)
    headroom = out.state.headroom.cpu().numpy()
    if not np.all(np.isfinite(headroom)):
        raise FloatingPointError("capacity sweep: a lane's headroom is not finite")
    return _Lanes(out.node.cpu().numpy(),
                  out.fail_counts.cpu().numpy() if cfg.fail_reasons else None,
                  headroom, out.state.vg_used.cpu().numpy(),
                  out.gpu_pick.cpu().numpy() if cfg.enable_gpu else None,
                  out.vol_pick.cpu().numpy() if cfg.enable_pv_match else None,
                  out.state)


def _snapshot_stats(snapshot: ClusterSnapshot):
    alloc = np.asarray(snapshot.arrays.alloc)
    vg_cap = np.asarray(snapshot.arrays.vg_cap)
    return (alloc, snapshot.resources.index("cpu"), snapshot.resources.index("memory"),
            vg_cap, bool(np.any(vg_cap > 0)))


def capacity_sweep(
    snapshot: ClusterSnapshot,
    cfg: EngineConfig,
    counts: Sequence[int],
    thresholds: SweepThresholds = SweepThresholds(),
    mesh=None,
    fail_reasons: bool = False,
    retries: Optional[int] = None,
    backoff_s: Optional[float] = None,
    isolate_trials: Optional[bool] = None,
    device=None,
) -> CapacityPlan:
    """Run every candidate count as one lane of one launch on `device`
    (None = the card) and pick the smallest satisfying count.

    The lanes run without reason accounting by default (it costs the
    engine a pass per pod), and CapacityPlan.fail_counts is zeros;
    callers that report reasons re-run just their decoded lane with
    reasons on (the applier does). Pass fail_reasons=True to keep the
    accounting in every lane."""
    _refuse_unported(mesh, retries, backoff_s, isolate_trials)
    masks = active_masks_for_counts(snapshot, counts)
    sweep_cfg = cfg if fail_reasons else cfg._replace(fail_reasons=False)
    lanes = _run_lanes(snapshot, masks, sweep_cfg, device,
                       waves=_wave_plan(snapshot, sweep_cfg))
    nodes, fail, headroom, vg_used = lanes.nodes, lanes.fail, lanes.headroom, lanes.vg_used
    if fail is None:
        fail = np.zeros((len(counts), snapshot.n_pods, sweep_cfg.n_ops), dtype=np.int32)
    alloc, cpu_i, mem_i, vg_cap, has_storage = _snapshot_stats(snapshot)

    all_scheduled, cpu_occ, mem_occ, satisfied = [], [], [], []
    for si in range(len(counts)):
        st = _lane_stats(alloc, cpu_i, mem_i, vg_cap, has_storage, masks[si], nodes[si],
                         headroom[si], vg_used[si], None, thresholds)
        all_scheduled.append(st.all_scheduled)
        cpu_occ.append(st.cpu_pct)
        mem_occ.append(st.mem_pct)
        satisfied.append(st.satisfied)

    best = None
    for si in sorted(range(len(counts)), key=lambda i: counts[i]):
        if satisfied[si]:
            best = counts[si]
            break
    return CapacityPlan(
        counts=list(counts),
        all_scheduled=all_scheduled,
        cpu_occupancy_pct=cpu_occ,
        mem_occupancy_pct=mem_occ,
        satisfied=satisfied,
        best_count=best,
        nodes_per_scenario=nodes,
        fail_counts=fail,
        gpu_pick=lanes.gpu_pick,
        vol_pick=lanes.vol_pick,
    )


def _probe_ladder(max_new: int, lanes: int) -> List[int]:
    """First bisection round: a geometric ladder with both endpoints —
    0 (is the cluster already enough?) and max_new (is it impossible?) —
    downsampled evenly to the lane budget."""
    ladder = sorted({0, max_new} | {
        min(1 << i, max_new) for i in range(max(max_new, 1).bit_length())})
    if len(ladder) > lanes:
        idx = np.round(np.linspace(0, len(ladder) - 1, lanes)).astype(int)
        ladder = sorted({ladder[i] for i in idx})
    return ladder


def capacity_bisect(
    snapshot: ClusterSnapshot,
    cfg: EngineConfig,
    max_new: int,
    thresholds: SweepThresholds = SweepThresholds(),
    mesh=None,
    lanes: int = 8,
    retries: Optional[int] = None,
    backoff_s: Optional[float] = None,
    isolate_trials: Optional[bool] = None,
    resume: Optional[str] = None,
    checkpoint: Optional[bool] = None,
    device=None,
) -> CapacityPlan:
    """Minimum satisfying node count by batched galloping bisection, on
    `device` (None = the card).

    Feasibility is monotone in the node count (more nodes never
    unschedule a pod, and occupancy only falls), so each round runs
    `lanes` probes covering the current bracket and shrinks it
    ~(lanes+1)x: round one is a geometric ladder (endpoints 0 and max_new
    always probed), later rounds spread evenly inside the bracket. Every
    round is one launch of `lanes` lanes — a short round repeats its last
    probe — and reuses the previous round's carry as its output buffer.

    Returns a CapacityPlan over the PROBED counts only (sorted);
    `best_count` equals the exhaustive sweep's on monotone clusters.
    Probes run with fail_reasons off always."""
    _refuse_unported(mesh, retries, backoff_s, isolate_trials, resume, checkpoint)
    if max_new < 0:
        raise ValueError(f"max_new must be >= 0, got {max_new}")
    alloc, cpu_i, mem_i, vg_cap, has_storage = _snapshot_stats(snapshot)
    sweep_cfg = cfg._replace(fail_reasons=False)
    lanes = max(1, min(lanes, max_new + 1))
    wave_plan = _wave_plan(snapshot, sweep_cfg)
    records: Dict[int, dict] = {}      # count -> hosted lane outputs
    carry_holder = {"carry": None}     # reused across rounds

    def probe(counts_round: List[int]) -> None:
        new = [c for c in counts_round if c not in records]
        if not new:
            return
        cs = list(new) + [new[-1]] * (lanes - len(new))
        masks = active_masks_for_counts(snapshot, cs)
        got = _run_lanes(snapshot, masks, sweep_cfg, device, carry=carry_holder["carry"],
                         waves=wave_plan)
        carry_holder["carry"] = got.state
        for i, c in enumerate(cs):
            if c in records:
                continue
            stats = _lane_stats(alloc, cpu_i, mem_i, vg_cap, has_storage, masks[i],
                                got.nodes[i], got.headroom[i], got.vg_used[i], None,
                                thresholds)
            records[c] = dict(nodes=got.nodes[i], stats=stats,
                              gpu=None if got.gpu_pick is None else got.gpu_pick[i],
                              vol=None if got.vol_pick is None else got.vol_pick[i])

    probe(_probe_ladder(max_new, lanes))

    def bracket():
        sat = sorted(c for c, r in records.items() if r["stats"].satisfied)
        hi = sat[0] if sat else None
        lo = max((c for c in records
                  if (hi is None or c < hi) and not records[c]["stats"].satisfied),
                 default=-1)
        return lo, hi

    lo, hi = bracket()
    while hi is not None and hi - lo > 1:
        cands = sorted(set(
            int(c) for c in np.round(np.linspace(lo + 1, hi - 1, lanes))
        ) - set(records))
        if not cands:
            break  # every interior count probed; hi is the minimum
        probe(cands)
        lo, hi = bracket()

    probed = sorted(records)
    stats = [records[c]["stats"] for c in probed]
    return CapacityPlan(
        counts=probed,
        all_scheduled=[s.all_scheduled for s in stats],
        cpu_occupancy_pct=[s.cpu_pct for s in stats],
        mem_occupancy_pct=[s.mem_pct for s in stats],
        satisfied=[s.satisfied for s in stats],
        best_count=hi,
        nodes_per_scenario=np.stack([records[c]["nodes"] for c in probed]),
        fail_counts=np.zeros((len(probed), snapshot.n_pods, cfg.n_ops), dtype=np.int32),
        gpu_pick=(np.stack([records[c]["gpu"] for c in probed]) if cfg.enable_gpu else None),
        vol_pick=(np.stack([records[c]["vol"] for c in probed])
                  if cfg.enable_pv_match else None),
    )
