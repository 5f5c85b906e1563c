"""The time-stepped replay engine: the reference's ``replay/engine.py`` on
the port's engine.

* **One encode for the whole trajectory.** The pod universe (cluster
  pods + every arrival batch, in event order) and the node universe
  (cluster nodes + ``max_new_nodes`` deterministic template clones) are
  encoded once and held on the device. Every step then changes only the
  forced-bind column and the active-node mask.

* **Step semantics.** A step's outcome is defined as: scan the full
  universe with departed and not-yet-arrived pods as bind-nothing
  sentinels (``forced_node = -4``), placed live pods pinned to their
  nodes (bound pods never move), and pending live pods free (the activeQ
  retries them every step). The pins are folded into the start carry
  first (``schedule_pods(..., hoist_forced=True)``: the ``forced_fold``
  kernel on the card) so that evicted pods earlier in pod order see the
  consumption of pinned pods later in it. Everything below is an
  optimization that must be bit-identical to that definition.

* **Carry fast path.** When an arrival lands on a trajectory with no
  pending pods, the new batch is scheduled alone: ``slice_pods`` cuts the
  batch out of the universe and the previous step's carry is passed in
  (the split-scan property: scan(prefix) then scan(batch, state=carry) ==
  scan(prefix+batch)). The launch leaves the passed carry as it was. The
  fast path is skipped whenever its exactness preconditions fail
  (pending pods would deserve a retry, a nonzero tie-break seed keys its
  jitter off the global pod index, extension ops may read anything); a
  device fault on it falls back to the full scan.

* **Controllers** (replay/controllers.py) run after each event until
  convergence; their scale actions flip the active mask, and a
  descheduler defrag re-places every movable pod under the bin-packing
  profile.

* **Journal + resume**: one fsynced JSON line per settled step; resume
  verifies the fingerprint (engine hash + the reference's bucketed shape
  + workload digest + trace digest + controller roster) and replays the
  recorded steps, so an interrupted-and-resumed trajectory's digest is
  bit-identical to an uninterrupted run's. Cancellation is observed at
  every step boundary with partial results.

Not ported: the per-step RunRecords and the trajectory summary in the run
ledger (ROADMAP queue 1, item 11).
"""

from __future__ import annotations

import collections
import dataclasses
import hashlib
import json
import logging
import os
import time
import uuid
from dataclasses import dataclass, field as dc_field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from open_simulator_tpu_torch.engine.sched_config import MOST_ALLOCATED_OVERRIDES
from open_simulator_tpu_torch.errors import SimulationError
from open_simulator_tpu_torch.replay.controllers import controllers_digest
from open_simulator_tpu_torch.replay.trace import (
    BASELINE_KIND,
    CHAOS_KINDS,
    ReplayTrace,
    TraceEvent,
    clone_template_nodes,
    parse_node_template,
)
from open_simulator_tpu_torch.resilience import faults, lifecycle
from open_simulator_tpu_torch.resilience import journal as journal_mod

_log = logging.getLogger(__name__)

REPLAY_JOURNAL_SUFFIX = ".replay.jsonl"
# the bind-nothing sentinel: departed and not-yet-arrived pods take zero
# carry
SENTINEL = -4
# score profile of the descheduler's defrag pass
DEFRAG_OVERRIDES = dict(MOST_ALLOCATED_OVERRIDES)

# steps executed, by path ("full", "slice", "noop"): the reference's
# simon_replay_steps_total
STEPS_TOTAL: "collections.Counter[str]" = collections.Counter()


@dataclass
class ReplayOptions:
    """One replay's knobs (the CLI flags map 1:1)."""

    controllers: List[Any] = dc_field(default_factory=list)
    resume: str = ""                   # replay-id prefix or "last"
    checkpoint: Optional[bool] = None  # None = auto (on when a dir exists)
    config_overrides: Dict[str, Any] = dc_field(default_factory=dict)
    # carry-threaded arrival steps (bit-identical; a perf/debug switch)
    fast_path: bool = True
    max_control_iters: int = 8
    validate: bool = True


def rows_digest(rows: List[Dict[str, Any]]) -> str:
    """The trajectory digest: a hash over the journal-schema rows (always
    JSON-native, so live and resumed runs digest identical bytes)."""
    return hashlib.sha256(json.dumps(rows, sort_keys=True).encode()).hexdigest()[:16]


# ---- journal -------------------------------------------------------------


class ReplayJournal(journal_mod.DurableJournal):
    """Append-only per-replay step log::

      {"kind": "header", "replay_id", "ts", "fingerprint", "n_events",
       "controllers": [spec...], "surface"}
      {"kind": "step", "row": {...}}
      {"kind": "done", "digest", "steps"}

    A row is appended only when the step settled (event applied,
    controllers converged, outputs hosted) and fsynced — a SIGKILL
    resumes from the last settled step. A torn final line resumes from
    the prefix; mid-file corruption is ``E_CORRUPT``; an unwritable
    directory latches checkpointing off.
    """

    KIND = "replay"

    def __init__(self, path: str, header: Dict[str, Any],
                 rows: Optional[List[Dict[str, Any]]] = None,
                 done: Optional[Dict[str, Any]] = None):
        super().__init__(path, header)
        self.rows = rows or []
        self.done = done

    @property
    def replay_id(self) -> str:
        return self.header["replay_id"]

    @classmethod
    def create(cls, root: str, fingerprint: Dict[str, Any], n_events: int,
               controller_specs: List[Dict[str, Any]],
               surface: str = "replay") -> "ReplayJournal":
        os.makedirs(root, exist_ok=True)
        # bounded disk: completed journals past the keep cap go,
        # resumable (unfinished) ones stay
        lifecycle.prune_journals(root, REPLAY_JOURNAL_SUFFIX)
        replay_id = uuid.uuid4().hex[:12]
        header = {"kind": "header", "replay_id": replay_id,
                  "ts": round(time.time(), 6), "fingerprint": fingerprint,
                  "n_events": int(n_events),
                  "controllers": controller_specs, "surface": surface}
        journal = cls(os.path.join(root, replay_id + REPLAY_JOURNAL_SUFFIX), header)
        journal._append(header)
        return journal

    @classmethod
    def load(cls, root: str, token: str) -> "ReplayJournal":
        path = journal_mod.resolve_journal_path(root, token, REPLAY_JOURNAL_SUFFIX, "replay")
        scan = journal_mod.read_journal(path, cls.KIND)
        header, rows, done = None, [], None
        for rec in scan.records:
            kind = rec.get("kind")
            if kind == "header":
                header = rec
            elif kind == "step":
                rows.append(rec["row"])
            elif kind == "done":
                done = rec
        if header is None:
            raise lifecycle.ResumeError(
                f"checkpoint {os.path.basename(path)} has no header line", ref="resume")
        journal = cls(path, header, rows, done)
        journal._adopt_scan(scan)
        return journal

    def verify(self, fingerprint: Dict[str, Any]) -> None:
        """Resume contract: the rebuilt trajectory must ask the engine the
        same questions the checkpointed one asked."""
        want = self.header.get("fingerprint") or {}
        if want != fingerprint:
            drift = sorted(k for k in set(want) | set(fingerprint)
                           if want.get(k) != fingerprint.get(k))
            raise lifecycle.ResumeError(
                f"replay fingerprint drifted since the checkpoint "
                f"(changed: {drift}): recorded steps answer a different "
                f"question", ref=f"replay/{self.replay_id}", field="fingerprint",
                hint="re-run without --resume, or restore the original "
                     "cluster/trace/controllers")

    def append_step(self, row: Dict[str, Any]) -> None:
        self._append({"kind": "step", "row": row})
        self.rows.append(row)

    def finish(self, digest: str, steps: int) -> None:
        rec = {"kind": "done", "digest": digest, "steps": int(steps)}
        self._append(rec)
        self.done = rec


def resolve_replay(token: str) -> ReplayJournal:
    """Load a replay journal by id prefix / ``last``."""
    return ReplayJournal.load(lifecycle.checkpoint_dir() or "", token)


# ---- trajectory state ----------------------------------------------------


def arrival_apps(trace: ReplayTrace) -> List[Any]:
    """Parse every arrival event's manifest into AppResources (event
    order), behind the structured taxonomy."""
    import yaml as _yaml

    from open_simulator_tpu_torch.core import AppResource
    from open_simulator_tpu_torch.k8s.loader import (
        ClusterResources,
        demux_object,
        parse_yaml_documents,
    )

    apps: List[AppResource] = []
    for ev in trace.arrivals():
        res_obj = ClusterResources()
        try:
            for doc in parse_yaml_documents(ev.app["yaml"]):
                demux_object(doc, res_obj)
        except _yaml.YAMLError as e:
            raise SimulationError(
                f"arrival app {ev.app.get('name')!r} has invalid YAML: {e}",
                code="E_SPEC", ref="replay_trace", field="events[].app.yaml") from None
        apps.append(AppResource(name=ev.app["name"], resources=res_obj))
    return apps


class _Program:
    """The encoded-once universe a trajectory executes against, its arrays
    on the device."""

    def __init__(self, cluster, trace: ReplayTrace, opts: ReplayOptions, device=None):
        from open_simulator_tpu_torch.apply.migrate import is_movable
        from open_simulator_tpu_torch.core import (
            _priority_sort,
            _resolve_priorities,
            _with_nodes,
            with_volume_objects,
        )
        from open_simulator_tpu_torch.encode.snapshot import encode_cluster
        from open_simulator_tpu_torch.engine.buckets import bucket_shape
        from open_simulator_tpu_torch.engine.scheduler import (
            device_arrays,
            make_config,
            resolve_device,
        )
        from open_simulator_tpu_torch.k8s.loader import make_valid_node
        from open_simulator_tpu_torch.models.expand import (
            expand_app_resources,
            expand_cluster_pods,
        )

        self.device = resolve_device(device)
        trace.validate(allow_empty=True)
        nodes = [make_valid_node(n) for n in cluster.nodes]
        if not nodes:
            raise SimulationError("cannot replay against a cluster with zero nodes",
                                  code="E_SPEC", ref="cluster", field="nodes")
        cluster = _with_nodes(cluster, nodes)
        self.trace = trace
        apps = arrival_apps(trace)
        self.apps = apps
        if opts.validate:
            from open_simulator_tpu_torch.resilience.admission import admit

            admit(cluster, apps)

        # node universe: cluster nodes + deterministic template clones
        self.n_cluster_nodes = len(nodes)
        self.n_slots = int(trace.max_new_nodes)
        all_nodes = list(nodes)
        if self.n_slots > 0:
            template = parse_node_template(trace.node_template)
            all_nodes += clone_template_nodes(template, self.n_slots)

        # pod universe: cluster batch, then each arrival batch in event
        # order (each batch priority-sorted like an activeQ batch)
        batch0 = expand_cluster_pods(cluster)
        _resolve_priorities(batch0, cluster, apps)
        universe = list(_priority_sort(batch0))
        self.batch_ranges: Dict[str, Tuple[int, int]] = {}
        for app in apps:
            batch = expand_app_resources(app.resources, nodes, app.name)
            _resolve_priorities(batch, cluster, apps)
            batch = _priority_sort(batch)
            self.batch_ranges[app.name] = (len(universe), len(universe) + len(batch))
            universe.extend(batch)
        self.n_cluster_pods = len(batch0)
        self.pods = universe
        self.key_to_idx: Dict[str, int] = {}
        for i, p in enumerate(universe):
            self.key_to_idx.setdefault(p.key, i)

        opts_enc = with_volume_objects(None, cluster, apps)
        self.snapshot = encode_cluster(all_nodes, universe, opts_enc)
        # forced_prefix off: the step loop rewrites the forced column, so
        # a prefix fold keyed to the original column would fold stale
        # binds; fail_reasons off: steps need only assignments
        self.cfg = make_config(self.snapshot, **dict(opts.config_overrides))._replace(
            forced_prefix=0, fail_reasons=False)
        self.cfg_defrag = self.cfg._replace(**DEFRAG_OVERRIDES)

        self.N = self.snapshot.n_nodes
        self.P = self.snapshot.n_pods
        # the reference pads both axes to this bucket; the port runs the
        # real shapes (padded nodes are inactive and padded pods
        # bind-nothing sentinels, so padding changes no real pod's result)
        # and keeps the bucket only for the resume fingerprint
        nb, pb = bucket_shape(self.N, self.P)
        self.N_pad, self.P_pad = int(nb), int(pb)
        self.host_master = self.snapshot.arrays
        self.dev_master = device_arrays(self.host_master, self.device)
        self.alloc = np.asarray(self.host_master.alloc)  # [N, R]
        res = self.snapshot.resources
        self.cpu_i = res.index("cpu")
        self.mem_i = res.index("memory")
        self.node_names = list(self.snapshot.node_names)
        self.node_labels = [n.meta.labels for n in self.snapshot.nodes]
        self.movable = np.fromiter((is_movable(p) for p in universe), dtype=bool, count=self.P)
        self.is_ds = np.fromiter((p.meta.owner_kind == "DaemonSet" for p in universe),
                                 dtype=bool, count=self.P)
        self.base_forced = np.array(np.asarray(self.snapshot.arrays.forced_node),
                                    dtype=np.int32, copy=True)
        # the pinned-consumption hoist folds all pinned pods into the start
        # carry: exact only when no pod that could ever be pinned carries
        # an order-dependent gpu/storage/WFC/shared-volume contribution
        a = self.snapshot.arrays
        self.hoist_forced = not (
            bool(self.cfg.extensions)
            or (self.cfg.enable_gpu and bool(np.any(np.asarray(a.gpu_cnt) > 0)))
            or (self.cfg.enable_storage
                and bool(np.any(np.asarray(a.lvm_req) > 0)
                         or np.any(np.asarray(a.sdev_req) > 0)))
            or bool(np.any(np.asarray(a.wfc_valid)))
            or (bool(np.any(np.asarray(a.svol_id) >= 0))
                and bool(np.any(np.asarray(a.vol_limit_cap) < 1e9))))

    def fingerprint(self, controllers) -> Dict[str, Any]:
        from open_simulator_tpu_torch.telemetry import ledger

        return {
            "engine": ledger.engine_config_hash(self.cfg),
            "bucket": [self.N_pad, self.P_pad],
            "workload": ledger.workload_digest(self.snapshot.arrays),
            "trace": self.trace.digest(),
            "controllers": controllers_digest(controllers),
        }

    def presence_after(self, events: List[TraceEvent]) -> np.ndarray:
        """The present mask after a replayed event prefix (resume restores
        bound/active from the journal row; presence is a function of the
        event list alone)."""
        present = np.zeros(self.P, dtype=bool)
        present[: self.n_cluster_pods] = True
        for ev in events:
            if ev.kind == "arrive":
                start, stop = self.batch_ranges[ev.app["name"]]
                present[start:stop] = True
            elif ev.kind == "depart":
                for i in self._depart_indices(ev):
                    present[i] = False
        return present

    def _depart_indices(self, ev: TraceEvent) -> List[int]:
        if ev.app_name:
            start, stop = self.batch_ranges[ev.app_name]
            return list(range(start, stop))
        out = []
        for key in ev.pods:
            idx = self.key_to_idx.get(key)
            if idx is None:
                raise SimulationError(
                    f"depart event references unknown pod {key!r}",
                    code="E_SPEC", ref="replay_trace", field="events[].pods",
                    hint="pod keys are ns/name of cluster or arrival pods")
            out.append(idx)
        return out


class _World:
    """Mutable host trajectory state + the device scans."""

    def __init__(self, prog: _Program):
        self.prog = prog
        self.present = np.zeros(prog.P, dtype=bool)
        self.present[: prog.n_cluster_pods] = True
        # bound: >=0 node, -1 pending (retries every step), -2 lost
        # (pinned node died — DaemonSets), never SENTINEL for live pods
        self.bound = prog.base_forced[: prog.P].copy()
        self.active = np.zeros(prog.N, dtype=bool)
        self.active[: prog.n_cluster_nodes] = np.asarray(
            prog.snapshot.arrays.active)[: prog.n_cluster_nodes]
        self.carry = None          # the device SimState after the last scan

    def step_forced(self) -> np.ndarray:
        return np.where(self.present, self.bound, np.int32(SENTINEL)).astype(np.int32)

    # -- device scans ------------------------------------------------------

    def full_scan(self, cfg=None, forced: Optional[np.ndarray] = None):
        """The defining semantics: scan the whole universe with the step's
        forced column, the pins hoisted. Runs inside the device fault
        domain (fn="replay_step"): transients retry, classified faults
        surface structured."""
        from open_simulator_tpu_torch.engine.scheduler import schedule_pods

        prog = self.prog
        col = self.step_forced() if forced is None else forced
        arrs = dataclasses.replace(prog.dev_master, forced_node=torch.from_numpy(
            np.ascontiguousarray(col, dtype=np.int32)).to(prog.device))

        def fire():
            out = schedule_pods(arrs, self.active, cfg or prog.cfg, device=prog.device,
                                hoist_forced=prog.hoist_forced)
            return out.state, out.node.cpu().numpy()[: prog.P]

        self.carry, assign = faults.run_launch("replay_step", fire)
        return assign

    def slice_scan(self, start: int, stop: int):
        """The carry fast path: schedule only pods [start:stop) from the
        previous carry — exact by the split-scan property. No transient
        retries (retries=0): any fault falls back to the defining full
        scan in settle_step, which needs no carry."""
        from open_simulator_tpu_torch.engine.scheduler import schedule_pods, slice_pods

        prog = self.prog
        sl = slice_pods(prog.dev_master, start, stop)
        carry = self.carry
        self.carry = None  # the reference donates it; a fault leaves none

        def fire():
            out = schedule_pods(sl, self.active, prog.cfg, state=carry, state_is_fresh=False,
                                device=prog.device)
            return out.state, out.node.cpu().numpy()[: stop - start]

        self.carry, assign = faults.run_launch("replay_step", fire, retries=0)
        return assign

    def update_bound(self, assign: np.ndarray, lo: int = 0, hi: Optional[int] = None) -> None:
        """Fold scan outputs back into the host binding table: placed pods
        pin, failed placements go pending (-1) unless the pod carries a
        sticky sentinel — -2 (pinned node died: DaemonSets never retry)
        or -4 (an encode-time pre-reason: the scan must never place it)."""
        hi = self.prog.P if hi is None else hi
        seg = slice(lo, hi)
        a = assign.astype(np.int32)
        cur = self.bound[seg]
        sticky = (cur == -2) | (cur == SENTINEL)
        self.bound[seg] = np.where(
            self.present[seg],
            np.where(a >= 0, a, np.where(sticky, cur, np.int32(-1))),
            cur)

    # -- derived stats -----------------------------------------------------

    def pods_per_node(self) -> np.ndarray:
        placed = self.present & (self.bound >= 0)
        return np.bincount(self.bound[placed], minlength=self.prog.N)[: self.prog.N]

    def counts(self) -> Tuple[int, int, int]:
        """(placed, pending, lost) among live pods; lost covers -2 and -4."""
        live = self.present
        placed = int(np.sum(live & (self.bound >= 0)))
        lost = int(np.sum(live & ((self.bound == -2) | (self.bound == SENTINEL))))
        pending = int(np.sum(live)) - placed - lost
        return placed, pending, lost

    def occupancy(self) -> Tuple[float, float]:
        if self.carry is None:
            return 0.0, 0.0
        headroom = self.carry.headroom.cpu().numpy()  # [N, R]
        used = self.prog.alloc - headroom
        act = self.active

        def pct(ri: int) -> float:
            tot = float(np.sum(self.prog.alloc[act, ri]))
            return 100.0 * float(np.sum(used[act, ri])) / tot if tot else 0.0

        return pct(self.prog.cpu_i), pct(self.prog.mem_i)


# ---- event application ---------------------------------------------------


def _apply_event(world: _World, ev: TraceEvent) -> Dict[str, Any]:
    """Mutate the world for one event; returns JSON-native event detail
    for the step row (evicted pod keys, nodes touched)."""
    prog = world.prog
    detail: Dict[str, Any] = {"evicted": [], "nodes": []}
    if ev.kind == BASELINE_KIND:
        return detail
    if ev.kind == "arrive":
        start, stop = prog.batch_ranges[ev.app["name"]]
        world.present[start:stop] = True
        return detail
    if ev.kind == "depart":
        for i in prog._depart_indices(ev):
            world.present[i] = False
        return detail
    if ev.kind == "node_add":
        slots = range(prog.n_cluster_nodes, prog.N)
        free = [i for i in slots if not world.active[i]]
        take = free[: ev.count]
        for i in take:
            world.active[i] = True
        detail["nodes"] = [int(i) for i in take]
        return detail

    # node_remove + the chaos kinds: nodes fail, their pods unbind
    # (DaemonSet pods die with the node)
    if ev.kind in CHAOS_KINDS:
        from open_simulator_tpu_torch.resilience.chaos import FaultEvent, _resolve_event

        failed = _resolve_event(FaultEvent(kind=ev.kind, target=ev.target),
                                prog.trace.zone_key, prog.node_names, prog.node_labels,
                                world.active)
    else:  # node_remove
        if ev.target not in prog.node_names:
            raise SimulationError(
                f"node {ev.target!r} not found in cluster", code="E_SPEC",
                ref=f"node/{ev.target}", field="events[].target",
                hint="node_remove targets a cluster node or an added template slot by name")
        idx = prog.node_names.index(ev.target)
        failed = [idx] if world.active[idx] else []
    failed_mask = np.zeros(prog.N, dtype=bool)
    failed_mask[failed] = True
    world.active &= ~failed_mask
    on_dead = (world.present & (world.bound >= 0)
               & failed_mask[np.maximum(world.bound, 0)])
    detail["evicted"] = sorted(prog.pods[i].key for i in np.nonzero(on_dead)[0])
    detail["nodes"] = [int(i) for i in failed]
    world.bound = np.where(on_dead, np.where(prog.is_ds, np.int32(-2), np.int32(-1)),
                           world.bound)
    return detail


# ---- controller loop -----------------------------------------------------


def _make_view(world: _World, step: int, t: float, kind: str):
    from open_simulator_tpu_torch.replay.controllers import StepView

    placed, pending, lost = world.counts()
    return StepView(step=step, t=float(t), event_kind=kind, pending=pending,
                    lost=lost, placed=placed, active=world.active.copy(),
                    pods_per_node=world.pods_per_node(),
                    n_cluster_nodes=world.prog.n_cluster_nodes,
                    n_slots=world.prog.n_slots)


def _run_defrag(world: _World) -> List[List[int]]:
    """Unpin every movable placed pod and re-place the world under the
    bin-packing profile; returns [pod_idx, from, to] moves."""
    prog = world.prog
    unpin = world.present & (world.bound >= 0) & prog.movable
    if not np.any(unpin):
        return []
    before = world.bound.copy()
    forced = np.where(world.present, np.where(unpin, np.int32(-1), world.bound),
                      np.int32(SENTINEL)).astype(np.int32)
    assign = world.full_scan(cfg=prog.cfg_defrag, forced=forced)
    world.update_bound(assign)
    moved = np.nonzero(unpin & (world.bound != before))[0]
    return [[int(i), int(before[i]), int(world.bound[i])] for i in moved]


def _controller_loop(world: _World, controllers, step: int, t: float, kind: str,
                     max_iters: int) -> Tuple[List[Dict[str, Any]], int, bool]:
    """Run controllers to convergence; returns (actions, iters,
    converged). Every mutating action is followed by the re-simulation
    that makes its effect observable to the next iteration."""
    actions: List[Dict[str, Any]] = []
    iters = 0
    while iters < max_iters:
        view = _make_view(world, step, t, kind)
        proposed = [(c, a) for c in controllers for a in c.actions(view)]
        if not proposed:
            break
        iters += 1
        rescan = False
        for ctrl, act in proposed:
            rec: Dict[str, Any] = {"controller": ctrl.name, "kind": act["kind"], "iter": iters}
            if act["kind"] == "scale_up":
                for i in act["nodes"]:
                    world.active[i] = True
                rec["nodes"] = [int(i) for i in act["nodes"]]
                rescan = True  # pending pods may now place
            elif act["kind"] == "scale_down":
                # the policy only proposes empty owned slots with no pending
                # pods, so deactivation changes no placement: no rescan
                for i in act["nodes"]:
                    world.active[i] = False
                rec["nodes"] = [int(i) for i in act["nodes"]]
            elif act["kind"] == "defrag":
                moves = _run_defrag(world)
                rec["moves"] = moves
                rec["n_moves"] = len(moves)
            else:  # pragma: no cover — controller contract violation
                raise SimulationError(
                    f"controller {ctrl.name} proposed unknown action {act['kind']!r}",
                    code="E_INTERNAL", ref="replay_controllers")
            actions.append(rec)
        if rescan:
            world.update_bound(world.full_scan())
    converged = iters < max_iters
    final_view = _make_view(world, step, t, kind)
    for c in controllers:
        c.observe(final_view)
    return actions, iters, converged


# ---- one settled step ----------------------------------------------------


def settle_step(prog: _Program, world: _World, controllers, ev: TraceEvent, step: int, *,
                fast_path: bool = True, max_control_iters: int = 8) -> Dict[str, Any]:
    """Apply one event to the trajectory and settle it: the event, the
    defining scan (or the carry fast path when its exactness
    preconditions hold), then the controller loop to convergence. Returns
    the JSON-native journal-schema row."""
    had_pending = bool(np.any(world.present & (world.bound == -1)))
    detail = _apply_event(world, ev)
    if ev.kind == "arrive":
        start, stop = prog.batch_ranges[ev.app["name"]]
    else:
        start = stop = 0
    fast_ok = (fast_path and ev.kind == "arrive" and world.carry is not None
               and not had_pending and stop > start and prog.cfg.tie_break_seed == 0
               and not prog.cfg.extensions)
    if fast_ok:
        try:
            world.update_bound(world.slice_scan(start, stop), lo=start, hi=stop)
            STEPS_TOTAL["slice"] += 1
        except faults.DeviceFault as f:
            # the fast path is only an optimization of the full scan: a
            # device fault on it degrades to the full scan from a fresh
            # carry, with the same row and digest
            faults.record_rung("replay_step", "full_scan", f.code)
            world.carry = None
            world.update_bound(world.full_scan())
            STEPS_TOTAL["full"] += 1
    elif ev.kind == "arrive" and stop == start:
        STEPS_TOTAL["noop"] += 1  # empty batch
    else:
        world.update_bound(world.full_scan())
        STEPS_TOTAL["full"] += 1
    actions, iters, converged = _controller_loop(world, controllers, step, ev.t, ev.kind,
                                                 max_control_iters)
    placed, pending, lost = world.counts()
    cpu_pct, mem_pct = world.occupancy()
    return {
        "step": step,
        "t": float(ev.t),
        "event": ({"kind": BASELINE_KIND, "t": float(ev.t)}
                  if ev.kind == BASELINE_KIND else ev.row_dict()),
        "placed": placed, "pending": pending, "lost": lost,
        "active_nodes": int(np.sum(world.active)),
        "evicted": detail["evicted"],
        "event_nodes": detail["nodes"],
        "actions": actions,
        "iters": int(iters),
        "converged": bool(converged),
        "cpu_pct": round(float(cpu_pct), 3),
        "mem_pct": round(float(mem_pct), 3),
        "assign": [int(b) for b in world.bound],
        "active": [int(a) for a in world.active],
        "controllers": {c.name: c.state_dict() for c in controllers},
    }


# ---- the replay ----------------------------------------------------------


def run_replay(cluster, trace: ReplayTrace, options: Optional[ReplayOptions] = None,
               device=None) -> Dict[str, Any]:
    """Execute (or resume) one trace replay; returns the report dict.
    `device` is where the scans run (None = the card; ``"cpu"`` runs the
    plain torch step).

    Deterministic end to end: same cluster + trace + controllers ->
    bit-identical journal rows and trajectory digest, interrupted or
    not, on either device."""
    from open_simulator_tpu_torch.replay.report import build_report

    opts = options or ReplayOptions()
    controllers = list(opts.controllers)
    names = [c.name for c in controllers]
    if len(set(names)) != len(names):
        raise SimulationError(
            f"controller names must be unique, got {names}", code="E_SPEC",
            ref="replay_controllers", field="controllers",
            hint="register each controller kind at most once")
    t0 = time.perf_counter()
    prog = _Program(cluster, trace, opts, device)
    world = _World(prog)

    fingerprint = prog.fingerprint(controllers)
    root = lifecycle.checkpoint_dir()
    journal: Optional[ReplayJournal] = None
    rows: List[Dict[str, Any]] = []
    resumed_steps = 0
    if opts.resume:
        journal = ReplayJournal.load(root or "", opts.resume)
        journal.verify(fingerprint)
        rows = list(journal.rows)
        resumed_steps = len(rows)
        if rows:
            last = rows[-1]
            world.bound = np.array(last["assign"], dtype=np.int32)
            world.active = np.array(last["active"], dtype=bool)
            world.present = prog.presence_after(trace.events[: resumed_steps - 1])
            for c in controllers:
                c.load_state((last.get("controllers") or {}).get(c.name, {}))
        _log.info("resumed replay %s: %d settled step(s) replayed",
                  journal.replay_id, resumed_steps)
    elif opts.checkpoint or (opts.checkpoint is None and root):
        if not root:
            raise ValueError(
                "checkpoint=True needs a checkpoint directory: set "
                "SIMON_CHECKPOINT_DIR or SIMON_LEDGER_DIR")
        try:
            journal = ReplayJournal.create(root, fingerprint, len(trace.events),
                                           [c.spec_dict() for c in controllers])
        except OSError as e:
            _log.warning("checkpoint dir %s is unwritable (%s); replay checkpointing "
                         "disabled for this run", root, e)
            journal = None
    replay_id = journal.replay_id if journal is not None else uuid.uuid4().hex[:12]

    # step 0 is the synthetic baseline (the cluster's own pods), then one
    # step per trace event; a resumed run skips the settled prefix
    baseline = TraceEvent(t=trace.events[0].t if trace.events else 0.0, kind=BASELINE_KIND)
    schedule = [baseline] + list(trace.events)

    def _partial() -> Dict[str, Any]:
        placed, pending, lost = world.counts()
        return {"replay_id": replay_id, "steps_completed": len(rows),
                "total_steps": len(schedule), "placed": placed,
                "pending": pending, "lost": lost}

    for step in range(resumed_steps, len(schedule)):
        ev = schedule[step]
        # the cancellation boundary: a cancelled run stops here, between
        # steps, with the journal intact and the settled prefix as partials
        lifecycle.check_current("replay step boundary", partial=_partial)
        row = settle_step(prog, world, controllers, ev, step, fast_path=opts.fast_path,
                          max_control_iters=opts.max_control_iters)
        rows.append(row)
        if journal is not None:
            journal.append_step(row)

    digest = rows_digest(rows)
    report = build_report(replay_id, rows, trace, wall_s=time.perf_counter() - t0,
                          resumed_steps=resumed_steps)
    if report["digest"] != digest:
        raise SimulationError("replay report digest disagrees with its rows",
                              code="E_INTERNAL", ref=f"replay/{replay_id}")
    if journal is not None and journal.done is None:
        journal.finish(digest, len(rows))
    # complete and correct, but unresumable past the last durable step
    if journal is not None and journal.broken:
        report["checkpointing_disabled"] = True
    return report


def report_from_journal(journal: ReplayJournal) -> Dict[str, Any]:
    """Rebuild a replay report from its journal rows (crash inspection —
    works on unfinished journals too)."""
    from open_simulator_tpu_torch.replay.report import build_report

    return build_report(journal.replay_id, list(journal.rows), None)
