"""The capacity planner ("simon apply") on the port's engine.

Reference behavior (pkg/apply/apply.go:60-258): load Simon config, build
cluster + app list + newNode template, then loop { simulate; if
unscheduled pods remain, add N nodes and re-simulate from scratch }.
Finally check occupancy thresholds and print reports.

As in the JAX package (``open_simulator_tpu/apply/applier.py``), the
add-node loop is the lane axis: ``parallel/sweep.py`` answers "minimum
nodes to add" with lanes of one kernel launch per round, and the report
decodes the chosen lane. The printed report is the reference's, line for
line. When the decoded lane leaves pods unscheduled and their priorities
differ, that lane is re-run under the DefaultPreemption pass
(``engine/preemption.py``), as in the reference, unless a
``--default-scheduler-config`` file disables DefaultPreemption (its
score weights and filter gates go into the engine config, through
``engine/sched_config.weight_overrides_from_file``). Not ported yet, each
raising NotImplementedError that names its ROADMAP item:
``--interactive``, chart apps, a ``kubeConfig`` cluster, the compile
cache and sweep resume.

Env knobs (reference: satisfyResourceSetting, apply.go:614-681):
  MaxCPU     max average cluster CPU occupancy %, default 100
  MaxMemory  max average cluster memory occupancy %, default 100
"""

from __future__ import annotations

import os
import sys
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from open_simulator_tpu_torch.api.v1alpha1 import SimonConfig, load_config
from open_simulator_tpu_torch.core import (
    AppResource,
    SimulateResult,
    build_pod_sequence,
    decode_output,
    decode_result,
    host_schedule_fn,
    with_volume_objects,
)
from open_simulator_tpu_torch.encode.snapshot import EncodeOptions, encode_cluster
from open_simulator_tpu_torch.engine.scheduler import make_config, schedule_lanes
from open_simulator_tpu_torch.k8s.loader import (
    ClusterResources,
    load_resources_from_directory,
    make_valid_node,
)
from open_simulator_tpu_torch.k8s.objects import Node
from open_simulator_tpu_torch.parallel.sweep import (
    SweepThresholds,
    active_masks_for_counts,
    capacity_bisect,
    capacity_sweep,
)
from open_simulator_tpu_torch.report.tables import full_report

# the rest of apply's surface (the reference's applier and CLI options)
_APPLY_ITEM = "ROADMAP queue 1, item 15"


@dataclass
class ApplyOptions:
    """CLI surface parity (cmd/apply/apply.go:27-36), plus the device."""

    config_path: str = ""
    default_scheduler_config: str = ""
    output_file: str = ""
    use_greed: bool = False
    interactive: bool = False
    extended_resources: List[str] = field(default_factory=list)
    max_new_nodes: int = 128             # sweep upper bound
    # "bisect" (default): galloping bisection over the monotone
    # node-count axis, ~log_W(max_new) W-lane rounds; "exhaustive": one
    # lane per candidate count
    sweep_mode: str = "bisect"
    compile_cache_dir: str = ""
    resume: str = ""
    device: Optional[str] = None         # None = the card; "cpu" = the plain step


class ApplyError(RuntimeError):
    pass


def _load_new_node_template(path: str) -> Optional[Node]:
    if not path:
        return None
    res = (
        load_resources_from_directory(path)
        if os.path.isdir(path)
        else _load_resources_file(path)
    )
    if not res.nodes:
        raise ApplyError(f"newNode path {path} contains no Node object")
    if len(res.nodes) > 1:
        raise ApplyError(f"newNode path {path}: only one node template is supported")
    return make_valid_node(res.nodes[0])


def _load_resources_file(path: str) -> ClusterResources:
    from open_simulator_tpu_torch.k8s.loader import demux_object, parse_yaml_documents

    res = ClusterResources()
    with open(path, "r", encoding="utf-8") as f:
        for doc in parse_yaml_documents(f.read()):
            demux_object(doc, res)
    return res


def build_cluster_from_config(config: SimonConfig, base_dir: str) -> ClusterResources:
    """Cluster inputs for a Simon config."""
    cc = config.cluster
    if cc.kube_config:
        raise NotImplementedError(
            f"a kubeConfig cluster (a recorded API dump) is not ported yet ({_APPLY_ITEM})")
    path = os.path.join(base_dir, cc.custom_config)
    cluster = load_resources_from_directory(path, strict=False)
    if not cluster.nodes:
        raise ApplyError(f"cluster source {path} contains no nodes")
    cluster.nodes = [make_valid_node(n) for n in cluster.nodes]
    return cluster


def build_apps_from_config(config: SimonConfig, base_dir: str) -> List[AppResource]:
    apps: List[AppResource] = []
    for entry in config.app_list:
        if entry.chart:
            raise NotImplementedError(
                f"chart apps (app {entry.name!r}) are not ported yet ({_APPLY_ITEM})")
        path = os.path.join(base_dir, entry.path)
        apps.append(AppResource(name=entry.name, resources=load_resources_from_directory(path)))
    return apps


class Applier:
    def __init__(self, options: ApplyOptions):
        self.opts = options
        if not options.config_path:
            raise ApplyError("--simon-config is required")
        self.config: SimonConfig = load_config(options.config_path)
        self.base_dir = os.path.dirname(os.path.abspath(options.config_path))
        self.config.validate(self.base_dir)
        self._out = sys.stdout
        self._pdbs = []

    def _thresholds(self) -> SweepThresholds:
        def env_pct(name: str) -> float:
            v = os.environ.get(name, "")
            try:
                return float(v) if v else 100.0
            except ValueError:
                return 100.0

        return SweepThresholds(
            max_cpu_pct=env_pct("MaxCPU"),
            max_memory_pct=env_pct("MaxMemory"),
            max_vg_pct=env_pct("MaxVG"),
        )

    def run(self) -> int:
        out_f = None
        if self.opts.output_file:
            out_f = open(self.opts.output_file, "w", encoding="utf-8")
            self._out = out_f
        try:
            return self._run_inner()
        finally:
            if out_f:
                out_f.close()

    def _say(self, msg: str = "") -> None:
        print(msg, file=self._out)

    def _refuse_unported_options(self) -> None:
        if self.opts.interactive:
            raise NotImplementedError(f"--interactive is not ported yet ({_APPLY_ITEM})")
        if self.opts.compile_cache_dir:
            raise NotImplementedError(
                "--compile-cache-dir is not ported yet (ROADMAP queue 1, item 8)")
        if self.opts.resume:
            raise NotImplementedError(
                "--resume (sweep journals) is not ported yet (ROADMAP queue 1, item 8)")

    def _run_inner(self) -> int:
        self._refuse_unported_options()
        cluster = build_cluster_from_config(self.config, self.base_dir)
        apps = build_apps_from_config(self.config, self.base_dir)
        template = _load_new_node_template(
            os.path.join(self.base_dir, self.config.new_node) if self.config.new_node else ""
        )
        self._pdbs = list(cluster.pdbs) + [p for a in apps for p in a.resources.pdbs]
        pods = build_pod_sequence(cluster, apps, use_greed=self.opts.use_greed)
        max_new = self.opts.max_new_nodes if template is not None else 0
        snapshot = encode_cluster(
            cluster.nodes,
            pods,
            with_volume_objects(
                EncodeOptions(max_new_nodes=max_new, new_node_template=template),
                cluster, apps,
            ),
        )
        overrides = {}
        if self.opts.default_scheduler_config:
            from open_simulator_tpu_torch.engine.sched_config import weight_overrides_from_file

            overrides = weight_overrides_from_file(self.opts.default_scheduler_config)
        self._preemption = not overrides.pop("_disable_preemption", False)
        cfg = make_config(snapshot, **overrides)
        thresholds = self._thresholds()
        dev = self.opts.device

        if self.opts.sweep_mode == "bisect":
            plan = capacity_bisect(snapshot, cfg, max_new, thresholds, device=dev)
        else:
            # exhaustive: candidate counts 0..max_new, one lane each
            counts = list(range(max_new + 1))
            plan = capacity_sweep(snapshot, cfg, counts, thresholds, device=dev)
        if plan.best_count is None:
            self._say(
                f"FAILED: apps do not fit even with {max_new} new node(s) "
                f"(raise --max-new-nodes or adjust the newNode spec)"
            )
            # both modes probe max_new, so the last (largest) lane is the
            # most-capacity view worth reporting
            worst = self._result_for(snapshot, plan, len(plan.counts) - 1, cfg)
            self._say(full_report(worst, self.opts.extended_resources))
            return 1

        best_idx = plan.counts.index(plan.best_count)
        result = self._result_for(snapshot, plan, best_idx, cfg)
        # the reasons re-run is a single run of the chosen lane; keep the
        # summary consistent with the per-pod report below if they differ
        sweep_sched = int(np.sum(plan.nodes_per_scenario[best_idx] >= 0))
        decoded_sched = len(result.scheduled_pods)
        if decoded_sched != sweep_sched:
            self._say(
                f"note: decoded report schedules {decoded_sched} pod(s) vs the "
                f"sweep lane's {sweep_sched} (the decode re-run applies "
                f"preemption and can resolve exact ties differently from the "
                f"batched sweep); the per-pod report below is authoritative"
            )
        if plan.best_count > 0:
            how = (f"bisected {max_new + 1} candidates in "
                   f"{len(plan.counts)} probes"
                   if self.opts.sweep_mode == "bisect"
                   else f"swept {len(plan.counts)} candidates in one batch")
            self._say(
                f"cluster requires {plan.best_count} new node(s) of the given spec "
                f"to satisfy all apps ({how})"
            )
        else:
            self._say("all apps fit on the existing cluster; no new nodes needed")
        self._say(
            f"occupancy at chosen size: cpu {plan.cpu_occupancy_pct[best_idx]:.1f}% "
            f"mem {plan.mem_occupancy_pct[best_idx]:.1f}% "
            f"(limits: cpu {thresholds.max_cpu_pct:.0f}% mem {thresholds.max_memory_pct:.0f}%)"
        )
        self._say()
        self._say(full_report(result, self.opts.extended_resources))
        return 0

    def _result_for(self, snapshot, plan, idx: int, cfg) -> SimulateResult:
        masks = active_masks_for_counts(snapshot, plan.counts)
        lane_has_unscheduled = bool(np.any(plan.nodes_per_scenario[idx] < 0))
        if (lane_has_unscheduled and getattr(self, "_preemption", True)
                and len({p.priority for p in snapshot.pods}) > 1):
            # The chosen lane's placements and reasons reflect the
            # PostFilter pass: the lane re-run through one-lane
            # schedule_pods under run_with_preemption. A multi-victim
            # preemption can shrink the scheduled count relative to the
            # sweep lane, so this decode is the authoritative report.
            import time

            from open_simulator_tpu_torch.engine.preemption import run_with_preemption

            lane_active = np.asarray(masks[idx])
            t0 = time.perf_counter()
            out, pre = run_with_preemption(
                snapshot, lane_active,
                host_schedule_fn(snapshot, lane_active, cfg, self.opts.device), list(self._pdbs))
            return decode_output(snapshot, out, lane_active, cfg, time.perf_counter() - t0,
                                 pre.preempted_by)
        if lane_has_unscheduled:
            # The sweep lanes run with fail_reasons off; the reported lane
            # needs real per-op counts, so re-run just this lane with the
            # accounting on and decode the re-run's own assignments.
            out = schedule_lanes(snapshot.arrays, masks[idx][None],
                                 cfg._replace(fail_reasons=True), device=self.opts.device)
            return decode_result(
                snapshot,
                out.node[0].cpu().numpy(),
                out.fail_counts[0].cpu().numpy(),
                masks[idx],
                gpu_pick=out.gpu_pick[0].cpu().numpy() if cfg.enable_gpu else None,
                vol_pick=out.vol_pick[0].cpu().numpy() if cfg.enable_pv_match else None,
            )
        return decode_result(
            snapshot,
            plan.nodes_per_scenario[idx],
            plan.fail_counts[idx],
            masks[idx],
            gpu_pick=plan.gpu_pick[idx] if plan.gpu_pick is not None else None,
            vol_pick=plan.vol_pick[idx] if plan.vol_pick is not None else None,
        )
