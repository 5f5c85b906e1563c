"""The host part of the reference's ``engine/exec_cache.py`` that fleet
campaigns need, and the fleet launch.

* **Padding** (``pad_snapshot_arrays``, ``_PAD_VALUES``): the node and
  pod axes of ``SnapshotArrays`` padded up to the reference's bucket
  shape (``engine/buckets.bucket_shape``). Padded nodes are inactive and
  unschedulable, padded pods bind-nothing sentinels (``forced_node`` -4,
  zero requests), so every real pod's result equals the unpadded run's.
  Only the fleet pads: the reference groups a campaign's clusters by
  their padded shape, and the report's ``buckets`` and ``launches`` are
  the reference's only when the port groups the same way.
* **Stacking** (``_shape_sig``, ``stack_fleet_arrays``): same-shape
  snapshots along a new leading lane axis.
* **The fleet launch** (``run_fleet_batched``): ``schedule_pods`` once per
  lane over that lane's own snapshot, from a fresh carry, as the
  reference's vmapped executable runs it — on the card one launch of the
  step kernel's fleet form (``kernels/step.plain_step_fleet``), on the CPU
  the plain step lane by lane.

The reference's AOT executable cache, donated carries and persistent
compilation cache are ROADMAP queue 1, item 8; the port compiles nothing
per shape.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from open_simulator_tpu_torch.encode.snapshot import (
    NODE_AXIS_FIRST,
    NODE_AXIS_SECOND,
    POD_AXIS_FIRST,
    SnapshotArrays,
)

# Non-default pad values. Everything else pads with 0/False, the "does
# not exist" encoding of inactive nodes and invalid term slots:
# forced_node -4 is the engine's bind-nothing sentinel, the slot arrays
# use -1 as their empty marker, and a padded node is unschedulable as well
# as inactive.
_PAD_VALUES: Dict[str, Any] = {
    "forced_node": -4,
    "match_gid": -1,
    "own_tid": -1,
    "hit_tid": -1,
    "svol_id": -1,
    "unschedulable": True,
}


def pad_snapshot_arrays(arrs: SnapshotArrays, n_nodes_to: int,
                        n_pods_to: int) -> SnapshotArrays:
    """Pad the node and pod axes up to the given sizes (host numpy).

    Padded nodes are inactive (``active`` False) and padded pods are
    bind-nothing sentinels, so the placements, the real pods' failure
    counts and the carry equal the unpadded run's."""
    n = arrs.alloc.shape[0]
    p = arrs.req.shape[0]
    dn = n_nodes_to - n
    dp = n_pods_to - p
    if dn < 0 or dp < 0:
        raise ValueError(
            f"bucket ({n_nodes_to}, {n_pods_to}) smaller than snapshot "
            f"({n}, {p})")
    if dn == 0 and dp == 0:
        return arrs

    def pad(name: str, x):
        x = np.asarray(x)
        if name in NODE_AXIS_FIRST:
            axis, grow = 0, dn
        elif name in NODE_AXIS_SECOND:
            axis, grow = 1, dn
        elif name in POD_AXIS_FIRST:
            axis, grow = 0, dp
        else:
            return x
        if grow == 0:
            return x
        fill = _PAD_VALUES.get(name, False if x.dtype == np.bool_ else 0)
        shape = list(x.shape)
        shape[axis] = grow
        block = np.full(shape, fill, dtype=x.dtype)
        return np.concatenate([x, block], axis=axis)

    out = {f.name: pad(f.name, getattr(arrs, f.name))
           for f in dataclasses.fields(arrs)}
    return type(arrs)(**out)


def _shape_sig(arrs) -> Tuple:
    out = []
    for f in dataclasses.fields(arrs):
        x = getattr(arrs, f.name)
        out.append((f.name, tuple(x.shape), str(x.dtype)))
    return tuple(out)


def stack_fleet_arrays(arrs_list):
    """Stack same-shape SnapshotArrays along a NEW leading lane axis — the
    fleet-lane batch (campaign/lanes.py). Every field must already agree
    in shape (the same node/pod bucket and the same vocabulary widths);
    callers group by the full ``_shape_sig`` before stacking."""
    first = arrs_list[0]
    sig = _shape_sig(first)
    for a in arrs_list[1:]:
        if _shape_sig(a) != sig:
            raise ValueError(
                "fleet lanes need shape-identical snapshots; group by "
                "the full shape signature before stacking")
    out = {}
    for f in dataclasses.fields(first):
        out[f.name] = np.stack(
            [np.asarray(getattr(a, f.name)) for a in arrs_list])
    return type(first)(**out)


def _lane(arrs_batch, s: int):
    """Lane `s` of a stacked batch, as the one-cluster SnapshotArrays."""
    return type(arrs_batch)(**{f.name: np.asarray(getattr(arrs_batch, f.name))[s]
                               for f in dataclasses.fields(arrs_batch)})


def run_fleet_batched(arrs_batch, masks, cfg, fn_name: str = "fleet_schedule",
                      device=None):
    """Run ``schedule_pods`` once per lane over that lane's OWN snapshot:
    `arrs_batch` is a SnapshotArrays whose every field carries a leading
    lane axis (``stack_fleet_arrays``), `masks` the per-lane [S, N] active
    matrix; every lane starts from a fresh carry (the reference's
    ``state_is_fresh=True``), with no wave plan and no preemption column.
    Each lane's outputs and final carry equal a lone ``schedule_pods`` of
    its cluster: nothing is shared across lanes that a lone run computes
    per cluster — each lane folds its own first ``cfg.forced_prefix``
    pods into its own template (one ``forced_fold`` sequence a lane), and
    has its own hoisted domain statistics and inverse allocatable. On the
    card the scan is one launch of the step's fleet form; on the CPU the
    plain step, lane by lane. The launch runs inside
    ``faults.run_launch``, so a classified failure escapes as a
    ``DeviceFault`` for the caller's degradation ladder; nothing falls
    back to the plain step. Under extensions each lane runs alone, one
    launch a pod (``engine.scheduler._extension_scan``). Returns a
    ScheduleOutput with [S, ...] outputs and carry."""
    from open_simulator_tpu_torch.engine import scheduler as sched
    from open_simulator_tpu_torch.kernels import step as step_kernels
    from open_simulator_tpu_torch.resilience import faults

    masks = np.asarray(masks, dtype=bool)
    n_lanes = int(masks.shape[0])
    n_nodes = np.asarray(arrs_batch.alloc).shape[1]
    n_pods = np.asarray(arrs_batch.req).shape[1]
    if masks.shape != (n_lanes, n_nodes) or np.asarray(arrs_batch.alloc).shape[0] != n_lanes:
        raise ValueError(f"masks must be [S, {n_nodes}] over the batch's lanes, "
                         f"got {masks.shape}")
    dev = sched.resolve_device(device)
    k = min(cfg.forced_prefix, n_pods)
    if cfg.extensions:
        # the extension callables read each lane's own cluster (the
        # reference vmaps them over the lanes' snapshots), one pod at a
        # time: each lane runs as a lone schedule_pods of its cluster
        lone = faults.run_launch(fn_name, lambda: [
            sched.schedule_pods(_lane(arrs_batch, s), masks[s], cfg, device=dev)
            for s in range(n_lanes)])
        return sched.ScheduleOutput(
            *[torch.stack([o[i] for o in lone]) for i in range(len(lone[0]) - 1)],
            state=sched.SimState(**{f: torch.stack([getattr(o.state, f) for o in lone])
                                    for f in sched.STATE_FIELDS}))

    def fire():
        lanes: List[step_kernels.FleetLane] = []
        for s in range(n_lanes):
            arrs_t = sched.device_arrays(_lane(arrs_batch, s), dev)
            active = torch.from_numpy(np.ascontiguousarray(masks[s])).to(dev)[None]
            template = sched.init_state(arrs_t, cfg)
            if k:
                template = sched.apply_forced_prefix(arrs_t, cfg, template, k)
            template = sched.SimState(**{f: getattr(template, f).contiguous()
                                         for f in sched.STATE_FIELDS})
            lanes.append(step_kernels.FleetLane(
                arrs_t, active, sched.hoist_of(arrs_t, active), sched.inv_alloc_of(arrs_t.alloc),
                sched.lane_carry(template, 1), template))
        outs = step_kernels.plain_step_fleet(lanes, cfg, k, n_pods)
        if dev.type == "cuda":
            # block inside the fault domain: a device fault surfaces here,
            # classified, not at the caller's first host read
            torch.cuda.synchronize(dev)
        return lanes, outs

    lanes, outs = faults.run_launch(fn_name, fire)
    rows = []
    for ln, out in zip(lanes, outs):
        if k:
            # the prefix pods' outputs are the forced-bind constants
            out = [o if i == 1 and not cfg.fail_reasons else torch.cat([c[None], o], 1)
                   for i, (c, o) in enumerate(zip(sched._const_outputs(ln.arrs, cfg, 0, k),
                                                  out))]
        rows.append(out)
    fields = [torch.cat([r[i] for r in rows]) for i in range(len(rows[0]))]
    if not cfg.fail_reasons:
        fields[1] = step_kernels.no_fail_counts(n_lanes, n_pods, cfg.n_ops, dev)
    state = sched.SimState(**{f: torch.cat([getattr(ln.state, f) for ln in lanes])
                              for f in sched.STATE_FIELDS})
    return sched.ScheduleOutput(*fields, state=state)
