"""Fleet lanes (the reference's ``campaign/lanes.py``): same-bucket
campaign clusters execute as lanes of ONE device launch.

Clusters that share a bucket (the full ``_shape_sig`` of their padded
arrays, not just the [N, P] bucket: vocabulary widths included) and an
``EngineConfig`` pack as lanes of one ``exec_cache.run_fleet_batched``
launch — on the card one launch of the step kernel's fleet form, each
lane its own cluster.

Equivalence contract: each lane's decoded row is **identical to the
serial boundary's** — the lanes share nothing a lone run computes per
cluster, ``cluster_row``/``quarantine_row`` are the shared row
constructors, and the report digest of a fleet-lane campaign equals the
``fleet_lanes=False`` serial run bit for bit.

Quarantine semantics are unchanged and PER LANE:

* a cluster whose host-side load/admit/encode fails, whose pods carry
  mixed priorities (preemption is an iterative host fixed-point — not a
  lane), or whose config registers extension ops, falls back to the
  serial ``_run_one`` boundary (full retry/quarantine machinery);
* a lane whose decode or placement audit fails is quarantined alone —
  its siblings in the same launch settle normally;
* a launch that fails with a DETERMINISTIC device fault
  (``resilience/faults.py`` classification) walks the batch-split rung:
  the chunk halves and re-launches, isolating the poison down to one
  cluster's own serial verdict while siblings stay batched — per-lane
  rows are chunking-invariant, so the report digest is unchanged; a NaN
  (``E_NUMERIC``) that reaches a one-cluster chunk quarantines it there;
* a launch that fails any other way (transient retries already spent
  inside the launch's fault domain, or an unclassified lane-path bug)
  re-runs its members through the serial boundary, whose
  classifier-gated retry/quarantine machinery owns the verdict.

Cancellation is observed BETWEEN launches with the campaign's own
partial-result shape, so a cancelled campaign still names the settled
clusters and the journal resumes past them. The reference's launch
counters, spans and per-lane ledger captures are ROADMAP queue 1, item 11.
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Tuple

import numpy as np

from open_simulator_tpu_torch.errors import SimulationError
from open_simulator_tpu_torch.resilience import lifecycle

_log = logging.getLogger(__name__)


@dataclass
class _Prepared:
    """One lane candidate: the host-side pipeline of `simulate()` up to
    (and including) the device transfer, run inside the per-cluster
    fault boundary."""

    entry: Any
    snapshot: Any
    cfg: Any                 # the engine config simulate() would run
    fp_cfg: Any              # the fingerprint config _run_one records
    arrs: Any                # bucket-padded HOST arrays (stack_fleet_arrays
    #                          stacks on host; run_fleet_batched moves them)
    n_pods: int
    active: np.ndarray       # UNPADDED activation (decode reads this)
    lane_ok: bool            # provably equivalent to the serial path?
    why_serial: str = ""


def _prepare(entry, apps, opts) -> _Prepared:
    """Mirror `core.simulate()`'s host pipeline exactly (validate=True,
    use_greed=False — the campaign's fixed calling convention) so a lane
    run answers the same question `_run_one` would."""
    from open_simulator_tpu_torch.campaign.runner import load_and_admit
    from open_simulator_tpu_torch.core import (
        _with_nodes,
        build_pod_sequence,
        with_volume_objects,
    )
    from open_simulator_tpu_torch.encode.snapshot import encode_cluster
    from open_simulator_tpu_torch.engine import exec_cache
    from open_simulator_tpu_torch.engine.buckets import bucket_shape
    from open_simulator_tpu_torch.engine.scheduler import make_config
    from open_simulator_tpu_torch.k8s.loader import make_valid_node
    from open_simulator_tpu_torch.resilience.admission import admit

    cluster = load_and_admit(entry)
    nodes = [make_valid_node(n) for n in cluster.nodes]
    cluster = _with_nodes(cluster, nodes)
    admit(cluster, apps)
    pods = build_pod_sequence(cluster, apps)
    snapshot = encode_cluster(nodes, pods,
                              with_volume_objects(None, cluster, apps))
    overrides = dict(opts.config_overrides)
    overrides.pop("_disable_preemption", None)
    cfg = make_config(snapshot, **overrides)
    fp_cfg = make_config(snapshot, **{
        k: v for k, v in opts.config_overrides.items()
        if not k.startswith("_")})
    # pad on the host to the reference's bucket: lanes group by the padded
    # shape, and the one transfer is the fleet launch's
    n_nodes = snapshot.arrays.alloc.shape[0]
    n_pods = snapshot.arrays.req.shape[0]
    arrs = exec_cache.pad_snapshot_arrays(
        snapshot.arrays, *bucket_shape(n_nodes, n_pods))

    lane_ok, why = True, ""
    if len({p.priority for p in snapshot.pods}) > 1:
        # preemption is a host-side fixed-point per cluster — a lane
        # cannot iterate it; the serial boundary runs it unchanged
        lane_ok, why = False, "mixed pod priorities (preemption)"
    elif cfg.extensions:
        lane_ok, why = False, "extension ops registered"
    return _Prepared(entry=entry, snapshot=snapshot, cfg=cfg,
                     fp_cfg=fp_cfg, arrs=arrs, n_pods=n_pods,
                     active=np.asarray(snapshot.arrays.active),
                     lane_ok=lane_ok, why_serial=why)


def _decode_lane(prep: _Prepared, out, lane: int, n_lanes: int,
                 opts, campaign_id: str
                 ) -> Tuple[Dict[str, Any], Dict[str, str]]:
    """One lane's outputs -> the SAME report row + fingerprint the
    serial boundary produces (shared `cluster_row`; raises AuditError /
    SimulationError into the caller's per-lane quarantine boundary)."""
    from open_simulator_tpu_torch.campaign.audit import AuditError, audit_result
    from open_simulator_tpu_torch.campaign.runner import cluster_row
    from open_simulator_tpu_torch.core import decode_result
    from open_simulator_tpu_torch.telemetry import ledger

    cfg, snapshot, n_pods = prep.cfg, prep.snapshot, prep.n_pods
    t0 = time.perf_counter()
    node_assign = np.asarray(out.node)[lane, :n_pods]
    fail_counts = np.asarray(out.fail_counts)[lane, :n_pods]
    kw: Dict[str, Any] = {}
    if cfg.explain_topk:
        from open_simulator_tpu_torch.engine.scheduler import score_part_names

        kw = dict(
            topk_node=np.asarray(out.topk_node)[lane, :n_pods],
            topk_score=np.asarray(out.topk_score)[lane, :n_pods],
            topk_parts=np.asarray(out.topk_parts)[lane, :n_pods],
            score_part_names=list(score_part_names(cfg)))
    result = decode_result(
        snapshot, node_assign, fail_counts, prep.active,
        elapsed_s=time.perf_counter() - t0,
        gpu_pick=(np.asarray(out.gpu_pick)[lane, :n_pods]
                  if cfg.enable_gpu else None),
        vol_pick=(np.asarray(out.vol_pick)[lane, :n_pods]
                  if cfg.enable_pv_match else None),
        extra_op_names=list(cfg.extension_op_names),
        **kw)
    audit = audit_result(result)
    if opts.audit and not audit.ok:
        raise AuditError(audit, ref=f"cluster/{prep.entry.name}")
    row = cluster_row(prep.entry, result, audit)
    fingerprint = {"source": prep.entry.digest,
                   "engine": ledger.engine_config_hash(prep.fp_cfg)}
    return row, fingerprint


def _settle_serial(entry, apps, opts, campaign_id: str,
                   settle: Callable, partial: Callable) -> int:
    """The unchanged serial boundary for one cluster (full
    retry/quarantine machinery); returns the launches it cost (1)."""
    from open_simulator_tpu_torch.campaign import runner

    lifecycle.check_current("campaign cluster boundary", partial=partial)
    kind, row, fingerprint = runner._run_one(entry, apps, opts,
                                             campaign_id)
    settle(entry, kind, row, fingerprint)
    return 1


def _run_chunk(chunk: List[_Prepared], apps, opts, campaign_id: str,
               settle: Callable, partial: Callable) -> int:
    """Execute up to lane_width prepared clusters as ONE launch; per-lane
    quarantine; whole-launch failure falls back to the serial boundary.
    Returns the device launches dispatched. A short chunk launches as
    it is: the reference pads it to the lane width with copies of its last lane
    so that its executable cache sees one lane count; the port compiles
    nothing per shape, and a copy would only repeat a lane's scan."""
    from open_simulator_tpu_torch.campaign import runner
    from open_simulator_tpu_torch.engine import exec_cache
    from open_simulator_tpu_torch.resilience import faults

    cfg = chunk[0].cfg
    lifecycle.check_current("campaign fleet-lane boundary",
                            partial=partial)
    try:
        arrs_batch = exec_cache.stack_fleet_arrays([p.arrs for p in chunk])
        out = exec_cache.run_fleet_batched(
            arrs_batch, arrs_batch.active, cfg, device=opts.device)
        # every field decode reads, on the host HERE, inside the
        # whole-launch boundary: a transient device error on these reads
        # must take the serial fallback (with its retry machinery), not
        # quarantine a lane — and one copy per array beats one per lane
        sync = {"node": out.node.cpu().numpy(),
                "fail_counts": out.fail_counts.cpu().numpy()}
        if cfg.explain_topk:
            sync.update(topk_node=out.topk_node.cpu().numpy(),
                        topk_score=out.topk_score.cpu().numpy(),
                        topk_parts=out.topk_parts.cpu().numpy())
        if cfg.enable_gpu:
            sync["gpu_pick"] = out.gpu_pick.cpu().numpy()
        if cfg.enable_pv_match:
            sync["vol_pick"] = out.vol_pick.cpu().numpy()
        # E_NUMERIC sentinel scan over the launch's float state: a NaN
        # escaping a score must raise here (and walk the batch-split
        # ladder down to the poisoned cluster's own quarantine), not
        # settle into report rows undetected
        faults.check_finite(
            "fleet_schedule",
            headroom=out.state.headroom.cpu().numpy(),
            **({"topk_score": sync["topk_score"]}
               if cfg.explain_topk else {}))
        out = out._replace(**sync)
    except lifecycle.CancelledError:
        raise
    except Exception as e:  # noqa: BLE001 — classified below; the serial
        # boundary stays the last line of defense either way
        if (isinstance(e, faults.DeviceFault) and not e.transient
                and len(chunk) > 1):
            # batch-split rung: a deterministic device fault (a NaN in
            # one lane, an OOM the exec-cache rung couldn't absorb)
            # halves the chunk and re-launches each side — per-lane rows
            # are chunking-invariant, so the report digest is identical;
            # a single poisoned cluster degrades all the way down to its
            # own verdict while siblings stay batched
            faults.record_rung("fleet_schedule", "batch_split", e.code)
            half = len(chunk) // 2
            return (_run_chunk(chunk[:half], apps, opts, campaign_id,
                               settle, partial)
                    + _run_chunk(chunk[half:], apps, opts, campaign_id,
                                 settle, partial))
        if (isinstance(e, faults.DeviceFault) and not e.transient
                and e.code == faults.E_NUMERIC):
            # the ladder bottom for a NaN: the serial boundary runs the
            # same data through a scan with NO finite sentinel, so a
            # fallback would settle NaN-derived placements as a
            # completed row — the one outcome the sentinel exists to
            # prevent. The launch verdict IS the verdict: quarantine
            # the cluster with the structured E_NUMERIC.
            prep = chunk[0]
            _log.warning(
                "campaign %s: cluster %s quarantined [E_NUMERIC] by the "
                "fleet-lane sentinel: %s", campaign_id, prep.entry.name, e)
            settle(prep.entry, "quarantine",
                   runner.quarantine_row(prep.entry, e.to_dict(),
                                         attempts=1), {})
            return 1
        # transient retries already spent inside the launch's fault
        # domain (or an unclassified lane-path bug): the serial boundary
        # re-runs every member with its own retry/quarantine machinery,
        # so no cluster's verdict depends on the batched path working —
        # and because the classifier gates the serial retries too, a
        # deterministic fault quarantines on attempt 1 there instead of
        # being retried like a transient
        faults.record_rung(
            "fleet_schedule", "serial",
            e.code if isinstance(e, faults.DeviceFault) else "")
        _log.warning(
            "fleet-lane launch of %d cluster(s) failed (%s: %s); "
            "falling back to the serial boundary",
            len(chunk), type(e).__name__, e)
        return sum(_settle_serial(p.entry, apps, opts, campaign_id,
                                  settle, partial) for p in chunk)
    for i, prep in enumerate(chunk):
        try:
            row, fingerprint = _decode_lane(prep, out, i, len(chunk),
                                            opts, campaign_id)
            settle(prep.entry, "cluster", row, fingerprint)
            continue
        except lifecycle.CancelledError:
            raise
        except SimulationError as e:
            err = e.to_dict()
        except Exception as e:  # noqa: BLE001 — per-lane last line of
            # defense, mirroring _run_one's
            err = {"code": "E_INTERNAL",
                   "ref": f"cluster/{prep.entry.name}", "field": "",
                   "hint": "file the dump as a repro",
                   "message": f"{type(e).__name__}: {e}"}
        _log.warning("campaign %s: cluster %s quarantined [%s] in a "
                     "fleet lane: %s", campaign_id, prep.entry.name,
                     err.get("code"), err.get("message"))
        settle(prep.entry, "quarantine",
               runner.quarantine_row(prep.entry, err, attempts=1), {})
    return 1


def run_fleet(entries, apps, opts, campaign_id: str,
              settle: Callable, partial: Callable) -> int:
    """Drive the pending fleet: group shape+config-identical clusters,
    launch groups as lanes, serial-boundary everything else. Returns the
    total device launches dispatched (the `report["launches"]` witness:
    same-bucket fleets finish in fewer launches than clusters)."""
    launches = 0
    width = max(1, int(opts.lane_width))
    # A full group launches the moment it reaches lane_width (the chunk
    # membership is identical to batching after a whole-fleet prepass —
    # same-signature clusters chunk in arrival order either way), so
    # peak residency is bounded by lane_width PREPARED clusters per
    # distinct signature, not by the fleet size: a 100-cluster fleet
    # must not hold 100 host snapshots + device arrays at once.
    groups: Dict[Tuple, List[_Prepared]] = {}
    for entry in entries:
        lifecycle.check_current("campaign cluster boundary",
                                partial=partial)
        if width == 1:
            # a lone lane gains nothing over the serial boundary — and
            # preparing first would run the host pipeline twice
            launches += _settle_serial(entry, apps, opts, campaign_id,
                                       settle, partial)
            continue
        try:
            prep = _prepare(entry, apps, opts)
        except lifecycle.CancelledError:
            raise
        except Exception:  # noqa: BLE001 — the serial boundary owns the
            # retry/quarantine verdict; re-running the host pipeline for
            # a failing cluster is cheap next to mis-shaping its record
            launches += _settle_serial(entry, apps, opts, campaign_id,
                                       settle, partial)
            continue
        if not prep.lane_ok:
            _log.debug("campaign %s: cluster %s takes the serial "
                       "boundary (%s)", campaign_id, entry.name,
                       prep.why_serial)
            launches += _settle_serial(entry, apps, opts, campaign_id,
                                       settle, partial)
            continue
        from open_simulator_tpu_torch.engine.exec_cache import _shape_sig

        key = (prep.cfg, _shape_sig(prep.arrs))
        bucket = groups.setdefault(key, [])
        bucket.append(prep)
        if len(bucket) >= width:
            groups[key] = []
            launches += _run_chunk(bucket, apps, opts, campaign_id,
                                   settle, partial)

    # remainders, in first-seen signature order (dict insertion order)
    for group in groups.values():
        if not group:
            continue
        if len(group) == 1:
            # a lone lane gains nothing over the serial boundary —
            # and the serial path keeps its retry machinery
            launches += _settle_serial(group[0].entry, apps, opts,
                                       campaign_id, settle, partial)
        else:
            launches += _run_chunk(group, apps, opts, campaign_id,
                                   settle, partial)
    return launches
