"""Per-pod scheduling explanations ("why this node / why unschedulable"),
on the port's results: a copy of the reference's
``open_simulator_tpu/telemetry/explain.py``.

The engine computes everything an explanation needs: per-pod per-op
failure counts (the first-failing-filter accounting behind the "0/N nodes
are available: ..." line), and, with ``EngineConfig.explain_topk``, the
top-k candidate nodes by final score with each score plugin's weighted
contribution at those nodes, recorded at the pod's own step (on the card,
inside the ``plain_step`` kernel's pod loop). This module only decodes:
host numpy over the arrays ``core.decode_result`` stores on
``SimulateResult``, no re-simulation.

Report shape (the reference's; rendered as text by ``explain`` and as
JSON by ``explain --json``):

  {"n_active_nodes": N, "summary": {"scheduled": a, "unscheduled": b},
   "score_parts": [...plugin names...],
   "pods": [{"pod": "ns/name", "status": "scheduled"|"unscheduled"|"preempted",
             "node": "...",                       # scheduled only
             "forced": bool,                      # spec.nodeName fast path
             "candidates": [{"node", "score", "parts": {plugin: v}}],
             "reason": "...",                     # unscheduled only
             "first_failing_op": "...",           # pipeline-order first op
             "eliminations": [{"op", "nodes"}]}]}
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np

# masked-out candidates carry the engine's neg_inf score sentinel
# (-3.4e38); anything below this threshold is "not a feasible candidate"
_SCORE_FLOOR = -1e37


def _eliminations(counts: np.ndarray, op_names: Sequence[str]) -> List[Dict[str, Any]]:
    return [
        {"op": op_names[i], "nodes": int(c)}
        for i, c in enumerate(counts)
        if i < len(op_names) and int(c) > 0
    ]


def first_failing_op(counts: np.ndarray, op_names: Sequence[str]) -> Optional[str]:
    """The first op in the vendored pipeline order that eliminated at
    least one node — the engine charges each node to its first failing
    filter, so pipeline order IS severity order here."""
    for i, c in enumerate(counts):
        if int(c) > 0 and i < len(op_names):
            return op_names[i]
    return None


def explain_result(result, top_k: Optional[int] = None,
                   pods: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    """Build the explain report from a decoded SimulateResult.

    top_k trims the candidate list further than the engine recorded;
    pods filters to specific pod keys (ns/name). Works on any result —
    candidate lists are present only when the run recorded them
    (EngineConfig.explain_topk > 0), failure decodes always are.
    """
    snapshot = result.snapshot
    if snapshot is None:
        raise ValueError("explain needs a result decoded with its snapshot")
    op_names = list(result.op_names) or list(snapshot.op_names)
    fail_counts = result.fail_counts
    part_names = list(result.score_part_names or [])
    want = set(pods) if pods else None

    node_by_key = {sp.pod.key: sp.node_name for sp in result.scheduled_pods}
    reason_by_key = {up.pod.key: up.reason for up in result.unscheduled_pods}
    preempted = set(result.preempted_pod_keys or [])
    # walk the RESULT's own pod set, not the whole snapshot: a trimmed
    # per-app result (Simulator.schedule_app) covers a subset of the
    # snapshot, and inferring "unscheduled" from absence in the trimmed
    # scheduled list would mislabel every out-of-app pod. Rows still
    # index the full snapshot, so map key -> snapshot index.
    index_by_key = {pod.key: i for i, pod in enumerate(snapshot.pods)}
    result_keys = set(node_by_key) | set(reason_by_key)

    entries: List[Dict[str, Any]] = []
    forced = np.asarray(snapshot.arrays.forced_node)
    for i, pod in enumerate(snapshot.pods):
        key = pod.key
        if key not in result_keys or i != index_by_key[key]:
            continue
        if want is not None and key not in want:
            continue
        entry: Dict[str, Any] = {"pod": key,
                                 "forced": bool(forced[i] >= 0)}
        if result.wave_id is not None and i < len(result.wave_id):
            # wave-scheduling provenance (engine/waves.py): which
            # placement wave the pod rode and whether it took the
            # batched filter+score path or the fallback scan
            entry["wave"] = int(result.wave_id[i])
            entry["wave_path"] = ("batched" if bool(result.wave_batched[i])
                                  else "scan")
        if key in node_by_key:
            entry["status"] = "scheduled"
            entry["node"] = node_by_key[key]
            entry["candidates"] = _candidates(result, i, part_names, top_k)
        else:
            reason = reason_by_key.get(key, "")
            entry["status"] = ("preempted"
                               if key in preempted else "unscheduled")
            entry["reason"] = reason
            if fail_counts is not None and entry["status"] == "unscheduled":
                row = np.asarray(fail_counts[i])
                entry["first_failing_op"] = first_failing_op(row, op_names)
                entry["eliminations"] = _eliminations(row, op_names)
            entry["candidates"] = _candidates(result, i, part_names, top_k)
        entries.append(entry)

    report: Dict[str, Any] = {
        "n_active_nodes": int(result.n_active_nodes),
        "summary": {
            "scheduled": len(result.scheduled_pods),
            "unscheduled": len(result.unscheduled_pods),
        },
        "score_parts": part_names,
        "pods": entries,
    }
    if result.wave_id is not None:
        wb = np.asarray(result.wave_batched)
        wid = np.asarray(result.wave_id)
        report["waves"] = {
            # batched placement units only — the same semantic as
            # bench.py's n_waves (fallback-scan pods are degenerate
            # one-pod waves and are reported as scan_pods instead)
            "n_waves": int(np.unique(wid[wb]).size),
            "batched_pods": int(wb.sum()),
            "scan_pods": int((~wb).sum()),
        }
    return report


def _candidates(result, i: int, part_names: List[str],
                top_k: Optional[int]) -> List[Dict[str, Any]]:
    if result.topk_node is None or result.topk_node.shape[1] == 0:
        return []
    snapshot = result.snapshot
    idx_row = np.asarray(result.topk_node[i])
    val_row = np.asarray(result.topk_score[i])
    parts_row = (np.asarray(result.topk_parts[i])
                 if result.topk_parts is not None else None)  # [C, K]
    out: List[Dict[str, Any]] = []
    limit = (len(idx_row) if top_k is None
             else max(0, min(top_k, len(idx_row))))
    for j in range(limit):
        ni = int(idx_row[j])
        score = float(val_row[j])
        if ni < 0 or ni >= snapshot.n_nodes or score <= _SCORE_FLOOR:
            continue
        cand: Dict[str, Any] = {
            "node": snapshot.node_names[ni],
            "score": round(score, 3),
        }
        if parts_row is not None and part_names:
            cand["parts"] = {
                name: round(float(parts_row[c, j]), 3)
                for c, name in enumerate(part_names)
            }
        out.append(cand)
    return out


def format_explain(report: Dict[str, Any]) -> str:
    """Human rendering of the explain report."""
    s = report["summary"]
    lines = [
        f"explain: {s['scheduled']} scheduled, {s['unscheduled']} unscheduled "
        f"across {report['n_active_nodes']} active node(s)"
    ]
    wv = report.get("waves")
    if wv:
        lines.append(
            f"  waves: {wv['n_waves']} wave(s); {wv['batched_pods']} pod(s) "
            f"batched, {wv['scan_pods']} on the fallback scan")

    def _wave_suffix(e) -> str:
        if "wave" not in e:
            return ""
        return f" [wave {e['wave']}, {e['wave_path']}]"

    for e in report["pods"]:
        if e["status"] == "scheduled":
            suffix = " (pinned via spec.nodeName)" if e.get("forced") else ""
            suffix += _wave_suffix(e)
            lines.append(f"  {e['pod']}: scheduled on {e['node']}{suffix}")
            for c in e.get("candidates") or []:
                parts = c.get("parts") or {}
                detail = ", ".join(f"{k} {v:g}" for k, v in parts.items())
                lines.append(
                    f"      candidate {c['node']}: score {c['score']:g}"
                    + (f" ({detail})" if detail else ""))
        elif e["status"] == "preempted":
            lines.append(f"  {e['pod']}: preempted — {e.get('reason', '')}")
        else:
            lines.append(f"  {e['pod']}: UNSCHEDULABLE — "
                         f"{e.get('reason', '')}{_wave_suffix(e)}")
            ffo = e.get("first_failing_op")
            if ffo:
                lines.append(f"      first failing op: {ffo}")
            elims = e.get("eliminations") or []
            if elims:
                lines.append("      eliminations: " + "; ".join(
                    f"{el['nodes']} x {el['op']}" for el in elims))
    return "\n".join(lines)


def run_explain(config_path: str, default_scheduler_config: str = "",
                top_k: int = 3, pods: Optional[Sequence[str]] = None,
                use_greed: bool = False, device=None) -> Dict[str, Any]:
    """Load a simon/v1alpha1 config, simulate once on `device` (None = the
    card; "cpu" runs the plain torch step) with per-op failure accounting
    AND top-k score recording on, and return the report. (The CLI surface
    behind ``explain``.) A KubeSchedulerConfiguration file's overrides go
    under explain's own, as in the reference."""
    import os

    from open_simulator_tpu_torch.api.v1alpha1 import load_config
    from open_simulator_tpu_torch.apply.applier import (
        build_apps_from_config,
        build_cluster_from_config,
    )
    from open_simulator_tpu_torch.core import simulate

    config = load_config(config_path)
    base_dir = os.path.dirname(os.path.abspath(config_path))
    config.validate(base_dir)
    cluster = build_cluster_from_config(config, base_dir)
    apps = build_apps_from_config(config, base_dir)
    overrides: Dict[str, Any] = {"fail_reasons": True,
                                 "explain_topk": max(0, int(top_k))}
    if default_scheduler_config:
        from open_simulator_tpu_torch.engine.sched_config import weight_overrides_from_file

        overrides = {**weight_overrides_from_file(default_scheduler_config), **overrides}
    result = simulate(cluster, apps, use_greed=use_greed,
                      config_overrides=overrides, device=device)
    return explain_result(result, top_k=top_k or None, pods=pods)
