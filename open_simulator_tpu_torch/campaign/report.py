"""Fleet report: deterministic analytics over a campaign's cluster rows
(the reference's ``campaign/report.py``).

The report is built from the SAME per-cluster row dicts the campaign
journal records (one fsynced JSON line per completed cluster), so a
``--resume`` run that replays rows from disk and an uninterrupted run
that built them live produce byte-identical reports — ``report_digest``
is the acceptance witness for that. Everything hashed is therefore
JSON-native (str/int/float/list/dict, floats round-tripping exactly
through ``json``), sorted by cluster name, and free of wall-clock or id
noise (campaign id, timings and the ledger run ids live OUTSIDE the
digested core).
"""

from __future__ import annotations

import hashlib
import json
import statistics
from typing import Any, Dict, List, Optional

# top rejecting filter ops reported per cluster and fleet-wide
TOP_OPS = 5


def _pct_stats(values: List[float]) -> Dict[str, float]:
    if not values:
        return {"min": 0.0, "p50": 0.0, "max": 0.0, "mean": 0.0}
    return {
        "min": min(values),
        "p50": float(statistics.median(values)),
        "max": max(values),
        "mean": float(sum(values) / len(values)),
    }


def report_digest(rows: List[Dict[str, Any]],
                  quarantined: List[Dict[str, Any]]) -> str:
    """Digest of the deterministic core: completed rows + quarantine
    records, each sorted by cluster name."""
    body = {
        "clusters": sorted(rows, key=lambda r: r["cluster"]),
        "quarantined": sorted(quarantined, key=lambda q: q["cluster"]),
    }
    return hashlib.sha256(
        json.dumps(body, sort_keys=True).encode()).hexdigest()[:16]


def build_report(campaign_id: str, rows: List[Dict[str, Any]],
                 quarantined: List[Dict[str, Any]],
                 wall_s: Optional[float] = None,
                 resumed_clusters: int = 0) -> Dict[str, Any]:
    """Assemble the fleet report dict (the CLI/REST response body)."""
    rows = sorted(rows, key=lambda r: r["cluster"])
    quarantined = sorted(quarantined, key=lambda q: q["cluster"])
    reject_totals: Dict[str, int] = {}
    buckets: Dict[str, int] = {}
    for r in rows:
        for op, n in r.get("top_rejects") or []:
            reject_totals[op] = reject_totals.get(op, 0) + int(n)
        b = r.get("bucket")
        if b:
            key = f"{int(b[0])}x{int(b[1])}"
            buckets[key] = buckets.get(key, 0) + 1
    by_code: Dict[str, int] = {}
    for q in quarantined:
        code = (q.get("error") or {}).get("code", "?")
        by_code[code] = by_code.get(code, 0) + 1
    out: Dict[str, Any] = {
        "campaign_id": campaign_id,
        "totals": {
            "clusters": len(rows) + len(quarantined),
            "completed": len(rows),
            "quarantined": len(quarantined),
            "placed": sum(int(r["placed"]) for r in rows),
            "unplaced": sum(int(r["unplaced"]) for r in rows),
        },
        "utilization": {
            "cpu_pct": _pct_stats([float(r["cpu_pct"]) for r in rows]),
            "mem_pct": _pct_stats([float(r["mem_pct"]) for r in rows]),
        },
        "top_reject_ops": sorted(
            ([op, n] for op, n in reject_totals.items()),
            key=lambda kv: (-kv[1], kv[0]))[:TOP_OPS],
        # distinct bucket shapes across the fleet: the lane-sharing
        # witness (same-bucket clusters share a fleet launch)
        "buckets": dict(sorted(buckets.items())),
        "quarantine_summary": dict(sorted(by_code.items())),
        "clusters": rows,
        "quarantined": quarantined,
        "digest": report_digest(rows, quarantined),
        "resumed_clusters": int(resumed_clusters),
    }
    if wall_s is not None:
        out["wall_s"] = round(float(wall_s), 6)
        if wall_s > 0:
            out["clusters_per_sec"] = round(
                (len(rows) + len(quarantined)) / wall_s, 3)
    return out


def format_report(report: Dict[str, Any]) -> str:
    """Human rendering of a fleet report."""
    t = report["totals"]
    lines = [
        f"campaign {report['campaign_id']}: {t['clusters']} cluster(s) — "
        f"{t['completed']} completed, {t['quarantined']} quarantined"
        + (f" (resumed {report['resumed_clusters']} from checkpoint)"
           if report.get("resumed_clusters") else ""),
        f"report digest: {report['digest']}"
        + (f"  ({report.get('clusters_per_sec', 0)} clusters/s)"
           if report.get("clusters_per_sec") is not None else ""),
    ]
    u = report["utilization"]
    lines.append(
        f"utilization: cpu {u['cpu_pct']['min']:.1f}/"
        f"{u['cpu_pct']['p50']:.1f}/{u['cpu_pct']['max']:.1f}% "
        f"(min/p50/max), mem {u['mem_pct']['min']:.1f}/"
        f"{u['mem_pct']['p50']:.1f}/{u['mem_pct']['max']:.1f}%; "
        f"placed {t['placed']}, unplaced {t['unplaced']}")
    if report.get("buckets"):
        shared = ", ".join(f"{k} x{v}" for k, v in report["buckets"].items())
        lines.append(f"executable buckets: {shared}")
    if report["top_reject_ops"]:
        lines.append("top rejecting filter ops:")
        for op, n in report["top_reject_ops"]:
            lines.append(f"  {n:>6}  {op}")
    lines.append(f"{'CLUSTER':<22} {'PODS':>6} {'PLACED':>7} {'UNPL':>5} "
                 f"{'CPU%':>6} {'MEM%':>6}  STATUS")
    for r in report["clusters"]:
        lines.append(
            f"{r['cluster']:<22} {r['n_pods']:>6} {r['placed']:>7} "
            f"{r['unplaced']:>5} {r['cpu_pct']:>6.1f} {r['mem_pct']:>6.1f}"
            f"  ok (audit {'pass' if r.get('audit_ok') else '?'})")
    for q in report["quarantined"]:
        err = q.get("error") or {}
        lines.append(
            f"{q['cluster']:<22} {'-':>6} {'-':>7} {'-':>5} {'-':>6} "
            f"{'-':>6}  QUARANTINED [{err.get('code')}] after "
            f"{q.get('attempts', 1)} attempt(s): {err.get('message', '')}")
    return "\n".join(lines)
