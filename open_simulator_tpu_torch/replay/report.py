"""Replay report: trajectory rows -> totals + digest + rendering (a copy
of the reference's ``replay/report.py``).

The report is ALWAYS built from the journal-schema JSON-native rows
(live runs construct the same rows they journal), so an interrupted-and-
resumed trajectory reports a digest bit-identical to an uninterrupted
run.
"""

from __future__ import annotations

from typing import Any, Dict, List


def build_report(replay_id: str, rows: List[Dict[str, Any]], trace,
                 wall_s: float = 0.0,
                 resumed_steps: int = 0) -> Dict[str, Any]:
    from open_simulator_tpu_torch.replay.engine import rows_digest

    last = rows[-1] if rows else {}
    scale_ups = scale_downs = defrag_moves = 0
    evicted = 0
    for r in rows:
        evicted += len(r.get("evicted") or [])
        for a in r.get("actions") or []:
            if a.get("kind") == "scale_up":
                scale_ups += len(a.get("nodes") or [])
            elif a.get("kind") == "scale_down":
                scale_downs += len(a.get("nodes") or [])
            elif a.get("kind") == "defrag":
                defrag_moves += int(a.get("n_moves") or 0)
    totals = {
        "steps": len(rows),
        "events": max(0, len(rows) - 1),
        "placed": int(last.get("placed") or 0),
        "pending": int(last.get("pending") or 0),
        "lost": int(last.get("lost") or 0),
        "active_nodes": int(last.get("active_nodes") or 0),
        "peak_pending": max((int(r.get("pending") or 0) for r in rows),
                            default=0),
        "evicted": evicted,
        "scale_ups": scale_ups,
        "scale_downs": scale_downs,
        "defrag_moves": defrag_moves,
        "converged": all(bool(r.get("converged", True)) for r in rows),
    }
    out: Dict[str, Any] = {
        "replay_id": replay_id,
        "digest": rows_digest(rows),
        "totals": totals,
        "steps": [trim_row(r) for r in rows],
        "resumed_steps": int(resumed_steps),
        "wall_s": round(float(wall_s), 6),
    }
    if trace is not None:
        out["trace_digest"] = trace.digest()
        out["n_trace_events"] = len(trace.events)
    return out


def trim_row(row: Dict[str, Any]) -> Dict[str, Any]:
    """The human/REST view of one step: everything but the dense
    assign/active vectors and controller internals (those live in the
    journal, and in the digest)."""
    return {k: v for k, v in row.items()
            if k not in ("assign", "active", "controllers")}


def _fmt_event(ev: Dict[str, Any]) -> str:
    kind = ev.get("kind", "?")
    if kind == "arrive":
        return f"arrive {ev.get('app', '')}"
    if kind == "depart":
        what = ev.get("app") or ",".join(ev.get("pods") or [])
        return f"depart {what}"
    if kind == "node_add":
        return f"node_add x{ev.get('count', 0)}"
    if kind == "baseline":
        return "baseline"
    return f"{kind} {ev.get('target', '')}"


def format_report(report: Dict[str, Any]) -> str:
    t = report["totals"]
    lines = [
        f"replay {report['replay_id']}: {t['steps']} step(s) over "
        f"{t['events']} event(s), digest {report['digest']}"
        + (f" (resumed past {report['resumed_steps']} settled step(s))"
           if report.get("resumed_steps") else ""),
        f"  final: {t['placed']} placed / {t['pending']} pending / "
        f"{t['lost']} lost on {t['active_nodes']} node(s); "
        f"peak pending {t['peak_pending']}",
        f"  controllers: +{t['scale_ups']}/-{t['scale_downs']} node "
        f"scale ops, {t['defrag_moves']} defrag move(s), "
        f"{t['evicted']} eviction(s), "
        f"{'converged' if t['converged'] else 'DID NOT CONVERGE'}",
    ]
    lines.append(f"  {'STEP':>4} {'T':>8}  {'EVENT':<28} {'PLACED':>7} "
                 f"{'PEND':>5} {'LOST':>5} {'NODES':>6} {'CPU%':>6} "
                 f"{'MEM%':>6}  ACTIONS")
    for r in report.get("steps") or []:
        acts = []
        for a in r.get("actions") or []:
            if a["kind"] in ("scale_up", "scale_down"):
                sign = "+" if a["kind"] == "scale_up" else "-"
                acts.append(f"{sign}{len(a.get('nodes') or [])}n")
            elif a["kind"] == "defrag":
                acts.append(f"defrag:{a.get('n_moves', 0)}mv")
        lines.append(
            f"  {r['step']:>4} {r['t']:>8.6g}  "
            f"{_fmt_event(r.get('event') or {}):<28} {r['placed']:>7} "
            f"{r['pending']:>5} {r['lost']:>5} {r['active_nodes']:>6} "
            f"{r['cpu_pct']:>6.1f} {r['mem_pct']:>6.1f}  "
            f"{' '.join(acts)}")
    return "\n".join(lines)
