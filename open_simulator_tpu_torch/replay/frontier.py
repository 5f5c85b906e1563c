"""Cost-aware capacity frontiers over heterogeneous node-spec mixes, on
the port's engine (the reference's ``replay/frontier.py``).

The capacity bisection answers "how many nodes of ONE spec" with a
single ``best_count``; real capacity teams choose among SEVERAL specs by
cost. This module sweeps the full mix grid — every (c_1..c_k) assignment
of counts to node specs, bounded per spec and optionally in total — as
the lanes of ``schedule_lanes`` launches (one lane per mix, the capacity
sweep's active-mask lanes), and returns the **Pareto set** over

    (cost: minimize, unplaced pods a.k.a. disruption: minimize,
     utilization: maximize)

instead of one count. Mix A dominates mix B iff cost_A <= cost_B,
unplaced_A <= unplaced_B and util_A >= util_B with at least one strict
inequality; the frontier is the non-dominated set, sorted by (cost,
unplaced, -util). ``dominates_on`` and ``pareto_front`` are the shared
dominance machinery the policy tune search (``tune/search.py``) reuses.

Spec clones are deterministically named (``sim-<spec>-<i>``), so mix
lane masks, reports and digests are stable across processes.
"""

from __future__ import annotations

import hashlib
import itertools
import json
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from open_simulator_tpu_torch.errors import SimulationError
from open_simulator_tpu_torch.replay.trace import (
    clone_template_nodes,
    parse_node_template,
)

# grid guardrail: the mix count multiplies device lanes; an unbounded
# request would wedge the single-flight worker (the MAX_CAPACITY_NEW_NODES
# lesson applied to the mix axis)
DEFAULT_MAX_MIXES = 2048
DEFAULT_LANE_WIDTH = 8


@dataclass(frozen=True)
class NodeSpec:
    """One purchasable node shape: a Node template plus its unit cost."""

    name: str
    cost: float
    max_count: int
    spec_yaml: str

    @classmethod
    def from_dict(cls, d: Dict[str, Any], index: int = 0) -> "NodeSpec":
        def err(msg: str, field_name: str, hint: str = ""):
            return SimulationError(msg, code="E_SPEC", ref="frontier",
                                   field=f"specs[{index}].{field_name}",
                                   hint=hint)

        if not isinstance(d, dict):
            raise SimulationError(
                f"spec must be an object, got {type(d).__name__}",
                code="E_SPEC", ref="frontier", field=f"specs[{index}]",
                hint='{"name": "small", "cost": 1.0, "max_count": 4, '
                     '"spec_yaml": "<Node yaml>"}')
        name = str(d.get("name") or "")
        if not name:
            raise err("spec needs a name", "name")
        try:
            cost = float(d.get("cost"))
        except (TypeError, ValueError):
            raise err(f"cost must be a number, got {d.get('cost')!r}",
                      "cost") from None
        if not (cost >= 0.0) or cost != cost or cost == float("inf"):
            raise err(f"cost must be finite and >= 0, got {cost}", "cost")
        try:
            max_count = int(d.get("max_count"))
        except (TypeError, ValueError):
            raise err(
                f"max_count must be an integer, got {d.get('max_count')!r}",
                "max_count") from None
        if max_count < 0:
            raise err(f"max_count must be >= 0, got {max_count}",
                      "max_count")
        spec_yaml = str(d.get("spec_yaml") or "")
        if not spec_yaml.strip():
            raise err("spec needs spec_yaml (a Node template)", "spec_yaml")
        return cls(name=name, cost=cost, max_count=max_count,
                   spec_yaml=spec_yaml)


def parse_specs(raw: Any) -> List[NodeSpec]:
    if not isinstance(raw, list) or not raw:
        raise SimulationError(
            "frontier needs a non-empty specs list", code="E_SPEC",
            ref="frontier", field="specs",
            hint='[{"name": ..., "cost": ..., "max_count": ..., '
                 '"spec_yaml": ...}, ...]')
    specs = [NodeSpec.from_dict(d, i) for i, d in enumerate(raw)]
    names = [s.name for s in specs]
    if len(set(names)) != len(names):
        raise SimulationError(
            f"spec names must be unique, got {names}", code="E_SPEC",
            ref="frontier", field="specs[].name")
    return specs


def _gen_mixes(specs: List[NodeSpec], max_total: Optional[int]):
    """Lazily yield valid mixes in lexicographic order, pruning by the
    remaining total budget — never iterates combinations the max_total
    cap excludes (a filtered itertools.product would)."""
    def rec(i: int, remaining: Optional[int]):
        if i == len(specs):
            yield ()
            return
        cap = (specs[i].max_count if remaining is None
               else min(specs[i].max_count, remaining))
        for c in range(cap + 1):
            nxt = None if remaining is None else remaining - c
            for rest in rec(i + 1, nxt):
                yield (c,) + rest

    return rec(0, None if max_total is None else max(0, int(max_total)))


def enumerate_mixes(specs: List[NodeSpec],
                    max_total: Optional[int] = None,
                    max_mixes: int = DEFAULT_MAX_MIXES
                    ) -> List[Tuple[int, ...]]:
    """The full mix grid, lexicographic, bounded: every per-spec count in
    [0, max_count], total optionally capped. Structured error past
    ``max_mixes`` — silent truncation would masquerade as exhaustive.
    The guardrail is enforced LAZILY (at most ``max_mixes + 1`` mixes
    are ever generated), so a request with max_count = 10**9 is a cheap
    structured 400, not an OOM on the single-flight worker."""
    mixes = list(itertools.islice(_gen_mixes(specs, max_total),
                                  max_mixes + 1))
    if len(mixes) > max_mixes:
        raise SimulationError(
            f"mix grid exceeds the {max_mixes}-combination cap",
            code="E_SPEC", ref="frontier",
            field="specs[].max_count",
            hint="lower max_count/max_total, or raise max_mixes if you "
                 "really want a grid this large")
    return mixes


def dominates_on(a: Dict[str, Any], b: Dict[str, Any],
                 minimize: Tuple[str, ...] = (),
                 maximize: Tuple[str, ...] = ()) -> bool:
    """Generic dominance over named objective keys: ``a`` dominates
    ``b`` iff it is no worse on every objective and strictly better on
    at least one. The node-mix frontier below instantiates it with
    (cost, unplaced | util_pct); the scheduler-policy tune search
    (tune/search.py) reuses it with (unplaced, cost, disruption)."""
    if not all(a[k] <= b[k] for k in minimize):
        return False
    if not all(a[k] >= b[k] for k in maximize):
        return False
    return (any(a[k] < b[k] for k in minimize)
            or any(a[k] > b[k] for k in maximize))


def pareto_front(points: List[Dict[str, Any]],
                 minimize: Tuple[str, ...] = (),
                 maximize: Tuple[str, ...] = (),
                 sort_key=None) -> List[Dict[str, Any]]:
    """The non-dominated subset under ``dominates_on`` (O(W^2), the same
    brute-force definition the tier-1 tests re-verify independently)."""
    front = [p for p in points
             if not any(dominates_on(q, p, minimize, maximize)
                        for q in points)]
    return sorted(front, key=sort_key) if sort_key is not None else front


def dominates(a: Dict[str, Any], b: Dict[str, Any]) -> bool:
    """The frontier dominance rule (cheaper, no more disruption, at
    least as utilized — with something strictly better)."""
    return dominates_on(a, b, minimize=("cost", "unplaced"),
                        maximize=("util_pct",))


def pareto_set(points: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    return pareto_front(
        points, minimize=("cost", "unplaced"), maximize=("util_pct",),
        sort_key=lambda p: (p["cost"], p["unplaced"], -p["util_pct"],
                            p["counts"]))


def capacity_frontier(cluster, apps, specs: List[NodeSpec],
                      max_total: Optional[int] = None,
                      lane_width: int = DEFAULT_LANE_WIDTH,
                      max_mixes: int = DEFAULT_MAX_MIXES,
                      config_overrides: Optional[Dict[str, Any]] = None,
                      validate: bool = True, device=None) -> Dict[str, Any]:
    """Sweep every node-spec mix and return all points + the Pareto set
    (the reference's ``capacity_frontier``).

    One encode for the whole grid (the cluster's nodes, then each spec's
    clones); the mixes run ``lane_width`` lanes a round through
    ``schedule_lanes`` on `device` (None = the card), the tail round padded
    by repeating its last mix so every round has one shape, and each
    round's carry is the next round's output buffer."""
    from open_simulator_tpu_torch.core import (
        _with_nodes,
        build_pod_sequence,
        with_volume_objects,
    )
    from open_simulator_tpu_torch.encode.snapshot import encode_cluster
    from open_simulator_tpu_torch.engine.scheduler import make_config, schedule_lanes
    from open_simulator_tpu_torch.k8s.loader import make_valid_node
    from open_simulator_tpu_torch.resilience import lifecycle

    nodes = [make_valid_node(n) for n in cluster.nodes]
    cluster = _with_nodes(cluster, nodes)
    apps = list(apps)
    if validate:
        from open_simulator_tpu_torch.resilience.admission import admit

        admit(cluster, apps)
    mixes = enumerate_mixes(specs, max_total=max_total, max_mixes=max_mixes)
    lane_width = max(1, min(int(lane_width), len(mixes)))

    # spec clone ranges follow the real nodes, one contiguous block per
    # spec, deterministically named
    all_nodes = list(nodes)
    ranges: List[Tuple[int, int]] = []
    for s in specs:
        template = parse_node_template(s.spec_yaml)
        start = len(all_nodes)
        all_nodes += clone_template_nodes(template, s.max_count, prefix=f"sim-{s.name}")
        ranges.append((start, len(all_nodes)))
    pods = build_pod_sequence(cluster, apps)
    snapshot = encode_cluster(all_nodes, pods, with_volume_objects(None, cluster, apps))
    cfg = make_config(snapshot, **dict(config_overrides or {}))._replace(fail_reasons=False)
    n_pods = snapshot.n_pods
    base_active = np.zeros(snapshot.n_nodes, dtype=bool)
    base_active[: len(nodes)] = np.asarray(snapshot.arrays.active)[: len(nodes)]

    def mask_for(mix: Tuple[int, ...]) -> np.ndarray:
        m = base_active.copy()
        for (start, _), c in zip(ranges, mix):
            m[start: start + c] = True
        return m

    alloc = np.asarray(snapshot.arrays.alloc)
    cpu_i = snapshot.resources.index("cpu")
    mem_i = snapshot.resources.index("memory")
    points: List[Dict[str, Any]] = []
    carry = None
    for lo in range(0, len(mixes), lane_width):
        # the deadline/drain boundary: a cancelled request stops between
        # lane rounds with the computed points as partials
        lifecycle.check_current(
            "frontier round boundary",
            partial=lambda: {"mixes_done": len(points), "mixes_total": len(mixes)})
        chunk = list(mixes[lo: lo + lane_width])
        padded = chunk + [chunk[-1]] * (lane_width - len(chunk))
        masks = np.stack([mask_for(m) for m in padded])
        out = schedule_lanes(snapshot.arrays, masks, cfg, device=device, carry=carry)
        nodes_out = out.node.cpu().numpy()[:, :n_pods]
        headroom = out.state.headroom.cpu().numpy()
        carry = out.state
        for li, mix in enumerate(chunk):
            used = alloc - headroom[li]
            act = masks[li]

            def pct(ri: int) -> float:
                tot = float(np.sum(alloc[act, ri]))
                return 100.0 * float(np.sum(used[act, ri])) / tot if tot else 0.0

            cpu_pct, mem_pct = pct(cpu_i), pct(mem_i)
            points.append({
                "mix": {s.name: int(c) for s, c in zip(specs, mix)},
                "counts": list(int(c) for c in mix),
                "cost": round(float(sum(c * s.cost for s, c in zip(specs, mix))), 6),
                "unplaced": int(np.sum(nodes_out[li] < 0)),
                "cpu_pct": round(cpu_pct, 3),
                "mem_pct": round(mem_pct, 3),
                "util_pct": round((cpu_pct + mem_pct) / 2.0, 3),
                "nodes": int(np.sum(act)),
            })
    front = pareto_set(points)
    digest = hashlib.sha256(json.dumps(points, sort_keys=True).encode()).hexdigest()[:16]
    return {
        "specs": [{"name": s.name, "cost": s.cost, "max_count": s.max_count} for s in specs],
        "n_mixes": len(mixes),
        "n_pods": int(n_pods),
        "max_total": max_total,
        "points": points,
        "pareto": front,
        "digest": digest,
    }


def format_frontier(result: Dict[str, Any]) -> str:
    names = [s["name"] for s in result["specs"]]
    lines = [
        f"capacity frontier: {result['n_mixes']} mix(es) over specs "
        f"{', '.join(names)} -> {len(result['pareto'])} Pareto point(s) "
        f"(digest {result['digest']})",
        f"  {'MIX':<24} {'COST':>8} {'UNPLACED':>9} {'UTIL%':>7} "
        f"{'CPU%':>6} {'MEM%':>6} {'NODES':>6}",
    ]
    for p in result["pareto"]:
        mix = "+".join(f"{p['mix'][n]}x{n}" for n in names)
        lines.append(
            f"  {mix:<24} {p['cost']:>8.2f} {p['unplaced']:>9} "
            f"{p['util_pct']:>7.1f} {p['cpu_pct']:>6.1f} "
            f"{p['mem_pct']:>6.1f} {p['nodes']:>6}")
    return "\n".join(lines)
