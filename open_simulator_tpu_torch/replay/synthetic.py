"""Synthetic replay workloads (a copy of the reference's
``replay/synthetic.py``; chip_smoke.py and the tests use them).

Builds a deterministic "day in the cluster": an initial cluster with a
few running pods, arrival waves of Deployment batches, departures of
earlier waves, one mid-trace fault, and node-template headroom for the
autoscaler to scale into. Everything derives from fixed seeds so
smoke digests are comparable run to run.
"""

from __future__ import annotations

import textwrap
from typing import Any, Dict, Optional


def _node_yaml(cpu: str = "4", mem: str = "8Gi") -> str:
    return textwrap.dedent(f"""
        apiVersion: v1
        kind: Node
        metadata:
          name: template
          labels: {{"topology.kubernetes.io/zone": "z-sim"}}
        status:
          allocatable: {{cpu: "{cpu}", memory: {mem}, pods: "110"}}
    """).strip()


def _deployment_yaml(name: str, replicas: int, cpu_m: int,
                     mem_mi: int) -> str:
    return textwrap.dedent(f"""
        apiVersion: apps/v1
        kind: Deployment
        metadata: {{name: {name}, namespace: default}}
        spec:
          replicas: {replicas}
          selector: {{matchLabels: {{app: {name}}}}}
          template:
            metadata: {{labels: {{app: {name}}}}}
            spec:
              containers:
                - name: c
                  image: registry.local/r:1
                  resources:
                    requests: {{cpu: {cpu_m}m, memory: {mem_mi}Mi}}
    """).strip()


def synthetic_replay_cluster(n_nodes: int = 8, n_initial_pods: int = 8,
                             cpu_m: int = 4000, mem_mib: int = 8192):
    """A small deterministic cluster: zoned nodes + a few Running pods
    owned by a tolerant controller (so the descheduler may move them)."""
    from open_simulator_tpu_torch.k8s.loader import ClusterResources
    from open_simulator_tpu_torch.k8s.objects import Node, Pod

    cluster = ClusterResources()
    for i in range(n_nodes):
        cluster.nodes.append(Node.from_dict({
            "metadata": {"name": f"rn-{i}",
                         "labels": {"topology.kubernetes.io/zone":
                                    f"z{i % 2}"}},
            "status": {"allocatable": {"cpu": f"{cpu_m}m",
                                       "memory": f"{mem_mib}Mi",
                                       "pods": 110}},
        }))
    for i in range(n_initial_pods):
        cluster.pods.append(Pod.from_dict({
            "metadata": {"name": f"base-{i}", "namespace": "default",
                         "labels": {"app": "base"},
                         "ownerReferences": [{"kind": "ReplicaSet",
                                              "name": "base-rs",
                                              "controller": True}]},
            "spec": {
                "nodeName": f"rn-{i % n_nodes}",
                "containers": [{"name": "c", "resources": {"requests": {
                    "cpu": "500m", "memory": "512Mi"}}}],
            },
        }))
    return cluster


def synthetic_trace_dict(n_batches: int = 6, batch_pods: int = 8,
                         cpu_m: int = 900, mem_mi: int = 768,
                         depart_every: int = 3,
                         chaos_at: Optional[int] = None,
                         chaos_target: str = "rn-0",
                         max_new_nodes: int = 4) -> Dict[str, Any]:
    """A trace dict: one arrival per step, every ``depart_every``-th
    arrival followed by the departure of the oldest live batch, and one
    ``kill_node`` mid-trace (``chaos_at`` = the arrival index it fires
    before; default the middle wave). Sized so the arrivals overflow the
    initial cluster and the autoscaler must scale into the template
    slots to converge."""
    events = []
    t = 0.0
    live: list = []
    chaos_at = (n_batches // 2) if chaos_at is None else chaos_at
    chaos_placed = False
    for b in range(n_batches):
        if b == chaos_at:
            events.append({"t": t, "kind": "kill_node",
                           "target": chaos_target})
            chaos_placed = True
            t += 1.0
        name = f"wave-{b}"
        events.append({"t": t, "kind": "arrive", "app": {
            "name": name,
            "yaml": _deployment_yaml(name, batch_pods,
                                     cpu_m + 25 * (b % 4), mem_mi)}})
        live.append(name)
        t += 1.0
        if depart_every and (b + 1) % depart_every == 0 and len(live) > 1:
            events.append({"t": t, "kind": "depart", "app": live.pop(0)})
            t += 1.0
    if not chaos_placed:  # tiny traces: still get their fault
        events.append({"t": t, "kind": "kill_node",
                       "target": chaos_target})
    return {
        "events": events,
        "max_new_nodes": max_new_nodes,
        "node_template": _node_yaml(),
    }


def synthetic_frontier_specs(small_cost: float = 1.0,
                             big_cost: float = 2.25,
                             max_small: int = 4,
                             max_big: int = 2) -> list:
    """Two purchasable shapes whose cost/capacity trade produces a
    non-trivial Pareto set on the synthetic workloads."""
    return [
        {"name": "small", "cost": small_cost, "max_count": max_small,
         "spec_yaml": _node_yaml(cpu="4", mem="8Gi")},
        {"name": "big", "cost": big_cost, "max_count": max_big,
         "spec_yaml": _node_yaml(cpu="16", mem="32Gi")},
    ]
