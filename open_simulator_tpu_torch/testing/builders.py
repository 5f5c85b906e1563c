"""Fixture builders with keyword options (reference: pkg/test/*.go), a
copy of the JAX package's ``open_simulator_tpu/testing/builders.py``, so
that tests build the same objects in both packages.

Every builder returns a typed object ready for ClusterResources /
simulate(). Defaults mirror the reference's (110-pod nodes, nginx-ish
single container).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

from open_simulator_tpu_torch.k8s import objects as k8s


def make_fake_node(
    name: str,
    cpu: str = "4",
    memory: str = "8Gi",
    pods: int = 110,
    labels: Optional[Dict[str, str]] = None,
    annotations: Optional[Dict[str, str]] = None,
    taints: Optional[List[Dict[str, Any]]] = None,
    unschedulable: bool = False,
    extra_allocatable: Optional[Dict[str, Any]] = None,
) -> k8s.Node:
    alloc: Dict[str, Any] = {"cpu": cpu, "memory": memory, "pods": str(pods)}
    alloc.update(extra_allocatable or {})
    return k8s.Node.from_dict({
        "apiVersion": "v1",
        "kind": "Node",
        "metadata": {"name": name, "labels": labels or {}, "annotations": annotations or {}},
        "spec": {"taints": taints or [], "unschedulable": unschedulable},
        "status": {"allocatable": alloc, "capacity": dict(alloc)},
    })


def _pod_spec(
    cpu: str,
    memory: str,
    image: str = "nginx:latest",
    node_selector: Optional[Dict[str, str]] = None,
    tolerations: Optional[List[Dict[str, Any]]] = None,
    affinity: Optional[Dict[str, Any]] = None,
    node_name: str = "",
    host_ports: Optional[List[int]] = None,
    topology_spread: Optional[List[Dict[str, Any]]] = None,
) -> Dict[str, Any]:
    spec: Dict[str, Any] = {
        "containers": [{
            "name": "main",
            "image": image,
            "resources": {"requests": {"cpu": cpu, "memory": memory}},
            "ports": [{"hostPort": p} for p in host_ports or []],
        }],
    }
    if node_selector:
        spec["nodeSelector"] = node_selector
    if tolerations:
        spec["tolerations"] = tolerations
    if affinity:
        spec["affinity"] = affinity
    if node_name:
        spec["nodeName"] = node_name
    if topology_spread:
        spec["topologySpreadConstraints"] = topology_spread
    return spec


def make_fake_pod(
    name: str,
    namespace: str = "default",
    cpu: str = "100m",
    memory: str = "128Mi",
    labels: Optional[Dict[str, str]] = None,
    annotations: Optional[Dict[str, str]] = None,
    **spec_kw,
) -> k8s.Pod:
    return k8s.Pod.from_dict({
        "apiVersion": "v1",
        "kind": "Pod",
        "metadata": {"name": name, "namespace": namespace,
                     "labels": labels or {}, "annotations": annotations or {}},
        "spec": _pod_spec(cpu, memory, **spec_kw),
    })


def _workload(
    kind: str,
    name: str,
    namespace: str,
    replicas: int,
    match_labels: Dict[str, str],
    cpu: str,
    memory: str,
    pod_labels: Optional[Dict[str, str]] = None,
    pod_annotations: Optional[Dict[str, str]] = None,
    **spec_kw,
) -> Dict[str, Any]:
    labels = dict(match_labels)
    labels.update(pod_labels or {})
    return {
        "apiVersion": "apps/v1" if kind not in ("Job", "CronJob") else "batch/v1",
        "kind": kind,
        "metadata": {"name": name, "namespace": namespace},
        "spec": {
            "replicas": replicas,
            "selector": {"matchLabels": match_labels},
            "template": {
                "metadata": {"labels": labels, "annotations": pod_annotations or {}},
                "spec": _pod_spec(cpu, memory, **spec_kw),
            },
        },
    }


def make_fake_deployment(name, namespace="default", replicas=1, match_labels=None,
                         cpu="100m", memory="128Mi", **kw) -> k8s.Deployment:
    return k8s.Deployment.from_dict(
        _workload("Deployment", name, namespace, replicas, match_labels or {"app": name}, cpu, memory, **kw)
    )


def make_fake_replicaset(name, namespace="default", replicas=1, match_labels=None,
                         cpu="100m", memory="128Mi", **kw) -> k8s.ReplicaSet:
    return k8s.ReplicaSet.from_dict(
        _workload("ReplicaSet", name, namespace, replicas, match_labels or {"app": name}, cpu, memory, **kw)
    )


def make_fake_statefulset(name, namespace="default", replicas=1, match_labels=None,
                          cpu="100m", memory="128Mi", **kw) -> k8s.StatefulSet:
    return k8s.StatefulSet.from_dict(
        _workload("StatefulSet", name, namespace, replicas, match_labels or {"app": name}, cpu, memory, **kw)
    )


def make_fake_daemonset(name, namespace="default", match_labels=None,
                        cpu="100m", memory="128Mi", **kw) -> k8s.DaemonSet:
    doc = _workload("DaemonSet", name, namespace, 0, match_labels or {"app": name}, cpu, memory, **kw)
    del doc["spec"]["replicas"]
    return k8s.DaemonSet.from_dict(doc)


def make_fake_job(name, namespace="default", completions=1, parallelism=1,
                  cpu="100m", memory="128Mi", **kw) -> k8s.Job:
    return k8s.Job.from_dict({
        "apiVersion": "batch/v1",
        "kind": "Job",
        "metadata": {"name": name, "namespace": namespace},
        "spec": {
            "completions": completions,
            "parallelism": parallelism,
            "template": {"spec": {**_pod_spec(cpu, memory, **kw), "restartPolicy": "Never"}},
        },
    })


def make_fake_cronjob(name, namespace="default", schedule="*/5 * * * *", completions=1,
                      cpu="100m", memory="128Mi", **kw) -> k8s.CronJob:
    return k8s.CronJob.from_dict({
        "apiVersion": "batch/v1",
        "kind": "CronJob",
        "metadata": {"name": name, "namespace": namespace},
        "spec": {
            "schedule": schedule,
            "jobTemplate": {"spec": {
                "completions": completions,
                "template": {"spec": {**_pod_spec(cpu, memory, **kw), "restartPolicy": "Never"}},
            }},
        },
    })
