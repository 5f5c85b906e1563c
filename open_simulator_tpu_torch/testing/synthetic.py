"""Synthetic clusters (a copy of the reference's, plus the soft-spread
cluster the card's smoke run and the parity tests share).

rich=False is the round-1..3-comparable workload (cpu/mem requests + one
soft zone spread — most feature gates autodetect OFF). rich=True is the
honest all-ops-on workload: fractions of pods carry host ports, required
pod-affinity, anti-affinity, hard and hostname spread, preferred pod/node
affinities, node selectors and tolerations, and fractions of nodes carry
taints / unschedulable marks — so make_config keeps every feature gate ON
and a bench pays for the full op pipeline (VERDICT r3: gates must not
hide regressions).
"""

from __future__ import annotations

import json

import numpy as np


def synthetic_snapshot(n_nodes: int = 64, n_pods: int = 256, max_new: int = 0,
                       rich: bool = False, pools: int = 0,
                       bound: float = 0.0):
    """The reference's synthetic snapshot: ``synthetic_objects`` encoded,
    with `max_new` template node slots."""
    from open_simulator_tpu_torch.encode.snapshot import EncodeOptions, encode_cluster

    nodes, pods, template = synthetic_objects(n_nodes, n_pods, rich=rich,
                                              pools=pools, bound=bound)
    opts = None
    if max_new:
        opts = EncodeOptions(max_new_nodes=max_new, new_node_template=template)
    return encode_cluster(nodes, pods, opts)


def synthetic_objects(n_nodes: int = 64, n_pods: int = 256, rich: bool = False,
                      pools: int = 0, bound: float = 0.0):
    """(nodes, pods, new-node template) of the synthetic cluster — what
    ``simulate()`` takes, so the smoke run can drive the entry point a
    user calls on the same cluster the snapshot encodes.

    pools > 0 labels nodes into `pools` tenant pools and gives every
    pod a matching nodeSelector (+ per-pool app groups) — the
    multi-tenant shape whose disjoint footprints the wave scheduler
    (engine/waves.py) batches. bound > 0 pre-binds that fraction of pods
    via spec.nodeName, interleaved through the sequence — the
    cluster-dump replay shape. Both default off and leave the rich /
    non-rich workloads byte-identical to the tracked bench series."""
    from open_simulator_tpu_torch.k8s.objects import Node, Pod

    rng = np.random.RandomState(0)
    app_mod = pools if pools > 0 else 8

    def mk_node(name, i=0):
        labels = {"topology.kubernetes.io/zone": f"z{rng.randint(4)}"}
        spec = {}
        if pools > 0:
            labels["pool"] = f"p{i % pools}"
        if rich:
            if i % 2 == 0:
                labels["disk"] = "ssd"
            if i % 16 == 7:
                spec["taints"] = [{"key": "dedicated", "value": "infra",
                                   "effect": "NoSchedule"}]
            if i % 8 == 3:
                spec.setdefault("taints", []).append(
                    {"key": "degraded", "effect": "PreferNoSchedule"})
            if i % 64 == 33:
                spec["unschedulable"] = True
        return Node.from_dict({
            "metadata": {"name": name, "labels": labels},
            "status": {"allocatable": {"cpu": "16", "memory": "64Gi", "pods": 110}},
            "spec": spec,
        })

    def mk_pod(i):
        labels = {"app": f"a{i % app_mod}"}
        spread = [{
            "maxSkew": 5,
            "topologyKey": "topology.kubernetes.io/zone",
            "whenUnsatisfiable": "ScheduleAnyway",
            "labelSelector": {"matchLabels": {"app": f"a{i % app_mod}"}},
        }]
        spec = {
            "containers": [{
                "name": "c",
                "resources": {"requests": {
                    "cpu": f"{rng.randint(100, 2000)}m",
                    "memory": f"{rng.randint(64, 2048)}Mi",
                }},
            }],
            "topologySpreadConstraints": spread,
        }
        if pools > 0:
            spec["nodeSelector"] = {"pool": f"p{i % pools}"}
        if bound > 0.0 and (i * 7919) % 100 < int(bound * 100):
            # deterministic interleave of already-bound pods (a recorded
            # cluster dump replays placed pods mid-sequence)
            spec["nodeName"] = f"n{(i * 31) % n_nodes}"
        if rich:
            labels["anti"] = f"g{i % 97}"
            if i % 17 == 0:
                spec["containers"][0]["ports"] = [{"hostPort": 8000 + i % 5}]
            if i % 9 == 0:
                spec["nodeSelector"] = {"disk": "ssd"}
            if i % 16 == 0:
                spec["tolerations"] = [{"key": "dedicated", "operator": "Equal",
                                        "value": "infra", "effect": "NoSchedule"}]
            if i % 7 == 0:
                spread.append({
                    "maxSkew": 3,
                    "topologyKey": "topology.kubernetes.io/zone",
                    "whenUnsatisfiable": "DoNotSchedule",
                    "labelSelector": {"matchLabels": {"app": f"a{i % app_mod}"}},
                })
            if i % 19 == 0:
                spread.append({
                    "maxSkew": 4,
                    "topologyKey": "kubernetes.io/hostname",
                    "whenUnsatisfiable": "ScheduleAnyway",
                    "labelSelector": {"matchLabels": {"app": f"a{i % app_mod}"}},
                })
            affinity = {}
            if i % 13 == 0:
                affinity["podAffinity"] = {
                    "requiredDuringSchedulingIgnoredDuringExecution": [{
                        "labelSelector": {"matchLabels": {"app": f"a{i % app_mod}"}},
                        "topologyKey": "topology.kubernetes.io/zone",
                    }],
                }
            if i % 11 == 0:
                affinity["podAntiAffinity"] = {
                    "requiredDuringSchedulingIgnoredDuringExecution": [{
                        "labelSelector": {"matchLabels": {"anti": f"g{i % 97}"}},
                        "topologyKey": "kubernetes.io/hostname",
                    }],
                }
            if i % 5 == 0:
                affinity.setdefault("podAffinity", {})[
                    "preferredDuringSchedulingIgnoredDuringExecution"] = [{
                        "weight": 10,
                        "podAffinityTerm": {
                            "labelSelector": {"matchLabels": {"app": f"a{(i + 1) % app_mod}"}},
                            "topologyKey": "topology.kubernetes.io/zone",
                        },
                    }]
            if i % 6 == 0:
                affinity["nodeAffinity"] = {
                    "preferredDuringSchedulingIgnoredDuringExecution": [{
                        "weight": 5,
                        "preference": {"matchExpressions": [
                            {"key": "disk", "operator": "In", "values": ["ssd"]},
                        ]},
                    }],
                }
            if affinity:
                spec["affinity"] = affinity
        return Pod.from_dict({
            "metadata": {"name": f"p{i}", "namespace": "default", "labels": labels},
            "spec": spec,
        })

    nodes = [mk_node(f"n{i}", i) for i in range(n_nodes)]
    pods = [mk_pod(i) for i in range(n_pods)]
    return nodes, pods, mk_node("template")


def soft_spread_cluster(n_nodes: int, n_pods: int, seed: int = 0,
                        hostname: bool = True):
    """(node dicts, pod dicts) for ``Node.from_dict`` / ``Pod.from_dict``:
    a cluster on the ported step's ops only. Nodes carry zone and region
    labels (a few lack them), some NoSchedule / PreferNoSchedule taints,
    some are unschedulable. Pods spread ScheduleAnyway over zone and
    region, and with `hostname` a third of them over the hostname too
    (the group_count carry; without it the dom_count carry with two
    non-hostname keys). Pods carry host ports, node selectors,
    tolerations and preferred node affinity; a leading run and a sprinkle
    of pods are pre-bound through spec.nodeName (one to a missing node),
    and a few pods are too large for any node. Dicts, so each package
    builds its own objects from the same data."""
    rng = np.random.RandomState(seed)
    nodes = []
    for i in range(n_nodes):
        labels = {}
        if i % 37 != 5:
            labels["topology.kubernetes.io/zone"] = f"z{rng.randint(4)}"
            labels["topology.kubernetes.io/region"] = f"r{i % 2}"
        if i % 2 == 0:
            labels["disk"] = "ssd"
        spec = {}
        if i % 16 == 7:
            spec["taints"] = [{"key": "dedicated", "value": "infra", "effect": "NoSchedule"}]
        if i % 8 == 3:
            spec.setdefault("taints", []).append({"key": "degraded", "effect": "PreferNoSchedule"})
        if i % 64 == 33:
            spec["unschedulable"] = True
        nodes.append({
            "metadata": {"name": f"n{i}", "labels": labels},
            "status": {"allocatable": {"cpu": "16", "memory": "64Gi", "pods": 110}},
            "spec": spec,
        })
    lead = min(n_pods // 16, n_nodes)
    pods = []
    for i in range(n_pods):
        app = f"a{i % 8}"
        sel = {"matchLabels": {"app": app}}
        spread = [{"maxSkew": 3, "topologyKey": "topology.kubernetes.io/zone",
                   "whenUnsatisfiable": "ScheduleAnyway", "labelSelector": sel}]
        if i % 5 == 0:
            spread.append({"maxSkew": 2, "topologyKey": "topology.kubernetes.io/region",
                           "whenUnsatisfiable": "ScheduleAnyway", "labelSelector": sel})
        if hostname and i % 3 == 0:
            spread.append({"maxSkew": 1, "topologyKey": "kubernetes.io/hostname",
                           "whenUnsatisfiable": "ScheduleAnyway", "labelSelector": sel})
        cpu = "20" if i % 101 == 50 else f"{rng.randint(100, 2000)}m"
        container = {"name": "c", "resources": {"requests": {
            "cpu": cpu, "memory": f"{rng.randint(64, 2048)}Mi"}}}
        if i % 13 == 0:
            container["ports"] = [{"hostPort": 8000 + i % 3}]
        spec = {"containers": [container], "topologySpreadConstraints": spread}
        if i < lead or i % 97 == 40:
            spec["nodeName"] = f"n{(i * 31) % n_nodes}"
        elif i % 211 == 100:
            spec["nodeName"] = "missing-node"
        if i % 9 == 0:
            spec["nodeSelector"] = {"disk": "ssd"}
        if i % 16 == 0:
            spec["tolerations"] = [{"key": "dedicated", "operator": "Equal",
                                    "value": "infra", "effect": "NoSchedule"}]
        if i % 6 == 0:
            spec["affinity"] = {"nodeAffinity": {
                "preferredDuringSchedulingIgnoredDuringExecution": [{
                    "weight": 5, "preference": {"matchExpressions": [
                        {"key": "disk", "operator": "In", "values": ["ssd"]}]}}]}}
        pods.append({"metadata": {"name": f"p{i}", "namespace": "default",
                                  "labels": {"app": app}},
                     "spec": spec})
    return nodes, pods


EBS_LIMIT_KEY = "attachable-volumes-csi-ebs.csi.aws.com"
# kube-scheduler 1.23's DefaultMaxEBSNitroVolumeLimit
EBS_NITRO_LIMIT = 25
_GIB = 1 << 30


def device_resource_manifests(n_nodes: int, n_pods: int, seed: int = 0, rich: bool = False):
    """The device-resource cluster: plain manifest dicts (Nodes, Pods,
    PersistentVolumeClaims, PersistentVolumes, one StorageClass), so each
    package builds its own objects through ``demux_object``.

    Nodes, by index i (the repository's examples, at scale):

    * i % 4 == 0: GPU-share nodes, alternating 8 x 32 GiB (64 CPU,
      256 Gi) and 4 x 16 GiB (32 CPU, 128 Gi) (``cluster/gpushare``);
    * i % 4 == 1: open-local nodes with VGs of 100 and 50 GiB and devices
      of 100 GiB hdd and 200 GiB ssd (``cluster/open-local/store-a.json``)
      and two local PVs each, 20 and 100 GiB, on a no-provisioner
      WaitForFirstConsumer class with hostname node affinity
      (``cluster/stateful``);
    * the rest: 16 CPU / 64 Gi workers; every 64th node (i % 64 == 2) is
      already at its 25 EBS attachments: five pods bound to it by
      ``spec.nodeName`` mount five EBS claims each.

    Every node declares the EBS CSI attach limit of 25 and carries a zone
    label (both the well-known key and the EBS driver's topology key).

    Pods, after the bound ones, all with ``synthetic_objects``' cpu and
    memory requests and its soft zone spread:

    * i % 5 == 0 (20%): GPU share, 4-16 GiB per device; one in ten asks
      for 2 or 4 devices; one in a hundred is bound to a GPU node with a
      pinned ``gpu-index``;
    * i % 20 == 1 (5%): one or two open-local LVM volumes of 5-40 GiB;
    * i % 50 == 11 (2%): an exclusive hdd (20-100 GiB) or ssd (50-200
      GiB) device;
    * i % 25 == 3 (4%): a StatefulSet replica with one
      WaitForFirstConsumer claim (5-20 GiB, so any local PV holds it) on
      the local class;
    * i % 20 == 7 (5%): a bound EBS claim whose PV is zonal (half pinned
      by the CSI driver's node affinity, half by the zone label); a
      quarter of them share their claim with the next such pod.

    The groups are disjoint, apart from LVM pods that also take a device
    (no GPU node holds local storage), and sized so that every pod fits
    the cluster as it is: a capacity plan adds GPU nodes, which bring no
    local storage or PVs.

    rich=True adds ``synthetic_objects``' inter-pod constraints to the
    unbound pods, so that both slices' gates are on: an ``anti`` label
    on every pod; i % 11 == 0, a required hostname anti-affinity term
    over its ``anti`` group; i % 13 == 0, a required zone pod affinity
    over its app; i % 7 == 0, a hard zone spread (maxSkew 3); i % 6 ==
    0, a preferred zone pod affinity (weight 10) toward the next app.
    """
    rng = np.random.RandomState(seed)
    zone_key, ebs_zone_key = "topology.kubernetes.io/zone", "topology.ebs.csi.aws.com/zone"
    objs, pods, pvcs, pvs = [], [], [], []
    zones = [f"z{rng.randint(4)}" for _ in range(n_nodes)]

    def local_pv(name, node, gib):
        return {"apiVersion": "v1", "kind": "PersistentVolume",
                "metadata": {"name": name},
                "spec": {"capacity": {"storage": f"{gib}Gi"}, "accessModes": ["ReadWriteOnce"],
                         "storageClassName": "local-disks",
                         "nodeAffinity": {"required": {"nodeSelectorTerms": [{
                             "matchExpressions": [{"key": "kubernetes.io/hostname",
                                                   "operator": "In", "values": [node]}]}]}}},
                "status": {"phase": "Available"}}

    def ebs_claim(claim, zone, by_affinity):
        pv = {"apiVersion": "v1", "kind": "PersistentVolume",
              "metadata": {"name": f"pv-{claim}", "labels": {}},
              "spec": {"capacity": {"storage": "50Gi"}, "accessModes": ["ReadWriteOnce"],
                       "storageClassName": "ebs-gp3",
                       "csi": {"driver": "ebs.csi.aws.com", "volumeHandle": f"vol-{claim}"},
                       "claimRef": {"namespace": "default", "name": claim}},
              "status": {"phase": "Bound"}}
        if by_affinity:
            pv["spec"]["nodeAffinity"] = {"required": {"nodeSelectorTerms": [{
                "matchExpressions": [{"key": ebs_zone_key, "operator": "In",
                                      "values": [zone]}]}]}}
        else:
            pv["metadata"]["labels"][zone_key] = zone
        pvs.append(pv)
        pvcs.append({"apiVersion": "v1", "kind": "PersistentVolumeClaim",
                     "metadata": {"name": claim, "namespace": "default"},
                     "spec": {"accessModes": ["ReadWriteOnce"], "storageClassName": "ebs-gp3",
                              "resources": {"requests": {"storage": "50Gi"}},
                              "volumeName": f"pv-{claim}"},
                     "status": {"phase": "Bound"}})

    nodes = []
    for i in range(n_nodes):
        name = f"n{i}"
        labels = {zone_key: zones[i], ebs_zone_key: zones[i], "kubernetes.io/hostname": name}
        alloc = {"cpu": "16", "memory": "64Gi", "pods": 110, EBS_LIMIT_KEY: EBS_NITRO_LIMIT}
        annotations = {}
        if i % 4 == 0:
            big = (i // 4) % 2 == 0
            alloc.update({"cpu": "64" if big else "32", "memory": "256Gi" if big else "128Gi",
                          "alibabacloud.com/gpu-count": "8" if big else "4",
                          "alibabacloud.com/gpu-mem": "256" if big else "64"})
            labels["alibabacloud.com/gpu-card-model"] = "A100" if big else "T4"
        elif i % 4 == 1:
            annotations["simon.tpu/node-local-storage"] = json.dumps({
                "vgs": [{"name": "pool0", "capacity": str(100 * _GIB), "requested": "0"},
                        {"name": "pool1", "capacity": str(50 * _GIB), "requested": "0"}],
                "devices": [{"name": "/dev/vdb", "device": "/dev/vdb",
                             "capacity": str(100 * _GIB), "mediaType": "hdd",
                             "isAllocated": "false"},
                            {"name": "/dev/vdc", "device": "/dev/vdc",
                             "capacity": str(200 * _GIB), "mediaType": "ssd",
                             "isAllocated": "false"}]})
            pvs.append(local_pv(f"local-{name}-small", name, 20))
            pvs.append(local_pv(f"local-{name}-big", name, 100))
        nodes.append({"apiVersion": "v1", "kind": "Node",
                      "metadata": {"name": name, "labels": labels, "annotations": annotations},
                      "status": {"allocatable": alloc}})

    def container(cpu=None, mem=None):
        return {"name": "c", "resources": {"requests": {
            "cpu": cpu or f"{rng.randint(100, 2000)}m",
            "memory": mem or f"{rng.randint(64, 2048)}Mi"}}}

    # the bound EBS-heavy pods come first (a cluster dump lists placed pods)
    for i in range(2, n_nodes, 64):
        for k in range(5):
            claims = [f"heavy-{i}-{k}-{v}" for v in range(5)]
            for c in claims:
                ebs_claim(c, zones[i], by_affinity=True)
            pods.append({"apiVersion": "v1", "kind": "Pod",
                         "metadata": {"name": f"gw-{i}-{k}", "namespace": "default",
                                      "labels": {"app": "ebs-gateway"}},
                         "spec": {"nodeName": f"n{i}",
                                  "containers": [container("100m", "128Mi")],
                                  "volumes": [{"name": f"v{v}",
                                               "persistentVolumeClaim": {"claimName": c}}
                                              for v, c in enumerate(claims)]}})
    gpu_nodes = list(range(0, n_nodes, 4))
    ebs_shared = None
    for i in range(n_pods - len(pods)):
        app = f"a{i % 8}"
        spec = {"containers": [container()],
                "topologySpreadConstraints": [{
                    "maxSkew": 5, "topologyKey": zone_key,
                    "whenUnsatisfiable": "ScheduleAnyway",
                    "labelSelector": {"matchLabels": {"app": app}}}]}
        meta = {"name": f"p{i}", "namespace": "default", "labels": {"app": app},
                "annotations": {}}
        if i % 5 == 0:
            cnt = 1 if (i // 5) % 10 else int(rng.choice([2, 4]))
            meta["annotations"]["alibabacloud.com/gpu-mem"] = str(rng.randint(4, 17))
            if cnt > 1:
                meta["annotations"]["alibabacloud.com/gpu-count"] = str(cnt)
            if (i // 5) % 100 == 37:
                node = gpu_nodes[(i * 7) % len(gpu_nodes)]
                spec["nodeName"] = f"n{node}"
                meta["annotations"]["alibabacloud.com/gpu-index"] = "-".join(
                    str((i + d) % 4) for d in range(cnt))
        volumes = []
        if i % 20 == 1:
            volumes += [{"size": str(int(rng.randint(5, 41)) * _GIB), "kind": "LVM",
                         "scName": "open-local-lvm"} for _ in range(1 + (i // 20) % 4 // 3)]
        if i % 50 == 11:
            ssd = (i // 50) % 2 == 1
            gib = int(rng.randint(50, 201)) if ssd else int(rng.randint(20, 101))
            volumes.append({"size": str(gib * _GIB), "kind": "SSD" if ssd else "HDD",
                            "scName": "open-local-device-ssd" if ssd else "open-local-device-hdd"})
        if volumes:
            meta["annotations"]["simon.tpu/pod-local-storage"] = json.dumps({"volumes": volumes})
        if rich:
            _add_interpod_terms(i, meta, spec)
        claims = []
        if i % 25 == 3:
            sts = f"db{i % 7}"
            meta["name"] = f"{sts}-{i}"
            meta["labels"]["statefulset.kubernetes.io/pod-name"] = meta["name"]
            claim = f"data-{meta['name']}"
            pvcs.append({"apiVersion": "v1", "kind": "PersistentVolumeClaim",
                         "metadata": {"name": claim, "namespace": "default"},
                         "spec": {"accessModes": ["ReadWriteOnce"],
                                  "storageClassName": "local-disks",
                                  "resources": {"requests": {
                                      "storage": f"{int(rng.randint(5, 21))}Gi"}}}})
            claims.append(claim)
        if i % 20 == 7:
            if ebs_shared is not None:
                claims.append(ebs_shared)
                ebs_shared = None
            else:
                claim = f"ebs-{i}"
                ebs_claim(claim, f"z{(i // 20) % 4}", by_affinity=(i // 20) % 2 == 0)
                claims.append(claim)
                if (i // 20) % 4 == 1:
                    ebs_shared = claim
        if claims:
            spec["volumes"] = [{"name": f"v{k}", "persistentVolumeClaim": {"claimName": c}}
                               for k, c in enumerate(claims)]
        pods.append({"apiVersion": "v1", "kind": "Pod", "metadata": meta, "spec": spec})
    objs.append({"apiVersion": "storage.k8s.io/v1", "kind": "StorageClass",
                 "metadata": {"name": "local-disks"},
                 "provisioner": "kubernetes.io/no-provisioner",
                 "volumeBindingMode": "WaitForFirstConsumer"})
    return nodes + pods + pvcs + pvs + objs


def _add_interpod_terms(i: int, meta: dict, spec: dict) -> None:
    """The rich pod shapes' inter-pod constraints on pod `i` (see
    ``device_resource_manifests``)."""
    app = meta["labels"]["app"]
    meta["labels"]["anti"] = f"g{i % 97}"
    zone = "topology.kubernetes.io/zone"
    affinity = {}
    if i % 11 == 0:
        affinity["podAntiAffinity"] = {"requiredDuringSchedulingIgnoredDuringExecution": [{
            "labelSelector": {"matchLabels": {"anti": f"g{i % 97}"}},
            "topologyKey": "kubernetes.io/hostname"}]}
    if i % 13 == 0:
        affinity["podAffinity"] = {"requiredDuringSchedulingIgnoredDuringExecution": [{
            "labelSelector": {"matchLabels": {"app": app}}, "topologyKey": zone}]}
    if i % 6 == 0:
        affinity.setdefault("podAffinity", {})[
            "preferredDuringSchedulingIgnoredDuringExecution"] = [{
                "weight": 10, "podAffinityTerm": {
                    "labelSelector": {"matchLabels": {"app": f"a{(i + 1) % 8}"}},
                    "topologyKey": zone}}]
    if affinity:
        spec["affinity"] = affinity
    if i % 7 == 0:
        spec["topologySpreadConstraints"].append({
            "maxSkew": 3, "topologyKey": zone, "whenUnsatisfiable": "DoNotSchedule",
            "labelSelector": {"matchLabels": {"app": app}}})


# the new-node template of examples/newnode/gpu.yaml
GPU_NODE_TEMPLATE = {
    "apiVersion": "v1", "kind": "Node",
    "metadata": {"name": "gpu-template",
                 "labels": {"kubernetes.io/os": "linux",
                            "alibabacloud.com/gpu-card-model": "A100"}},
    "status": {"allocatable": {"cpu": "64", "memory": "256Gi", "pods": "110",
                               "alibabacloud.com/gpu-count": "8",
                               "alibabacloud.com/gpu-mem": "256"}},
}


def device_resource_cluster(n_nodes: int, n_pods: int, seed: int = 0, rich: bool = False):
    """``device_resource_manifests`` loaded into this package's
    ClusterResources (what ``simulate()`` takes)."""
    from open_simulator_tpu_torch.k8s.loader import ClusterResources, demux_object

    cluster = ClusterResources()
    for doc in device_resource_manifests(n_nodes, n_pods, seed, rich):
        demux_object(doc, cluster)
    return cluster


def device_resource_snapshot(n_nodes: int, n_pods: int, max_new: int = 0, seed: int = 0,
                             rich: bool = False):
    """The device-resource cluster encoded as ``simulate()`` encodes it,
    with `max_new` slots of the GPU node template (rich: with the
    inter-pod constraints too)."""
    from open_simulator_tpu_torch.core import build_pod_sequence, with_volume_objects
    from open_simulator_tpu_torch.encode.snapshot import EncodeOptions, encode_cluster
    from open_simulator_tpu_torch.k8s.loader import make_valid_node
    from open_simulator_tpu_torch.k8s.objects import Node

    cluster = device_resource_cluster(n_nodes, n_pods, seed, rich)
    cluster.nodes = [make_valid_node(n) for n in cluster.nodes]
    opts = EncodeOptions()
    if max_new:
        opts = EncodeOptions(max_new_nodes=max_new, new_node_template=make_valid_node(
            Node.from_dict(GPU_NODE_TEMPLATE)))
    pods = build_pod_sequence(cluster, [])
    return encode_cluster(cluster.nodes, pods, with_volume_objects(opts, cluster, []))


def preemption_columns(forced_node: np.ndarray, active: np.ndarray, seed: int = 0):
    """Random ``disabled`` [P] bool / ``nominated`` [P] i32 preemption
    columns over a pod sequence (`forced_node` [P]) and an [N] active
    mask, with every edge the step must handle: about 5% victims and 20%
    nominations, among them -1, a negative value, past-the-end values,
    the first and last node, inactive (infeasible) nodes, half the forced
    pods and half the victims."""
    rng = np.random.RandomState(seed)
    n_pods, n = len(forced_node), len(active)
    disabled = rng.rand(n_pods) < 0.05
    nominated = np.where(rng.rand(n_pods) < 0.2, rng.randint(0, n, n_pods), -1).astype(np.int32)
    order = rng.permutation(n_pods)
    nominated[order[:6]] = [n, n + 3, -1, -7, n - 1, 0]
    off = np.flatnonzero(~np.asarray(active, dtype=bool))
    if len(off):
        nominated[order[6:12]] = off[rng.randint(0, len(off), 6)]
    forced = np.flatnonzero(np.asarray(forced_node) >= 0)
    nominated[forced[::2]] = rng.randint(0, n, len(forced[::2]))
    victims = np.flatnonzero(disabled)
    nominated[victims[::2]] = rng.randint(0, n, len(victims[::2]))
    return disabled, nominated


def wave_pools_objects(n_nodes: int, n_pods: int, pools: int, gpu: bool = False,
                       interpod: bool = False):
    """(nodes, pods) of a multi-tenant cluster whose pods the wave planner
    batches: `pools` node pools, pod i pinned to pool i % pools by its
    nodeSelector and labelled with its pool's app and anti groups, so
    consecutive pods of different pools are carry-independent (a GRID of
    width `pools`). gpu: every node has 4 GPUs of 32 GiB and every pod asks
    for 1 or 2 of 2-6 GiB (GPU share inside waves). interpod: every pod
    softly spreads its app over hostnames and prefers its app's zone
    (weight 7), and one pod in four keeps its anti group off its node:
    the group_count, term and preference paints go through the merge."""
    from open_simulator_tpu_torch.testing.builders import make_fake_node, make_fake_pod

    gpu_node = {"alibabacloud.com/gpu-count": "4", "alibabacloud.com/gpu-mem": "32"}
    nodes = [make_fake_node(f"n{i}", cpu="16", memory="64Gi",
                            labels={"pool": f"p{i % pools}",
                                    "topology.kubernetes.io/zone": f"z{i % 3}"},
                            extra_allocatable=gpu_node if gpu else None)
             for i in range(n_nodes)]
    rng = np.random.RandomState(3)
    pods = []
    for i in range(n_pods):
        pool = i % pools
        kw = {}
        if gpu:
            kw["annotations"] = {"alibabacloud.com/gpu-mem": str(2 + i % 5),
                                 "alibabacloud.com/gpu-count": "2" if i % 3 == 0 else "1"}
        if interpod:
            aff = {"podAffinity": {"preferredDuringSchedulingIgnoredDuringExecution": [{
                "weight": 7, "podAffinityTerm": {
                    "labelSelector": {"matchLabels": {"app": f"a{pool}"}},
                    "topologyKey": "topology.kubernetes.io/zone"}}]}}
            if i % 4 == 0:
                aff["podAntiAffinity"] = {"requiredDuringSchedulingIgnoredDuringExecution": [{
                    "labelSelector": {"matchLabels": {"anti": f"g{pool}"}},
                    "topologyKey": "kubernetes.io/hostname"}]}
            kw["affinity"] = aff
            kw["topology_spread"] = [{
                "maxSkew": 2, "topologyKey": "kubernetes.io/hostname",
                "whenUnsatisfiable": "ScheduleAnyway",
                "labelSelector": {"matchLabels": {"app": f"a{pool}"}}}]
        pods.append(make_fake_pod(f"w{i}", cpu=f"{rng.randint(100, 2000)}m",
                                  memory=f"{rng.randint(64, 2048)}Mi",
                                  labels={"app": f"a{pool}", "anti": f"g{pool}"},
                                  node_selector={"pool": f"p{pool}"}, **kw))
    return nodes, pods


def wave_pools_snapshot(n_nodes: int, n_pods: int, pools: int, gpu: bool = False,
                        interpod: bool = False):
    """``wave_pools_objects`` encoded as ``simulate()`` encodes it."""
    from open_simulator_tpu_torch.encode.snapshot import encode_cluster
    from open_simulator_tpu_torch.k8s.loader import make_valid_node

    nodes, pods = wave_pools_objects(n_nodes, n_pods, pools, gpu, interpod)
    return encode_cluster([make_valid_node(n) for n in nodes], pods)


def widen_device_resources(arrs, n_vg: int = 9, n_dev: int = 33, n_claims: int = 9,
                           seed: int = 0):
    """A device-resource snapshot's arrays (host numpy, any package's
    SnapshotArrays) widened past the step kernel's per-thread walk widths:
    `n_vg` volume groups and `n_dev` exclusive devices on every node with
    open-local storage (tight enough that some refuse), three LVM volumes
    (descending) and two device claims on every pod that asks for storage,
    and up to `n_claims`
    WaitForFirstConsumer claims on every pod with one (valid slots first,
    some pods at `n_claims`). Returns a SnapshotArrays of the same type."""
    import dataclasses

    rng = np.random.RandomState(seed)
    a = {f.name: np.asarray(getattr(arrs, f.name)) for f in dataclasses.fields(arrs)}
    n, p = a["alloc"].shape[0], a["req"].shape[0]
    storage = (a["vg_cap"] > 0).any(1) | (a["sdev_cap"] > 0).any(1)
    vg = np.zeros((n, n_vg), a["vg_cap"].dtype)
    vg[storage] = rng.choice([0, 4096, 12288], size=(int(storage.sum()), n_vg))
    dev = np.zeros((n, n_dev), a["sdev_cap"].dtype)
    dev[storage] = rng.choice([0, 51200, 65536], size=(int(storage.sum()), n_dev))
    lvm = np.zeros((p, 3), a["lvm_req"].dtype)
    wants = (a["lvm_req"] > 0).any(1)
    lvm[wants] = -np.sort(-rng.choice([2048, 4096, 10240], size=(int(wants.sum()), 3)), axis=1)
    sreq = np.zeros((p, 2), a["sdev_req"].dtype)
    claims = (a["sdev_req"] > 0).any(1)
    sreq[claims] = rng.choice([40960, 60416], size=(int(claims.sum()), 2))
    n_cls = max(1, a["pv_cand"].shape[0])
    ccid = np.zeros((p, n_claims), a["wfc_ccid"].dtype)
    valid = np.zeros((p, n_claims), bool)
    for i in np.flatnonzero(a["wfc_valid"].any(1)):
        k = n_claims if i % 3 == 0 else rng.randint(1, n_claims + 1)
        valid[i, :k] = True
        ccid[i, :k] = rng.randint(0, n_cls, k)
    a.update(vg_cap=vg, sdev_cap=dev, sdev_ssd=rng.rand(n, n_dev) < 0.5, lvm_req=lvm,
             sdev_req=sreq, sdev_req_ssd=rng.rand(p, 2) < 0.5, wfc_ccid=ccid, wfc_valid=valid)
    return type(arrs)(**a)


def fleet_variants(arrs, n_lanes: int, seed: int = 0):
    """`n_lanes` clusters of one shape signature from one snapshot's arrays
    (host numpy): lane 0 the snapshot itself, lane s > 0 with each node's
    allocatable doubled or kept at random and every forced bind moved
    7·s nodes along the real nodes — a fleet whose lanes differ in their
    arrays, their forced-prefix folds and their placements."""
    import dataclasses

    rng = np.random.RandomState(seed)
    real = int(np.asarray(arrs.active).sum()) or np.asarray(arrs.alloc).shape[0]
    out = [arrs]
    for s in range(1, n_lanes):
        alloc = np.asarray(arrs.alloc)
        scale = rng.choice([1.0, 2.0], size=(alloc.shape[0], 1)).astype(alloc.dtype)
        forced = np.asarray(arrs.forced_node)
        moved = np.where(forced >= 0, (forced + 7 * s) % real, forced).astype(forced.dtype)
        out.append(dataclasses.replace(arrs, alloc=alloc * scale, forced_node=moved))
    return out


def many_domain_objects(n_nodes: int, n_pods: int, domains: int, affinity: bool = False):
    """(nodes, pods) of a cluster whose zone key has `domains` values (node
    i in zone i % domains): every pod spreads its app (one of 8) over the
    zones, softly and with a DoNotSchedule skew of 64; with `affinity`,
    every pod also requires a pod of its app in its zone (itself, for the
    first), which puts the spread on the group_count carry and its
    column reads. The shape whose per-domain tables outgrow a block's
    shared memory at a few thousand zones."""
    from open_simulator_tpu_torch.k8s.objects import Node, Pod

    rng = np.random.RandomState(1)
    zone = "topology.kubernetes.io/zone"
    nodes = [Node.from_dict({
        "metadata": {"name": f"n{i}", "labels": {zone: f"z{i % domains}"}},
        "status": {"allocatable": {"cpu": "16", "memory": "64Gi", "pods": 110}}})
        for i in range(n_nodes)]
    pods = []
    for i in range(n_pods):
        app = {"matchLabels": {"app": f"a{i % 8}"}}
        spec = {"containers": [{"name": "c", "resources": {"requests": {
                    "cpu": f"{rng.randint(100, 2000)}m",
                    "memory": f"{rng.randint(64, 2048)}Mi"}}}],
                "topologySpreadConstraints": [
                    {"maxSkew": 5, "topologyKey": zone, "whenUnsatisfiable": "ScheduleAnyway",
                     "labelSelector": app},
                    {"maxSkew": 64, "topologyKey": zone, "whenUnsatisfiable": "DoNotSchedule",
                     "labelSelector": app}]}
        if affinity:
            spec["affinity"] = {"podAffinity": {"requiredDuringSchedulingIgnoredDuringExecution": [
                {"labelSelector": app, "topologyKey": zone}]}}
        pods.append(Pod.from_dict({"metadata": {"name": f"p{i}", "namespace": "default",
                                                "labels": {"app": f"a{i % 8}"}},
                                   "spec": spec}))
    return nodes, pods


def many_domain_snapshot(n_nodes: int, n_pods: int, domains: int, affinity: bool = False):
    """``many_domain_objects`` encoded as ``simulate()`` encodes it."""
    from open_simulator_tpu_torch.encode.snapshot import encode_cluster
    from open_simulator_tpu_torch.k8s.loader import make_valid_node

    nodes, pods = many_domain_objects(n_nodes, n_pods, domains, affinity)
    return encode_cluster([make_valid_node(n) for n in nodes], pods)


def synthetic_extensions():
    """Five torch extension ops (``engine/extensions.ExtensionOp``) that
    cover every kind between them, for the card's smoke run and the
    tests: a filter of the arrays only (the reference's even-index
    example), a filter of the pod slice (a rotating fifth of the nodes
    refused by ``_pod_index``), a "minmax" score of the arrays (the
    node's allocatable CPU, weight 2), a "max" score of the carry (the
    node's free CPU fraction from ``state.headroom``, weight 3: a pod run
    against the wrong carry places differently) and a "none" score (a
    fixed 0..60 pattern, weight 0.5)."""
    import torch

    from open_simulator_tpu_torch.engine.extensions import ExtensionOp

    def iota(arrs):
        return torch.arange(arrs.alloc.shape[0], device=arrs.alloc.device)

    return (
        ExtensionOp(name="node(s) rejected by the even-index policy",
                    filter_fn=lambda state, arrs, x: iota(arrs) % 2 == 0),
        ExtensionOp(name="node(s) rejected by the rotation policy",
                    filter_fn=lambda state, arrs, x: (iota(arrs) + x["_pod_index"]) % 5 != 0),
        ExtensionOp(name="prefer-large-nodes", normalize="minmax", weight=2.0,
                    score_fn=lambda state, arrs, x: arrs.alloc[:, 0]),
        ExtensionOp(name="prefer-free-cpu", normalize="max", weight=3.0,
                    score_fn=lambda state, arrs, x: (
                        state.headroom[:, 0] / torch.clamp_min(arrs.alloc[:, 0], 1.0))),
        ExtensionOp(name="fixed-pattern", weight=0.5,
                    score_fn=lambda state, arrs, x: (iota(arrs) % 7).to(torch.float32) * 10.0),
    )


def random_extension_rows(cfg, n_lanes: int, n_pods: int, n_nodes: int, seed: int = 0,
                          nan: bool = False):
    """Seeded extension rows for a launch of `n_pods` pods over `n_lanes`
    lanes under `cfg.extensions` (CPU tensors): ``ext_ok`` [S, P, Ef, N]
    bool (about one node in eight refused per row) and ``ext_raw``
    [S, P, Es, N] f32 (small integers and halves, so ties occur, negative
    ones among them); with `nan`, a NaN at one node of the first score
    row for every third pod. Either is None where no extension of its
    kind is registered."""
    import torch

    rng = np.random.RandomState(seed)
    n_f = sum(1 for e in cfg.extensions if e.filter_fn is not None)
    n_s = sum(1 for e in cfg.extensions if e.score_fn is not None)
    ok = raw = None
    if n_f:
        ok = torch.from_numpy(rng.rand(n_lanes, n_pods, n_f, n_nodes) >= 0.125)
    if n_s:
        vals = (rng.randint(-8, 40, (n_lanes, n_pods, n_s, n_nodes)) / 2.0).astype(np.float32)
        if nan:
            vals[:, ::3, 0, rng.randint(n_nodes)] = np.nan
        raw = torch.from_numpy(vals)
    return ok, raw
