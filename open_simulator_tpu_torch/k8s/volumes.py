"""Volume scheduling host model: PVC/PV/StorageClass analysis feeding the
VolumeBinding + VolumeZone tensor ops.

Semantics re-expressed from the vendored plugins the reference compiles in
(vendor/.../plugins/volumebinding/{volume_binding.go,binder.go},
volumezone/volume_zone.go):

  PreFilter  missing / Lost / being-deleted PVCs and unbound claims whose
             class binds immediately -> the pod is unschedulable before
             any node is considered (UnschedulableAndUnresolvable).
  Filter     bound claims: the PV must exist, its nodeAffinity must admit
             the node (ErrReasonNodeConflict), and its zone/region labels
             must match the node (VolumeZone ErrReasonConflict);
             WaitForFirstConsumer claims: an Available, class/size/mode/
             selector-compatible PV whose nodeAffinity admits the node
             must exist, claims matched to DISJOINT PVs smallest-first
             (binder.go findMatchingVolumes -> pvutil.FindMatchingVolume);
             dynamic-provision claims: the class's allowedTopologies must
             admit the node (both -> ErrReasonBindConflict).
  Reserve    matched PVs are consumed — the scan carries a pv_taken column
             so two pods can never bind the same PV.

NOTE ON REFERENCE PARITY: the reference *vendors* all of this but feeds it
nothing — MakeValidPod rewrites every PVC volume to hostPath /tmp
(pkg/utils/utils.go:393-399, "todo: handle pvc"), so its simulations never
exercise volume binding. This framework schedules PVCs for real; that is a
deliberate, documented superset (PARITY.md).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from open_simulator_tpu_torch.k8s.objects import (
    LabelSelector,
    Node,
    PersistentVolume,
    PersistentVolumeClaim,
    Pod,
    StorageClass,
)
from open_simulator_tpu_torch.k8s.selectors import (
    labels_match_selector,
    node_selector_terms_match,
)

PRE_UNBOUND_IMMEDIATE = "pod has unbound immediate PersistentVolumeClaims"


@dataclass
class PodVolumes:
    """Per-pod volume analysis (the stateData analog)."""

    pre_reason: Optional[str] = None
    bound_pv_ids: List[int] = field(default_factory=list)
    missing_pv: bool = False          # bound claim -> non-existent PV
    wfc_claim_ids: List[int] = field(default_factory=list)   # candidate-class ids
    wfc_claim_keys: List[str] = field(default_factory=list)  # ns/name per slot
    provision_scs: List[str] = field(default_factory=list)   # SC names
    # attachable-volume demand (NodeVolumeLimits analog): one
    # (claim_key, limit_key) entry per attachable volume the pod mounts,
    # keyed like the node allocatable keys ("attachable-volumes-csi-..."
    # etc.). The claim key is the volume's dedup identity — the vendored
    # plugins count UNIQUE volumes per node (csi.go getVolumeUniqueName:
    # bound claims resolve to one PV per claim via claimRef, unbound
    # provisioned claims count per claim UID), so a claim mounted by two
    # pods on the same node attaches once. The encoder splits entries into
    # a static per-pod count (claims no other pod shares) and a shared-
    # volume vocabulary the engine dedups against a per-node presence
    # carry.
    limit_claims: List[Tuple[str, str]] = field(default_factory=list)


@dataclass
class VolumeModel:
    """Host-side volume world, ordered and deduped for encoding."""

    pvs: List[PersistentVolume]                      # capacity-ascending order
    pod_volumes: List[PodVolumes]                    # parallel to pods
    claim_cand: List[np.ndarray] = field(default_factory=list)  # [Npv] bool per claim class
    any_volumes: bool = False

    @property
    def n_pvs(self) -> int:
        return len(self.pvs)


def _allowed_topology_ok(sc: StorageClass, node: Node) -> bool:
    terms = sc.allowed_topologies
    if not terms:
        return True
    labels = node.meta.labels
    for term in terms:
        exprs = term.get("matchLabelExpressions") or []
        if all(labels.get(e.get("key")) in (e.get("values") or []) for e in exprs):
            return True
    return False


def pv_admits_node(pv: PersistentVolume, node: Node) -> bool:
    terms = pv.node_affinity_terms
    if terms is None:
        return True
    return node_selector_terms_match(node.meta.labels, terms)


def _pv_matches_claim(pv: PersistentVolume, pvc: PersistentVolumeClaim,
                      claim_key: str) -> bool:
    """pvutil.FindMatchingVolume's static criteria (node affinity checked
    separately per node)."""
    if pv.phase not in ("Available", "Bound"):
        return False
    ref = pv.claim_ref
    if ref is not None and ref != claim_key:
        return False
    if ref is None and pv.phase == "Bound":
        return False
    if (pv.storage_class_name or "") != (pvc.storage_class_name or ""):
        return False
    if not set(pvc.access_modes).issubset(set(pv.access_modes)):
        return False
    if pv.capacity_mib < pvc.request_mib:
        return False
    sel = pvc.selector
    if sel is not None:
        parsed = LabelSelector.from_dict(sel)
        if parsed is None or not labels_match_selector(pv.meta.labels, parsed):
            return False
    return True


def attach_limit_key_for_pv(pv: PersistentVolume) -> Optional[str]:
    """The node-allocatable limit key an attached PV counts against
    (vendored nodevolumelimits: GetCSIAttachLimitKey + the in-tree cloud
    keys). Local/hostPath/NFS-style volumes are not attachable -> None."""
    spec = pv.spec
    if spec.get("csi"):
        return f"attachable-volumes-csi-{spec['csi'].get('driver', '')}"
    if spec.get("awsElasticBlockStore"):
        return "attachable-volumes-aws-ebs"
    if spec.get("gcePersistentDisk"):
        return "attachable-volumes-gce-pd"
    if spec.get("azureDisk"):
        return "attachable-volumes-azure-disk"
    return None


_INTREE_PROVISIONER_KEYS = {
    "kubernetes.io/aws-ebs": "attachable-volumes-aws-ebs",
    "kubernetes.io/gce-pd": "attachable-volumes-gce-pd",
    "kubernetes.io/azure-disk": "attachable-volumes-azure-disk",
}


def attach_limit_key_for_sc(sc: Optional[StorageClass]) -> Optional[str]:
    """Dynamic-provision claims count against the provisioner's limit key:
    the in-tree cloud provisioners map to their legacy keys (mirroring
    attach_limit_key_for_pv and the vendored non-CSI limit plugins, which
    count unbound claims by SC provisioner), everything else to the CSI
    key."""
    if sc is None or not sc.provisioner:
        return None
    if sc.provisioner == "kubernetes.io/no-provisioner":
        return None
    intree = _INTREE_PROVISIONER_KEYS.get(sc.provisioner)
    return intree or f"attachable-volumes-csi-{sc.provisioner}"


def _claim_name_for_volume(pod: Pod, vol: Dict[str, Any]) -> Tuple[Optional[str], bool]:
    """(pvc name, is_ephemeral) for a pod volume; (None, False) if the
    volume does not reference a claim (podHasPVCs, volume_binding.go)."""
    pvc_src = vol.get("persistentVolumeClaim")
    if pvc_src and pvc_src.get("claimName"):
        return pvc_src["claimName"], False
    if vol.get("ephemeral") is not None:
        # generic ephemeral volume: controller-created claim "<pod>-<vol>"
        return f"{pod.meta.name}-{vol.get('name', '')}", True
    return None, False


def analyze_volumes(
    pods: Sequence[Pod],
    pvcs: Sequence[PersistentVolumeClaim],
    pvs: Sequence[PersistentVolume],
    storage_classes: Sequence[StorageClass],
) -> VolumeModel:
    """Build the host volume model: per-pod claim classification plus the
    per-claim-class candidate PV sets (smallest-first PV order)."""
    # capacity-ascending, name-stable order makes "first available
    # candidate" == FindMatchingVolume's smallest-satisfying pick
    pv_sorted = sorted(pvs, key=lambda p: (p.capacity_mib, p.meta.name))
    pv_index = {p.meta.name: i for i, p in enumerate(pv_sorted)}
    pvc_index = {
        f"{p.meta.namespace or 'default'}/{p.meta.name}": p for p in pvcs
    }
    sc_index = {s.meta.name: s for s in storage_classes}
    claim_refs = {p.claim_ref for p in pv_sorted}

    model = VolumeModel(pvs=pv_sorted, pod_volumes=[])
    cand_cache: Dict[str, int] = {}   # claim-spec fingerprint -> class id

    for pod in pods:
        info = PodVolumes()
        model.pod_volumes.append(info)
        volumes = (pod.raw.get("spec") or {}).get("volumes") or []
        seen_claims: set = set()
        for vol in volumes:
            name, is_ephemeral = _claim_name_for_volume(pod, vol)
            if name is None:
                continue
            model.any_volumes = True
            claim_key = f"{pod.meta.namespace or 'default'}/{name}"
            if claim_key in seen_claims:
                continue  # unique volumes count once (nodevolumelimits)
            seen_claims.add(claim_key)
            pvc = pvc_index.get(claim_key)
            if pvc is None:
                info.pre_reason = (
                    f'waiting for ephemeral volume controller to create the '
                    f'persistentvolumeclaim "{name}"'
                    if is_ephemeral else
                    f'persistentvolumeclaim "{name}" not found'
                )
                break
            if pvc.phase == "Lost":
                info.pre_reason = (
                    f'persistentvolumeclaim "{name}" bound to '
                    f'non-existent persistentvolume "{pvc.volume_name}"'
                )
                break
            if (pvc.raw.get("metadata") or {}).get("deletionTimestamp"):
                info.pre_reason = f'persistentvolumeclaim "{name}" is being deleted'
                break
            if pvc.volume_name:
                pv_id = pv_index.get(pvc.volume_name)
                if pv_id is None:
                    info.missing_pv = True
                else:
                    info.bound_pv_ids.append(pv_id)
                    lk = attach_limit_key_for_pv(pv_sorted[pv_id])
                    if lk:
                        info.limit_claims.append((claim_key, lk))
                continue
            # unbound claim: binding mode decides
            sc = sc_index.get(pvc.storage_class_name or "")
            if sc is None or not sc.is_wait_for_first_consumer:
                info.pre_reason = PRE_UNBOUND_IMMEDIATE
                break
            if sc.provisioner and sc.provisioner != "kubernetes.io/no-provisioner":
                info.provision_scs.append(sc.meta.name)
                lk = attach_limit_key_for_sc(sc)
                if lk:
                    info.limit_claims.append((claim_key, lk))
                continue
            # static (no-provisioner) WFC claim: candidate PV set
            fp = "|".join([
                pvc.storage_class_name or "",
                ",".join(sorted(pvc.access_modes)),
                f"{pvc.request_mib:.3f}",
                repr(pvc.selector),
                claim_key if claim_key in claim_refs else "",
            ])
            cid = cand_cache.get(fp)
            if cid is None:
                row = np.array(
                    [_pv_matches_claim(p, pvc, claim_key) for p in pv_sorted],
                    dtype=bool,
                )
                cid = len(model.claim_cand)
                model.claim_cand.append(row)
                cand_cache[fp] = cid
            info.wfc_claim_ids.append(cid)
            info.wfc_claim_keys.append(claim_key)
    return model


def _label_index(nodes: Sequence[Node]) -> Dict[str, Dict[str, List[int]]]:
    """label key -> value -> indices of the nodes carrying it."""
    index: Dict[str, Dict[str, List[int]]] = {}
    for j, node in enumerate(nodes):
        for k, v in node.meta.labels.items():
            index.setdefault(k, {}).setdefault(v, []).append(j)
    return index


def _label_in_mask(index, n: int, key: str, values) -> np.ndarray:
    """[n] bool: the node has label `key` with a value in `values` (the
    string values; no other value equals a label)."""
    mask = np.zeros(n, dtype=bool)
    by_value = index.get(key, {})
    for v in values:
        rows = by_value.get(v) if isinstance(v, str) else None
        if rows:
            mask[rows] = True
    return mask


def _in_terms_mask(index, n: int, terms) -> Optional[np.ndarray]:
    """pv_admits_node over every node at once, for node-affinity terms
    built only of ``In`` expressions (the local-PV and zonal-PV shape):
    terms ORed, expressions ANDed, an empty term matching nothing. None
    for any other shape, which the per-node evaluation then takes."""
    if terms is None:
        return np.ones(n, dtype=bool)
    mask = np.zeros(n, dtype=bool)
    for term in terms:
        exprs = term.get("matchExpressions") or []
        if term.get("matchFields") or any(e.get("operator", "In") != "In" for e in exprs):
            return None
        if not exprs:
            continue
        m = np.ones(n, dtype=bool)
        for e in exprs:
            m &= _label_in_mask(index, n, e.get("key", ""), e.get("values") or [])
        mask |= m
    return mask


def build_volume_masks(
    model: VolumeModel,
    nodes: Sequence[Node],
    sc_by_name: Dict[str, StorageClass],
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Static per-pod node masks, class-deduped.

    Returns (vol_cid [P], class_vol_node [Cv, N], class_vol_zone [Cv, N],
    class_vol_bind_static [Cv, N], pv_node_ok [Npv, N])."""
    n = len(nodes)
    index = _label_index(nodes)
    pv_node_ok = np.ones((model.n_pvs, n), dtype=bool)
    for i, pv in enumerate(model.pvs):
        fast = _in_terms_mask(index, n, pv.node_affinity_terms)
        if fast is not None:
            pv_node_ok[i] = fast
            continue
        for j, node in enumerate(nodes):
            pv_node_ok[i, j] = pv_admits_node(pv, node)
    pv_zone_ok = np.ones((model.n_pvs, n), dtype=bool)
    for i, pv in enumerate(model.pvs):
        for key, allowed in pv.zone_labels().items():
            # VolumeZone: the node's label value lies in the PV's set
            pv_zone_ok[i] &= _label_in_mask(index, n, key, allowed)

    vocab: Dict[bytes, int] = {}
    rows_node: List[np.ndarray] = []
    rows_zone: List[np.ndarray] = []
    rows_bind: List[np.ndarray] = []
    vol_cid = np.zeros(len(model.pod_volumes), dtype=np.int64)
    sc_topo_cache: Dict[str, np.ndarray] = {}

    def sc_mask(name: str) -> np.ndarray:
        m = sc_topo_cache.get(name)
        if m is None:
            sc = sc_by_name.get(name)
            m = np.array(
                [(_allowed_topology_ok(sc, nd) if sc else True) for nd in nodes],
                dtype=bool,
            )
            sc_topo_cache[name] = m
        return m

    for pi, info in enumerate(model.pod_volumes):
        node_mask = np.ones(n, dtype=bool)
        zone_mask = np.ones(n, dtype=bool)
        bind_mask = np.ones(n, dtype=bool)
        # (a missing bound PV is charged via the dedicated vol_pv_missing
        # op row, not these masks)
        for pv_id in info.bound_pv_ids:
            node_mask &= pv_node_ok[pv_id]
            zone_mask &= pv_zone_ok[pv_id]
        for sc_name in info.provision_scs:
            bind_mask &= sc_mask(sc_name)
        key = node_mask.tobytes() + b"|" + zone_mask.tobytes() + b"|" + bind_mask.tobytes()
        cid = vocab.get(key)
        if cid is None:
            cid = len(rows_node)
            vocab[key] = cid
            rows_node.append(node_mask)
            rows_zone.append(zone_mask)
            rows_bind.append(bind_mask)
        vol_cid[pi] = cid

    if not rows_node:
        rows_node = [np.ones(n, dtype=bool)]
        rows_zone = [np.ones(n, dtype=bool)]
        rows_bind = [np.ones(n, dtype=bool)]
    return (
        vol_cid,
        np.stack(rows_node),
        np.stack(rows_zone),
        np.stack(rows_bind),
        pv_node_ok,
    )
