"""The port's device-resource slice equals the JAX package's, engine and
path.

``schedule_pods`` and ``schedule_lanes`` of the port (the plain torch step
on the CPU) against the reference's ``schedule_pods(..., waves=None)`` and
``parallel/sweep.batched_schedule`` on the same arrays: node, fail counts,
feasible counts, ``gpu_pick``, ``vol_pick`` and all twelve carry fields
must be equal (bf16 carries by their bits), with reason accounting on and
off. Inputs: the ``gpushare``, ``openlocal`` and ``stateful`` examples;
the attach-limit and shared-volume clusters of ``tests/test_volume_ops.py``
(dedup on and off); ``device_resource_manifests`` at 96 x 768, loaded by
each package from the same manifests (the encoders must agree too), with
mid-sequence pods bound by ``spec.nodeName`` that carry GPU and
WaitForFirstConsumer requests; each device-resource gate forced on over a
cluster with no such objects (the ``tests/test_gate_equality.py`` idea).
Then ``simulate()`` on the three examples against
``tests/golden/*.json``. Tolerance: exact.
"""

from __future__ import annotations

import copy
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest

import torch_parity as tp
from open_simulator_tpu.encode.snapshot import EncodeOptions, encode_cluster
from open_simulator_tpu.engine import scheduler as jsched
from open_simulator_tpu.parallel import sweep as jsweep
from open_simulator_tpu.testing.synthetic import synthetic_snapshot as jax_synthetic
from open_simulator_tpu_torch import convert
from open_simulator_tpu_torch.apply.applier import (
    build_apps_from_config,
    build_cluster_from_config,
)
from open_simulator_tpu_torch.api.v1alpha1 import load_config
from open_simulator_tpu_torch.core import simulate
from open_simulator_tpu_torch.engine import scheduler as tsched
from open_simulator_tpu_torch.testing.synthetic import (
    GPU_NODE_TEMPLATE,
    device_resource_manifests,
)
from tests.test_volume_ops import WFC_SC, claim_pod, csi_pv, make_node, pvc

GATES = ("enable_gpu", "enable_storage", "enable_vol_static", "enable_pv_match",
         "enable_vol_limits", "enable_vol_dedup")
EBS = "attachable-volumes-csi-ebs.csi.aws.com"
GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")


def check(snap, **overrides):
    """Both engines on the snapshot's arrays; everything equal."""
    jcfg, outs_j, st_j = tp.run_jax(snap, **overrides)
    outs_t, st_t = tp.run_torch(tp.fields(snap.arrays), snap.arrays.active, tp.torch_cfg(jcfg))
    tp.assert_same(outs_j, st_j, outs_t, st_t)
    return jcfg, outs_j


def encode_manifests(pkg, docs, max_new=0):
    """The manifests through `pkg`'s own loader and encoder, as simulate()
    encodes a cluster, with `max_new` GPU template slots."""
    loader, core, snapshot = tp.PKGS[pkg]
    cluster = loader.ClusterResources()
    for doc in copy.deepcopy(docs):
        loader.demux_object(doc, cluster)
    nodes = [loader.make_valid_node(n) for n in cluster.nodes]
    cluster.nodes = nodes
    opts = snapshot.EncodeOptions()
    if max_new:
        opts = snapshot.EncodeOptions(max_new_nodes=max_new, new_node_template=(
            loader.make_valid_node(type(nodes[0]).from_dict(copy.deepcopy(GPU_NODE_TEMPLATE)))))
    pods = core.build_pod_sequence(cluster, [])
    return snapshot.encode_cluster(nodes, pods, core.with_volume_objects(opts, cluster, []))


def devres_docs(forced_mid=False):
    docs = device_resource_manifests(96, 768)
    if forced_mid:
        # bind a multi-GPU pod and a StatefulSet replica (its claim still
        # unbound) mid-sequence, through the picks of the forced path
        pods = [d for d in docs if d["kind"] == "Pod"]
        gpu = next(p for p in pods[300:] if p["metadata"]["annotations"].get(
            "alibabacloud.com/gpu-count"))
        gpu["spec"]["nodeName"] = "n8"
        sts = next(p for p in pods[300:] if p["metadata"]["name"].startswith("db"))
        sts["spec"]["nodeName"] = "n5"
    return docs


_SNAPS = {}


def devres_snapshot(name):
    if name not in _SNAPS:
        docs = devres_docs(forced_mid=name == "devres-forced-mid")
        max_new = 8 if name == "devres-new8" else 0
        snap = encode_manifests("jax", docs, max_new)
        port = encode_manifests("torch", docs, max_new)
        fj, ft = tp.fields(snap.arrays), tp.fields(port.arrays)
        for k, v in fj.items():
            assert v.dtype == ft[k].dtype and np.array_equal(v, ft[k]), k
        _SNAPS[name] = snap
    return _SNAPS[name]


@pytest.mark.parametrize("fail_reasons", [True, False])
@pytest.mark.parametrize("name", ["gpushare", "openlocal", "stateful"])
def test_example_engine_equals_reference(name, fail_reasons):
    jcfg, outs = check(tp.encode("jax", name), fail_reasons=fail_reasons)
    want = {"gpushare": "enable_gpu", "openlocal": "enable_storage",
            "stateful": "enable_pv_match"}[name]
    assert getattr(jcfg, want)
    assert (outs["node"] >= 0).any()


def _volume_cluster(name):
    limited = [make_node(f"n{i}", labels={"kubernetes.io/hostname": f"n{i}"},
                         extra_alloc={EBS: 2 if name == "attach-limits" else 1})
               for i in range(2)]
    if name == "attach-limits":
        pvcs = [pvc(f"c{i}", volume_name=f"ebs-{i}") for i in range(5)]
        pvs = [csi_pv(f"ebs-{i}", f"c{i}") for i in range(5)]
        pods = [claim_pod(f"p{i}", [f"c{i}"]) for i in range(5)]
    else:
        pvcs = [pvc("cshare", volume_name="ebs-share"), pvc("cown", volume_name="ebs-own"),
                pvc("cextra", volume_name="ebs-extra")]
        pvs = [csi_pv("ebs-share", "cshare", modes=("ReadWriteMany",)),
               csi_pv("ebs-own", "cown"), csi_pv("ebs-extra", "cextra")]
        pods = ([claim_pod(f"s{i}", ["cshare"]) for i in range(3)]
                + [claim_pod("own", ["cown"]), claim_pod("extra", ["cextra", "cshare"])])
        pods[0].raw["spec"]["nodeSelector"] = {"kubernetes.io/hostname": "n1"}
    return encode_cluster(limited, pods, EncodeOptions(pvcs=pvcs, pvs=pvs,
                                                       storage_classes=[WFC_SC]))


@pytest.mark.parametrize("name,overrides", [
    ("attach-limits", {}),
    ("shared-volumes", {}),
    ("shared-volumes", {"enable_vol_dedup": False}),
    ("shared-volumes", {"fail_reasons": False}),
])
def test_attach_limits_and_dedup_equal_reference(name, overrides):
    jcfg, outs = check(_volume_cluster(name), **overrides)
    assert jcfg.enable_vol_limits
    assert jcfg.enable_vol_dedup == (name == "shared-volumes"
                                     and overrides.get("enable_vol_dedup", True))
    if jcfg.fail_reasons:
        assert (outs["fail_counts"][:, -1] > 0).any()  # the limit row refused nodes


@pytest.mark.parametrize("fail_reasons", [True, False])
@pytest.mark.parametrize("name", ["devres", "devres-forced-mid"])
def test_device_resource_cluster_equals_reference(name, fail_reasons):
    snap = devres_snapshot(name)
    jcfg, outs = check(snap, fail_reasons=fail_reasons)
    assert all(getattr(jcfg, g) for g in GATES) and jcfg.forced_prefix > 0
    assert (outs["gpu_pick"] > 0).any() and (outs["vol_pick"] >= 0).any()
    forced = np.asarray(snap.arrays.forced_node)
    mid = np.nonzero(forced[jcfg.forced_prefix:] >= 0)[0] + jcfg.forced_prefix
    assert len(mid)
    if name == "devres-forced-mid":
        gpu = np.asarray(snap.arrays.gpu_cnt)[mid] > 1
        wfc = np.asarray(snap.arrays.wfc_valid)[mid].any(1)
        assert gpu.any() and wfc.any()
        want = np.asarray(snap.arrays.gpu_cnt)[mid[gpu]].astype(np.int32)
        assert np.array_equal(outs["gpu_pick"][mid[gpu]].sum(1), want)
        assert (outs["vol_pick"][mid[wfc]] >= 0).all()
    if fail_reasons:
        # every device-resource row but the missing-PV one refuses nodes
        r = snap.arrays.alloc.shape[1]
        rows = outs["fail_counts"].sum(0)[7 + r:]
        assert (rows[[0, 1, 2, 3, 4, 6]] > 0).all(), rows


def lane_masks(snap):
    n, n_real = snap.n_nodes, snap.n_real_nodes
    rng = np.random.RandomState(3)
    masks = list(jsweep.active_masks_for_counts(snap, [0, 3, n - n_real]))
    masks.append(np.concatenate([rng.rand(n_real) < 0.8, np.ones(n - n_real, bool)]))
    return np.stack(masks)


@pytest.mark.parametrize("fail_reasons", [True, False])
def test_lanes_equal_reference_lanes(fail_reasons):
    """Four lanes of one launch against the reference's vmapped lanes."""
    snap = devres_snapshot("devres-new8")
    masks = lane_masks(snap)
    jcfg = jsched.make_config(snap, fail_reasons=fail_reasons)
    out = jsweep.batched_schedule(jsched.device_arrays(snap), jnp.asarray(masks), jcfg)
    got = tsched.schedule_lanes(convert.snapshot_arrays_from_numpy(tp.fields(snap.arrays)),
                                masks, tp.torch_cfg(jcfg), device="cpu")
    for k in tp.OUTPUTS:
        ref = np.asarray(getattr(out, k))
        assert np.array_equal(getattr(got, k).numpy(), ref), k
    st_j, st_t = tp.jax_state(out.state), convert.state_to_numpy(got.state)
    for f in tp.CARRY:
        assert st_t[f].dtype == st_j[f].dtype and st_t[f].tobytes() == st_j[f].tobytes(), f
    assert len({tuple(r) for r in np.asarray(out.node).tolist()}) >= 2


def _plain_fit():
    return jax_synthetic(48, 192)


@pytest.mark.parametrize("gates", [(g,) for g in GATES] + [GATES])
def test_forced_gates_on_a_cluster_without_their_objects(gates):
    """A gate forced on over a cluster with no GPU, storage or volume
    object changes nothing, in either package, and both agree."""
    snap = _plain_fit()
    _, base = check(snap)
    _, forced = check(snap, **{g: True for g in gates})
    for k in ("node", "fail_counts", "feasible"):
        assert np.array_equal(base[k], forced[k]), k


@pytest.mark.parametrize("name", ["gpushare", "openlocal", "stateful"])
def test_simulate_reproduces_the_golden_placements(name):
    examples = os.path.join(os.path.dirname(GOLDEN), "..", "examples")
    cfg = load_config(os.path.join(examples, f"{name}-config.yaml"))
    cluster = build_cluster_from_config(cfg, examples)
    apps = build_apps_from_config(cfg, examples)
    res = simulate(cluster, apps, device="cpu")
    got = {"placements": dict(sorted(res.placements().items())),
           "unscheduled": sorted(u.pod.key for u in res.unscheduled_pods)}
    with open(os.path.join(GOLDEN, f"{name}-config.json")) as f:
        assert got == json.load(f)
    if name == "gpushare":
        assert res.gpu_assignments
    if name == "stateful":
        assert res.volume_bindings


def test_volume_masks_equal_the_reference_walk():
    """The port's label-index shortcut for PV node affinity and zone
    labels gives the reference's per-node answers, on every affinity shape
    (In over one and several terms, NotIn, Exists, matchFields, an empty
    term) and on multi-zone labels."""
    from open_simulator_tpu.k8s import objects as jobjects
    from open_simulator_tpu.k8s import volumes as jvolumes
    from open_simulator_tpu_torch.k8s import objects as tobjects
    from open_simulator_tpu_torch.k8s import volumes as tvolumes

    def expr(key, op, values=None):
        e = {"key": key, "operator": op}
        if values is not None:
            e["values"] = values
        return e

    nodes = [{"metadata": {"name": f"n{i}", "labels": {
        "kubernetes.io/hostname": f"n{i}", "topology.kubernetes.io/zone": f"z{i % 3}",
        **({"disk": "ssd"} if i % 2 else {})}}} for i in range(7)]
    shapes = [
        None,
        [{"matchExpressions": [expr("kubernetes.io/hostname", "In", ["n1", "n4"])]}],
        [{"matchExpressions": [expr("topology.kubernetes.io/zone", "In", ["z1"]),
                               expr("disk", "In", ["ssd"])]},
         {"matchExpressions": [expr("kubernetes.io/hostname", "In", ["n0"])]}],
        [{"matchExpressions": [expr("disk", "NotIn", ["ssd"])]}],
        [{"matchExpressions": [expr("disk", "Exists")]}],
        [{"matchFields": [expr("metadata.name", "In", ["n2"])]}],
        [{}, {"matchExpressions": [expr("topology.kubernetes.io/zone", "In", ["z2", 3])]}],
    ]
    pvs = []
    for i, terms in enumerate(shapes):
        d = {"metadata": {"name": f"pv{i}", "labels": {}},
             "spec": {"capacity": {"storage": f"{i + 1}Gi"}, "accessModes": ["ReadWriteOnce"],
                      "storageClassName": "local-wfc"}}
        if terms is not None:
            d["spec"]["nodeAffinity"] = {"required": {"nodeSelectorTerms": terms}}
        if i % 3 == 1:
            d["metadata"]["labels"]["topology.kubernetes.io/zone"] = "z0__z2"
        pvs.append(d)

    # one pod per PV, its claim bound to it: the class rows carry both masks
    pvcs = [{"metadata": {"name": f"c{i}", "namespace": "default"},
             "spec": {"accessModes": ["ReadWriteOnce"], "storageClassName": "local-wfc",
                      "resources": {"requests": {"storage": "1Gi"}}, "volumeName": f"pv{i}"}}
            for i in range(len(pvs))]
    pods = [{"metadata": {"name": f"p{i}", "namespace": "default"},
             "spec": {"containers": [{"name": "c"}],
                      "volumes": [{"name": "v", "persistentVolumeClaim": {"claimName": f"c{i}"}}]}}
            for i in range(len(pvs))]

    def masks(volumes, objects):
        model = volumes.analyze_volumes(
            [objects.Pod.from_dict(copy.deepcopy(p)) for p in pods],
            [objects.PersistentVolumeClaim.from_dict(copy.deepcopy(c)) for c in pvcs],
            [objects.PersistentVolume.from_dict(copy.deepcopy(p)) for p in pvs], [])
        ns = [objects.Node.from_dict(copy.deepcopy(n)) for n in nodes]
        return volumes.build_volume_masks(model, ns, {})

    ref = masks(jvolumes, jobjects)
    got = masks(tvolumes, tobjects)
    for a, b in zip(ref, got):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert got[4][1].tolist() == [False, True, False, False, True, False, False]
    assert not got[2].all()  # a zone row refuses nodes
