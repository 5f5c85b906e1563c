"""The port's preemption slice equals the JAX package's.

* ``simulate(device="cpu")`` against the reference's ``simulate()`` on the
  cases of ``tests/test_preemption.py`` (each built from the same dicts by
  each package's own objects), plus a leading nodeName run (the prefix
  fold is skipped under the columns) and a GPU-share preemption: the
  placements, the unscheduled reason strings, ``preempted_pod_keys``,
  ``node_status``, ``fail_counts`` and the reference's
  ``telemetry.ledger.result_digest`` of both results. The session cases
  are in ``tests/test_torch_simulator.py``.
* ``_PdbState`` of both packages on the percentage-budget case.
* The engine: ``schedule_pods`` with random ``disabled`` / ``nominated``
  columns (about 5% victims and 20% nominations, among them -1, negative
  and past-the-end values, inactive nodes, forced pods and victims) on a
  plain-fit, a rich, a device-resource and a rich device-resource
  snapshot, against the reference's ``schedule_pods(..., disabled=,
  nominated=)``: node, fail counts, feasible counts, GPU and PV picks and
  all twelve carry fields.
* The applier's decoded lane under preemption against the reference's
  ``_result_for``, through both CLIs.

Tolerance: exact.
"""

from __future__ import annotations

import copy

import numpy as np
import pytest

import torch_parity as tp
from open_simulator_tpu import core as jcore
from open_simulator_tpu.apply import applier as japplier
from open_simulator_tpu.cli.main import main as ref_main
from open_simulator_tpu.encode import snapshot as jsnapshot
from open_simulator_tpu.engine import preemption as jpre
from open_simulator_tpu.k8s import loader as jloader
from open_simulator_tpu.k8s import objects as jobjects
from open_simulator_tpu.telemetry.ledger import result_digest
from open_simulator_tpu.testing.synthetic import synthetic_snapshot as jax_synthetic
from open_simulator_tpu_torch import convert
from open_simulator_tpu_torch import core as tcore
from open_simulator_tpu_torch.apply import applier as tapplier
from open_simulator_tpu_torch.cli.main import main as port_main
from open_simulator_tpu_torch.encode import snapshot as tsnapshot
from open_simulator_tpu_torch.engine import preemption as tpre
from open_simulator_tpu_torch.engine import scheduler as tsched
from open_simulator_tpu_torch.k8s import loader as tloader
from open_simulator_tpu_torch.k8s import objects as tobjects
from open_simulator_tpu_torch.testing.synthetic import (
    device_resource_manifests,
    preemption_columns,
)
from tests.test_torch_devres import encode_manifests

PKG = {"jax": (jloader, jobjects, jcore), "torch": (tloader, tobjects, tcore)}


def node_doc(name, cpu_m=4000, mem_mib=8192, extra=None):
    alloc = {"cpu": f"{cpu_m}m", "memory": f"{mem_mib}Mi", "pods": 110}
    alloc.update(extra or {})
    return {"metadata": {"name": name, "labels": {}}, "status": {"allocatable": alloc},
            "spec": {"taints": [], "unschedulable": False}}


def pod_doc(name, cpu="500m", labels=None, on=None, affinity=None, node_name="",
            pclass="", annotations=None):
    spec = {"containers": [{"name": "c", "image": "nginx",
                            "resources": {"requests": {"cpu": cpu, "memory": "512Mi"}}}]}
    if on:
        spec["nodeSelector"] = {"kubernetes.io/hostname": on}
    if affinity:
        spec["affinity"] = affinity
    if node_name:
        spec["nodeName"] = node_name
    if pclass:
        spec["priorityClassName"] = pclass
    return {"metadata": {"name": name, "namespace": "default", "labels": labels or {},
                         "annotations": annotations or {}}, "spec": spec}


def pc_doc(name, value):
    return {"apiVersion": "scheduling.k8s.io/v1", "kind": "PriorityClass",
            "metadata": {"name": name}, "value": value, "globalDefault": False}


def pdb_doc(name, match_labels, min_available=None, max_unavailable=None):
    spec = {"selector": {"matchLabels": match_labels}}
    if min_available is not None:
        spec["minAvailable"] = min_available
    if max_unavailable is not None:
        spec["maxUnavailable"] = max_unavailable
    return {"apiVersion": "policy/v1", "kind": "PodDisruptionBudget",
            "metadata": {"name": name, "namespace": "default"}, "spec": spec}


def scenario(nodes, apps, pcs=(), pdbs=(), cluster_pods=(), **kw):
    return dict(nodes=nodes, apps=apps, pcs=list(pcs), pdbs=list(pdbs),
                cluster_pods=list(cluster_pods), kw=kw)


def build(pkg, sc):
    """(cluster, apps, simulate kwargs) of a scenario through `pkg`'s objects."""
    loader, objects, core = PKG[pkg]

    def objs(cls, docs):
        return [cls.from_dict(copy.deepcopy(d)) for d in docs]

    cluster = loader.ClusterResources()
    cluster.nodes = objs(objects.Node, sc["nodes"])
    cluster.priority_classes = objs(objects.PriorityClass, sc["pcs"])
    cluster.pdbs = objs(objects.PodDisruptionBudget, sc["pdbs"])
    cluster.pods = objs(objects.Pod, sc["cluster_pods"])
    apps = []
    for i, docs in enumerate(sc["apps"]):
        res = loader.ClusterResources()
        res.pods = objs(objects.Pod, docs)
        apps.append(core.AppResource(name=f"a{i}", resources=res))
    return cluster, apps, dict(sc["kw"])


LOW2 = [pod_doc("low-a", "1800m"), pod_doc("low-b", "1800m")]
HIGH = [pod_doc("high", "1800m", pclass="critical")]
ANTI_X = {"podAntiAffinity": {"requiredDuringSchedulingIgnoredDuringExecution": [{
    "labelSelector": {"matchLabels": {"app": "x"}}, "topologyKey": "kubernetes.io/hostname"}]}}
GPU_NODE = {"alibabacloud.com/gpu-count": "1", "alibabacloud.com/gpu-mem": "32"}


def gpu_pod(name, mem, pclass=""):
    return pod_doc(name, "500m", pclass=pclass,
                   annotations={"alibabacloud.com/gpu-mem": str(mem)})


# the cases of tests/test_preemption.py (its two session cases are in
# tests/test_torch_simulator.py), then two of the port's own
CASES = {
    "basic-preemption": scenario([node_doc("n0")], [LOW2, HIGH],
                                 pcs=[pc_doc("critical", 1000)]),
    "equal-priorities": scenario([node_doc("n0")], [[pod_doc(n, "1800m") for n in "abc"]]),
    "flag-off": scenario([node_doc("n0")], [LOW2, HIGH], pcs=[pc_doc("critical", 1000)],
                         preemption=False),
    "victim-is-lowest": scenario(
        [node_doc("n0")], [[pod_doc("mid", "1800m", pclass="mid"), pod_doc("zero", "1800m")],
                           HIGH], pcs=[pc_doc("mid", 100), pc_doc("critical", 1000)]),
    "pdb-steers": scenario(
        [node_doc("n0", 2000), node_doc("n1", 2000)],
        [[pod_doc("guarded", "1800m", labels={"app": "guarded"}, on="n0"),
          pod_doc("free", "1800m", on="n1")], HIGH],
        pcs=[pc_doc("critical", 1000)], pdbs=[pdb_doc("guard", {"app": "guarded"}, 1)]),
    "pdb-last-resort": scenario(
        [node_doc("n0", 2000)], [[pod_doc("guarded", "1800m", labels={"app": "guarded"})], HIGH],
        pcs=[pc_doc("critical", 1000)], pdbs=[pdb_doc("guard", {"app": "guarded"}, 1)]),
    "victims-deleted": scenario(
        [node_doc("n0", 2000), node_doc("n1", 2000)],
        [[pod_doc("mid", "1800m", on="n0", pclass="mid")],
         [pod_doc("high", "1800m", on="n0", pclass="critical")]],
        pcs=[pc_doc("mid", 100), pc_doc("critical", 1000)]),
    "bound-pods-stay": scenario(
        [node_doc("n0"), node_doc("n1")],
        [[pod_doc("victim", "1800m", on="n0"), pod_doc("bystander", "1800m")],
         [pod_doc("high", "3000m", on="n0", pclass="critical")]],
        pcs=[pc_doc("critical", 1000)]),
    "rollback": scenario(
        [node_doc("n0")],
        [[pod_doc("equal", "500m", labels={"app": "x"}, pclass="mid"), pod_doc("low", "3000m")],
         [pod_doc("high", "1800m", affinity=ANTI_X, pclass="critical")]],
        pcs=[pc_doc("mid", 100), pc_doc("critical", 1000)]),
    "negative-priority": scenario(
        [node_doc("n0", 2000)], [[pod_doc("neg", "1800m", pclass="underdog")],
                                 [pod_doc("plain", "1800m")]],
        pcs=[pc_doc("underdog", -100)]),
    # a leading nodeName run (the first pass folds it; the rescans, with
    # columns, run it through the step) and victims on three nodes
    "forced-prefix": scenario(
        [node_doc(f"n{i}", 3200) for i in range(3)],
        [[pod_doc(f"low-{i}", "1200m") for i in range(5)],
         [pod_doc(f"high-{i}", "2500m", pclass="critical") for i in range(3)]],
        pcs=[pc_doc("critical", 1000)],
        cluster_pods=[pod_doc(f"pinned-{i}", "300m", node_name=f"n{i % 3}") for i in range(4)]),
    # GPU share: the planner frees a victim's device memory, the rescan
    # re-picks devices
    "gpu-share": scenario(
        [node_doc("g0", 8000, extra=GPU_NODE), node_doc("g1", 8000, extra=GPU_NODE)],
        [[gpu_pod(f"train-{i}", 12) for i in range(4)], [gpu_pod("infer", 14, "critical")]],
        pcs=[pc_doc("critical", 1000)]),
}


def answer(r):
    return (r.placements(), {u.pod.key: u.reason for u in r.unscheduled_pods},
            sorted(r.preempted_pod_keys),
            [(ns.node.name, [p.key for p in ns.pods]) for ns in r.node_status],
            r.gpu_assignments)


@pytest.mark.parametrize("name", sorted(CASES))
def test_simulate_preemption_equals_reference(name):
    sc = CASES[name]
    cluster_j, apps_j, kw = build("jax", sc)
    rj = jcore.simulate(cluster_j, apps_j, **kw)
    cluster_t, apps_t, kw = build("torch", sc)
    rt = tcore.simulate(cluster_t, apps_t, device="cpu", **kw)
    assert answer(rt) == answer(rj)
    assert rt.fail_counts.dtype == rj.fail_counts.dtype
    np.testing.assert_array_equal(rt.fail_counts, rj.fail_counts)
    assert result_digest(rt) == result_digest(rj)
    want_preempted = name not in ("equal-priorities", "flag-off", "rollback")
    assert bool(rt.preempted_pod_keys) == want_preempted


def test_the_cases_preempt_as_the_reference_tests_expect():
    """A few of tests/test_preemption.py's own assertions, through the port."""
    r = tcore.simulate(*build("torch", CASES["basic-preemption"])[:2], device="cpu")
    assert r.placements()["default/high"] == "n0"
    assert [u.reason for u in r.unscheduled_pods] == [
        'preempted to admit higher-priority pod "default/high"']
    r = tcore.simulate(*build("torch", CASES["rollback"])[:2], device="cpu")
    assert [u.pod.meta.name for u in r.unscheduled_pods] == ["high"]
    assert "preempted" not in r.unscheduled_pods[0].reason
    r = tcore.simulate(*build("torch", CASES["forced-prefix"])[:2], device="cpu")
    assert r.snapshot.n_pods == 12 and len(r.preempted_pod_keys) >= 3
    assert all(r.placements()[f"default/high-{i}"] for i in range(3))


def test_pdb_percentages_equal_reference():
    """tests/test_preemption.py's percentage-budget case, both packages."""
    docs = [pod_doc(f"p{i}", labels={"app": "db"}) for i in range(4)]
    snaps = {pkg: enc.encode_cluster([objs.Node.from_dict(node_doc("n0"))],
                                     [objs.Pod.from_dict(copy.deepcopy(d)) for d in docs])
             for pkg, objs, enc in (("jax", jobjects, jsnapshot), ("torch", tobjects, tsnapshot))}
    for spec, assign, want in (({"min_available": "50%"}, [0, 0, -1, -1], [0]),
                               ({"max_unavailable": "25%"}, [0, 0, -1, -1], [0]),
                               ({"max_unavailable": "25%"}, [0, 0, 0, 0], [1])):
        allowed = []
        for pkg, mod in (("jax", jpre), ("torch", tpre)):
            cls = PKG[pkg][1].PodDisruptionBudget
            st = mod._PdbState(snaps[pkg], [cls.from_dict(pdb_doc("b", {"app": "db"}, **spec))],
                               np.array(assign))
            allowed.append(st.allowed)
            assert st.violations([0, 1]) == max(0, 2 - st.allowed[0])
        assert allowed == [want, want]


def _synthetic(rich):
    return jax_synthetic(48, 256, rich=rich, bound=0.2)


def _devres(rich):
    return encode_manifests("jax", device_resource_manifests(48, 320, rich=rich))


ENGINE = {"plain-fit": lambda: _synthetic(False), "rich": lambda: _synthetic(True),
          "devres": lambda: _devres(False), "devres-rich": lambda: _devres(True)}


@pytest.mark.parametrize("name", sorted(ENGINE))
def test_schedule_pods_columns_equal_reference(name):
    snap = ENGINE[name]()
    active = np.asarray(snap.arrays.active).copy()
    active[np.arange(snap.n_nodes) % 9 == 4] = False
    disabled, nominated = preemption_columns(snap.arrays.forced_node, active, len(name))
    jcfg, outs_j, st_j = tp.run_jax(snap, active=active, disabled=disabled, nominated=nominated)
    outs_t, st_t = tp.run_torch(tp.fields(snap.arrays), active, tp.torch_cfg(jcfg),
                                disabled=disabled, nominated=nominated)
    tp.assert_same(outs_j, st_j, outs_t, st_t)
    node = outs_t["node"]
    assert (node[disabled] == -3).all() and (outs_t["feasible"][disabled] == 0).all()
    assert not outs_t["fail_counts"][disabled].any()
    # a nomination that holds is the pick, and the feasible count is 1
    held = (~disabled & (nominated >= 0) & (snap.arrays.forced_node == -1)
            & (outs_t["feasible"] == 1) & (node == nominated))
    assert held.sum() > 10
    if name.startswith("devres"):
        assert (outs_t["gpu_pick"][disabled] == 0).all()
        assert (outs_t["vol_pick"][disabled] == -1).all()


def test_prefix_fold_is_skipped_under_the_columns():
    """With the columns, the forced prefix runs the step: its fail and
    feasible rows are the step's, not the fold's zeros (the reference's
    schedule_pods sets k = 0 the same way)."""
    snap = _synthetic(False)
    jcfg, outs_j, _ = tp.run_jax(snap, disabled=np.zeros(snap.n_pods, bool))
    assert jcfg.forced_prefix >= 1
    outs_t, _ = tp.run_torch(tp.fields(snap.arrays), snap.arrays.active, tp.torch_cfg(jcfg),
                             disabled=np.zeros(snap.n_pods, bool))
    outs_f, _ = tp.run_torch(tp.fields(snap.arrays), snap.arrays.active, tp.torch_cfg(jcfg))
    np.testing.assert_array_equal(outs_t["feasible"], outs_j["feasible"])
    np.testing.assert_array_equal(outs_t["node"], outs_f["node"])
    assert outs_t["feasible"][0] > 0 and outs_f["feasible"][0] == 0


def test_columns_of_the_wrong_length_are_refused():
    snap = _synthetic(False)
    cfg = tp.torch_cfg(tp.run_jax(snap)[0])
    arrs = convert.snapshot_arrays_from_numpy(tp.fields(snap.arrays))
    with pytest.raises(ValueError, match="nominated must be"):
        tsched.schedule_pods(arrs, snap.arrays.active, cfg, device="cpu",
                                nominated=np.zeros(3, np.int32))


def _write_config(tmp_path):
    """A capacity plan whose cluster is full of low-priority pods and whose
    app brings higher-priority ones: no newNode, so the decoded lane is
    the one lane, and it has unscheduled pods."""
    import yaml

    cdir, adir = tmp_path / "cluster", tmp_path / "app"
    cdir.mkdir()
    adir.mkdir()
    docs = [{"apiVersion": "v1", "kind": "Node", **node_doc(f"n{i}", 4000)} for i in range(2)]
    docs += [pc_doc("critical", 1000), pdb_doc("keep", {"app": "web"}, min_available=2)]
    docs += [{"apiVersion": "v1", "kind": "Pod",
              **pod_doc(f"web-{i}", "1200m", labels={"app": "web"})} for i in range(6)]
    (cdir / "cluster.yaml").write_text(yaml.safe_dump_all(docs))
    app = [{"apiVersion": "v1", "kind": "Pod", **pod_doc(f"api-{i}", "2000m", pclass="critical")}
           for i in range(2)]
    (adir / "app.yaml").write_text(yaml.safe_dump_all(app))
    cfg = tmp_path / "config.yaml"
    cfg.write_text(yaml.safe_dump({
        "apiVersion": "simon/v1alpha1", "kind": "Config", "metadata": {"name": "preempt"},
        "spec": {"cluster": {"customConfig": "cluster"},
                 "appList": [{"name": "api", "path": "app"}]}}))
    return str(cfg)


@pytest.mark.parametrize("mode", ["bisect", "exhaustive"])
def test_applier_decoded_lane_preempts_as_reference(tmp_path, mode, monkeypatch, capsys):
    path = _write_config(tmp_path)
    results = {}
    for pkg, mod in (("jax", japplier), ("torch", tapplier)):
        orig = mod.Applier._result_for

        def record(self, *a, _orig=orig, _pkg=pkg, **kw):
            results[_pkg] = _orig(self, *a, **kw)
            return results[_pkg]

        monkeypatch.setattr(mod.Applier, "_result_for", record)
    argv = ["apply", "-f", path, "--sweep-mode", mode]
    rc_j = ref_main(argv)
    out_j = capsys.readouterr().out
    rc_t = port_main(argv + ["--device", "cpu"])
    out_t = capsys.readouterr().out
    assert (rc_t, out_t) == (rc_j, out_j)
    rj, rt = results["jax"], results["torch"]
    assert answer(rt) == answer(rj)
    assert result_digest(rt) == result_digest(rj)
    assert len(rt.preempted_pod_keys) >= 2 and "preempted to admit" in out_t
