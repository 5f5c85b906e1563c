"""Explain and the seeded tie-break through the port equal the JAX package.

* The engine: ``schedule_pods`` (scan), ``schedule_lanes``, a wave plan
  and ``simulate()`` under preemption, with ``explain_topk`` and/or
  ``tie_break_seed``, against the reference on the same arrays: node,
  fail and feasible counts, GPU and PV picks, every carry field and the
  three top-k tensors. Tolerance: exact. (ROADMAP's known differences
  allow a one-ulp score difference where XLA's CPU backend contracts an
  FMA; ``topk_score`` and ``topk_parts`` are equal as values, every
  integer output and carry field bit for bit, except on the GPU-share
  row, which XLA contracts: there the scores are within one ulp and the
  parts within two ulps of the score. A zero part can differ in its
  sign: see ``assert_outputs_equal``.)
* The top-k's order: ``engine.scheduler.rank_desc`` against
  ``lax.top_k`` on vectors with ties, filler sentinels and a -0.0 beside
  a +0.0 (``lax.top_k`` ranks +0.0 first; selectHost's ``pick_key`` keys
  them equal, and the kernel's top-k key keeps the total order).
* ``tests/test_local_storage_and_profile.py::test_tie_break_seed_changes_only_ties``
  through the port, with the reference's placements.
* The cases of ``tests/test_explain.py`` (all but the ``--trace-out`` and
  chaos ones) through the port's ``simulate(device="cpu")``,
  ``telemetry/explain.py``, ``Simulator`` and CLI; the reports equal the
  reference's.
"""

from __future__ import annotations

import copy
import json
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

import torch_parity as tp
from open_simulator_tpu import core as jcore
from open_simulator_tpu import simulator as jsimulator
from open_simulator_tpu.cli.main import main as ref_main
from open_simulator_tpu.engine import scheduler as jsched
from open_simulator_tpu.engine import waves as JW
from open_simulator_tpu.k8s import loader as jloader
from open_simulator_tpu.k8s import objects as jobjects
from open_simulator_tpu.parallel import sweep as jsweep
from open_simulator_tpu.telemetry import explain as jexplain
from open_simulator_tpu.telemetry.ledger import result_digest
from open_simulator_tpu.testing.synthetic import synthetic_snapshot as jsynthetic
from open_simulator_tpu_torch import convert
from open_simulator_tpu_torch import core as tcore
from open_simulator_tpu_torch import simulator as tsimulator
from open_simulator_tpu_torch.cli.main import main as port_main
from open_simulator_tpu_torch.engine import scheduler as tsched
from open_simulator_tpu_torch.engine import waves as TW
from open_simulator_tpu_torch.k8s import loader as tloader
from open_simulator_tpu_torch.k8s import objects as tobjects
from open_simulator_tpu_torch.telemetry import explain as texplain
from open_simulator_tpu_torch.testing.synthetic import device_resource_manifests
from tests.test_torch_devres import encode_manifests

TOPK = ("topk_node", "topk_score", "topk_parts")
OUTS = tp.OUTPUTS + TOPK
MODES = {"topk": dict(explain_topk=3), "seed": dict(tie_break_seed=7),
         "topk-seed": dict(explain_topk=4, tie_break_seed=2**31 - 1)}
SNAPS = {"plain": lambda: jsynthetic(16, 48, 0),
         "rich": lambda: jsynthetic(16, 48, 0, rich=True),
         "bound-prefix": lambda: jsynthetic(16, 64, 0, bound=0.5),
         "devres": lambda: encode_manifests("jax", device_resource_manifests(12, 40))}
_CACHE: dict = {}


def snapshot(name):
    if name not in _CACHE:
        snap = SNAPS[name]()
        _CACHE[name] = (snap, tp.port_snapshot(snap))
    return _CACHE[name]


def outputs(out) -> dict:
    return {k: np.asarray(getattr(out, k)) for k in OUTS}


def assert_outputs_equal(want: dict, got: dict, names=OUTS, fma: bool = False) -> None:
    """Every output equal; the integer ones bit for bit, the top-k floats
    as values (a zero part can carry the other sign: where a normalizer's
    range is 0 the reference's XLA-fused row multiplies a fused difference
    by the zero inverse and can give -0.0, the port's IEEE ops +0.0).

    `fma`: the GPU-share row, whose min-max normalization XLA's CPU
    backend contracts into an FMA (ROADMAP's known differences): the
    scores within one ulp, each part within two ulps of its candidate's
    score (the FMA skips one rounding of lo * inv, a product no larger
    than the score), the filler slots exact."""
    for k in names:
        assert want[k].dtype == got[k].dtype, k
        assert want[k].shape == got[k].shape, k
        if want[k].dtype != np.float32:
            assert want[k].tobytes() == got[k].tobytes(), k
        elif not fma:
            assert np.array_equal(want[k], got[k]), k
    if fma and "topk_score" in names:
        score = want["topk_score"]
        np.testing.assert_array_max_ulp(score, got["topk_score"], maxulp=1)
        room = 2 * np.spacing(np.abs(score))[..., None, :]
        assert (np.abs(want["topk_parts"] - got["topk_parts"]) <= room).all()
        filler = score <= -1e37
        assert (got["topk_parts"][np.broadcast_to(filler[..., None, :],
                                                  got["topk_parts"].shape)] == 0).all()


def assert_states_equal(st_j: dict, st_t: dict) -> None:
    for f, want in st_j.items():
        assert st_t[f].dtype == want.dtype, f
        assert st_t[f].tobytes() == want.tobytes(), f


# ---- the engine ---------------------------------------------------------------

@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("name", sorted(SNAPS))
def test_scan_equals_reference(name, mode):
    snap, tsnap = snapshot(name)
    jcfg = jsched.make_config(snap, **MODES[mode])
    ref = jsched.schedule_pods(jsched.device_arrays(snap), jnp.asarray(snap.arrays.active),
                               jcfg, waves=None)
    got = tsched.schedule_pods(tsnap.arrays, snap.arrays.active, tp.torch_cfg(jcfg),
                               device="cpu")
    assert_outputs_equal(outputs(ref), {k: getattr(got, k).numpy() for k in OUTS},
                         fma=name == "devres")
    assert_states_equal(tp.jax_state(ref.state), convert.state_to_numpy(got.state))
    if jcfg.explain_topk:
        k_top = min(jcfg.explain_topk, snap.n_nodes)
        assert got.topk_node.shape == (snap.n_pods, k_top)
        assert got.topk_parts.shape[1] == len(tsched.score_part_names(tp.torch_cfg(jcfg)))
        if name == "bound-prefix":
            k = jcfg.forced_prefix
            assert k > 0 and (got.topk_node[:k] == -1).all()
            assert (got.topk_node[k:, 0] >= 0).any()


def test_score_part_names_equal_reference():
    for name in SNAPS:
        snap, _ = snapshot(name)
        for over in ({}, {"w_taint": 0.0, "w_simon": 0.0}, {"w_spread": 0.0}):
            jcfg = jsched.make_config(snap, explain_topk=2, **over)
            assert tsched.score_part_names(tp.torch_cfg(jcfg)) == jsched.score_part_names(jcfg)


@pytest.mark.parametrize("mode", ["topk", "topk-seed"])
def test_lanes_equal_reference_lanes(mode):
    snap, tsnap = snapshot("rich")
    n = snap.n_nodes
    masks = np.stack([np.ones(n, bool), np.arange(n) % 3 != 1, np.arange(n) >= n // 4])
    jcfg = jsched.make_config(snap, **MODES[mode])
    ref = jsweep.batched_schedule(jsched.device_arrays(snap), jnp.asarray(masks), jcfg)
    got = tsched.schedule_lanes(tsnap.arrays, masks, tp.torch_cfg(jcfg), device="cpu")
    assert_outputs_equal({k: np.asarray(getattr(ref, k)) for k in OUTS},
                         {k: getattr(got, k).numpy() for k in OUTS})
    assert_states_equal(tp.jax_state(ref.state), convert.state_to_numpy(got.state))


@pytest.mark.parametrize("mode", ["topk", "seed", "topk-seed"])
def test_waves_equal_reference_and_scan(mode):
    """A pools cluster whose plan batches (one GRID): the port's wave run
    and its scan equal the reference's wave run, top-k tensors included."""
    snap = jsynthetic(16, 96, 0, pools=8)
    tsnap = tp.port_snapshot(snap)
    jcfg = jsched.make_config(snap, **MODES[mode])
    tcfg = tsched.EngineConfig(**jcfg._asdict())
    jplan, plan = JW.waves_for(snap.arrays, jcfg), TW.waves_for(tsnap.arrays, tcfg)
    assert plan is not None and tuple(plan) == tuple(jplan)
    assert any(s[2] == TW.GRID for s in plan.segments)
    ref = jsched.schedule_pods(jsched.device_arrays(snap), jnp.asarray(snap.arrays.active),
                               jcfg, waves=jplan)
    for wp in (plan, None):
        got = tsched.schedule_pods(tsnap.arrays, snap.arrays.active, tcfg, device="cpu",
                                   waves=wp)
        assert_outputs_equal(outputs(ref), {k: getattr(got, k).numpy() for k in OUTS})
        assert_states_equal(tp.jax_state(ref.state), convert.state_to_numpy(got.state))


def _preempt_objects(objects, loader, core):
    node = {"metadata": {"name": "solo"},
            "status": {"allocatable": {"cpu": "2", "memory": "8Gi", "pods": 110}}}
    pcs = [objects.PriorityClass.from_dict({
        "apiVersion": "scheduling.k8s.io/v1", "kind": "PriorityClass",
        "metadata": {"name": "critical"}, "value": 1000, "globalDefault": False})]

    def pod(name, cpu, pclass=""):
        spec = {"containers": [{"name": "c", "resources": {"requests": {"cpu": cpu}}}]}
        if pclass:
            spec["priorityClassName"] = pclass
        return objects.Pod.from_dict({"metadata": {"name": name, "namespace": "default"},
                                      "spec": spec})

    cluster = loader.ClusterResources()
    cluster.nodes = [objects.Node.from_dict(copy.deepcopy(node)),
                     objects.Node.from_dict({**copy.deepcopy(node),
                                             "metadata": {"name": "other"}})]
    cluster.priority_classes = pcs
    cluster.pods = [pod(f"low-{i}", "900m") for i in range(4)]
    apps = loader.ClusterResources()
    apps.pods = [pod("high-0", "1500m", "critical"), pod("high-1", "1500m", "critical")]
    return cluster, [core.AppResource("a", apps)]


@pytest.mark.parametrize("mode", ["topk", "topk-seed"])
def test_simulate_under_preemption_equals_reference(mode):
    """simulate() with victims: the returned pass's top-k tensors, the
    placements and result_digest are the reference's."""
    ref = jcore.simulate(*_preempt_objects(jobjects, jloader, jcore),
                         config_overrides=dict(MODES[mode]))
    got = tcore.simulate(*_preempt_objects(tobjects, tloader, tcore), device="cpu",
                         config_overrides=dict(MODES[mode]))
    assert ref.preempted_pod_keys and got.preempted_pod_keys == ref.preempted_pod_keys
    assert result_digest(got) == result_digest(ref)
    assert got.placements() == ref.placements()
    assert_outputs_equal({k: np.asarray(getattr(ref, k)) for k in TOPK},
                         {k: getattr(got, k) for k in TOPK}, TOPK)
    assert got.score_part_names == ref.score_part_names
    assert texplain.explain_result(got) == jexplain.explain_result(ref)


def test_tie_break_seed_changes_only_ties():
    """tests/test_local_storage_and_profile.py's case through the port:
    identical nodes tie everywhere; every variant schedules everything,
    different seeds resolve the ties differently, and each variant's
    placements are the reference's."""
    def run(pkg, **over):
        loader, core, snapshot_mod = tp.PKGS[pkg]
        objects = jobjects if pkg == "jax" else tobjects
        cluster = loader.ClusterResources()
        cluster.nodes = [objects.Node.from_dict({
            "metadata": {"name": f"n{i}"},
            "status": {"allocatable": {"cpu": "4", "memory": "8Gi", "pods": 110}}})
            for i in range(4)]
        app = loader.ClusterResources()
        app.pods = [objects.Pod.from_dict({
            "metadata": {"name": f"p{i}", "namespace": "default"},
            "spec": {"containers": [{"name": "c", "resources": {"requests": {
                "cpu": "500m", "memory": "512Mi"}}}]}}) for i in range(8)]
        pods = core.build_pod_sequence(cluster, [core.AppResource(name="a", resources=app)])
        snap = snapshot_mod.encode_cluster(cluster.nodes, pods)
        if pkg == "jax":
            arrs = jsched.device_arrays(snap)
            return np.asarray(jsched.schedule_pods(
                arrs, arrs.active, jsched.make_config(snap, **over)).node)
        return tsched.schedule_pods(snap.arrays, snap.arrays.active,
                                    tsched.make_config(snap, **over), device="cpu").node.numpy()

    a, b, det = run("torch", tie_break_seed=7), run("torch", tie_break_seed=8), run("torch")
    assert (a >= 0).all() and (b >= 0).all() and (det >= 0).all()
    assert not np.array_equal(a, b) or not np.array_equal(a, det)
    assert np.array_equal(a, run("jax", tie_break_seed=7))
    assert np.array_equal(b, run("jax", tie_break_seed=8))
    assert np.array_equal(det, run("jax"))


# ---- the top-k's order --------------------------------------------------------

NEG = -3.4e38


@pytest.mark.parametrize("vec", [
    [0.0, -0.0], [-0.0, 0.0], [-0.0, NEG, 0.0, -0.0, 0.0],
    [1.0, NEG, 1.0, 2.5, NEG, 2.5, -0.0, 0.0],
    [NEG, NEG, NEG], [3.0, -1.0, -0.0, -1.0, 3.0],
])
def test_rank_desc_is_lax_top_k_order(vec):
    v = np.asarray(vec, np.float32)
    _, want = jax.lax.top_k(jnp.asarray(v), len(v))
    import torch

    got = tsched.rank_desc(torch.from_numpy(v)).numpy()
    assert got.tolist() == np.asarray(want).tolist()


@settings(max_examples=60, deadline=None)
@given(st.lists(st.sampled_from([0.0, -0.0, 1.0, -1.0, 2.5, 100.0, NEG]),
                min_size=1, max_size=40))
def test_rank_desc_on_random_ties(vals):
    import torch

    v = np.asarray(vals, np.float32)
    _, want = jax.lax.top_k(jnp.asarray(v), len(v))
    assert tsched.rank_desc(torch.from_numpy(v)).numpy().tolist() == np.asarray(want).tolist()


# ---- tests/test_explain.py through the port --------------------------------

def make_node(objects, name, cpu_m=4000, taints=None):
    return objects.Node.from_dict({
        "metadata": {"name": name, "labels": {}},
        "status": {"allocatable": {"cpu": f"{cpu_m}m", "memory": "8192Mi", "pods": 110}},
        "spec": {"taints": taints or [], "unschedulable": False}})


def make_pod(objects, name, cpu="500m", tolerations=None, node_name="", labels=None):
    spec = {"containers": [{"name": "c", "image": "nginx",
                            "resources": {"requests": {"cpu": cpu, "memory": "512Mi"}}}]}
    if tolerations:
        spec["tolerations"] = tolerations
    if node_name:
        spec["nodeName"] = node_name
    return objects.Pod.from_dict({"metadata": {"name": name, "namespace": "default",
                                               "labels": labels or {}, "annotations": {}},
                                  "spec": spec})


PKG = {"jax": (jloader, jobjects, jcore, {}), "torch": (tloader, tobjects, tcore,
                                                      {"device": "cpu"})}


def small_cluster(pkg):
    """tests/test_explain.py's fixture: two schedulable nodes (one tainted);
    a pod that fits, one whose cpu fits nowhere, one blocked by the taint
    on one node and cpu on the other."""
    loader, objects, core, _ = PKG[pkg]
    cluster = loader.ClusterResources()
    cluster.nodes = [make_node(objects, "big", cpu_m=4000),
                     make_node(objects, "small-tainted", cpu_m=1000, taints=[
                         {"key": "dedicated", "value": "infra", "effect": "NoSchedule"}])]
    apps = loader.ClusterResources()
    apps.pods = [make_pod(objects, "fits", cpu="500m"),
                 make_pod(objects, "too-big", cpu="9000m", tolerations=[{"operator": "Exists"}]),
                 make_pod(objects, "squeezed", cpu="3600m")]
    return cluster, [core.AppResource("a", apps)]


def simulate(pkg, cluster, apps, **overrides):
    _, _, core, dev = PKG[pkg]
    return core.simulate(cluster, apps, config_overrides=overrides or None, **dev)


def test_explain_golden_small_cluster():
    result = simulate("torch", *small_cluster("torch"), explain_topk=2)
    report = texplain.explain_result(result)
    assert report == jexplain.explain_result(
        simulate("jax", *small_cluster("jax"), explain_topk=2))
    assert report["n_active_nodes"] == 2
    assert report["summary"] == {"scheduled": 1, "unscheduled": 2}
    by_pod = {e["pod"]: e for e in report["pods"]}
    fits = by_pod["default/fits"]
    assert fits["status"] == "scheduled" and not fits["forced"]
    assert fits["candidates"][0]["node"] == fits["node"]
    top = fits["candidates"][0]
    assert sum(top["parts"].values()) == pytest.approx(top["score"], abs=1e-2)
    assert set(top["parts"]) == set(report["score_parts"])
    too_big = by_pod["default/too-big"]
    assert too_big["status"] == "unscheduled"
    assert too_big["first_failing_op"] == "Insufficient cpu"
    assert too_big["eliminations"] == [{"op": "Insufficient cpu", "nodes": 2}]
    assert "0/2 nodes are available" in too_big["reason"]
    assert too_big["candidates"] == []
    squeezed = by_pod["default/squeezed"]
    assert squeezed["first_failing_op"] == "node(s) had taint that the pod didn't tolerate"
    assert {e["op"]: e["nodes"] for e in squeezed["eliminations"]} == {
        "node(s) had taint that the pod didn't tolerate": 1, "Insufficient cpu": 1}


def test_explain_matches_engine_fail_counts():
    result = simulate("torch", *small_cluster("torch"))
    report = texplain.explain_result(result)
    keys = [p.key for p in result.snapshot.pods]
    for entry in report["pods"]:
        if entry["status"] != "unscheduled":
            continue
        row = np.asarray(result.fail_counts[keys.index(entry["pod"])])
        assert entry["first_failing_op"] == texplain.first_failing_op(row, result.op_names)
        assert sum(e["nodes"] for e in entry["eliminations"]) == int(row.sum())


def test_topk_outputs_off_by_default():
    result = simulate("torch", *small_cluster("torch"))
    assert result.topk_node is None and result.score_part_names == []
    assert all(e["candidates"] == [] for e in texplain.explain_result(result)["pods"])


def test_topk_respects_node_count_and_order():
    result = simulate("torch", *small_cluster("torch"), explain_topk=16)
    assert result.topk_node.shape == (3, 2)
    report = texplain.explain_result(result, top_k=1)
    fits = next(e for e in report["pods"] if e["pod"] == "default/fits")
    assert len(fits["candidates"]) == 1
    for e in texplain.explain_result(result)["pods"]:
        scores = [c["score"] for c in e["candidates"]]
        assert scores == sorted(scores, reverse=True)


def test_explain_negative_topk_clamped():
    result = simulate("torch", *small_cluster("torch"), explain_topk=2)
    report = texplain.explain_result(result, top_k=-1)
    assert all(e["candidates"] == [] for e in report["pods"])


def test_explain_pod_filter_and_format():
    result = simulate("torch", *small_cluster("torch"), explain_topk=2)
    report = texplain.explain_result(result, pods=["default/too-big"])
    assert [e["pod"] for e in report["pods"]] == ["default/too-big"]
    text = texplain.format_explain(texplain.explain_result(result))
    assert text == jexplain.format_explain(jexplain.explain_result(
        simulate("jax", *small_cluster("jax"), explain_topk=2)))
    assert "default/fits: scheduled on" in text
    assert "default/too-big: UNSCHEDULABLE" in text
    assert "first failing op: Insufficient cpu" in text
    assert "candidate" in text


def test_forced_pod_marked():
    reports = []
    for pkg in ("torch", "jax"):
        loader, objects, _, _ = PKG[pkg]
        cluster = loader.ClusterResources()
        cluster.nodes = [make_node(objects, "n0"), make_node(objects, "n1")]
        cluster.pods = [make_pod(objects, "pinned", node_name="n1")]
        reports.append(texplain.explain_result(simulate(pkg, cluster, [], explain_topk=2)))
    report = reports[0]
    assert report == reports[1]
    [entry] = report["pods"]
    assert entry["forced"] and entry["status"] == "scheduled" and entry["node"] == "n1"
    assert "pinned via spec.nodeName" in texplain.format_explain(report)


def test_preempted_status_from_structured_marker():
    results = []
    for pkg in ("torch", "jax"):
        loader, objects, core, _ = PKG[pkg]
        cluster = loader.ClusterResources()
        cluster.nodes = [make_node(objects, "solo", cpu_m=1000)]
        cluster.pods = [make_pod(objects, "low", cpu="800m")]
        high = make_pod(objects, "high", cpu="800m")
        high.priority = 1000
        apps = loader.ClusterResources()
        apps.pods = [high]
        results.append(simulate(pkg, cluster, [core.AppResource("a", apps)]))
    result = results[0]
    assert result.preempted_pod_keys == ["default/low"]
    report = texplain.explain_result(result)
    assert report == jexplain.explain_result(results[1])
    entry = next(e for e in report["pods"] if e["pod"] == "default/low")
    assert entry["status"] == "preempted" and "preempted" in entry["reason"]
    placed = next(e for e in report["pods"] if e["pod"] == "default/high")
    assert placed["status"] == "scheduled" and placed["node"] == "solo"


def test_simulator_session_carries_explain_surface():
    reports = []
    for pkg, sim_mod in (("torch", tsimulator), ("jax", jsimulator)):
        loader, objects, core, dev = PKG[pkg]
        cluster = loader.ClusterResources()
        cluster.nodes = [make_node(objects, "n0", cpu_m=2000)]
        sim = sim_mod.Simulator(cluster, config_overrides={"explain_topk": 2}, **dev)
        sim.run_cluster()
        apps = loader.ClusterResources()
        apps.pods = [make_pod(objects, "w", cpu="500m", labels={"simon/app-name": "webapp"})]
        res = sim.schedule_app(core.AppResource("webapp", apps))
        reports.append((texplain if pkg == "torch" else jexplain).explain_result(res))
    report = reports[0]
    assert report == reports[1]
    entry = next(e for e in report["pods"] if e["pod"] == "default/w")
    assert entry["status"] == "scheduled" and entry["candidates"]
    assert {e["pod"] for e in report["pods"]} == {"default/w"}


def _explain_config(tmp_path):
    cluster_dir = tmp_path / "cluster"
    cluster_dir.mkdir()
    (cluster_dir / "node.yaml").write_text(textwrap.dedent("""
        apiVersion: v1
        kind: Node
        metadata: {name: c0}
        status:
          allocatable: {cpu: '2', memory: 4Gi, pods: '110'}
    """))
    app_dir = tmp_path / "app"
    app_dir.mkdir()
    (app_dir / "pods.yaml").write_text(textwrap.dedent("""
        apiVersion: v1
        kind: Pod
        metadata: {name: ok, namespace: default}
        spec:
          containers: [{name: c, resources: {requests: {cpu: 500m}}}]
        ---
        apiVersion: v1
        kind: Pod
        metadata: {name: nope, namespace: default}
        spec:
          containers: [{name: c, resources: {requests: {cpu: '32'}}}]
    """))
    config = tmp_path / "config.yaml"
    config.write_text(textwrap.dedent("""
        apiVersion: simon/v1alpha1
        kind: Config
        metadata: {name: explain-test}
        spec:
          cluster: {customConfig: cluster}
          appList:
            - {name: app, path: app}
    """))
    return config


def test_explain_cli_json(tmp_path, capsys):
    config = _explain_config(tmp_path)
    assert port_main(["explain", "-f", str(config), "--json", "--device", "cpu"]) == 0
    report = json.loads(capsys.readouterr().out)
    assert report["summary"] == {"scheduled": 1, "unscheduled": 1}
    nope = next(e for e in report["pods"] if e["pod"] == "default/nope")
    assert nope["first_failing_op"] == "Insufficient cpu"
    assert ref_main(["explain", "-f", str(config), "--json"]) == 0
    assert json.loads(capsys.readouterr().out) == report


def test_explain_cli_missing_config_errors(tmp_path, capsys):
    assert port_main(["explain", "-f", str(tmp_path / "nope.yaml"), "--device", "cpu"]) == 1
    assert "error:" in capsys.readouterr().err


@pytest.mark.parametrize("flags", [["--json"], ["--top-k", "1", "--pod", "default/web-0"],
                                   ["--use-greed"]])
def test_explain_cli_prints_the_reference_report(flags, tmp_path, capsys):
    """examples/config.yaml through both CLIs: the same text or JSON on
    stdout, and with --output-file the same file."""
    config = str(tp.EXAMPLES) + "/config.yaml"
    assert port_main(["explain", "-f", config, "--device", "cpu"] + flags) == 0
    port_out = capsys.readouterr().out
    assert ref_main(["explain", "-f", config] + flags) == 0
    assert capsys.readouterr().out == port_out
    assert port_out.strip()
    out_file = tmp_path / "report.txt"
    assert port_main(["explain", "-f", config, "--device", "cpu", "--output-file",
                      str(out_file)] + flags) == 0
    assert out_file.read_text() == port_out


@pytest.mark.parametrize("flag,item", [("--trace-out", "item 11")])
def test_explain_cli_refuses_unported_options(flag, item, tmp_path, capsys):
    config = str(tp.EXAMPLES) + "/config.yaml"
    assert port_main(["explain", "-f", config, "--device", "cpu", flag,
                      str(tmp_path / "x")]) == 1
    err = capsys.readouterr().err
    assert "error:" in err and item in err


def test_explain_cli_needs_the_card_without_device(monkeypatch, capsys):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert port_main(["explain", "-f", str(tp.EXAMPLES) + "/config.yaml"]) == 1
    assert "CUDA is not available" in capsys.readouterr().err
