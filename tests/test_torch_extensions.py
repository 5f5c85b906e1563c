"""Out-of-tree extension ops through the port equal the JAX package.

The same seeded snapshot runs through the reference with JAX callables
(``open_simulator_tpu.engine.extensions.ExtensionOp``) and through the
port with their torch twins (``open_simulator_tpu_torch.engine.
extensions.ExtensionOp``, the ops of ``testing/synthetic.
synthetic_extensions``): node, fail and feasible counts, GPU and PV
picks and every carry field bit for bit, and the config's
``telemetry/ledger`` hash. Where the reference's XLA CPU backend
contracts the final score sum into an FMA (ROADMAP's known differences)
the top-k scores are within one ulp and the parts within two ulps of
their candidate's score; the explain tests say so.

Covered: every case of ``tests/test_extensions.py``; each normalize kind
and the filter rows; the "max" row's zero fill (every node feasible, one
node feasible, every raw score negative); a NaN score; a score that
reads the carry, at two lanes with different masks; a rich config (the
group_count and the dom_count carries both kept) and a device-resource
one; the preemption columns, and ``simulate()`` under the preemption
pass; explain with K = 3; the loop's device-cursor pod slice, read by
ops of the pod's class, request, index and preemption columns, under a
forced-prefix shift, at two lanes, beside a NaN score and with the
columns; a forced prefix kept by an override;
``simulate()``, ``Simulator``, the sweeps, ``explain_result``,
``run_replay`` and a campaign with extensions; and
``--default-scheduler-config`` on ``apply`` and ``explain`` against the
reference's output on the examples, over the profile cases of
``tests/test_local_storage_and_profile.py`` and ``tests/test_extensions.py``.
Shapes are tiny and each ``ExtensionOp`` is one module-level instance, so
the reference compiles once per config.
"""

from __future__ import annotations

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity as tp
from open_simulator_tpu import core as jcore
from open_simulator_tpu import replay as jreplay
from open_simulator_tpu import simulator as jsimulator
from open_simulator_tpu.cli.main import main as ref_main
from open_simulator_tpu.engine import extensions as jext
from open_simulator_tpu.engine import scheduler as jsched
from open_simulator_tpu.engine.sched_config import weight_overrides_from_file as jweights
from open_simulator_tpu.k8s import loader as jloader
from open_simulator_tpu.k8s import objects as jobjects
from open_simulator_tpu.parallel import sweep as jsweep
from open_simulator_tpu.telemetry import explain as jexplain
from open_simulator_tpu.telemetry import ledger as jledger
from open_simulator_tpu.testing.synthetic import synthetic_snapshot as jsynthetic
from open_simulator_tpu_torch import convert
from open_simulator_tpu_torch import core as tcore
from open_simulator_tpu_torch import replay as treplay
from open_simulator_tpu_torch import simulator as tsimulator
from open_simulator_tpu_torch.cli.main import main as port_main
from open_simulator_tpu_torch.engine import exec_cache
from open_simulator_tpu_torch.engine import extensions as text
from open_simulator_tpu_torch.engine import scheduler as tsched
from open_simulator_tpu_torch.engine.sched_config import weight_overrides_from_file as tweights
from open_simulator_tpu_torch.k8s import loader as tloader
from open_simulator_tpu_torch.k8s import objects as tobjects
from open_simulator_tpu_torch.kernels import step
from open_simulator_tpu_torch.parallel import sweep as tsweep
from open_simulator_tpu_torch.telemetry import explain as texplain
from open_simulator_tpu_torch.telemetry import ledger as tledger
from open_simulator_tpu_torch.testing.synthetic import preemption_columns as jcolumns
from open_simulator_tpu_torch.testing.synthetic import synthetic_extensions
from open_simulator_tpu_torch.testing.synthetic import device_resource_manifests
from tests.test_torch_devres import encode_manifests
from tests.test_torch_explain import assert_outputs_equal

TOPK = ("topk_node", "topk_score", "topk_parts")

# the reference's twins of synthetic_extensions(), in the same order
J_EXTS = (
    jext.ExtensionOp(name="node(s) rejected by the even-index policy",
                     filter_fn=lambda state, arrs, x: jnp.arange(arrs.alloc.shape[0]) % 2 == 0),
    jext.ExtensionOp(name="node(s) rejected by the rotation policy",
                     filter_fn=lambda state, arrs, x: (
                         (jnp.arange(arrs.alloc.shape[0]) + x["_pod_index"]) % 5 != 0)),
    jext.ExtensionOp(name="prefer-large-nodes", normalize="minmax", weight=2.0,
                     score_fn=lambda state, arrs, x: arrs.alloc[:, 0]),
    jext.ExtensionOp(name="prefer-free-cpu", normalize="max", weight=3.0,
                     score_fn=lambda state, arrs, x: (
                         state.headroom[:, 0] / jnp.maximum(arrs.alloc[:, 0], 1.0))),
    jext.ExtensionOp(name="fixed-pattern", weight=0.5,
                     score_fn=lambda state, arrs, x: (
                         jnp.arange(arrs.alloc.shape[0]) % 7).astype(jnp.float32) * 10.0),
)
T_EXTS = synthetic_extensions()
ALL = tuple(range(len(J_EXTS)))

# the "max" row's edges and a NaN, on a raw score of the carry: every node
# below zero but the masked-in ones' own values, one node in the mask, a
# NaN at one node
J_NEG = jext.ExtensionOp(name="negative-free-cpu", normalize="max",
                         score_fn=lambda state, arrs, x: -state.headroom[:, 0] - 1.0)
T_NEG = text.ExtensionOp(name="negative-free-cpu", normalize="max",
                         score_fn=lambda state, arrs, x: -state.headroom[:, 0] - 1.0)
J_ONE = jext.ExtensionOp(name="node(s) outside the one-node policy",
                         filter_fn=lambda state, arrs, x: jnp.arange(arrs.alloc.shape[0]) == 5)
T_ONE = text.ExtensionOp(name="node(s) outside the one-node policy",
                         filter_fn=lambda state, arrs, x: torch.arange(arrs.alloc.shape[0]) == 5)
J_NAN = jext.ExtensionOp(name="nan-at-node-3", normalize="minmax", score_fn=lambda s, a, x: (
    jnp.where((jnp.arange(a.alloc.shape[0]) == 3) & (x["_pod_index"] % 3 == 0), jnp.nan, 1.0)))
T_NAN = text.ExtensionOp(name="nan-at-node-3", normalize="minmax", score_fn=lambda s, a, x: (
    torch.where((torch.arange(a.alloc.shape[0]) == 3) & (x["_pod_index"] % 3 == 0), torch.nan,
                1.0)))
# ops that read the pod slice beyond _pod_index: a filter of the pod's
# class and index, a score of its request, index and preemption columns
# (small integers, so both packages' sums are exact)
J_XF = jext.ExtensionOp(name="node(s) rejected by the class policy", filter_fn=lambda s, a, x: (
    (jnp.arange(a.alloc.shape[0]) + x["class_id"] + x["_pod_index"]) % 4 != 1))
T_XF = text.ExtensionOp(name="node(s) rejected by the class policy", filter_fn=lambda s, a, x: (
    (torch.arange(a.alloc.shape[0]) + x["class_id"] + x["_pod_index"]) % 4 != 1))
J_XS = jext.ExtensionOp(name="pod-slice-pattern", weight=0.5, score_fn=lambda s, a, x: (
    ((jnp.arange(a.alloc.shape[0]) + x["_pod_index"]) % 7).astype(jnp.float32) * 10.0
    + (x["req"][0] > 500.0).astype(jnp.float32) * (jnp.arange(a.alloc.shape[0]) % 2) * 5.0
    + (jnp.maximum(x["_nominated"], 0) % 3).astype(jnp.float32)
    + x["_disabled"].astype(jnp.float32) * 2.0))
T_XS = text.ExtensionOp(name="pod-slice-pattern", weight=0.5, score_fn=lambda s, a, x: (
    ((torch.arange(a.alloc.shape[0]) + x["_pod_index"]) % 7).to(torch.float32) * 10.0
    + (x["req"][0] > 500.0).to(torch.float32) * (torch.arange(a.alloc.shape[0]) % 2) * 5.0
    + (torch.clamp_min(x["_nominated"], 0) % 3).to(torch.float32)
    + x["_disabled"].to(torch.float32) * 2.0))
PAIRS = {"neg": (J_NEG, T_NEG), "one": (J_ONE, T_ONE), "nan": (J_NAN, T_NAN),
         "xf": (J_XF, T_XF), "xs": (J_XS, T_XS)}

_SNAPS: dict = {}


def snapshot(name):
    """A seeded reference snapshot and the port's view of it."""
    if name not in _SNAPS:
        snap = {"plain": lambda: jsynthetic(12, 24, 0),
                "rich": lambda: jsynthetic(16, 32, 0, rich=True),
                "bound": lambda: jsynthetic(12, 24, 0, bound=0.5),
                "devres": lambda: encode_manifests("jax", device_resource_manifests(12, 28))}[name]()
        _SNAPS[name] = (snap, tp.port_snapshot(snap))
    return _SNAPS[name]


def pick(idx, extra=()):
    j = tuple(J_EXTS[i] for i in idx) + tuple(PAIRS[k][0] for k in extra)
    t = tuple(T_EXTS[i] for i in idx) + tuple(PAIRS[k][1] for k in extra)
    return j, t


def run_both(name, idx=ALL, extra=(), masks=None, columns=False, **over):
    """schedule_pods (one lane) or the lanes of `masks` through both
    packages with the same extension ops; returns (ref, got, tcfg)."""
    snap, tsnap = snapshot(name)
    j_ops, t_ops = pick(idx, extra)
    jcfg = jsched.make_config(snap, extensions=j_ops, **over)
    tcfg = tsched.make_config(tsnap, extensions=t_ops, **over)
    assert tledger.engine_config_hash(tcfg) == jledger.engine_config_hash(jcfg)
    cols = {}
    if columns:
        dis, nom = jcolumns(snap.arrays.forced_node, snap.arrays.active, seed=3)
        cols = dict(disabled=dis, nominated=nom)
    if masks is None:
        ref = jsched.schedule_pods(jsched.device_arrays(snap), jnp.asarray(snap.arrays.active),
                                   jcfg, waves=None,
                                   **{k: jnp.asarray(v) for k, v in cols.items()})
        got = tsched.schedule_pods(tsnap.arrays, snap.arrays.active, tcfg, device="cpu", **cols)
    else:
        ref = jsweep.batched_schedule(jsched.device_arrays(snap), jnp.asarray(masks), jcfg)
        got = tsched.schedule_lanes(tsnap.arrays, masks, tcfg, device="cpu")
    for k in tp.OUTPUTS:
        want, have = np.asarray(getattr(ref, k)), getattr(got, k).numpy()
        assert want.dtype == have.dtype and want.tobytes() == have.tobytes(), k
    st_j, st_t = tp.jax_state(ref.state), convert.state_to_numpy(got.state)
    for f, want in st_j.items():
        assert st_t[f].dtype == want.dtype and st_t[f].tobytes() == want.tobytes(), f
    return ref, got, tcfg


# ---- the module and the config ---------------------------------------------


def test_extension_op_is_the_reference_shape():
    assert text.ExtensionOp._fields == jext.ExtensionOp._fields
    assert text.ExtensionOp._field_defaults == jext.ExtensionOp._field_defaults


@pytest.mark.parametrize("kw", [dict(score_fn=lambda *a: 0, normalize="zscore"), dict()])
def test_extension_validation(kw):
    """tests/test_extensions.py::test_extension_validation: the same
    ValueError and message, from validate() and from make_config."""
    with pytest.raises(ValueError) as ref:
        jext.ExtensionOp(name="bad", **kw).validate()
    with pytest.raises(ValueError) as got:
        text.ExtensionOp(name="bad", **kw).validate()
    assert str(got.value) == str(ref.value)
    with pytest.raises(ValueError, match="ExtensionOp bad"):
        tsched.make_config(snapshot("plain")[1], extensions=(text.ExtensionOp(name="bad", **kw),))


def test_make_config_keeps_the_prefix_in_the_scan():
    """Extension ops may read the carry per pod: make_config zeroes the
    forced prefix unless the caller overrode it, as the reference's does,
    and counts a reason row per filter extension."""
    snap, tsnap = snapshot("bound")
    base = tsched.make_config(tsnap)
    assert base.forced_prefix > 0
    cfg = tsched.make_config(tsnap, extensions=T_EXTS)
    assert cfg.forced_prefix == 0 and cfg.n_ops == base.n_ops + 2
    assert cfg.extension_op_names == jsched.make_config(snap, extensions=J_EXTS).extension_op_names
    assert tsched.make_config(tsnap, extensions=T_EXTS, forced_prefix=3).forced_prefix == 3
    assert tsched.score_part_names(cfg)[-3:] == tuple(e.name for e in T_EXTS[2:])


# ---- the cases of tests/test_extensions.py ----------------------------------


def _objects(objects, loader, n_nodes, pods):
    cluster = loader.ClusterResources()
    cluster.nodes = [objects.Node.from_dict({
        "metadata": {"name": f"n{i}", "labels": {}},
        "status": {"allocatable": {"cpu": "4000m", "memory": "8192Mi", "pods": 110}},
        "spec": {"taints": ([{"key": "dedicated", "value": "x", "effect": "NoSchedule"}]
                            if n_nodes == -1 else []), "unschedulable": False}})
        for i in range(abs(n_nodes))]
    app = loader.ClusterResources()
    app.pods = [objects.Pod.from_dict({
        "metadata": {"name": name, "namespace": "default"},
        "spec": {"containers": [{"name": "c", "image": "nginx", "resources": {
            "requests": {"cpu": cpu, "memory": mem}}}]}}) for name, cpu, mem in pods]
    return cluster, app


# the reference's worked examples: even nodes only, and prefer the last node
J_EVEN = jext.ExtensionOp(name="node(s) rejected by the even-index policy",
                          filter_fn=lambda state, arrs, x: jnp.arange(arrs.alloc.shape[0]) % 2 == 0)
J_LAST = jext.ExtensionOp(name="prefer-last-node", normalize="minmax", weight=1000.0,
                          score_fn=lambda state, arrs, x: jnp.arange(arrs.alloc.shape[0],
                                                                     dtype=jnp.float32))
T_LAST = text.ExtensionOp(name="prefer-last-node", normalize="minmax", weight=1000.0,
                          score_fn=lambda state, arrs, x: torch.arange(arrs.alloc.shape[0],
                                                                       dtype=torch.float32))


def test_filter_extension_masks_nodes_and_reports_reason():
    got = None
    for n_nodes, pods in ((4, [(f"p{i}", "100m", "512Mi") for i in range(8)]),
                          (2, [("big0", "3900m", "512Mi"), ("big1", "3900m", "512Mi")])):
        out = []
        for objects, loader, core, dev, ext in (
                (jobjects, jloader, jcore, {}, J_EVEN),
                (tobjects, tloader, tcore, {"device": "cpu"}, T_EXTS[0])):
            cluster, app = _objects(objects, loader, n_nodes, pods)
            out.append(core.simulate(cluster, [core.AppResource(name="a", resources=app)],
                                     config_overrides={"extensions": (ext,)}, **dev))
        ref, got = out
        assert got.placements() == ref.placements()
        assert ({u.pod.key: u.reason for u in got.unscheduled_pods}
                == {u.pod.key: u.reason for u in ref.unscheduled_pods})
        assert jledger.result_digest(got) == jledger.result_digest(ref)
    assert len(got.unscheduled_pods) == 1
    reason = got.unscheduled_pods[0].reason
    assert "1 node(s) rejected by the even-index policy" in reason
    assert "1 Insufficient cpu" in reason


def test_score_extension_changes_ranking():
    out = []
    for objects, loader, core, dev, ext in ((jobjects, jloader, jcore, {}, J_LAST),
                                            (tobjects, tloader, tcore, {"device": "cpu"},
                                             T_LAST)):
        cluster, app = _objects(objects, loader, 4, [("p0", "10m", "1Mi")])
        apps = [core.AppResource(name="a", resources=app)]
        out.append((core.simulate(cluster, apps, **dev).placements(),
                    core.simulate(cluster, apps, config_overrides={"extensions": (ext,)},
                                  **dev).placements()))
    assert out[1] == out[0] == ({"default/p0": "n0"}, {"default/p0": "n3"})


PROFILE_FILTERS = """
apiVersion: kubescheduler.config.k8s.io/v1beta2
kind: KubeSchedulerConfiguration
profiles:
  - plugins:
      filter:
        disabled:
          - name: NodePorts
          - name: InterPodAffinity
          - name: NodeResourcesFit
      postFilter:
        disabled:
          - name: DefaultPreemption
"""
PROFILE_WEIGHTS = """
apiVersion: kubescheduler.config.k8s.io/v1beta2
kind: KubeSchedulerConfiguration
profiles:
  - plugins:
      score:
        enabled:
          - name: NodeResourcesFit
            weight: 5
          - name: Simon
            weight: 3
        disabled:
          - name: PodTopologySpread
"""
PROFILE_MOST = """
apiVersion: kubescheduler.config.k8s.io/v1beta2
kind: KubeSchedulerConfiguration
profiles:
  - plugins:
      score:
        enabled:
          - name: NodeResourcesFit
            weight: 4
    pluginConfig:
      - name: NodeResourcesFit
        args:
          scoringStrategy:
            type: MostAllocated
"""
PROFILE_LEAST = """
kind: KubeSchedulerConfiguration
profiles:
  - pluginConfig:
      - name: NodeResourcesFit
        args:
          scoringStrategy:
            type: LeastAllocated
"""
PROFILES = {"filters": PROFILE_FILTERS, "weights": PROFILE_WEIGHTS, "most": PROFILE_MOST,
            "least": PROFILE_LEAST}


def test_profile_filter_disable_maps_to_gates(tmp_path):
    """The port's KubeSchedulerConfiguration reader gives the reference's
    overrides: filter disables turn gates off, DefaultPreemption off is
    ``_disable_preemption``, NodeResourcesFit's filter is ignored."""
    for name, text_ in PROFILES.items():
        path = tmp_path / f"{name}.yaml"
        path.write_text(text_)
        assert tweights(str(path)) == jweights(str(path)), name
    ov = tweights(str(tmp_path / "filters.yaml"))
    assert ov["enable_ports"] is False and ov["_disable_preemption"] is True
    assert ov["enable_pod_affinity"] is False and ov["enable_anti_affinity"] is False
    assert "enable_unsched" not in ov and not any(k.startswith("enable_fit") for k in ov)


def test_disabled_taint_filter_schedules_onto_tainted_node():
    out = []
    for objects, loader, core, dev in ((jobjects, jloader, jcore, {}),
                                       (tobjects, tloader, tcore, {"device": "cpu"})):
        cluster, app = _objects(objects, loader, -1, [("p0", "100m", "512Mi")])
        apps = [core.AppResource(name="a", resources=app)]
        blocked = core.simulate(cluster, apps, **dev)
        allowed = core.simulate(cluster, apps, config_overrides={"enable_class_taint": False},
                                **dev)
        out.append((len(blocked.unscheduled_pods), allowed.placements()))
    assert out[1] == out[0] == (1, {"default/p0": "n0"})


# ---- the engine ----------------------------------------------------------------


@pytest.mark.parametrize("kind,idx", [("filters", (0, 1)), ("minmax", (2,)), ("max", (3,)),
                                      ("none", (4,)), ("all", ALL)])
def test_each_kind_equals_reference(kind, idx):
    _, got, cfg = run_both("plain", idx)
    assert (got.node >= 0).any()
    if kind in ("filters", "all"):
        assert got.fail_counts[:, cfg.n_ops - 2:].sum() > 0


@pytest.mark.parametrize("edge,extra", [("every-node-feasible", ("neg",)),
                                        ("one-node-feasible", ("one", "neg")),
                                        ("nan-score", ("nan",))])
def test_max_row_and_nan_edges_equal_reference(edge, extra):
    """The "max" row's zero fill reaches the minimum wherever a node is
    infeasible: with every node feasible and every raw score negative the
    maximum is the largest negative one, with one node feasible the fill's
    0; a NaN score leaves its pod unbound, as the reference's max does."""
    idx = (3,) if edge != "nan-score" else (2,)
    _, got, _ = run_both("plain", idx, extra)
    if edge == "one-node-feasible":
        assert set(got.node[got.node >= 0].tolist()) <= {5}
    if edge == "nan-score":
        assert (got.node[::3] == -1).all() and (got.node[1::3] >= 0).any()


def test_carry_reading_score_at_two_lanes_equals_reference():
    """The free-CPU score reads each lane's own carry: two lanes with
    different masks through schedule_lanes and the reference's vmapped
    lanes."""
    snap, _ = snapshot("plain")
    n = snap.n_nodes
    masks = np.stack([np.ones(n, bool), np.arange(n) % 3 != 0])
    _, got, _ = run_both("plain", (3, 4), masks=masks)
    assert not torch.equal(got.node[0], got.node[1])


@pytest.mark.parametrize("name", ["rich", "devres"])
def test_rich_and_devres_configs_equal_reference(name):
    _, got, cfg = run_both(name)
    if name == "rich":
        flags = step._flags(cfg, got.state, False)
        assert flags & step.F_GC and flags & step.F_DOM
    else:
        assert step.devres_on(cfg)


def test_preemption_columns_equal_reference():
    _, got, _ = run_both("plain", columns=True)
    assert (got.node == -3).any()


def test_explain_topk_equals_reference():
    """K = 3: the candidates, their scores and the parts, the extension
    rows among them, as the reference's (within its FMA's ulp)."""
    ref, got, cfg = run_both("rich", explain_topk=3)
    assert got.topk_parts.shape[1] == len(tsched.score_part_names(cfg))
    assert_outputs_equal({k: np.asarray(getattr(ref, k)) for k in TOPK},
                         {k: getattr(got, k).numpy() for k in TOPK}, TOPK, fma=True)


def test_forced_prefix_override_shifts_the_pod_index():
    """An explicit forced_prefix folds the leading nodeName pods; the
    rotation filter keys on the global pod index, as in the reference."""
    snap, _ = snapshot("bound")
    k = jsched.make_config(snap).forced_prefix
    _, got, cfg = run_both("bound", forced_prefix=k)
    assert cfg.forced_prefix == k > 0


def test_pod_slice_cuts_each_column_at_the_cursor():
    """The cursor-form PodSlice: each key's row is the column's row at the
    pod the cursor names, with the column's dtype and its shape past the
    pod axis, and it follows the cursor as the loop steps it."""
    _, tsnap = snapshot("rich")
    cfg = tsched.make_config(tsnap, extensions=T_EXTS)
    arrs = tsched.device_arrays(tsnap.arrays, "cpu")
    cols = tsched.pod_columns(arrs, cfg, None, None)
    assert {"_pod_index", "_disabled", "_nominated", "gcr_gid", "gcr_key"} <= set(cols)
    cursor = torch.tensor([3], dtype=torch.int32)
    x = tsched.PodSlice(cols, cursor)
    assert set(x) == set(cols) and len(x) == len(cols)
    for p in (3, 4):
        for key, col in cols.items():
            row = x[key]
            assert row.dtype == col.dtype and row.shape == col[p].shape, key
            assert torch.equal(row, col[p]), key
        assert int(x["_pod_index"]) == p
        cursor.add_(1)


@pytest.mark.parametrize("case", ["prefix", "two-lanes", "nan", "columns"])
def test_cursor_pod_slice_equals_reference(case):
    """The loop's device-cursor PodSlice against the reference's xs, with
    ops that read the pod's class, request, index and preemption columns:
    under a forced-prefix shift of the pod index, beside a score of the
    carry at two lanes, beside a NaN score, and with the preemption
    columns."""
    extra = ("xf", "xs")
    if case == "prefix":
        snap, _ = snapshot("bound")
        k = jsched.make_config(snap).forced_prefix
        _, got, cfg = run_both("bound", (1,), extra, forced_prefix=k)
        assert cfg.forced_prefix == k > 0
    elif case == "two-lanes":
        snap, _ = snapshot("plain")
        n = snap.n_nodes
        masks = np.stack([np.ones(n, bool), np.arange(n) % 3 != 0])
        _, got, _ = run_both("plain", (3,), extra, masks=masks)
        assert not torch.equal(got.node[0], got.node[1])
    elif case == "nan":
        _, got, _ = run_both("plain", (2,), ("nan",) + extra)
        assert (got.node[::3] == -1).any()
    else:
        _, got, _ = run_both("plain", (0,), extra, columns=True)
        assert (got.node == -3).any()
    assert (got.node >= 0).any()


# ---- the entry points -----------------------------------------------------------


def test_simulate_and_explain_result_equal_reference():
    """simulate() on an example with every kind of extension, explain on:
    placements, reasons, result_digest and explain_result's report."""
    out = []
    for pkg, ops in (("jax", J_EXTS), ("torch", T_EXTS)):
        cluster, apps = tp.load(pkg, "config")
        core = tcore if pkg == "torch" else jcore
        kw = {"device": "cpu"} if pkg == "torch" else {}
        out.append(core.simulate(cluster, apps, config_overrides={"extensions": ops,
                                                                  "explain_topk": 3}, **kw))
    ref, got = out
    assert got.placements() == ref.placements()
    assert jledger.result_digest(got) == jledger.result_digest(ref)
    rep_t, rep_j = texplain.explain_result(got), jexplain.explain_result(ref)
    assert json.dumps(rep_t, sort_keys=True) == json.dumps(rep_j, sort_keys=True)
    assert T_EXTS[2].name in json.dumps(rep_t)


def test_simulate_under_preemption_equals_reference():
    """simulate() under the DefaultPreemption pass with the score
    extensions: the rescans carry the victim and nomination columns, and
    the placements, the victims and result_digest are the reference's."""
    from tests.test_torch_explain import _preempt_objects

    ref = jcore.simulate(*_preempt_objects(jobjects, jloader, jcore),
                         config_overrides={"extensions": J_EXTS[2:]})
    got = tcore.simulate(*_preempt_objects(tobjects, tloader, tcore), device="cpu",
                         config_overrides={"extensions": T_EXTS[2:]})
    assert ref.preempted_pod_keys and got.preempted_pod_keys == ref.preempted_pod_keys
    assert got.placements() == ref.placements()
    assert jledger.result_digest(got) == jledger.result_digest(ref)


def test_simulator_session_equals_reference():
    out = []
    for objects, loader, core, sim_mod, ops, kw in (
            (jobjects, jloader, jcore, jsimulator, J_EXTS, {}),
            (tobjects, tloader, tcore, tsimulator, T_EXTS, {"device": "cpu"})):
        cluster, app = _objects(objects, loader, 6, [(f"p{i}", "700m", "512Mi")
                                                      for i in range(10)])
        sim = sim_mod.Simulator(cluster, config_overrides={"extensions": ops}, **kw)
        calls = [sim.run_cluster(), sim.schedule_app(core.AppResource(name="a", resources=app))]
        out.append([(r.placements(), {u.pod.key: u.reason for u in r.unscheduled_pods})
                    for r in calls])
        sim.close()
    assert out[1] == out[0] and out[1][1][0]


def test_capacity_sweep_and_bisect_equal_reference():
    snap = jsynthetic(10, 30, 6)
    tsnap = tp.port_snapshot(snap)
    jcfg = jsched.make_config(snap, extensions=J_EXTS[2:])
    tcfg = tsched.make_config(tsnap, extensions=T_EXTS[2:])
    counts = [0, 2, 4, 6]
    ref = jsweep.capacity_sweep(snap, jcfg, counts)
    got = tsweep.capacity_sweep(tsnap, tcfg, counts, device="cpu")
    assert got.best_count == ref.best_count
    np.testing.assert_array_equal(got.nodes_per_scenario, np.asarray(ref.nodes_per_scenario))
    ref_b = jsweep.capacity_bisect(snap, jcfg, 6, lanes=2)
    got_b = tsweep.capacity_bisect(tsnap, tcfg, 6, lanes=2, device="cpu")
    assert got_b.best_count == ref_b.best_count and list(got_b.counts) == list(ref_b.counts)


def test_replay_with_extensions_equals_reference():
    """run_replay with ReplayOptions.config_overrides: the hoist and the
    fast path stay off under extensions, as in the reference; the steps
    and the digest are the reference's."""
    reports = []
    for R, ops, kw in ((jreplay, J_EXTS, {}), (treplay, T_EXTS, {"device": "cpu"})):
        cluster = R.synthetic_replay_cluster(n_nodes=4, n_initial_pods=4)
        trace = R.ReplayTrace.from_dict(R.synthetic_trace_dict(
            n_batches=3, batch_pods=4, depart_every=2, max_new_nodes=2))
        options = R.ReplayOptions(checkpoint=False, config_overrides={"extensions": ops},
                                  controllers=[R.controller_from_dict({"kind": "autoscaler",
                                                                       "scale_step": 1})])
        reports.append(R.run_replay(cluster, trace, options, **kw))
    ref, got = reports
    assert got["steps"] == ref["steps"] and got["digest"] == ref["digest"]


def test_campaign_runs_extension_clusters_serially(tmp_path, monkeypatch):
    """A campaign under extensions runs its clusters serially (the
    reference's lanes.py rule): the rows are the reference's; so is
    run_fleet_batched's answer, lane by lane."""
    from open_simulator_tpu import campaign as jcampaign
    from open_simulator_tpu_torch import campaign as tcampaign

    monkeypatch.delenv("SIMON_CHECKPOINT_DIR", raising=False)
    fleet = tmp_path / "fleet"
    tcampaign.write_synthetic_fleet(str(fleet), n_clusters=2, nodes=4, pods=12)
    ref = jcampaign.run_campaign(jcampaign.CampaignOptions(
        fleet=str(fleet), config_overrides={"extensions": J_EXTS}))
    got = tcampaign.run_campaign(tcampaign.CampaignOptions(
        fleet=str(fleet), config_overrides={"extensions": T_EXTS}, device="cpu"))
    assert got["totals"] == ref["totals"] and got["launches"] == ref["launches"]
    strip = ("wall_s", "campaign_id", "t_s", "elapsed_s")
    rows = [[{k: v for k, v in r.items() if k not in strip} for r in rep["clusters"]]
            for rep in (ref, got)]
    assert rows[1] == rows[0]
    # the fleet launch itself, under extensions: each lane alone
    snap, tsnap = snapshot("plain")
    cfg = tsched.make_config(tsnap, extensions=T_EXTS)
    batch = exec_cache.stack_fleet_arrays([tsnap.arrays, tsnap.arrays])
    masks = np.stack([snap.arrays.active, snap.arrays.active & (np.arange(snap.n_nodes) > 0)])
    out = exec_cache.run_fleet_batched(batch, masks, cfg, device="cpu")
    for s in range(2):
        lone = tsched.schedule_pods(tsnap.arrays, masks[s], cfg, device="cpu")
        assert torch.equal(out.node[s], lone.node) and torch.equal(out.state.headroom[s],
                                                                  lone.state.headroom)


# ---- --default-scheduler-config on apply and explain --------------------------


def _run(main, argv, capsys):
    for rand in (jloader._RAND, tloader._RAND):
        rand.seed(20260729)
    rc = main(argv)
    cap = capsys.readouterr()
    return rc, cap.out


@pytest.mark.parametrize("profile", sorted(PROFILES))
def test_apply_default_scheduler_config_equals_reference(profile, tmp_path, capsys):
    path = tmp_path / "sched.yaml"
    path.write_text(PROFILES[profile])
    argv = ["apply", "-f", tp.EXAMPLES + "/morepods-config.yaml", "--max-new-nodes", "8",
            "--default-scheduler-config", str(path)]
    rc_ref, out_ref = _run(ref_main, argv, capsys)
    rc, out = _run(port_main, argv + ["--device", "cpu"], capsys)
    assert rc == rc_ref == 0 and out == out_ref and "new node" in out


@pytest.mark.parametrize("profile", ["filters", "most"])
def test_explain_default_scheduler_config_equals_reference(profile, tmp_path, capsys):
    path = tmp_path / "sched.yaml"
    path.write_text(PROFILES[profile])
    argv = ["explain", "-f", tp.EXAMPLES + "/config.yaml", "--json",
            "--default-scheduler-config", str(path)]
    rc_ref, out_ref = _run(ref_main, argv, capsys)
    rc, out = _run(port_main, argv + ["--device", "cpu"], capsys)
    assert rc == rc_ref == 0 and json.loads(out) == json.loads(out_ref)
