"""The port's traced score weights and policy tuning equal the JAX package's.

The cases of ``tests/test_tune.py`` (all but the REST route, which waits
for the port's server, and the fleet lanes, which wait for
``run_fleet_batched``) through the port on the CPU, each against the
reference's run of the same arrays or cluster:

* the traced mode at the config's own weight vector (the easy, rich,
  pools and GPU snapshots, scan and waves): the port's traced run and its
  constant run (which drops zero-weight rows, so the two run different
  code) each equal the reference's traced run in every output and carry
  field and the result digest, the explain rows included;
* a traced config without weights, a non-default vector against the
  constant config built with it, the lanes of one [W, K] launch against
  singleton runs and against the reference's lanes, the weight
  validation of ``schedule_pods`` and ``schedule_lanes``, both capacity
  sweeps and ``simulate()`` (three example configs) under a traced
  config;
* ``tune_search`` in grid and CEM modes: the report's ``points``,
  ``pareto`` and ``digest`` equal the reference's (``tune_id`` and
  ``wall_s`` aside), the Pareto set equals a brute-force dominance sweep
  and a one-variant-at-a-time enumeration; the batch-split rung after a
  deterministic device fault gives the same points; cancellation at the
  round boundary carries the partials;
* ``TuneOptions.from_body`` and the KubeSchedulerConfiguration parser
  (the base document, the 50-seed mutation fuzz, bad YAML): the same
  result, or an error with the same code and field, in both packages;
* ``tune`` through the CLI: the reference's JSON report and its
  ``error:`` exit on a bad scheduler config.

The port runs its plain torch step on the CPU. Tolerance: exact (the
integer outputs and carries bit for bit; the explain scores as values).
"""

from __future__ import annotations

import copy
import json
import os
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

import torch_parity as tp
from open_simulator_tpu import tune as JT
from open_simulator_tpu.encode.snapshot import encode_cluster as jencode
from open_simulator_tpu.engine import exec_cache as jexec
from open_simulator_tpu.engine import sched_config as JS
from open_simulator_tpu.engine import scheduler as jsched
from open_simulator_tpu.engine import waves as JW
from open_simulator_tpu.errors import SimulationError as JError
from open_simulator_tpu.k8s.loader import ClusterResources as JResources
from open_simulator_tpu.k8s.objects import (
    ANNO_GPU_COUNT,
    ANNO_GPU_MEM,
    RES_GPU_COUNT,
    RES_GPU_MEM,
)
from open_simulator_tpu.parallel import sweep as jsweep
from open_simulator_tpu.resilience import lifecycle as jlifecycle
from open_simulator_tpu.telemetry.ledger import array_result_digest
from open_simulator_tpu.testing.synthetic import synthetic_snapshot as jsynthetic
from open_simulator_tpu_torch import tune as TT
from open_simulator_tpu_torch.engine import sched_config as TS
from open_simulator_tpu_torch.engine import scheduler as tsched
from open_simulator_tpu_torch.engine import waves as TW
from open_simulator_tpu_torch.errors import SimulationError as TError
from open_simulator_tpu_torch.k8s.loader import ClusterResources as TResources
from open_simulator_tpu_torch.k8s.objects import Node as TNode, Pod as TPod
from open_simulator_tpu_torch.parallel import sweep as tsweep
from open_simulator_tpu_torch.resilience import faults as tfaults
from open_simulator_tpu_torch.resilience import lifecycle as tlifecycle
from tests.conftest import make_node, make_pod

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUTS = ("node", "fail_counts", "feasible", "gpu_pick", "vol_pick", "topk_node", "topk_score",
        "topk_parts")
K = len(tsched.WEIGHT_FIELDS)


def _gpu_snapshot(n_nodes=6, n_pods=18):
    nodes = [make_node(f"g{i}", cpu_m=16000, mem_mib=65536,
                       extra_alloc={RES_GPU_COUNT: 2, RES_GPU_MEM: 32},
                       labels={"topology.kubernetes.io/zone": f"z{i % 2}"})
             for i in range(n_nodes)]
    pods = [make_pod(f"p{i}", cpu="500m",
                     annotations={ANNO_GPU_MEM: str(4 + i % 3), ANNO_GPU_COUNT: "1"})
            for i in range(n_pods)]
    return jencode(nodes, pods)


SNAPSHOTS = {
    "easy": lambda: jsynthetic(10, 40, 0),
    "rich": lambda: jsynthetic(10, 40, 0, rich=True),
    "pools": lambda: jsynthetic(12, 48, 0, pools=4),
    "gpu": _gpu_snapshot,
}
_CACHE = {}


def snapshots(name):
    """(reference snapshot, the port's snapshot of the same arrays)."""
    if name not in _CACHE:
        snap = SNAPSHOTS[name]()
        _CACHE[name] = (snap, tp.port_snapshot(snap))
    return _CACHE[name]


def port_cfg(jcfg) -> tsched.EngineConfig:
    return tsched.EngineConfig(**jcfg._asdict())


def ref_run(snap, jcfg, weights=None, waves=None):
    """The reference's schedule_pods -> (numpy outputs, numpy state)."""
    kw = {} if weights is None else {"weights": jnp.asarray(weights)}
    out = jsched.schedule_pods(jsched.device_arrays(snap), jnp.asarray(snap.arrays.active),
                               jcfg, waves=waves, **kw)
    return {k: np.asarray(getattr(out, k)) for k in OUTS}, tp.jax_state(out.state)


def port_run(tsnap, cfg, weights=None, waves=None):
    out = tsched.schedule_pods(tsnap.arrays, tsnap.arrays.active, cfg, device="cpu",
                               waves=waves, weights=weights)
    return {k: getattr(out, k).numpy() for k in OUTS}, tp.convert.state_to_numpy(out.state)


def assert_runs_equal(ref, got, what=""):
    """Every output and carry field equal (the integer ones and the carry
    bit for bit, the explain floats as values), and the result digest."""
    (outs_j, st_j), (outs_t, st_t) = ref, got
    for k in OUTS:
        assert outs_j[k].dtype == outs_t[k].dtype and outs_j[k].shape == outs_t[k].shape, \
            (what, k)
        if outs_j[k].dtype == np.float32:
            assert np.array_equal(outs_j[k], outs_t[k]), (what, k)
        else:
            assert outs_j[k].tobytes() == outs_t[k].tobytes(), (what, k)
    for f, want in st_j.items():
        assert st_t[f].dtype == want.dtype and st_t[f].tobytes() == want.tobytes(), (what, f)
    assert (array_result_digest(outs_j["node"])
            == array_result_digest(outs_t["node"])), what


# ---- the traced-weights mode ---------------------------------------------


@pytest.mark.parametrize("waves", [False, True], ids=["scan", "waves"])
@pytest.mark.parametrize("name", sorted(SNAPSHOTS))
def test_traced_default_vector_equals_reference(name, waves):
    """The reference's traced run at the config's own vector against the
    port's traced run and the port's constant run (explain on the rich
    snapshot, whose part table holds every score row)."""
    snap, tsnap = snapshots(name)
    jcfg = jsched.make_config(snap, explain_topk=2 if name == "rich" else 0)
    jcfg_t = jcfg._replace(traced_weights=True)
    cfg, cfg_t = port_cfg(jcfg), port_cfg(jcfg_t)
    assert tsched.score_part_names(cfg_t) == jsched.score_part_names(jcfg_t)
    assert tsched.score_part_names(cfg) == jsched.score_part_names(jcfg)
    w = jsched.weight_vector(jcfg)
    assert np.array_equal(tsched.weight_vector(cfg), w)
    ref = ref_run(snap, jcfg_t, w, JW.waves_for(snap.arrays, jcfg_t) if waves else None)
    plan_c = TW.waves_for(tsnap.arrays, cfg) if waves else None
    plan_t = TW.waves_for(tsnap.arrays, cfg_t) if waves else None
    if waves and name == "pools":
        assert plan_t is not None and any(s[2] != TW.SCAN for s in plan_t.segments)
    assert_runs_equal(ref, port_run(tsnap, cfg_t, w, plan_t), f"{name} traced")
    assert_runs_equal(ref, port_run(tsnap, cfg, None, plan_c), f"{name} constant")


def test_traced_config_without_weights_runs_its_own_vector():
    snap, tsnap = snapshots("easy")
    jcfg_t = jsched.make_config(snap)._replace(traced_weights=True)
    ref = ref_run(snap, jcfg_t)
    assert_runs_equal(ref, port_run(tsnap, port_cfg(jcfg_t)), "baked")
    assert_runs_equal(ref, port_run(tsnap, port_cfg(jcfg_t), tsched.weight_vector(
        port_cfg(jcfg_t))), "explicit")


def test_traced_weights_shape_and_mode_validation():
    """The reference's messages: weights without the traced mode, a row of
    the wrong width, and the lane matrix's shape."""
    _, tsnap = snapshots("easy")
    cfg = tsched.make_config(tsnap)
    a = tsnap.arrays
    with pytest.raises(ValueError, match="traced_weights is off"):
        tsched.schedule_pods(a, a.active, cfg, device="cpu", weights=np.zeros(K, np.float32))
    with pytest.raises(ValueError, match="WEIGHT_FIELDS"):
        tsched.schedule_pods(a, a.active, cfg._replace(traced_weights=True), device="cpu",
                             weights=np.zeros(3, np.float32))
    masks = np.tile(a.active, (2, 1))
    with pytest.raises(ValueError, match="need cfg.traced_weights"):
        tsched.schedule_lanes(a, masks, cfg, device="cpu", weights=np.zeros((2, K)))
    with pytest.raises(ValueError, match=r"\[2, 9\] \(lanes x WEIGHT_FIELDS\)"):
        tsched.schedule_lanes(a, masks, cfg._replace(traced_weights=True), device="cpu",
                              weights=np.zeros((3, K)))


def test_traced_nondefault_vector_matches_constant_config():
    """A traced run at the bin-packing profile's vector places as the
    constant config built with those weights, in both packages."""
    snap, tsnap = snapshots("easy")
    variant = dict(TS.MOST_ALLOCATED_OVERRIDES)
    assert variant == JS.MOST_ALLOCATED_OVERRIDES
    jcfg_c = jsched.make_config(snap, **variant)
    jcfg_t = jcfg_c._replace(traced_weights=True)
    w = jsched.weight_vector(jcfg_c)
    ref = ref_run(snap, jcfg_t, w)
    got_t = port_run(tsnap, port_cfg(jcfg_t), w)
    assert_runs_equal(ref, got_t, "traced")
    got_c = port_run(tsnap, port_cfg(jcfg_c))
    for k in ("node", "fail_counts", "feasible"):
        assert np.array_equal(got_c[0][k], got_t[0][k]), k


VARIANTS = [None, [1, 0, 1, 2, 0, 1, 0, 1, 1], [0, 2, 0, 0, 1, 0, 4, 0, 1],
            [0, 0, 0, 0, 0, 0, 0, 0, 0]]


def test_traced_lanes_match_singletons_and_reference():
    """One [W, K] launch: each lane equals its singleton traced run (every
    output and carry field) and the reference's lane of the same row."""
    snap, tsnap = snapshots("easy")
    jcfg = jsched.make_config(snap)._replace(traced_weights=True, fail_reasons=False)
    cfg = port_cfg(jcfg)
    wmat = np.stack([jsched.weight_vector(jcfg) if v is None else np.asarray(v, np.float32)
                     for v in VARIANTS])
    arrs, _, n_pods = jexec.bucketed_device_arrays(snap.arrays)
    ref = jexec.run_batched_cached(arrs, np.tile(np.asarray(arrs.active), (len(wmat), 1)),
                                   jcfg, weights=wmat)
    out = tsched.schedule_lanes(tsnap.arrays, np.tile(tsnap.arrays.active, (len(wmat), 1)), cfg,
                                device="cpu", weights=wmat)
    assert np.array_equal(out.node.numpy(), np.asarray(ref.node)[:, :n_pods])
    st = tp.convert.state_to_numpy(out.state)
    for i, vec in enumerate(wmat):
        solo = port_run(tsnap, cfg, vec)
        for k in ("node", "fail_counts", "feasible"):
            assert np.array_equal(getattr(out, k).numpy()[i], solo[0][k]), (i, k)
        for f, want in solo[1].items():
            assert st[f][i].tobytes() == want.tobytes(), (i, f)


@pytest.mark.parametrize("mode", ["exhaustive", "bisect"])
def test_capacity_sweeps_accept_traced_config(mode):
    """Both sweeps under a traced config (no weights): the plan of the
    constant config and of the reference, waves on."""
    snap = jsynthetic(6, 24, max_new=4)
    tsnap = tp.port_snapshot(snap)
    jcfg = jsched.make_config(snap)._replace(fail_reasons=False)
    plans = []
    for traced in (False, True):
        if mode == "exhaustive":
            plans.append(tsweep.capacity_sweep(tsnap, port_cfg(jcfg)._replace(
                traced_weights=traced), [0, 2, 4], device="cpu"))
        else:
            plans.append(tsweep.capacity_bisect(tsnap, port_cfg(jcfg)._replace(
                traced_weights=traced), 4, lanes=3, device="cpu"))
    if mode == "exhaustive":
        ref = jsweep.capacity_sweep(snap, jcfg._replace(traced_weights=True), [0, 2, 4])
    else:
        ref = jsweep.capacity_bisect(snap, jcfg._replace(traced_weights=True), 4, lanes=3)
    for plan in plans:
        assert plan.best_count == ref.best_count
        assert plan.counts == ref.counts
        assert np.array_equal(np.asarray(plan.nodes_per_scenario),
                              np.asarray(ref.nodes_per_scenario))


@pytest.mark.parametrize("name", ["config", "constraints", "gpushare"])
def test_simulate_under_traced_weights_equals_reference(name):
    """simulate() with ``traced_weights`` on an example config (the waves
    and the preemption pass as simulate() runs them) gives the
    reference's placements, reasons and result digest."""
    from open_simulator_tpu import core as jcore
    from open_simulator_tpu.telemetry.ledger import result_digest
    from open_simulator_tpu_torch import core as tcore

    over = {"traced_weights": True}
    cluster, apps = tp.load("jax", name)
    ref = jcore.simulate(cluster, apps, config_overrides=over)
    cluster, apps = tp.load("torch", name)
    got = tcore.simulate(cluster, apps, config_overrides=over, device="cpu")
    assert got.placements() == ref.placements()
    assert ({u.pod.key: u.reason for u in got.unscheduled_pods}
            == {u.pod.key: u.reason for u in ref.unscheduled_pods})
    assert result_digest(got)["digest"] == result_digest(ref)["digest"]


@pytest.fixture(autouse=True, scope="module")
def _reference_executables_released():
    """The reference's searches here compile the executables of
    tests/test_tune.py's cluster into its process-wide cache; drop them
    when this module ends, so that a later test on the same worker that
    counts its own compiles (test_tune_grid_one_executable_and_brute_force_pareto)
    starts from the cache it would find without this file."""
    yield
    jexec.EXEC_CACHE.clear()


# ---- the search -------------------------------------------------------------


def _tune_cluster(pkg, n_nodes=6, n_pods=18):
    """tests/test_tune.py's cluster: big and small nodes in two zones,
    pods with a soft zone spread, through `pkg`'s own objects."""
    nodes = [make_node(f"n{i}", cpu_m=16000 if i % 2 else 8000,
                       mem_mib=32768 if i % 2 else 16384,
                       labels={"topology.kubernetes.io/zone": f"z{i % 2}"})
             for i in range(n_nodes)]
    pods = [make_pod(f"p{i}", cpu="900m", mem="900Mi", labels={"app": f"a{i % 3}"},
                     spread=[{"maxSkew": 1, "topologyKey": "topology.kubernetes.io/zone",
                              "whenUnsatisfiable": "ScheduleAnyway",
                              "labelSelector": {"matchLabels": {"app": f"a{i % 3}"}}}])
            for i in range(n_pods)]
    if pkg == "jax":
        return JResources(nodes=nodes, pods=pods)
    return TResources(nodes=[TNode.from_dict(n.raw) for n in nodes],
                      pods=[TPod.from_dict(p.raw) for p in pods])


def _masked(report):
    return {k: v for k, v in report.items() if k not in ("tune_id", "wall_s")}


def both_tunes(body):
    """The reference's and the port's report for the same request body."""
    ref = JT.tune_search(_tune_cluster("jax"), [], JT.TuneOptions.from_body(body))
    got = TT.tune_search(_tune_cluster("torch"), [], TT.TuneOptions.from_body(body),
                         device="cpu")
    assert _masked(got) == _masked(ref)
    return got


def test_tune_grid_equals_reference_and_brute_force_pareto():
    rep = both_tunes({"mode": "grid", "variants": 4, "grid_values": [0.0, 2.0]})
    assert rep["rounds_run"] > 1
    assert rep["n_variants"] == len(rep["points"])
    assert rep["baseline"]["disruption"] == 0
    bf = TT.brute_force_pareto(rep["points"])
    assert [p["vector"] for p in rep["pareto"]] == [p["vector"] for p in bf]
    assert TT.format_tune(rep)


def test_tune_cem_equals_reference_and_brute_force_pareto():
    rep = both_tunes({"mode": "cem", "variants": 4, "rounds": 2, "seed": 7})
    assert rep["n_variants"] >= 4
    bf = TT.brute_force_pareto(rep["points"])
    assert [p["vector"] for p in rep["pareto"]] == [p["vector"] for p in bf]


def test_tune_pareto_matches_single_variant_enumeration():
    """Every point re-derived by a singleton traced run of its vector, and
    the Pareto set of the re-derived points is the report's."""
    from open_simulator_tpu_torch.core import build_pod_sequence
    from open_simulator_tpu_torch.encode.snapshot import encode_cluster
    from open_simulator_tpu_torch.k8s.loader import make_valid_node

    cluster = _tune_cluster("torch")
    rep = TT.tune_search(cluster, [], TT.TuneOptions(mode="cem", variants=4, rounds=2, seed=3),
                         device="cpu")
    nodes = [make_valid_node(n) for n in cluster.nodes]
    snap = encode_cluster(nodes, build_pod_sequence(cluster, []))
    cfg = tsched.make_config(snap, traced_weights=True)._replace(fail_reasons=False)
    baseline_row, rederived = None, []
    for p in rep["points"]:
        row = tsched.schedule_pods(snap.arrays, snap.arrays.active, cfg, device="cpu",
                                   weights=np.asarray(p["vector"], np.float32)).node.numpy()
        if baseline_row is None:
            baseline_row = row
        placed = row >= 0
        rederived.append({"vector": p["vector"], "unplaced": int(np.sum(~placed)),
                          "cost": int(np.unique(row[placed]).size),
                          "disruption": int(np.sum(row != baseline_row))})
        for k in ("unplaced", "cost", "disruption"):
            assert rederived[-1][k] == p[k], (k, p)
    assert ([p["vector"] for p in TT.pareto_points(rederived)]
            == [p["vector"] for p in rep["pareto"]])


def test_tune_objectives_are_not_degenerate():
    rep = both_tunes({"mode": "grid", "variants": 4, "grid_values": [0.0, 4.0]})
    assert len({p["cost"] for p in rep["points"]}) > 1


def test_tune_batch_split_rung_gives_the_same_points(monkeypatch):
    """A deterministic device fault at full width: the round re-runs as two
    half-width launches, with the same points, Pareto set and digest."""
    opts = TT.TuneOptions(mode="grid", variants=4, grid_values=(0.0, 2.0))
    want = TT.tune_search(_tune_cluster("torch"), [], opts, device="cpu")
    real = tsched.schedule_lanes
    widths = []

    def flaky(arrs, masks, cfg, **kw):
        widths.append(len(masks))
        if len(masks) == 4:
            raise RuntimeError("CUDA out of memory. Tried to allocate 2.00 GiB")
        return real(arrs, masks, cfg, **kw)

    monkeypatch.setattr(tsched, "schedule_lanes", flaky)
    before = tfaults.RUNGS[("tune_round", "batch_split")]
    got = TT.tune_search(_tune_cluster("torch"), [], opts, device="cpu")
    assert _masked(got) == _masked(want)
    assert tfaults.RUNGS[("tune_round", "batch_split")] == before + got["rounds_run"]
    assert 2 in widths


def test_tune_cancellation_at_round_boundary_carries_partial():
    partials = []
    for pkg, T, lc in (("jax", JT, jlifecycle), ("torch", TT, tlifecycle)):
        kw = {} if pkg == "jax" else {"device": "cpu"}
        with lc.cancel_scope(lc.CancelToken(1e-6)):
            with pytest.raises(lc.CancelledError) as ei:
                T.tune_search(_tune_cluster(pkg), [], T.TuneOptions(mode="grid", variants=4),
                              **kw)
        partials.append({k: v for k, v in ei.value.partial.items() if k != "tune_id"})
        assert ei.value.code == "E_DEADLINE"
        assert set(ei.value.partial) >= {"tune_id", "rounds_done", "variants_done",
                                         "pareto_so_far"}
    assert partials[0] == partials[1] == {"rounds_done": 0, "variants_done": 0,
                                          "pareto_so_far": 0}


# ---- the options and the scheduler config -----------------------------------

BAD_BODIES = [
    ({"mode": "anneal"}, "mode"),
    ({"variants": 0}, "variants"),
    ({"variants": 10_000}, "variants"),
    ({"variants": 8.9}, "variants"),
    ({"variants": True}, "variants"),
    ({"sigma": True}, "sigma"),
    ({"weights": {"w_spread": True}}, "weights.w_spread"),
    ({"grid_values": [True]}, "grid_values[0]"),
    ({"grid_values": [0.0] * 65}, "grid_values"),
    ({"rounds": -1}, "rounds"),
    ({"rounds": "many"}, "rounds"),
    ({"grid_values": []}, "grid_values"),
    ({"grid_values": [1, "x"]}, "grid_values[1]"),
    ({"grid_values": [-1.0]}, "grid_values[0]"),
    ({"elite_frac": 0.0}, "elite_frac"),
    ({"sigma": float("nan")}, "sigma"),
    ({"max_weight": -2}, "max_weight"),
    ({"weights": ["w_spread"]}, "weights"),
    ({"weights": {"w_bogus": 1}}, "weights.w_bogus"),
    ({"weights": {"w_spread": -1}}, "weights.w_spread"),
    ({"weights": {"w_spread": "heavy"}}, "weights.w_spread"),
    ({"weights": {"w_spread": 1e39}}, "weights.w_spread"),
    ({"grid_values": [1e39]}, "grid_values[0]"),
    ({"scheduler_config": {"kind": "Deployment"}}, "kind"),
    ({"scheduler_config": "{broken: ["}, ""),
]


@pytest.mark.parametrize("i", range(len(BAD_BODIES)))
def test_tune_options_validation_equals_reference(i):
    body, field = BAD_BODIES[i]
    got = []
    for T, err in ((JT, JError), (TT, TError)):
        with pytest.raises(err) as ei:
            T.TuneOptions.from_body(copy.deepcopy(body))
        got.append((ei.value.code, ei.value.field, str(ei.value)))
    assert got[0] == got[1]
    assert got[1][1] == field and got[1][0] in ("E_BAD_REQUEST", "E_SPEC")


GOOD_BODIES = [
    {},
    {"mode": "cem", "variants": "8", "rounds": 3.0, "seed": 11, "sigma": 0.5},
    {"weights": {"w_spread": 0, "w_most": 2.5}, "grid_values": [0, 1, 3], "max_weight": 3},
    {"max_weight": 1.0},
    {"scheduler_config": {"kind": "KubeSchedulerConfiguration", "profiles": [{"plugins": {
        "score": {"enabled": [{"name": "Simon", "weight": 3}]},
        "filter": {"disabled": [{"name": "NodePorts"}]}}}]}, "weights": {"w_simon": 1}},
]


@pytest.mark.parametrize("i", range(len(GOOD_BODIES)))
def test_tune_options_parse_equal_reference(i):
    body = GOOD_BODIES[i]
    ref = JT.TuneOptions.from_body(copy.deepcopy(body))
    got = TT.TuneOptions.from_body(copy.deepcopy(body))
    assert got.__dict__ == ref.__dict__


BASE_SCHED_DOC = {
    "apiVersion": "kubescheduler.config.k8s.io/v1beta2",
    "kind": "KubeSchedulerConfiguration",
    "profiles": [{
        "schedulerName": "default-scheduler",
        "plugins": {
            "score": {
                "enabled": [{"name": "PodTopologySpread", "weight": 2},
                            {"name": "NodeResourcesBalancedAllocation", "weight": 1}],
                "disabled": [{"name": "TaintToleration"}],
            },
            "filter": {"disabled": [{"name": "PodTopologySpread"}]},
        },
        "pluginConfig": [{"name": "NodeResourcesFit",
                          "args": {"scoringStrategy": {"type": "MostAllocated"}}}],
    }],
}


def _mutate_sched_doc(rng: random.Random):
    """tests/test_tune.py's malformations of the base document."""
    doc = copy.deepcopy(BASE_SCHED_DOC)
    prof = doc["profiles"][0]
    score = prof["plugins"]["score"]
    mutation = rng.choice([
        "kind", "profiles_type", "profile_type", "plugins_type", "score_type",
        "enabled_type", "entry_type", "drop_name", "name_type", "weight_type",
        "weight_negative", "weight_nan", "unknown_score", "unknown_score_disabled",
        "filter_type", "plugin_config_type", "entry_cfg_type", "args_type", "strategy_type",
    ])
    if mutation == "kind":
        doc["kind"] = rng.choice(["Deployment", "KubeScheduler", 42])
    elif mutation == "profiles_type":
        doc["profiles"] = rng.choice(["default", 1, {"a": 1}])
    elif mutation == "profile_type":
        doc["profiles"][0] = rng.choice(["p", 3, ["x"]])
    elif mutation == "plugins_type":
        prof["plugins"] = rng.choice([["score"], "score", 7])
    elif mutation == "score_type":
        prof["plugins"]["score"] = rng.choice([["e"], "on", 1])
    elif mutation == "enabled_type":
        score["enabled"] = rng.choice([{"name": "x"}, "all", 5])
    elif mutation == "entry_type":
        score["enabled"][0] = rng.choice(["PodTopologySpread", 9, ["n"]])
    elif mutation == "drop_name":
        del score["enabled"][0]["name"]
    elif mutation == "name_type":
        score["enabled"][0]["name"] = rng.choice([17, None, ["x"], ""])
    elif mutation == "weight_type":
        score["enabled"][0]["weight"] = rng.choice(["heavy", [2], {}])
    elif mutation == "weight_negative":
        score["enabled"][0]["weight"] = -rng.randint(1, 100)
    elif mutation == "weight_nan":
        score["enabled"][0]["weight"] = rng.choice([float("nan"), float("inf")])
    elif mutation == "unknown_score":
        score["enabled"][0]["name"] = f"OutOfTreeScore{rng.randint(0, 9)}"
    elif mutation == "unknown_score_disabled":
        score["disabled"][0]["name"] = f"Mystery{rng.randint(0, 9)}"
    elif mutation == "filter_type":
        prof["plugins"]["filter"] = rng.choice([["d"], "off", 2])
    elif mutation == "plugin_config_type":
        prof["pluginConfig"] = rng.choice([{"name": "x"}, "cfg", 4])
    elif mutation == "entry_cfg_type":
        prof["pluginConfig"][0] = rng.choice(["NodeResourcesFit", 6])
    elif mutation == "args_type":
        prof["pluginConfig"][0]["args"] = rng.choice([["s"], "args", 8])
    elif mutation == "strategy_type":
        prof["pluginConfig"][0]["args"]["scoringStrategy"] = rng.choice(
            [["t"], "MostAllocated", 3])
    return mutation, doc


def _parse_file(mod, err, path):
    try:
        return ("ok", mod.weight_overrides_from_file(path))
    except err as e:
        assert e.code == "E_SPEC" and isinstance(e.to_dict(), dict)
        return ("error", e.code, e.field, e.message)


def test_sched_config_base_doc_parses_as_reference():
    text = yaml.safe_dump(BASE_SCHED_DOC)
    ov = TS.weight_overrides_from_text(text)
    assert ov == JS.weight_overrides_from_text(text)
    assert ov["w_spread"] == 2.0 and ov["w_balanced"] == 1.0
    assert ov["w_taint"] == 0.0 and ov["w_most"] == 1.0


def test_fuzz_sched_config_mutations_equal_reference(tmp_path):
    """50 seeds: each mutated document gives the reference's overrides or
    its structured E_SPEC (same field and message), and most are
    rejected."""
    rejected = 0
    for seed in range(50):
        mutation, doc = _mutate_sched_doc(random.Random(seed))
        path = tmp_path / f"cfg_{seed}.yaml"
        path.write_text(yaml.safe_dump(doc))
        want = _parse_file(JS, JS.SchedulerConfigError, str(path))
        got = _parse_file(TS, TS.SchedulerConfigError, str(path))
        assert got == want, mutation
        rejected += got[0] == "error"
    assert rejected >= 25


def test_sched_config_invalid_yaml_text_is_espec():
    with pytest.raises(TS.SchedulerConfigError) as ei:
        TS.weight_overrides_from_text("{unclosed: [")
    assert ei.value.code == "E_SPEC" and ei.value.field == ""


# ---- the CLI ----------------------------------------------------------------


def test_cli_tune_bad_scheduler_config_is_error_exit(tmp_path, capsys):
    from open_simulator_tpu_torch.cli.main import main

    bad = tmp_path / "bad.yaml"
    bad.write_text(yaml.safe_dump({
        "kind": "KubeSchedulerConfiguration",
        "profiles": [{"plugins": {"score": {"enabled": [{"name": "NoSuchPlugin"}]}}}]}))
    rc = main(["tune", "--cluster-config", os.path.join(REPO, "examples", "cluster"),
               "--scheduler-config", str(bad), "--device", "cpu"])
    assert rc == 1
    err = capsys.readouterr().err
    assert "error:" in err and "E_SPEC" in err and "NoSuchPlugin" in err


@pytest.mark.parametrize("flag,item", [("--ledger-dir", "item 11"), ("--trace-out", "item 11"),
                                       ("--compile-cache-dir", "item 8")])
def test_cli_tune_refuses_unported_options(flag, item, tmp_path, capsys):
    from open_simulator_tpu_torch.cli.main import main

    assert main(["tune", "--cluster-config", os.path.join(REPO, "examples", "cluster", "demo"),
                 "--device", "cpu", flag, str(tmp_path / "x")]) == 1
    err = capsys.readouterr().err
    assert "error:" in err and f"ROADMAP queue 1, {item}" in err


def test_cli_tune_json_equals_reference(tmp_path, capsys, monkeypatch):
    """``tune --json`` with a scheduler config through both CLIs: the same
    report, ids and wall times aside."""
    from open_simulator_tpu.cli.main import main as jmain
    from open_simulator_tpu_torch.cli.main import main as tmain

    cfg = tmp_path / "sched.yaml"
    cfg.write_text(yaml.safe_dump({"kind": "KubeSchedulerConfiguration", "profiles": [{
        "plugins": {"score": {"enabled": [{"name": "PodTopologySpread", "weight": 3}]}}}]}))
    args = ["tune", "--cluster-config", os.path.join(REPO, "examples", "cluster", "demo"),
            "--mode", "cem", "--variants", "4", "--rounds", "2", "--seed", "5",
            "--scheduler-config", str(cfg), "--json"]
    monkeypatch.setenv("SIMON_WAVES", "1")  # --no-waves sets it; restored at teardown
    capsys.readouterr()
    assert jmain(args) == 0
    want = json.loads(capsys.readouterr().out)
    assert tmain(args + ["--device", "cpu", "--no-waves"]) == 0
    got = json.loads(capsys.readouterr().out)
    assert _masked(got) == _masked(want)
    assert got["baseline"]["weights"]["w_spread"] == 3.0
