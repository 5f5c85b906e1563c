"""The port's ``Simulator`` session facade equals the JAX package's.

The cases of ``tests/test_simulator_api.py`` (prior placements kept
across apps; an app's overflow reported per app) and the two session
cases of ``tests/test_preemption.py`` (victims stay deleted across calls;
``run_cluster`` resets the carried preemption state) run through both
facades (the port's with ``device="cpu"``), each package building its own
objects with its own ``testing`` builders. After every call both give the
same placements, reason strings, preempted pods and ``result_digest``,
for the call's result and for ``cluster_status()``. Without preemption
both plan waves and decode the same ``wave_id`` / ``wave_batched``.
"""

from __future__ import annotations

import numpy as np
import pytest

from open_simulator_tpu import core as jcore
from open_simulator_tpu import simulator as jsimulator
from open_simulator_tpu import testing as jtesting
from open_simulator_tpu.k8s import loader as jloader
from open_simulator_tpu.k8s import objects as jobjects
from open_simulator_tpu.telemetry.ledger import result_digest
from open_simulator_tpu_torch import core as tcore
from open_simulator_tpu_torch import simulator as tsimulator
from open_simulator_tpu_torch import testing as ttesting
from open_simulator_tpu_torch.k8s import loader as tloader
from open_simulator_tpu_torch.k8s import objects as tobjects

PKG = {"jax": (jloader, jobjects, jcore, jsimulator, jtesting),
       "torch": (tloader, tobjects, tcore, tsimulator, ttesting)}


def critical(objects):
    return objects.PriorityClass.from_dict({
        "apiVersion": "scheduling.k8s.io/v1", "kind": "PriorityClass",
        "metadata": {"name": "critical"}, "value": 1000, "globalDefault": False})


def res(loader, pods=(), deployments=()):
    r = loader.ClusterResources()
    r.pods, r.deployments = list(pods), list(deployments)
    return r


def prior_placements(pkg):
    """tests/test_simulator_api.py: each app's placements stay put."""
    loader, _, core, sim_mod, t = PKG[pkg]
    cluster = loader.ClusterResources()
    cluster.nodes = [t.make_fake_node(f"n{i}", cpu="8", memory="16Gi") for i in range(3)]
    cluster.pods = [t.make_fake_pod("seed", node_name="n0", cpu="1")]
    sim = sim_mod.Simulator(cluster, **({"device": "cpu"} if pkg == "torch" else {}))
    yield sim.run_cluster()
    for name, n in (("alpha", 3), ("beta", 2)):
        app = res(loader, deployments=[t.make_fake_deployment(name, replicas=n, cpu="2")])
        yield sim.schedule_app(core.AppResource(name=name, resources=app))
    yield sim.cluster_status()
    sim.close()


def overflow(pkg):
    """tests/test_simulator_api.py: an app's overflow is reported per app."""
    loader, _, core, sim_mod, t = PKG[pkg]
    cluster = loader.ClusterResources()
    cluster.nodes = [t.make_fake_node("n0", cpu="2")]
    sim = sim_mod.Simulator(cluster, **({"device": "cpu"} if pkg == "torch" else {}))
    yield sim.run_cluster()
    app = res(loader, deployments=[t.make_fake_deployment("big", replicas=3, cpu="1")])
    yield sim.schedule_app(core.AppResource(name="big", resources=app))


def _preempting_session(pkg):
    loader, objects, core, sim_mod, t = PKG[pkg]
    cluster = loader.ClusterResources()
    cluster.nodes = [t.make_fake_node("n0", cpu="4", memory="8Gi")]
    cluster.priority_classes = [critical(objects)]
    sim = sim_mod.Simulator(cluster, **({"device": "cpu"} if pkg == "torch" else {}))
    first = sim.run_cluster()
    lows = res(loader, pods=[t.make_fake_pod(f"low-{c}", cpu="1800m") for c in "ab"])
    r1 = sim.schedule_app(core.AppResource(name="lows", resources=lows))
    high = t.make_fake_pod("high", cpu="1800m")
    high.priority_class_name = "critical"
    r2 = sim.schedule_app(core.AppResource(name="high", resources=res(loader, pods=[high])))
    return sim, [first, r1, r2]


def victims_stay_deleted(pkg):
    """tests/test_preemption.py: a later call does not resurrect a victim."""
    loader, _, core, _, t = PKG[pkg]
    sim, results = _preempting_session(pkg)
    yield from results
    tiny = res(loader, pods=[t.make_fake_pod("tiny", cpu="100m")])
    yield sim.schedule_app(core.AppResource(name="tiny", resources=tiny))
    yield sim.cluster_status()


def run_cluster_resets(pkg):
    """tests/test_preemption.py: restarting the session drops the carried
    preemption state."""
    sim, results = _preempting_session(pkg)
    yield from results
    yield sim.run_cluster()


SESSIONS = {"prior-placements": prior_placements, "overflow": overflow,
            "victims-stay-deleted": victims_stay_deleted,
            "run-cluster-resets": run_cluster_resets}


def answer(r):
    return (r.placements(), {u.pod.key: u.reason for u in r.unscheduled_pods},
            sorted(r.preempted_pod_keys), result_digest(r))


@pytest.mark.parametrize("name", sorted(SESSIONS))
def test_session_equals_reference(name):
    got = {pkg: [answer(r) for r in SESSIONS[name](pkg)] for pkg in PKG}
    assert got["torch"] == got["jax"]
    calls = got["torch"]
    if name == "prior-placements":
        alpha = calls[1][0]
        assert len(alpha) == 3 and all(calls[-1][0][k] == v for k, v in alpha.items())
        assert calls[-1][0]["default/seed"] == "n0"
    elif name == "overflow":
        assert len(calls[1][0]) == 2 and "Insufficient cpu" in next(iter(calls[1][1].values()))
    elif name == "victims-stay-deleted":
        full = calls[-1]
        assert {"default/tiny", "default/high"} <= set(full[0])
        assert len([r for r in full[1].values() if "preempted" in r]) == 1
    else:
        assert calls[-1][1] == {}


def test_session_results_keep_fail_counts_and_snapshot():
    (sim_t, res_t), (sim_j, res_j) = (_preempting_session(p) for p in ("torch", "jax"))
    np.testing.assert_array_equal(res_t[-1].fail_counts, res_j[-1].fail_counts)
    assert res_t[-1].snapshot.n_pods == res_j[-1].snapshot.n_pods == 3
    assert sim_t.cluster_status().preempted_pod_keys == sim_j.cluster_status().preempted_pod_keys


def test_simulator_decodes_the_reference_waves_without_preemption():
    """Under preemption=False each run plans waves: the port's session
    decodes the reference's wave_id / wave_batched on a four-pool cluster,
    for the call's result and for cluster_status(), with the same
    answer."""
    results, status = {}, {}
    for pkg in PKG:
        loader, _, core, sim_mod, t = PKG[pkg]
        cluster = loader.ClusterResources()
        # four node pools and pods pinned to them: carry-independent runs
        # both packages batch into waves
        cluster.nodes = [t.make_fake_node(f"n{i}", cpu="8", memory="16Gi",
                                          labels={"pool": f"p{i % 4}"}) for i in range(8)]
        kw = {"device": "cpu"} if pkg == "torch" else {}
        sim = sim_mod.Simulator(cluster, preemption=False, **kw)
        sim.run_cluster()
        app = res(loader, pods=[t.make_fake_pod(f"w{i}", cpu="1",
                                                node_selector={"pool": f"p{i % 4}"})
                                for i in range(16)])
        results[pkg] = sim.schedule_app(core.AppResource(name="web", resources=app))
        status[pkg] = sim.cluster_status()
    for got, ref in ((results["torch"], results["jax"]), (status["torch"], status["jax"])):
        assert ref.wave_id is not None and ref.wave_batched.any()
        for a, b in ((got.wave_id, ref.wave_id), (got.wave_batched, ref.wave_batched)):
            assert a.dtype == b.dtype and np.array_equal(a, b)
        assert result_digest(got)["digest"] == result_digest(ref)["digest"]
    assert answer(results["torch"]) == answer(results["jax"])


def test_simulator_defaults_to_the_card(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cluster = tloader.ClusterResources()
    cluster.nodes = [ttesting.make_fake_node("n0")]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tsimulator.Simulator(cluster).run_cluster()
