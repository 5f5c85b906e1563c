"""The port's trace replay equals the JAX package's.

The cases of ``tests/test_replay.py`` (all but the cost frontier and the
ledger records, which the port has not ported) through the port's
``run_replay`` on the CPU, each against the reference's run of the same
cluster, trace and controllers: every step row and the ``rows_digest``,
with the carry fast path on and off. The trace model's structured errors
name the same code and field in both packages. A run killed by SIGKILL
after step 3 and resumed from its journal gives the reference's
uninterrupted digest; a drifted trace or controller roster is refused. A
device fault on the fast path falls back to the full scan with the same
digest, and a torch CUDA out-of-memory error classifies as
``E_DEVICE_OOM``. A hypothesis case: random arrive / depart / node_add /
kill_node traces on a 6-node cluster give the reference's digest.
Tolerance: exact.
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from open_simulator_tpu import replay as J
from open_simulator_tpu.errors import SimulationError as JError
from open_simulator_tpu.k8s.objects import Pod as JPod
from open_simulator_tpu_torch import replay as T
from open_simulator_tpu_torch.errors import SimulationError as TError
from open_simulator_tpu_torch.k8s.objects import Pod as TPod
from open_simulator_tpu_torch.replay import engine as tengine
from open_simulator_tpu_torch.replay.synthetic import _deployment_yaml, _node_yaml
from open_simulator_tpu_torch.resilience import faults, lifecycle
from open_simulator_tpu_torch.resilience.journal import unframe_line

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKGS = {"jax": J, "torch": T}


def _arrive(t, name, replicas=4, cpu_m=900, mem_mi=512):
    return {"t": t, "kind": "arrive",
            "app": {"name": name, "yaml": _deployment_yaml(name, replicas, cpu_m, mem_mi)}}


def _trace_dict(events, **kw):
    return {"events": events, **kw}


def _run(pkg, trace_dict, n_nodes, n_pods, controllers=(), extra_pods=(), fast=True,
         **opts):
    R = PKGS[pkg]
    cluster = R.synthetic_replay_cluster(n_nodes=n_nodes, n_initial_pods=n_pods)
    pod_cls = JPod if pkg == "jax" else TPod
    cluster.pods += [pod_cls.from_dict(p) for p in extra_pods]
    opts.setdefault("checkpoint", False)
    options = R.ReplayOptions(controllers=[R.controller_from_dict(dict(c)) for c in controllers],
                              fast_path=fast, **opts)
    trace = R.ReplayTrace.from_dict(trace_dict)
    if pkg == "jax":
        return R.run_replay(cluster, trace, options)
    return R.run_replay(cluster, trace, options, device="cpu")


def both(trace_dict, n_nodes=2, n_pods=2, controllers=(), extra_pods=()):
    """The reference's run and the port's, fast path on and off: every
    step row and the digest equal. Returns the port's report."""
    ref = _run("jax", trace_dict, n_nodes, n_pods, controllers, extra_pods)
    for fast in (True, False):
        got = _run("torch", trace_dict, n_nodes, n_pods, controllers, extra_pods, fast=fast)
        assert got["steps"] == ref["steps"], fast
        assert got["digest"] == ref["digest"], fast
        assert got["totals"] == ref["totals"], fast
        assert got["trace_digest"] == ref["trace_digest"]
    return got


# ---- trace model validation ---------------------------------------------

_A = _arrive(0, "a")
VALIDATION = {
    "no-events": ([], {}, "events"),
    "unknown-kind": ([{"t": 0, "kind": "meteor_strike", "target": "n0"}], {},
                     "events[0].kind"),
    "non-monotone": ([_arrive(5, "a"), _arrive(2, "b")], {}, "events[1].t"),
    "arrive-no-name": ([{"t": 0, "kind": "arrive", "app": {"yaml": "x"}}], {},
                       "events[0].app.name"),
    "arrive-no-yaml": ([{"t": 0, "kind": "arrive", "app": {"name": "a"}}], {},
                       "events[0].app.yaml"),
    "depart-nothing": ([_A, {"t": 1, "kind": "depart"}], {}, "events[1]"),
    "depart-ghost": ([_A, {"t": 1, "kind": "depart", "app": "ghost"}], {}, "events[1].app"),
    "kill-no-target": ([{"t": 0, "kind": "kill_node"}], {}, "events[0].target"),
    "remove-no-target": ([{"t": 0, "kind": "node_remove"}], {}, "events[0].target"),
    "duplicate-app": ([_A, _arrive(1, "a")], {}, "events[1].app.name"),
    "node-add-no-template": ([{"t": 0, "kind": "node_add", "count": 2}],
                             {"max_new_nodes": 2}, "node_template"),
    "node-add-over-budget": ([{"t": 0, "kind": "node_add", "count": 2}],
                             {"max_new_nodes": 1, "node_template": _node_yaml()},
                             "events[0].count"),
}


@pytest.mark.parametrize("case", sorted(VALIDATION))
def test_trace_validation_errors_equal_the_reference(case):
    events, kw, field = VALIDATION[case]
    for pkg, err in (("jax", JError), ("torch", TError)):
        with pytest.raises(err) as ei:
            PKGS[pkg].ReplayTrace.from_dict(_trace_dict(events, **kw)).validate()
        assert (ei.value.code, ei.value.field) == ("E_SPEC", field), pkg


PARSE = {
    "bad-t": ({"events": [{"t": "noon", "kind": "arrive"}]}, "events[0].t"),
    "bad-count": ({"events": [{"t": 0, "kind": "node_add", "count": "two"}]},
                  "events[0].count"),
    "non-object-app": ({"events": [{"t": 0, "kind": "arrive", "app": "x"}]}, "events[0].app"),
}


@pytest.mark.parametrize("case", sorted(PARSE))
def test_trace_parse_errors_equal_the_reference(case):
    d, field = PARSE[case]
    for pkg, err in (("jax", JError), ("torch", TError)):
        with pytest.raises(err) as ei:
            PKGS[pkg].ReplayTrace.from_dict(d)
        assert (ei.value.code, ei.value.field) == ("E_SPEC", field), pkg
    with pytest.raises(TError) as ei:
        T.ReplayTrace(events=[T.TraceEvent(t=0, kind="arrive", app="x")]).validate()
    assert ei.value.code == "E_SPEC"


def test_trace_digest_equals_the_reference_and_round_trips():
    d = T.synthetic_trace_dict(n_batches=3)
    assert d == J.synthetic_trace_dict(n_batches=3)
    a = T.ReplayTrace.from_dict(d)
    assert a.digest() == T.ReplayTrace.from_dict(a.to_dict()).digest()
    assert a.digest() == J.ReplayTrace.from_dict(d).digest()


# ---- step semantics and controllers --------------------------------------

_DS_POD = {
    "metadata": {"name": "ds-0", "namespace": "kube-system",
                 "ownerReferences": [{"kind": "DaemonSet", "name": "ds", "controller": True}]},
    "spec": {"nodeName": "rn-0",
             "containers": [{"name": "c", "resources": {
                 "requests": {"cpu": "100m", "memory": "64Mi"}}}]},
}


def _baseline(rep):
    assert rep["steps"][0]["event"]["kind"] == "baseline"
    assert [s["placed"] for s in rep["steps"]] == [2, 4]


def _pinned(rep):
    assert rep["totals"]["pending"] == 0
    assert [s["placed"] for s in rep["steps"]] == [3, 6, 9, 12]


def _departure(rep):
    s = rep["steps"]
    assert s[1]["pending"] == 0 and s[2]["pending"] == 2
    assert s[3]["pending"] == 0 and s[3]["placed"] == 5
    assert rep["totals"]["peak_pending"] == 2


def _kill_node(rep):
    step = rep["steps"][1]
    assert "kube-system/ds-0" in step["evicted"]
    assert step["lost"] == 1 and step["placed"] == 2


def _node_add_remove(rep):
    s = rep["steps"]
    assert s[1]["pending"] > 0 and s[2]["pending"] == 0 and s[2]["active_nodes"] == 3
    assert s[3]["active_nodes"] == 2 and s[3]["lost"] == 0 and s[3]["pending"] > 0


def _kill_zone(rep):
    assert rep["steps"][1]["active_nodes"] == 2
    assert rep["steps"][1]["event_nodes"] == [0, 2]


def _depart_keys(rep):
    assert rep["steps"][2]["placed"] == rep["steps"][1]["placed"] - 2


def _autoscaler(rep):
    s = rep["steps"]
    assert s[1]["pending"] == 0 and s[1]["actions"]
    assert all(r["converged"] for r in s)
    assert rep["totals"]["scale_ups"] > 0 and rep["totals"]["scale_downs"] > 0
    assert s[-1]["active_nodes"] < max(r["active_nodes"] for r in s)


def _cooldown(rep):
    s = rep["steps"]
    assert any(a["kind"] == "scale_up" for a in s[1]["actions"])
    assert s[2]["actions"] == [] and s[2]["pending"] > 0


def _defrag(rep):
    assert rep["totals"]["defrag_moves"] > 0
    steps = [r for r in rep["steps"] if any(a["kind"] == "defrag" for a in r["actions"])]
    assert steps and steps[0]["step"] == 4


def _synthetic(rep):
    assert rep["totals"]["evicted"] > 0 and rep["totals"]["scale_ups"] > 0


TMPL = {"max_new_nodes": 4, "node_template": _node_yaml()}
SCENARIOS = {
    "baseline": (_trace_dict([_arrive(0, "a", replicas=2)]), dict(), _baseline),
    "pinned": (_trace_dict([_arrive(0, "a", 3), _arrive(1, "b", 3), _arrive(2, "c", 3)]),
               dict(n_nodes=3, n_pods=3), _pinned),
    "departure": (_trace_dict([_arrive(0, "w0", 2, cpu_m=1200), _arrive(1, "w1", 2, cpu_m=1200),
                               {"t": 2, "kind": "depart", "app": "w0"}]),
                  dict(n_nodes=1, n_pods=3), _departure),
    "kill-node-daemonset": (_trace_dict([{"t": 0, "kind": "kill_node", "target": "rn-0"}]),
                            dict(extra_pods=[_DS_POD]), _kill_node),
    "node-add-remove": (_trace_dict([_arrive(0, "w", 9, cpu_m=1000),
                                     {"t": 1, "kind": "node_add", "count": 2},
                                     {"t": 2, "kind": "node_remove",
                                      "target": "sim-new-000"}],
                                    max_new_nodes=2, node_template=_node_yaml()),
                        dict(n_nodes=1, n_pods=1), _node_add_remove),
    "kill-zone": (_trace_dict([{"t": 0, "kind": "kill_zone", "target": "z0"}]),
                  dict(n_nodes=4, n_pods=0), _kill_zone),
    "depart-by-keys": (_trace_dict([_arrive(0, "a", 2), {
        "t": 1, "kind": "depart", "pods": ["default/base-0", "default/base-1"]}]),
        dict(), _depart_keys),
    "autoscaler": (_trace_dict([_arrive(0, "w0", 8, cpu_m=1000), _arrive(1, "w1", 4, cpu_m=1000),
                                {"t": 2, "kind": "depart", "app": "w0"},
                                {"t": 3, "kind": "depart", "app": "w1"},
                                _arrive(4, "tick0", 0), _arrive(5, "tick1", 0),
                                _arrive(6, "tick2", 0)], **TMPL),
                   dict(n_nodes=1, n_pods=1, controllers=[
                       {"kind": "autoscaler", "scale_step": 2, "idle_steps": 2,
                        "down_cooldown": 1}]), _autoscaler),
    "autoscaler-cooldown": (_trace_dict([_arrive(0, "w0", 6, cpu_m=1000),
                                         _arrive(1, "w1", 6, cpu_m=1000)],
                                        max_new_nodes=8, node_template=_node_yaml()),
                            dict(n_nodes=1, n_pods=1, controllers=[
                                {"kind": "autoscaler", "scale_step": 1, "up_cooldown": 5}]),
                            _cooldown),
    "descheduler": (_trace_dict([_arrive(0, "w0", 6, cpu_m=1500), _arrive(1, "w1", 4, cpu_m=1500),
                                 {"t": 2, "kind": "depart", "app": "w0"},
                                 _arrive(3, "tick", 0)]),
                    dict(n_nodes=4, n_pods=0,
                         controllers=[{"kind": "descheduler", "period": 4}]), _defrag),
    "synthetic-chaos-autoscaler": (
        T.synthetic_trace_dict(n_batches=5, batch_pods=6, depart_every=2, max_new_nodes=4),
        dict(n_nodes=3, n_pods=3, controllers=[{"kind": "autoscaler", "scale_step": 2}]),
        _synthetic),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_replay_equals_the_reference(name):
    """Every step row and the digest equal the reference's, with the fast
    path on and off; the reference test's own assertions hold too."""
    trace_dict, kw, check = SCENARIOS[name]
    check(both(trace_dict, **kw))


@pytest.mark.parametrize("event,needle", [
    ({"t": 0, "kind": "kill_node", "target": "ghost"}, "not found"),
    ({"t": 1, "kind": "depart", "pods": ["default/ghost"]}, "unknown pod"),
])
def test_bad_event_targets_are_structured(event, needle):
    trace = _trace_dict([_arrive(0, "a"), event])
    for pkg, err in (("jax", JError), ("torch", TError)):
        with pytest.raises(err) as ei:
            _run(pkg, trace, 2, 2)
        assert ei.value.code == "E_SPEC" and needle in str(ei.value), pkg


def test_controller_parsing():
    c = T.controller_from_arg("autoscaler:scale_step=3,idle_steps=5")
    assert c.spec_dict() == J.controller_from_arg("autoscaler:scale_step=3,idle_steps=5").spec_dict()
    assert c.spec_dict()["scale_step"] == 3 and c.spec_dict()["idle_steps"] == 5
    assert T.controller_from_dict({"kind": "descheduler", "period": 7}).spec_dict() == {
        "kind": "descheduler", "period": 7}
    for bad in ({"kind": "skynet"}, {"kind": "autoscaler", "bogus_knob": 1}):
        with pytest.raises(TError) as ei:
            T.controller_from_dict(bad)
        assert ei.value.code == "E_SPEC"
    with pytest.raises(TError):
        T.controller_from_arg("autoscaler:scale_step")
    with pytest.raises(TError, match="unique"):
        T.run_replay(T.synthetic_replay_cluster(2, 2),
                     T.ReplayTrace.from_dict(_trace_dict([_arrive(0, "a")])),
                     T.ReplayOptions(controllers=[T.AutoscalerPolicy(), T.AutoscalerPolicy()],
                                     checkpoint=False), device="cpu")


def test_report_render_and_totals():
    rep = _run("torch", _trace_dict([_arrive(0, "a", replicas=2)]), 2, 2)
    text = T.format_report(rep)
    assert "baseline" in text and "arrive a" in text
    assert rep["totals"]["steps"] == 2 and rep["totals"]["events"] == 1
    assert "assign" not in rep["steps"][0]


def test_fast_path_fault_falls_back_to_the_full_scan(monkeypatch):
    """A CUDA out-of-memory error on the fast path's launch classifies as
    E_DEVICE_OOM (deterministic), takes the full-scan rung and leaves the
    rows and the digest of a healthy run."""
    oom = RuntimeError("CUDA out of memory. Tried to allocate 2.00 GiB")
    assert faults.classify(oom).code == faults.E_DEVICE_OOM
    assert not faults.is_transient(oom)
    trace = T.synthetic_trace_dict(n_batches=3, batch_pods=4, max_new_nodes=2)
    healthy = _run("torch", trace, 3, 3)
    real = tengine._World.slice_scan

    def failing(self, start, stop):
        self.carry = None
        return faults.run_launch("replay_step", lambda: (_ for _ in ()).throw(oom), retries=0)

    before = faults.RUNGS[("replay_step", "full_scan")]
    slices = tengine.STEPS_TOTAL["slice"]
    monkeypatch.setattr(tengine._World, "slice_scan", failing)
    degraded = _run("torch", trace, 3, 3)
    monkeypatch.setattr(tengine._World, "slice_scan", real)
    assert faults.RUNGS[("replay_step", "full_scan")] > before
    assert tengine.STEPS_TOTAL["slice"] == slices
    assert degraded["steps"] == healthy["steps"] and degraded["digest"] == healthy["digest"]


# ---- journal + resume ----------------------------------------------------

KILL_AFTER_STEPS = 3
_RESUME_TRACE = dict(n_batches=4, batch_pods=6, depart_every=2, max_new_nodes=4)
_RESUME_CONTROLLERS = [{"kind": "autoscaler", "scale_step": 2},
                       {"kind": "descheduler", "period": 3}]

# the crash child imports only the port: it journals every step and
# SIGKILLs itself once step KILL_AFTER_STEPS is on disk
_CHILD = f"""
import os, signal
from open_simulator_tpu_torch import replay as T
from open_simulator_tpu_torch.replay import engine
real = engine.ReplayJournal.append_step
def kamikaze(self, row):
    real(self, row)
    if len(self.rows) >= {KILL_AFTER_STEPS}:
        os.kill(os.getpid(), signal.SIGKILL)
engine.ReplayJournal.append_step = kamikaze
T.run_replay(T.synthetic_replay_cluster(n_nodes=3, n_initial_pods=3),
             T.ReplayTrace.from_dict(T.synthetic_trace_dict(**{_RESUME_TRACE!r})),
             T.ReplayOptions(controllers=[T.controller_from_dict(dict(c))
                                          for c in {_RESUME_CONTROLLERS!r}]),
             device="cpu")
raise SystemExit("unreachable: the kill must fire mid-replay")
"""


def _resume_run(pkg="torch", **opts):
    return _run(pkg, PKGS[pkg].synthetic_trace_dict(**_RESUME_TRACE), 3, 3,
                _RESUME_CONTROLLERS, **opts)


@pytest.fixture(scope="module")
def reference_resume_digest():
    ref = _resume_run("jax")
    return ref


def test_sigkill_mid_replay_then_resume_equals_the_reference(tmp_path, monkeypatch,
                                                             reference_resume_digest):
    ref = reference_resume_digest
    env = {**os.environ, lifecycle.CHECKPOINT_DIR_ENV: str(tmp_path)}
    proc = subprocess.run([sys.executable, "-c", _CHILD], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == -signal.SIGKILL, proc.stderr
    [name] = [n for n in os.listdir(tmp_path) if n.endswith(tengine.REPLAY_JOURNAL_SUFFIX)]
    with open(tmp_path / name, encoding="utf-8") as f:
        kinds = [json.loads(unframe_line(ln))["kind"] for ln in f if ln.strip()]
    assert kinds == ["header"] + ["step"] * KILL_AFTER_STEPS
    monkeypatch.setenv(lifecycle.CHECKPOINT_DIR_ENV, str(tmp_path))
    resumed = _resume_run(resume="last", checkpoint=None)
    assert resumed["resumed_steps"] == KILL_AFTER_STEPS
    assert resumed["digest"] == ref["digest"] and resumed["steps"] == ref["steps"]
    done = T.resolve_replay("last").done
    assert done["digest"] == ref["digest"] and done["steps"] == ref["totals"]["steps"]
    report = tengine.report_from_journal(T.resolve_replay("last"))
    assert report["digest"] == ref["digest"]


def test_resume_refuses_drift_and_replays_a_finished_run(tmp_path, monkeypatch,
                                                         reference_resume_digest):
    monkeypatch.setenv(lifecycle.CHECKPOINT_DIR_ENV, str(tmp_path))
    first = _resume_run(checkpoint=None)
    assert first["digest"] == reference_resume_digest["digest"]
    again = _resume_run(resume="last", checkpoint=None)
    assert again["resumed_steps"] == first["totals"]["steps"]
    assert again["digest"] == first["digest"]
    with pytest.raises(lifecycle.ResumeError, match="drifted"):
        _run("torch", T.synthetic_trace_dict(**_RESUME_TRACE), 3, 3, (), resume="last",
             checkpoint=None)
    drifted = T.synthetic_trace_dict(**_RESUME_TRACE)
    drifted["events"].append(drifted["events"][-1])
    with pytest.raises(lifecycle.ResumeError, match="drifted"):
        _run("torch", drifted, 3, 3, _RESUME_CONTROLLERS, resume="last", checkpoint=None)


def test_resume_without_checkpoint_dir_is_structured(monkeypatch):
    monkeypatch.delenv(lifecycle.CHECKPOINT_DIR_ENV, raising=False)
    monkeypatch.delenv(lifecycle.LEDGER_DIR_ENV, raising=False)
    with pytest.raises(lifecycle.ResumeError, match="no checkpoint directory"):
        _resume_run(resume="last")


def test_cancellation_at_step_boundary_carries_partials():
    token = lifecycle.CancelToken(None)
    calls = {"n": 0}
    real = lifecycle.check_current

    def cancel_after_two(where="", partial=None):
        if where == "replay step boundary":
            calls["n"] += 1
            if calls["n"] > 2:
                token.cancel("test deadline")
        return real(where, partial)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(lifecycle, "check_current", cancel_after_two)
        with lifecycle.cancel_scope(token):
            with pytest.raises(lifecycle.CancelledError) as ei:
                _resume_run()
    partial = ei.value.partial
    assert ei.value.code == "E_CANCELLED"
    assert partial["steps_completed"] == 2
    assert partial["total_steps"] == len(T.synthetic_trace_dict(**_RESUME_TRACE)["events"]) + 1
    assert "replay_id" in partial


# ---- random traces -------------------------------------------------------

_NODES = [f"rn-{i}" for i in range(6)] + ["sim-new-000"]


@st.composite
def _events(draw):
    n = draw(st.integers(1, 10))
    events, arrived, added = [], [], 0
    for i in range(n):
        kind = draw(st.sampled_from(["arrive", "arrive", "depart", "node_add", "kill_node"]))
        if kind == "depart" and arrived:
            events.append({"t": float(i), "kind": "depart",
                           "app": arrived.pop(draw(st.integers(0, len(arrived) - 1)))})
        elif kind == "node_add" and added < 3:
            count = draw(st.integers(1, 3 - added))
            added += count
            events.append({"t": float(i), "kind": "node_add", "count": count})
        elif kind == "kill_node":
            events.append({"t": float(i), "kind": "kill_node",
                           "target": draw(st.sampled_from(_NODES))})
        else:
            name = f"a{i}"
            arrived.append(name)
            events.append(_arrive(float(i), name, draw(st.integers(0, 4)),
                                  cpu_m=draw(st.sampled_from([500, 1200, 2500]))))
    return _trace_dict(events, max_new_nodes=3, node_template=_node_yaml())


@settings(max_examples=4, deadline=None, derandomize=True)
@given(_events())
def test_random_traces_give_the_reference_digest(trace_dict):
    ref = _run("jax", trace_dict, 6, 4)
    got = _run("torch", trace_dict, 6, 4)
    assert got["steps"] == ref["steps"]
    assert got["digest"] == ref["digest"]
