"""Fleet campaigns through the port equal the JAX package's.

The cases of tests/test_campaign.py and of the fleet-lane tests of
tests/test_tune.py, run through ``open_simulator_tpu_torch.campaign`` on
the CPU (``device="cpu"``: the plain torch step, and the fleet launch's
plain version). Where both packages can run a fleet, the reference runs
the same dumps and the port must give its report digest, rows,
quarantine records, ``buckets`` and ``launches``: fleet lanes on and off,
a torn dump, a poisoned lane, mixed buckets and ``lane_width=2``; a
campaign killed after its first settled cluster and resumed gives the
uninterrupted digest. Tolerance: exact.

Left out (ROADMAP queue 1): the run ledger and the REST route (item 11:
test_campaign.py's ledger degradation case, the ``runs`` half of its CLI
case and its REST case), the sweep journals (item 8: its two sweep-journal
cases) and the bench contract (item 12).
"""

from __future__ import annotations

import json
import logging
import os
import random
import signal
import subprocess
import sys

import numpy as np
import pytest
import yaml

from open_simulator_tpu import campaign as ref
from open_simulator_tpu.replay import synthetic_replay_cluster as ref_replay_cluster
from open_simulator_tpu_torch import core as tcore
from open_simulator_tpu_torch.campaign import (
    AuditError,
    CampaignOptions,
    audit_result,
    discover_fleet,
    format_audit,
    format_report,
    lanes as lanes_mod,
    load_and_admit,
    report_from_journal,
    resolve_campaign,
    run_campaign,
    write_synthetic_fleet,
)
from open_simulator_tpu_torch.core import AppResource, simulate
from open_simulator_tpu_torch.errors import SimulationError
from open_simulator_tpu_torch.k8s.cluster_source import ClusterSourceError
from open_simulator_tpu_torch.k8s.loader import ClusterResources
from open_simulator_tpu_torch.resilience import lifecycle
from open_simulator_tpu_torch.resilience.journal import unframe_line
from open_simulator_tpu_torch.testing.builders import make_fake_node, make_fake_pod

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "tests", "fixtures", "api_dump.json")


@pytest.fixture
def fleet_dir(tmp_path):
    d = tmp_path / "fleet"
    write_synthetic_fleet(str(d), n_clusters=3, nodes=4, pods=12, malformed=1)
    return str(d)


@pytest.fixture
def no_checkpoint(monkeypatch):
    monkeypatch.delenv(lifecycle.CHECKPOINT_DIR_ENV, raising=False)
    monkeypatch.delenv(lifecycle.LEDGER_DIR_ENV, raising=False)


def port(**kw):
    return run_campaign(CampaignOptions(device="cpu", **kw))


def reference(**kw):
    return ref.run_campaign(ref.CampaignOptions(**kw))


def assert_same_report(got, want):
    for key in ("digest", "totals", "clusters", "quarantined", "buckets", "launches",
                "quarantine_summary", "top_reject_ops", "utilization"):
        assert got[key] == want[key], key


# ---- the synthetic fleet writer and fleet discovery ----------------------


def test_synthetic_fleet_equals_reference_bytes(tmp_path):
    a = write_synthetic_fleet(str(tmp_path / "a"), n_clusters=4, malformed=1, seed=3)
    b = ref.write_synthetic_fleet(str(tmp_path / "b"), n_clusters=4, malformed=1, seed=3)
    assert [os.path.basename(p) for p in a] == [os.path.basename(p) for p in b]
    for x, y in zip(a, b):
        with open(x, "rb") as fx, open(y, "rb") as fy:
            assert fx.read() == fy.read()
    got = discover_fleet(str(tmp_path / "a"))
    want = ref.discover_fleet(str(tmp_path / "b"))
    assert [(e.name, e.digest) for e in got] == [(e.name, e.digest) for e in want]
    assert ref.fleet_digest(want, "s", {"k": 1}) == __import__(
        "open_simulator_tpu_torch.campaign.fleet", fromlist=["fleet_digest"]).fleet_digest(
            got, "s", {"k": 1})


# ---- fault isolation -----------------------------------------------------


@pytest.mark.parametrize("fleet_lanes", [True, False])
def test_poisoned_cluster_quarantined_campaign_continues(fleet_dir, no_checkpoint, fleet_lanes):
    report = port(fleet=fleet_dir, checkpoint=False, fleet_lanes=fleet_lanes)
    t = report["totals"]
    assert t == {"clusters": 3, "completed": 2, "quarantined": 1,
                 "placed": t["placed"], "unplaced": t["unplaced"]}
    assert t["placed"] > 0
    [quar] = report["quarantined"]
    assert quar["cluster"] == "cluster-02"
    assert quar["error"]["code"] == "E_SOURCE"
    assert "line" in quar["error"]["field"]
    assert quar["attempts"] == 1
    assert [r["cluster"] for r in report["clusters"]] == ["cluster-00", "cluster-01"]
    assert all(r["audit_ok"] for r in report["clusters"])
    assert report["quarantine_summary"] == {"E_SOURCE": 1}
    assert len(report["buckets"]) == 2
    text = format_report(report)
    assert "QUARANTINED [E_SOURCE]" in text and "cluster-00" in text
    assert_same_report(report, reference(fleet=fleet_dir, checkpoint=False,
                                         fleet_lanes=fleet_lanes))


def test_audit_violation_quarantines_with_e_audit(fleet_dir, no_checkpoint, monkeypatch):
    real_simulate = simulate

    def corrupting(cluster, apps, **kw):
        result = real_simulate(cluster, apps, **kw)
        if result.scheduled_pods and cluster.nodes[0].name.startswith("cluster-00"):
            result.scheduled_pods[0].node_name = "ghost-node"
        return result

    monkeypatch.setattr(tcore, "simulate", corrupting)
    report = port(fleet=fleet_dir, checkpoint=False)
    codes = {q["cluster"]: q["error"]["code"] for q in report["quarantined"]}
    assert codes == {"cluster-00": "E_AUDIT", "cluster-02": "E_SOURCE"}
    assert [r["cluster"] for r in report["clusters"]] == ["cluster-01"]
    audit_err = next(q for q in report["quarantined"] if q["cluster"] == "cluster-00")["error"]
    assert "audit" in audit_err and not audit_err["audit"]["ok"]


def test_transient_failures_retry_with_history(fleet_dir, no_checkpoint, monkeypatch):
    calls = {"n": 0}
    real_simulate = simulate

    def flaky(cluster, apps, **kw):
        if cluster.nodes[0].name.startswith("cluster-00"):
            calls["n"] += 1
            if calls["n"] == 1:
                raise OSError("DATA_LOSS: failed to transfer buffer")
        return real_simulate(cluster, apps, **kw)

    monkeypatch.setattr(tcore, "simulate", flaky)
    report = port(fleet=fleet_dir, checkpoint=False, backoff_s=0.0)
    assert report["totals"]["completed"] == 2
    assert calls["n"] == 2

    def always_down(cluster, apps, **kw):
        if cluster.nodes[0].name.startswith("cluster-00"):
            raise OSError("connection reset by peer")
        return real_simulate(cluster, apps, **kw)

    monkeypatch.setattr(tcore, "simulate", always_down)
    report = port(fleet=fleet_dir, checkpoint=False, retries=2, backoff_s=0.0)
    quar = next(q for q in report["quarantined"] if q["cluster"] == "cluster-00")
    assert quar["error"]["code"] == "E_INTERNAL"
    assert quar["attempts"] == 3 and quar["transient_retries"] == 2

    det_calls = {"n": 0}

    def oom(cluster, apps, **kw):
        if cluster.nodes[0].name.startswith("cluster-00"):
            det_calls["n"] += 1
            raise RuntimeError("RESOURCE_EXHAUSTED: out of memory")
        return real_simulate(cluster, apps, **kw)

    monkeypatch.setattr(tcore, "simulate", oom)
    report = port(fleet=fleet_dir, checkpoint=False, retries=2, backoff_s=0.0)
    quar = next(q for q in report["quarantined"] if q["cluster"] == "cluster-00")
    assert det_calls["n"] == 1
    assert quar["attempts"] == 1 and quar["transient_retries"] == 0


def test_cancellation_observed_at_cluster_boundary(fleet_dir, no_checkpoint):
    token = lifecycle.CancelToken()
    token.cancel("drain")
    with lifecycle.cancel_scope(token):
        with pytest.raises(lifecycle.CancelledError) as ei:
            port(fleet=fleet_dir, checkpoint=False)
    assert "campaign cluster boundary" in str(ei.value)
    assert "clusters_settled" in ei.value.partial


# ---- checkpoint / resume -------------------------------------------------

_CHILD = """
import os, signal
from open_simulator_tpu_torch.campaign import CampaignOptions, run_campaign
from open_simulator_tpu_torch.campaign import runner
real_append = runner.CampaignJournal._append
def kamikaze(self, rec):
    real_append(self, rec)
    if rec.get("kind") in ("cluster", "quarantine"):
        os.kill(os.getpid(), signal.SIGKILL)
runner.CampaignJournal._append = kamikaze
run_campaign(CampaignOptions(fleet=os.environ["TEST_FLEET"], fleet_lanes=False, device="cpu"))
raise SystemExit("unreachable")
"""


def test_sigkill_mid_campaign_then_resume_bit_identical(fleet_dir, tmp_path, no_checkpoint,
                                                        monkeypatch):
    """Killed once its first settled cluster is journaled (the serial
    boundary), resumed with the fleet lanes on: the digest and totals of
    an uninterrupted run, the quarantined cluster reported once."""
    uninterrupted = port(fleet=fleet_dir, checkpoint=False)
    ckpt = tmp_path / "ckpt"
    env = {**os.environ, "TEST_FLEET": fleet_dir, lifecycle.CHECKPOINT_DIR_ENV: str(ckpt)}
    proc = subprocess.run([sys.executable, "-c", _CHILD], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == -signal.SIGKILL, proc.stderr
    [name] = [n for n in os.listdir(ckpt) if n.endswith(".campaign.jsonl")]
    with open(ckpt / name, encoding="utf-8") as f:
        kinds = [json.loads(unframe_line(ln))["kind"] for ln in f if ln.strip()]
    assert kinds == ["header", "cluster"]

    monkeypatch.setenv(lifecycle.CHECKPOINT_DIR_ENV, str(ckpt))
    resumed = port(fleet=fleet_dir, resume="last")
    journal = resolve_campaign("last")
    assert resumed["resumed_clusters"] == 1
    assert resumed["digest"] == uninterrupted["digest"]
    assert resumed["totals"] == uninterrupted["totals"]
    assert [q["cluster"] for q in resumed["quarantined"]] == ["cluster-02"]
    assert journal.done is not None and journal.done["digest"] == uninterrupted["digest"]
    assert report_from_journal(journal)["digest"] == uninterrupted["digest"]
    assert len([r for r in journal.records if r["kind"] == "quarantine"]) == 1


def test_resume_fleet_drift_is_structured(fleet_dir, tmp_path, no_checkpoint, monkeypatch):
    monkeypatch.setenv(lifecycle.CHECKPOINT_DIR_ENV, str(tmp_path / "ck"))
    port(fleet=fleet_dir)
    with open(os.path.join(fleet_dir, "cluster-00.json"), "a", encoding="utf-8") as f:
        f.write("\n")
    with pytest.raises(lifecycle.ResumeError, match="fleet drifted"):
        port(fleet=fleet_dir, resume="last")


def test_resume_unknown_id_and_no_dir(fleet_dir, no_checkpoint, tmp_path, monkeypatch):
    with pytest.raises(lifecycle.ResumeError, match="no checkpoint"):
        port(fleet=fleet_dir, resume="last")
    monkeypatch.setenv(lifecycle.CHECKPOINT_DIR_ENV, str(tmp_path))
    with pytest.raises(lifecycle.ResumeError, match="no campaign"):
        port(fleet=fleet_dir, resume="last")


# ---- the auditor ---------------------------------------------------------


def _small_result():
    cluster = ClusterResources()
    cluster.nodes = [make_fake_node("n0", cpu="4", memory="8Gi"),
                     make_fake_node("n1", cpu="4", memory="8Gi")]
    bound = make_fake_pod("bound", cpu="500m", memory="512Mi")
    bound.node_name = "n0"
    cluster.pods = [bound]
    app = ClusterResources()
    app.pods = [make_fake_pod(f"p{i}", cpu="500m", memory="256Mi") for i in range(4)]
    return simulate(cluster, [AppResource(name="a", resources=app)], device="cpu")


def test_audit_clean_result_passes():
    rep = audit_result(_small_result())
    assert rep.ok and rep.n_violations == 0
    assert rep.n_bound == 5 and rep.n_active_nodes == 2
    assert rep.cpu_pct > 0
    assert "binding" in rep.checks and "forced" in rep.checks
    assert "PASS" in format_audit(rep, name="small")


def _free_scheduled(result):
    forced = np.asarray(result.snapshot.arrays.forced_node)
    for sp in result.scheduled_pods:
        pi = next(i for i, p in enumerate(result.snapshot.pods) if p is sp.pod)
        if forced[pi] < 0:
            return sp
    raise AssertionError("no free scheduled pod in the fixture")


def test_audit_flags_unknown_and_inactive_node():
    result = _small_result()
    _free_scheduled(result).node_name = "ghost"
    rep = audit_result(result)
    assert not rep.ok and {v.kind for v in rep.violations} == {"unknown_node"}

    result = _small_result()
    had_on_n1 = any(sp.node_name == "n1" for sp in result.scheduled_pods)
    result.node_status = [ns for ns in result.node_status if ns.node.name != "n1"]
    rep = audit_result(result)
    if had_on_n1:
        assert {v.kind for v in rep.violations} == {"inactive_node"}
    else:
        assert rep.ok


def test_audit_flags_overcommit_and_forced_drift():
    import dataclasses

    result = _small_result()
    arrs = result.snapshot.arrays
    result.snapshot.arrays = dataclasses.replace(arrs, req=np.asarray(arrs.req) * 100.0)
    rep = audit_result(result)
    assert not rep.ok and "overcommit" in {v.kind for v in rep.violations}

    result = _small_result()
    arrs = result.snapshot.arrays
    forced = np.asarray(arrs.forced_node).copy()
    placed_on = result.scheduled_pods[0].node_name
    other = 1 if placed_on == result.snapshot.node_names[0] else 0
    pi = result.snapshot.pods.index(result.scheduled_pods[0].pod)
    forced[pi] = other
    result.snapshot.arrays = dataclasses.replace(arrs, forced_node=forced)
    rep = audit_result(result)
    assert any(v.kind == "forced_bind" for v in rep.violations)


def test_audit_error_payload_is_structured():
    result = _small_result()
    _free_scheduled(result).node_name = "ghost"
    err = AuditError(audit_result(result), ref="cluster/x")
    assert err.code == "E_AUDIT"
    d = err.to_dict()
    assert d["audit"]["n_violations"] == 1
    assert d["audit"]["violations"][0]["kind"] == "unknown_node"


def test_audit_cli_standalone_equals_reference(capsys):
    from open_simulator_tpu.cli.main import main as ref_main
    from open_simulator_tpu_torch.cli.main import main as port_main

    assert port_main(["campaign", "audit", FIXTURE, "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "PASS" in out
    assert ref_main(["campaign", "audit", FIXTURE]) == 0
    assert capsys.readouterr().out == out
    assert port_main(["campaign", "audit", FIXTURE, "--device", "cpu", "--json"]) == 0
    got = json.loads(capsys.readouterr().out)
    assert ref_main(["campaign", "audit", FIXTURE, "--json"]) == 0
    assert got == json.loads(capsys.readouterr().out)


# ---- the fuzzed admission boundary ---------------------------------------


def _mutate(doc, rng):
    doc = json.loads(json.dumps(doc))
    items = doc.get("items", [])
    kind = rng.randrange(6)
    if kind == 0 and items:
        obj = rng.choice(items)
        if obj:
            obj.pop(rng.choice(sorted(obj)), None)
    elif kind == 1 and items:
        obj = rng.choice(items)
        key = rng.choice(sorted(obj)) if obj else None
        if key:
            obj[key] = rng.choice([42, ["x"], "zzz", None])
    elif kind == 2:
        for obj in items:
            if obj.get("kind") == "Pod":
                c = obj.setdefault("spec", {}).setdefault("containers", [{}])[0]
                c.setdefault("resources", {})["requests"] = {
                    "cpu": rng.choice(["-1", "2x", "--", "1e999m"]), "memory": "-5Gi"}
                break
    elif kind == 3 and items:
        rng.choice(items)["kind"] = rng.choice(["Frobnicator", 7, "", None])
    elif kind == 4 and items:
        rng.choice(items)["metadata"] = rng.choice([3, "meta", ["x"]])
    elif items:
        obj = rng.choice(items)
        obj[rng.choice(["status", "spec"])] = rng.choice([17, "nope", [1, 2]])
    return doc


def test_fuzzed_dumps_yield_the_reference_verdicts(tmp_path):
    """~50 seeded mutations of a valid dump: the port's load and admission
    boundary answers each with success or a structured SimulationError,
    never a traceback, with the reference's code and message."""
    from open_simulator_tpu.errors import SimulationError as RefError

    with open(FIXTURE, encoding="utf-8") as f:
        base = json.load(f)
    rng = random.Random(1208)
    outcomes = {"ok": 0, "structured": 0}
    for i in range(50):
        doc = _mutate(base, rng)
        path = tmp_path / f"mutant-{i:02d}.json"
        text = json.dumps(doc)
        if i % 10 == 9:
            text = text[:rng.randrange(1, max(2, len(text) - 1))]
        path.write_text(text)
        try:
            ref.load_and_admit(str(path))
            want = None
        except RefError as e:
            want = (e.code, str(e))
        try:
            load_and_admit(str(path))
            outcomes["ok"] += 1
            assert want is None, f"mutant {i}: the reference refused {want}"
        except SimulationError as e:
            assert e.code and isinstance(e.to_dict(), dict)
            assert (e.code, str(e)) == want, f"mutant {i}"
            outcomes["structured"] += 1
    assert outcomes["structured"] > 0 and sum(outcomes.values()) == 50


# ---- degrade-to-disabled checkpoint dir ----------------------------------


def test_unwritable_checkpoint_dir_campaign_still_runs(fleet_dir, tmp_path, no_checkpoint,
                                                       monkeypatch, caplog):
    blocker = tmp_path / "blocker"
    blocker.write_text("not a dir")
    monkeypatch.setenv(lifecycle.CHECKPOINT_DIR_ENV, str(blocker / "ckpt"))
    with caplog.at_level(logging.WARNING):
        report = port(fleet=fleet_dir)
    assert report["totals"]["completed"] == 2
    assert any("checkpointing disabled" in r.message for r in caplog.records)


# ---- surfaces ------------------------------------------------------------


def test_campaign_cli_run_and_report(fleet_dir, tmp_path, no_checkpoint, monkeypatch, capsys):
    from open_simulator_tpu_torch.cli.main import main

    monkeypatch.setenv(lifecycle.CHECKPOINT_DIR_ENV, str(tmp_path / "ck"))
    rc = main(["campaign", "run", "--fleet", fleet_dir, "--json", "--device", "cpu"])
    report = json.loads(capsys.readouterr().out)
    assert rc == 0
    assert report["totals"] == {"clusters": 3, "completed": 2, "quarantined": 1,
                                "placed": report["totals"]["placed"],
                                "unplaced": report["totals"]["unplaced"]}
    rc = main(["campaign", "report", report["campaign_id"][:6], "--json"])
    assert rc == 0
    assert json.loads(capsys.readouterr().out)["digest"] == report["digest"]
    rc = main(["campaign", "report"])
    assert rc == 0 and report["digest"] in capsys.readouterr().out


@pytest.mark.parametrize("flag,item", [("--ledger-dir", "item 11"),
                                       ("--compile-cache-dir", "item 8")])
def test_campaign_cli_refuses_unported_options(fleet_dir, tmp_path, flag, item, capsys):
    from open_simulator_tpu_torch.cli.main import main

    rc = main(["campaign", "run", "--fleet", fleet_dir, flag, str(tmp_path / "x"),
               "--device", "cpu"])
    assert rc == 1 and item in capsys.readouterr().err


def test_fleet_manifest_and_errors(tmp_path, fleet_dir):
    manifest = tmp_path / "fleet.yaml"
    manifest.write_text(
        "clusters:\n"
        f"  - {os.path.join(fleet_dir, 'cluster-00.json')}\n"
        f"  - name: second\n"
        f"    path: {os.path.join(fleet_dir, 'cluster-01.json')}\n")
    entries = discover_fleet(str(manifest))
    assert [e.name for e in entries] == ["cluster-00", "second"]
    assert all(e.digest for e in entries)
    with pytest.raises(ClusterSourceError, match="does not exist"):
        discover_fleet(str(tmp_path / "nope"))
    empty = tmp_path / "empty"
    empty.mkdir()
    with pytest.raises(ClusterSourceError, match="no cluster dumps"):
        discover_fleet(str(empty))
    bad = tmp_path / "bad.yaml"
    bad.write_text("just a string")
    with pytest.raises(ClusterSourceError, match="manifest"):
        discover_fleet(str(bad))


def test_vanished_dump_quarantines_not_aborts(fleet_dir, tmp_path, no_checkpoint):
    manifest = tmp_path / "fleet.yaml"
    manifest.write_text(
        "clusters:\n"
        f"  - {os.path.join(fleet_dir, 'cluster-00.json')}\n"
        f"  - {os.path.join(fleet_dir, 'vanished.json')}\n")
    report = port(fleet=str(manifest), checkpoint=False)
    assert report["totals"]["completed"] == 1
    [quar] = report["quarantined"]
    assert quar["cluster"] == "vanished"
    assert quar["error"]["code"] == "E_SOURCE"
    assert quar["source"].startswith("unreadable-")
    assert_same_report(report, reference(fleet=str(manifest), checkpoint=False))


# ---- fleet lanes (the cases of tests/test_tune.py) -----------------------


def _write_fleet(tmp_path, n=4, poison_idx=None, sizes=None):
    """Recorded dumps of the reference's replay cluster (both packages read
    the same files)."""
    for i in range(n):
        path = tmp_path / f"c{i}.yaml"
        if i == poison_idx:
            path.write_text("{not: [valid yaml")
            continue
        nodes, pods = (sizes or {}).get(i, (6, 12))
        cl = ref_replay_cluster(n_nodes=nodes, n_initial_pods=pods, cpu_m=4000 + 500 * i)
        path.write_text(yaml.safe_dump_all(
            [{"apiVersion": "v1", "kind": "Node", **n_.raw} for n_ in cl.nodes]
            + [{"apiVersion": "v1", "kind": "Pod", **p.raw} for p in cl.pods]))
    return str(tmp_path)


def test_fleet_lanes_fewer_launches_same_digest(tmp_path):
    fleet = _write_fleet(tmp_path)
    serial = port(fleet=fleet, fleet_lanes=False, checkpoint=False)
    lanes = port(fleet=fleet, fleet_lanes=True, checkpoint=False)
    assert serial["totals"]["completed"] == 4
    assert lanes["digest"] == serial["digest"]
    assert serial["launches"] == 4 and lanes["launches"] == 1
    assert len(lanes["buckets"]) == 1
    assert_same_report(lanes, reference(fleet=fleet, fleet_lanes=True, checkpoint=False))


def test_fleet_lanes_quarantine_digest_identical(tmp_path):
    fleet = _write_fleet(tmp_path, poison_idx=1)
    serial = port(fleet=fleet, fleet_lanes=False, checkpoint=False)
    lanes = port(fleet=fleet, fleet_lanes=True, checkpoint=False)
    assert serial["totals"]["quarantined"] == 1
    assert lanes["digest"] == serial["digest"]
    assert lanes["launches"] == 2
    assert lanes["quarantined"][0]["error"]["code"] == "E_SOURCE"
    assert_same_report(lanes, reference(fleet=fleet, fleet_lanes=True, checkpoint=False))


def test_fleet_lane_poisoned_lane_is_isolated(tmp_path, monkeypatch):
    fleet = _write_fleet(tmp_path)
    real = lanes_mod._decode_lane

    def poisoned(prep, out, lane, n_lanes, opts, campaign_id):
        if prep.entry.name == "c2":
            raise SimulationError("placement audit violated (injected)", code="E_AUDIT",
                                  ref="cluster/c2")
        return real(prep, out, lane, n_lanes, opts, campaign_id)

    monkeypatch.setattr(lanes_mod, "_decode_lane", poisoned)
    rep = port(fleet=fleet, fleet_lanes=True, checkpoint=False)
    assert rep["totals"]["completed"] == 3 and rep["totals"]["quarantined"] == 1
    assert rep["quarantined"][0]["cluster"] == "c2"
    assert rep["quarantined"][0]["error"]["code"] == "E_AUDIT"
    assert rep["launches"] == 1

    from open_simulator_tpu.campaign import lanes as ref_lanes

    ref_real = ref_lanes._decode_lane

    def ref_poisoned(prep, out, lane, n_lanes, opts, campaign_id):
        if prep.entry.name == "c2":
            raise ref.runner.SimulationError("placement audit violated (injected)",
                                             code="E_AUDIT", ref="cluster/c2")
        return ref_real(prep, out, lane, n_lanes, opts, campaign_id)

    monkeypatch.setattr(ref_lanes, "_decode_lane", ref_poisoned)
    assert_same_report(rep, reference(fleet=fleet, fleet_lanes=True, checkpoint=False))


def test_fleet_lane_batch_split_isolates_a_numeric_fault(tmp_path, monkeypatch):
    """A launch whose decoded state carries a NaN walks the batch-split
    rung down to the poisoned cluster, which quarantines with E_NUMERIC;
    its siblings settle from their own launches."""
    from open_simulator_tpu_torch.engine import exec_cache

    fleet = _write_fleet(tmp_path)
    real = exec_cache.run_fleet_batched

    def nan_in_c1(arrs_batch, masks, cfg, **kw):
        out = real(arrs_batch, masks, cfg, **kw)
        alloc = np.asarray(arrs_batch.alloc)
        hit = [s for s in range(alloc.shape[0]) if alloc[s, 0, 0] == 4500]
        if hit:
            out.state.headroom[hit[0], 0, 0] = float("nan")
        return out

    monkeypatch.setattr(exec_cache, "run_fleet_batched", nan_in_c1)
    rep = port(fleet=fleet, fleet_lanes=True, checkpoint=False)
    assert rep["totals"]["completed"] == 3
    [quar] = rep["quarantined"]
    assert quar["cluster"] == "c1" and quar["error"]["code"] == "E_NUMERIC"
    assert rep["launches"] == 3  # [c0 c1 | c2 c3] then [c0 | c1]


def test_fleet_lane_mixed_buckets_group_by_shape(tmp_path):
    fleet = _write_fleet(tmp_path, sizes={0: (6, 12), 1: (6, 12), 2: (40, 80), 3: (40, 80)})
    rep = port(fleet=fleet, fleet_lanes=True, checkpoint=False)
    assert rep["totals"]["completed"] == 4
    assert rep["launches"] == 2 and len(rep["buckets"]) == 2


def test_fleet_lane_width_caps_the_batch(tmp_path):
    fleet = _write_fleet(tmp_path)
    rep = port(fleet=fleet, fleet_lanes=True, lane_width=2, checkpoint=False)
    assert rep["totals"]["completed"] == 4
    assert rep["launches"] == 2


def test_fleet_lane_width_2_over_mixed_buckets_equals_reference(tmp_path):
    fleet = _write_fleet(tmp_path, sizes={0: (6, 12), 1: (6, 12), 2: (40, 80), 3: (6, 12)})
    rep = port(fleet=fleet, fleet_lanes=True, lane_width=2, checkpoint=False)
    assert rep["totals"]["completed"] == 4
    assert rep["launches"] == 3  # [c0 c1], then c2 and c3 alone through the serial boundary
    assert_same_report(rep, reference(fleet=fleet, fleet_lanes=True, lane_width=2,
                                      checkpoint=False))
