"""The port's ``apply`` CLI prints the JAX package's report.

For each example config with a ``newNode`` whose ops are ported
(``config``, ``constraints``, ``controlplane``, ``morepods``), in both
sweep modes, ``python -m open_simulator_tpu_torch.cli apply ... --device
cpu`` writes the same stdout and exits with the same code as the
reference's ``simon-tpu apply``. Both packages name the new-node slots
from a seeded generator of their own, reseeded before each run. The
device-resource configs (``gpushare`` with ``--extended-resources gpu``,
``openlocal``, ``stateful``) print the reference's report too, and the
``gpushare`` capacity plans, with their GPU picks, have the reference's
``plan_digest`` in both sweep modes. Also: a bad config exits 1 with the
reference's message, and the default device is the card.
"""

from __future__ import annotations

import os

import pytest
import torch

import numpy as np

import torch_parity as tp
from open_simulator_tpu.cli.main import main as ref_main
from open_simulator_tpu.encode.snapshot import EncodeOptions
from open_simulator_tpu.engine import scheduler as jsched
from open_simulator_tpu.k8s import loader as jloader
from open_simulator_tpu.k8s.objects import Node as JNode
from open_simulator_tpu.parallel import sweep as jsweep
from open_simulator_tpu.telemetry.ledger import plan_digest
from open_simulator_tpu_torch.apply.applier import Applier, ApplyOptions
from open_simulator_tpu_torch.parallel import sweep as tsweep
from open_simulator_tpu_torch.cli.main import main as port_main
from open_simulator_tpu_torch.k8s import loader as tloader

EXAMPLES = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "examples")
CONFIGS = ("config", "constraints", "controlplane", "morepods")


def config_path(name: str) -> str:
    return os.path.join(EXAMPLES, "config.yaml" if name == "config" else f"{name}-config.yaml")


def run(main, argv, capsys):
    for rand in (jloader._RAND, tloader._RAND):
        rand.seed(20260729)
    rc = main(argv)
    out = capsys.readouterr()
    return rc, out.out, out.err


@pytest.mark.parametrize("mode", ["bisect", "exhaustive"])
@pytest.mark.parametrize("name", CONFIGS)
def test_apply_stdout_equals_reference(name, mode, capsys):
    argv = ["apply", "-f", config_path(name), "--max-new-nodes", "16", "--sweep-mode", mode]
    rc_ref, out_ref, _ = run(ref_main, argv, capsys)
    rc, out, err = run(port_main, argv + ["--device", "cpu"], capsys)
    assert (rc, err) == (rc_ref, "")
    assert out == out_ref
    assert "=== Pods ===" in out
    if name == "morepods":
        assert rc == 0 and "requires 3 new node(s)" in out and "(new)" in out


DEVRES = {"gpushare": ["--extended-resources", "gpu"], "openlocal": [], "stateful": []}


@pytest.mark.parametrize("mode", ["bisect", "exhaustive"])
@pytest.mark.parametrize("name", sorted(DEVRES))
def test_device_resource_apply_equals_reference(name, mode, capsys):
    argv = (["apply", "-f", config_path(name), "--max-new-nodes", "16", "--sweep-mode", mode]
            + DEVRES[name])
    rc_ref, out_ref, _ = run(ref_main, argv, capsys)
    rc, out, err = run(port_main, argv + ["--device", "cpu"], capsys)
    assert (rc, err) == (rc_ref, "")
    assert out == out_ref
    if name == "gpushare":
        assert rc == 0 and "=== GPU ===" in out and "gpu-3" in out


def _gpushare_plans(mode):
    """The gpushare config's snapshot with 16 GPU template slots, through
    both packages' sweeps in `mode` (reasons off, as apply runs them)."""
    cluster, apps = tp.load("jax", "gpushare")
    nodes = [jloader.make_valid_node(n) for n in cluster.nodes]
    with open(os.path.join(EXAMPLES, "newnode", "gpu.yaml"), encoding="utf-8") as f:
        doc = next(d for d in jloader.parse_yaml_documents(f.read()) if d)
    template = jloader.make_valid_node(JNode.from_dict(doc))
    cluster.nodes = nodes
    pods = tp.jcore.build_pod_sequence(cluster, apps)
    jloader._RAND.seed(20260729)
    snap = tp.jsnapshot.encode_cluster(nodes, pods, EncodeOptions(
        max_new_nodes=16, new_node_template=template))
    jcfg = jsched.make_config(snap)
    limit = jsweep.SweepThresholds(max_cpu_pct=30.0)
    port, cfg = tp.port_snapshot(snap), tp.torch_cfg(jcfg)
    if mode == "bisect":
        return (jsweep.capacity_bisect(snap, jcfg, 16, limit),
                tsweep.capacity_bisect(port, cfg, 16, limit, device="cpu"))
    counts = list(range(17))
    return (jsweep.capacity_sweep(snap, jcfg, counts, limit),
            tsweep.capacity_sweep(port, cfg, counts, limit, device="cpu"))


@pytest.mark.parametrize("mode", ["bisect", "exhaustive"])
def test_gpushare_plan_digest_and_picks_equal_reference(mode):
    ref, got = _gpushare_plans(mode)
    assert got.counts == ref.counts and got.best_count == ref.best_count
    assert got.satisfied == ref.satisfied and 0 < got.best_count < 16
    for f in ("nodes_per_scenario", "gpu_pick"):
        a, b = getattr(ref, f), getattr(got, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    assert got.vol_pick is None and ref.vol_pick is None
    assert plan_digest(got) == plan_digest(ref)


def test_bad_config_exits_1_with_the_reference_message(tmp_path, capsys):
    (tmp_path / "bad.yaml").write_text("apiVersion: v1\nkind: Pod\n")
    argv = ["apply", "-f", str(tmp_path / "bad.yaml")]
    rc_ref, _, err_ref = run(ref_main, argv, capsys)
    rc, out, err = run(port_main, argv + ["--device", "cpu"], capsys)
    assert rc == rc_ref == 1 and out == ""
    assert err == err_ref and "expected apiVersion simon/v1alpha1" in err


@pytest.mark.parametrize("flag", [["-i"],
                                  ["--compile-cache-dir", "c"], ["--resume", "last"],
                                  ["--trace-out", "t.json"], ["--ledger-dir", "l"]])
def test_unported_options_name_their_item(flag, capsys):
    rc, _, err = run(port_main, ["apply", "-f", config_path("morepods"), "--device", "cpu"]
                     + flag, capsys)
    assert rc == 1 and "not ported yet (ROADMAP queue 1, item" in err


def test_default_device_is_the_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc, out, err = run(port_main, ["apply", "-f", config_path("morepods")], capsys)
    assert rc == 1 and out == "" and "CUDA is not available" in err


def test_output_file(tmp_path, capsys):
    out_file = tmp_path / "report.txt"
    rc, out, _ = run(port_main, ["apply", "-f", config_path("config"), "--max-new-nodes", "2",
                                 "--device", "cpu", "--output-file", str(out_file)], capsys)
    assert rc == 0 and out == ""
    assert "=== Nodes ===" in out_file.read_text()


def test_chart_apps_and_preemption_name_their_items(tmp_path, capsys):
    """A chart app raises naming the ROADMAP item that ports it. A decoded
    lane that needs the preemption pass (unscheduled pods of differing
    priorities) runs it now, as the reference does: here the low-priority
    pod cannot preempt the high one, and both CLIs print the same
    FAILED report."""
    with pytest.raises(NotImplementedError, match="chart apps.*ROADMAP queue 1, item 15"):
        Applier(ApplyOptions(config_path=os.path.join(EXAMPLES, "chart-config.yaml"),
                             device="cpu")).run()
    for d in ("cluster", "apps"):
        (tmp_path / d).mkdir()
    node = ('apiVersion: v1\nkind: Node\nmetadata: {name: %s}\n'
            'status:\n  allocatable: {cpu: "%s", memory: 4Gi, pods: "10"}\n')
    pod = ('apiVersion: v1\nkind: Pod\nmetadata: {name: %s, namespace: default}\n'
           'spec:\n  priority: %d\n  containers:\n  - name: c\n'
           '    resources: {requests: {cpu: 1500m, memory: 1Gi}}\n')
    (tmp_path / "cluster" / "node.yaml").write_text(node % ("n0", "2"))
    (tmp_path / "cluster" / "high.yaml").write_text(pod % ("high", 100))
    (tmp_path / "apps" / "low.yaml").write_text(pod % ("low", 0))
    (tmp_path / "new.yaml").write_text(node % ("template", "1"))
    (tmp_path / "c.yaml").write_text(
        "apiVersion: simon/v1alpha1\nkind: Config\nmetadata: {name: t}\nspec:\n"
        "  cluster: {customConfig: cluster}\n  appList:\n  - {name: low, path: apps}\n"
        "  newNode: new.yaml\n")
    argv = ["apply", "-f", str(tmp_path / "c.yaml"), "--max-new-nodes", "2"]
    rc_ref, out_ref, _ = run(ref_main, argv, capsys)
    rc, out, err = run(port_main, argv + ["--device", "cpu"], capsys)
    assert (rc, out, err) == (rc_ref, out_ref, "")
    assert rc == 1 and out.startswith("FAILED") and "Insufficient cpu" in out


# ---- --no-waves, and every option the reference declares ------------------


def _subcommands(parser) -> dict:
    """{"apply": parser, "campaign run": parser, ...}: every subcommand,
    nested ones by their full name."""
    import argparse

    out = {}
    for action in parser._actions:
        if isinstance(action, argparse._SubParsersAction):
            for name, sub in action.choices.items():
                out[name] = sub
                out.update({f"{name} {k}": v for k, v in _subcommands(sub).items()})
    return out


def _options(parser) -> set:
    return {s for a in parser._actions for s in a.option_strings}


def test_every_subcommand_declares_the_reference_options():
    """Each subcommand the port declares takes every option of the
    reference's, and no other but ``--device`` (the options the port does
    not run yet are declared and refused with their ROADMAP item)."""
    from open_simulator_tpu.cli.main import build_parser as ref_parser
    from open_simulator_tpu_torch.cli.main import build_parser as port_parser

    ref, got = _subcommands(ref_parser()), _subcommands(port_parser())
    assert {"apply", "explain", "replay", "tune", "campaign", "campaign run",
            "campaign report", "campaign audit"} <= set(got)
    for name, sub in got.items():
        want = _options(ref[name])
        assert want - _options(sub) == set(), name
        assert _options(sub) - want <= {"--device"}, name


@pytest.mark.parametrize("sub", ["apply", "explain"])
def test_no_waves_is_declared_on_apply_and_explain(sub):
    from open_simulator_tpu_torch.cli.main import build_parser

    args = build_parser().parse_args([sub, "-f", config_path("config"), "--no-waves"])
    assert args.no_waves


@pytest.mark.parametrize("name", ["config", "morepods"])
def test_apply_no_waves_equals_reference(name, capsys, monkeypatch):
    """``apply --no-waves`` turns the waves off for the process, as the
    reference's does, and prints the reference's report."""
    from open_simulator_tpu_torch.engine.waves import WAVES_ENV

    monkeypatch.setenv(WAVES_ENV, "1")
    argv = ["apply", "-f", config_path(name), "--max-new-nodes", "16", "--no-waves"]
    rc_ref, out_ref, _ = run(ref_main, argv, capsys)
    monkeypatch.setenv(WAVES_ENV, "1")
    rc, out, err = run(port_main, argv + ["--device", "cpu"], capsys)
    assert os.environ[WAVES_ENV] == "0"
    assert (rc, err) == (rc_ref, "")
    assert out == out_ref and "=== Pods ===" in out


def test_explain_no_waves_equals_reference(capsys, monkeypatch):
    from open_simulator_tpu_torch.engine.waves import WAVES_ENV

    monkeypatch.setenv(WAVES_ENV, "1")
    argv = ["explain", "-f", config_path("config"), "--no-waves", "--json"]
    rc_ref, out_ref, _ = run(ref_main, argv, capsys)
    monkeypatch.setenv(WAVES_ENV, "1")
    rc, out, err = run(port_main, argv + ["--device", "cpu"], capsys)
    assert os.environ[WAVES_ENV] == "0"
    assert (rc, err) == (rc_ref, "") and rc == 0
    assert out == out_ref
