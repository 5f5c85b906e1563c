"""The port stands alone: it imports neither JAX nor the JAX package, needs
no PyYAML to import, runs on the card unless told otherwise, and refuses
every path it has not ported yet, naming the ROADMAP item."""

from __future__ import annotations

import ast
import json
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import open_simulator_tpu_torch
import torch_parity as tp
from open_simulator_tpu_torch import core as tcore
from open_simulator_tpu_torch.engine import scheduler as tsched
from open_simulator_tpu_torch.kernels import build
from open_simulator_tpu_torch.testing.synthetic import synthetic_snapshot

PKG_DIR = os.path.dirname(open_simulator_tpu_torch.__file__)
REPO = os.path.dirname(PKG_DIR)
FORBIDDEN = ("jax", "jaxlib", "chex", "open_simulator_tpu")


def _forbidden(name: str) -> bool:
    return name.split(".")[0] in FORBIDDEN


def all_modules():
    return [m.name for m in pkgutil.walk_packages([PKG_DIR], "open_simulator_tpu_torch.")]


def test_importing_every_module_loads_no_jax_and_no_yaml():
    """In a fresh interpreter where `yaml` cannot be imported, every module
    of the package imports, and no JAX / chex / reference module loads."""
    code = (
        "import sys, importlib\n"
        "class NoYaml:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name == 'yaml' or name.startswith('yaml.'):\n"
        "            raise ImportError('yaml blocked')\n"
        "sys.meta_path.insert(0, NoYaml())\n"
        f"for m in {all_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        f"bad = [m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}]\n"
        "assert not bad, bad\n"
        "print('ok', len(sys.modules))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


_BLOCKER = (
    "import sys\n"
    "class Block:\n"
    "    def __init__(self, names):\n"
    "        self.names = names\n"
    "    def find_spec(self, name, path=None, target=None):\n"
    "        if name.split('.')[0] in self.names:\n"
    "            raise ImportError(name + ' blocked')\n")

SLICE_MODULES = ("open_simulator_tpu_torch.parallel.sweep",
                 "open_simulator_tpu_torch.api.v1alpha1",
                 "open_simulator_tpu_torch.report.tables",
                 "open_simulator_tpu_torch.apply.applier",
                 "open_simulator_tpu_torch.cli.main")


def test_capacity_plan_modules_import_with_jax_and_yaml_blocked():
    """The lane slice's modules (sweeps, config schema, report, applier,
    CLI) import in an interpreter where jax, the JAX package and yaml
    cannot be imported."""
    code = (_BLOCKER
            + f"sys.meta_path.insert(0, Block({FORBIDDEN + ('yaml',)!r}))\n"
            + "import importlib\n"
            + f"for m in {SLICE_MODULES!r}:\n"
            + "    importlib.import_module(m)\n"
            + "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert set(SLICE_MODULES) <= set(all_modules())


PREEMPTION_MODULES = ("open_simulator_tpu_torch.engine.preemption",
                      "open_simulator_tpu_torch.simulator",
                      "open_simulator_tpu_torch.testing.builders")


def test_preemption_slice_modules_import_with_jax_blocked():
    """The preemption slice's modules (the planner, the Simulator facade,
    the fixture builders) import, and a Simulator session with a
    preemption runs on the CPU, in an interpreter where jax and the JAX
    package cannot be imported."""
    code = (_BLOCKER
            + f"sys.meta_path.insert(0, Block({FORBIDDEN + ('yaml',)!r}))\n"
            + "import importlib\n"
            + f"for m in {PREEMPTION_MODULES!r}:\n"
            + "    importlib.import_module(m)\n"
            + "from open_simulator_tpu_torch.core import AppResource\n"
            + "from open_simulator_tpu_torch.k8s.loader import ClusterResources\n"
            + "from open_simulator_tpu_torch.k8s.objects import PriorityClass\n"
            + "from open_simulator_tpu_torch.simulator import Simulator\n"
            + "from open_simulator_tpu_torch.testing import make_fake_node, make_fake_pod\n"
            + "c = ClusterResources(nodes=[make_fake_node('n0', cpu='2')])\n"
            + "c.priority_classes = [PriorityClass.from_dict({'metadata': {'name': 'hi'}, "
            + "'value': 10})]\n"
            + "sim = Simulator(c, device='cpu')\n"
            + "sim.run_cluster()\n"
            + "sim.schedule_app(AppResource('lo', ClusterResources(pods=[make_fake_pod('lo', "
            + "cpu='1500m')])))\n"
            + "hi = make_fake_pod('hi', cpu='1500m')\n"
            + "hi.priority_class_name = 'hi'\n"
            + "r = sim.schedule_app(AppResource('hi', ClusterResources(pods=[hi])))\n"
            + "print('ok', r.placements(), sim.cluster_status().preempted_pod_keys)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok {'default/hi': 'n0'} ['default/lo']")
    assert set(PREEMPTION_MODULES) <= set(all_modules())


WAVE_MODULES = ("open_simulator_tpu_torch.engine.waves",
                "open_simulator_tpu_torch.engine.buckets",
                "open_simulator_tpu_torch.kernels.wave")


def test_wave_slice_modules_import_with_jax_blocked():
    """The wave slice's modules (the planner, the bucket helper, the merge
    wrapper) import, and simulate() on a pools cluster plans waves and
    decodes them on the CPU, in an interpreter where jax and the JAX
    package cannot be imported."""
    code = (_BLOCKER
            + f"sys.meta_path.insert(0, Block({FORBIDDEN + ('yaml',)!r}))\n"
            + "import importlib\n"
            + f"for m in {WAVE_MODULES!r}:\n"
            + "    importlib.import_module(m)\n"
            + "from open_simulator_tpu_torch.core import simulate\n"
            + "from open_simulator_tpu_torch.k8s.loader import ClusterResources\n"
            + "from open_simulator_tpu_torch.testing.synthetic import synthetic_objects\n"
            + "nodes, pods, _ = synthetic_objects(8, 32, pools=4)\n"
            + "r = simulate(ClusterResources(nodes=nodes, pods=pods), [], device='cpu')\n"
            + "print('ok', int(r.wave_batched.sum()), int(r.wave_id.max()))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok 32 7")
    assert set(WAVE_MODULES) <= set(all_modules())


def test_apply_cli_runs_with_jax_blocked():
    """``python -m open_simulator_tpu_torch.cli apply`` answers the
    morepods capacity plan on the CPU with jax and the JAX package
    blocked (yaml is allowed: it reads the config)."""
    code = (_BLOCKER
            + f"sys.meta_path.insert(0, Block({FORBIDDEN!r}))\n"
            + "import runpy\n"
            + "sys.argv = ['cli', 'apply', '-f', 'examples/morepods-config.yaml',\n"
            + "            '--max-new-nodes', '16', '--device', 'cpu']\n"
            + "runpy.run_module('open_simulator_tpu_torch.cli', run_name='__main__')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "cluster requires 3 new node(s)" in out.stdout


def test_no_forbidden_import_in_source():
    bad = []
    for root, _dirs, files in os.walk(PKG_DIR):
        for f in files:
            if not f.endswith(".py"):
                continue
            path = os.path.join(root, f)
            tree = ast.parse(Path(path).read_text(encoding="utf-8"), path)
            for node in ast.walk(tree):
                names = []
                if isinstance(node, ast.Import):
                    names = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
                    names = [node.module]
                bad += [(path, n) for n in names if _forbidden(n)]
    assert not bad, bad
    assert len(all_modules()) >= 20


def test_smoke_script_imports_nothing_of_jax():
    tree = ast.parse(Path(REPO, "chip_smoke.py").read_text(encoding="utf-8"))
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
    names += [n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) and n.module]
    assert not [n for n in names if _forbidden(n)]


def test_simulate_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tcore.simulate(*tp.load("torch", "morepods"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tsched.resolve_device(None)
    assert tsched.resolve_device("cpu").type == "cpu"


def test_make_config_turns_waves_off(monkeypatch):
    """make_config sets wave_scheduling from SIMON_WAVES, as the
    reference's does: on by default, off under SIMON_WAVES=0."""
    assert tsched.make_config(synthetic_snapshot(8, 16)).wave_scheduling is True
    monkeypatch.setenv("SIMON_WAVES", "0")
    assert tsched.make_config(synthetic_snapshot(8, 16)).wave_scheduling is False


def _priority_pod(name, prio):
    from open_simulator_tpu_torch.k8s.objects import Pod

    return Pod.from_dict({"metadata": {"name": name, "namespace": "default"},
                          "spec": {"priority": prio, "containers": [{"name": "c"}]}})


def _small_node():
    from open_simulator_tpu_torch.k8s.objects import Node

    return Node.from_dict({"metadata": {"name": "n0"},
                           "status": {"allocatable": {"cpu": "4", "memory": "8Gi", "pods": 10}}})


def test_differing_priorities_run_preemption():
    """Pods of differing priority go through the preemption pass (both
    fit here, so nothing is preempted)."""
    from open_simulator_tpu_torch.k8s.loader import ClusterResources

    cluster = ClusterResources(nodes=[_small_node()],
                               pods=[_priority_pod("a", 0), _priority_pod("b", 1000)])
    res = tcore.simulate(cluster, [], device="cpu")
    assert len(res.scheduled_pods) == 2 and res.preempted_pod_keys == []


def test_differing_priorities_and_new_node_lanes_raise():
    """Equal priorities skip the preemption pass, and new-node template
    slots encode inactive in a plain simulate(); neither raises."""
    from open_simulator_tpu_torch.encode.snapshot import EncodeOptions
    from open_simulator_tpu_torch.k8s.loader import ClusterResources

    node, pod = _small_node(), _priority_pod
    # equal priorities: the reference's preemption pass does nothing
    same = ClusterResources(nodes=[node], pods=[pod("a", 1000), pod("b", 1000)])
    assert len(tcore.simulate(same, [], device="cpu").scheduled_pods) == 2
    # new-node template slots are the capacity plan's lanes (ported): a
    # plain simulate() encodes them inactive and leaves them empty
    res = tcore.simulate(same, [], device="cpu",
                         encode_options=EncodeOptions(max_new_nodes=2, new_node_template=node))
    assert res.snapshot.n_nodes == 3 and res.snapshot.n_real_nodes == 1
    assert [ns.node.name for ns in res.node_status] == ["n0"]
    assert {sp.node_name for sp in res.scheduled_pods} == {"n0"}


def test_kernel_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.nvcc_path()
    assert build.kernel_names() == ["forced_fold", "plain_step", "plain_step_explain",
                                    "plain_step_ext", "plain_step_ext_explain",
                                    "plain_step_wide", "plain_step_wide_explain", "wave_merge"]


def test_log_dom_is_computed_from_counts():
    from open_simulator_tpu_torch.ops.domains import hoist_active_stats

    topo = torch.zeros((1, 4, 2))
    topo[0, :2, 0] = 1
    topo[0, 2:, 1] = 1
    h = hoist_active_stats(topo, torch.ones((2, 4)), torch.ones((1, 4), dtype=torch.bool),
                           torch.tensor([True, True, False, False]))
    assert h.dom_counts.tolist() == [2.0, 1.0]
    # against a float64 log, to f32 rounding; the bit-exact check against
    # the reference's log is in test_torch_ops.py
    assert np.allclose(h.log_dom.numpy(), np.log([4.0, 3.0]), rtol=1e-6)


REPLAY_MODULES = ("open_simulator_tpu_torch.replay",
                  "open_simulator_tpu_torch.replay.engine",
                  "open_simulator_tpu_torch.utils.checkpoint",
                  "open_simulator_tpu_torch.resilience.faults",
                  "open_simulator_tpu_torch.resilience.journal",
                  "open_simulator_tpu_torch.resilience.lifecycle")


def test_replay_slice_modules_import_with_jax_blocked():
    """The replay slice's modules import, and a small replay with the
    autoscaler runs on the CPU through the CLI, in an interpreter where
    jax and the JAX package cannot be imported."""
    code = (_BLOCKER
            + f"sys.meta_path.insert(0, Block({FORBIDDEN!r}))\n"
            + "import importlib, json, os, tempfile\n"
            + f"for m in {REPLAY_MODULES!r}:\n"
            + "    importlib.import_module(m)\n"
            + "from open_simulator_tpu_torch.replay import synthetic_trace_dict\n"
            + "from open_simulator_tpu_torch.cli.main import main\n"
            + "path = os.path.join(tempfile.mkdtemp(), 'trace.json')\n"
            + "json.dump(synthetic_trace_dict(n_batches=2, batch_pods=3, "
            + "chaos_target='worker-a-0', max_new_nodes=2), open(path, 'w'))\n"
            + "sys.exit(main(['replay', '--cluster-config', 'examples/cluster/demo', "
            + "'--trace', path, '--controller', 'autoscaler', '--device', 'cpu']))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "step(s) over" in out.stdout and "baseline" in out.stdout
    assert set(REPLAY_MODULES) <= set(all_modules())


@pytest.mark.parametrize("flag,item", [("--ledger-dir", "item 11"),
                                       ("--trace-out", "item 11"),
                                       ("--compile-cache-dir", "item 8")])
def test_replay_cli_refuses_unported_options(flag, item, tmp_path, capsys):
    from open_simulator_tpu_torch.cli.main import main

    trace = tmp_path / "trace.json"
    trace.write_text('{"events": [{"t": 0, "kind": "kill_node", "target": "worker-a-0"}]}')
    assert main(["replay", "--cluster-config", os.path.join(REPO, "examples", "cluster", "demo"),
                 "--trace", str(trace), "--device", "cpu", flag, str(tmp_path / "x")]) == 1
    err = capsys.readouterr().err
    assert "error:" in err and f"ROADMAP queue 1, {item}" in err


TUNE_MODULES = ("open_simulator_tpu_torch.tune",
                "open_simulator_tpu_torch.tune.search",
                "open_simulator_tpu_torch.replay.frontier",
                "open_simulator_tpu_torch.engine.sched_config")


def test_tune_slice_modules_import_with_jax_and_yaml_blocked():
    """The tuning slice's modules (the search, the frontier, the scheduler
    config parser) import where jax, the JAX package and yaml cannot be
    imported, and a grid search over an inline cluster runs on the CPU
    there."""
    code = (_BLOCKER
            + f"sys.meta_path.insert(0, Block({FORBIDDEN + ('yaml',)!r}))\n"
            + "import importlib\n"
            + f"for m in {TUNE_MODULES!r}:\n"
            + "    importlib.import_module(m)\n"
            + "from open_simulator_tpu_torch.k8s.loader import ClusterResources\n"
            + "from open_simulator_tpu_torch.k8s.objects import Node, Pod\n"
            + "from open_simulator_tpu_torch.tune import TuneOptions, tune_search\n"
            + "nodes = [Node.from_dict({'metadata': {'name': f'n{i}'}, 'status': "
            + "{'allocatable': {'cpu': '8', 'memory': '16Gi', 'pods': 110}}}) for i in range(3)]\n"
            + "pods = [Pod.from_dict({'metadata': {'name': f'p{i}', 'namespace': 'default'}, "
            + "'spec': {'containers': [{'name': 'c', 'resources': {'requests': "
            + "{'cpu': '1', 'memory': '1Gi'}}}]}}) for i in range(4)]\n"
            + "rep = tune_search(ClusterResources(nodes=nodes, pods=pods), [], "
            + "TuneOptions(variants=2, rounds=1), device='cpu')\n"
            + "print('ok', rep['n_variants'], len(rep['pareto']))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok 2")
    assert set(TUNE_MODULES) <= set(all_modules())


CAMPAIGN_MODULES = ("open_simulator_tpu_torch.campaign",
                    "open_simulator_tpu_torch.campaign.audit",
                    "open_simulator_tpu_torch.campaign.fleet",
                    "open_simulator_tpu_torch.campaign.lanes",
                    "open_simulator_tpu_torch.campaign.report",
                    "open_simulator_tpu_torch.campaign.runner",
                    "open_simulator_tpu_torch.engine.exec_cache",
                    "open_simulator_tpu_torch.k8s.cluster_source",
                    "open_simulator_tpu_torch.resilience.retry")


def test_campaign_slice_modules_import_with_jax_and_yaml_blocked():
    """The campaign slice's modules (fleet discovery, the auditor, the
    report, the runner, the fleet lanes and their launch, the cluster
    sources, the retry loop) import where jax, the JAX package and yaml
    cannot be imported, and a campaign over a synthetic fleet of JSON dumps
    (one torn) runs on the CPU there through the CLI, its two same-bucket
    clusters as one fleet launch."""
    code = (_BLOCKER
            + f"sys.meta_path.insert(0, Block({FORBIDDEN + ('yaml',)!r}))\n"
            + "import importlib, json, tempfile\n"
            + f"for m in {CAMPAIGN_MODULES!r}:\n"
            + "    importlib.import_module(m)\n"
            + "from open_simulator_tpu_torch.campaign import write_synthetic_fleet\n"
            + "from open_simulator_tpu_torch.cli.main import main\n"
            + "root = tempfile.mkdtemp()\n"
            + "write_synthetic_fleet(root, n_clusters=4, malformed=1)\n"
            + "sys.exit(main(['campaign', 'run', '--fleet', root, '--json', '--device', "
            + "'cpu']))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    report = json.loads(out.stdout)
    assert report["totals"]["completed"] == 3 and report["totals"]["quarantined"] == 1
    assert report["launches"] == 3 and report["buckets"] == {"2x8": 1, "4x16": 2}
    assert set(CAMPAIGN_MODULES) <= set(all_modules())
