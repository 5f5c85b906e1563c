"""The port stands alone: it imports neither JAX nor the JAX package, needs
no PyYAML to import, runs on the card unless told otherwise, and refuses
every path it has not ported yet, naming the ROADMAP item."""

from __future__ import annotations

import ast
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


@pytest.mark.parametrize("name,gate", [
    ("stateful", "enable_vol_static"),
])
def test_unported_example_configs_raise(name, gate):
    with pytest.raises(NotImplementedError, match=f"{gate}.*ROADMAP"):
        tcore.simulate(*tp.load("torch", name), device="cpu")


def test_rich_synthetic_with_gpu_raises_naming_the_item():
    """The inter-pod gates run; a gate of a later slice still raises."""
    snap = synthetic_snapshot(16, 64, rich=True)
    cfg = tsched.make_config(snap, enable_gpu=True)
    assert cfg.enable_pod_affinity and cfg.enable_anti_affinity and cfg.enable_pref
    with pytest.raises(NotImplementedError, match="enable_gpu.*ROADMAP queue 1, item 3"):
        tsched.schedule_pods(snap.arrays, snap.arrays.active, cfg, device="cpu")


@pytest.mark.parametrize("override", [
    dict(explain_topk=3), dict(tie_break_seed=7), dict(traced_weights=True),
    dict(enable_gpu=True), dict(enable_storage=True), dict(enable_pv_match=True),
    dict(enable_vol_limits=True),
])
def test_every_unported_gate_raises(override):
    snap = synthetic_snapshot(8, 16)
    cfg = tsched.make_config(snap, **override)
    gate = next(iter(override))
    with pytest.raises(NotImplementedError, match=f"EngineConfig.{gate} .*ROADMAP"):
        tsched.schedule_pods(snap.arrays, snap.arrays.active, cfg, device="cpu")


def test_make_config_turns_waves_off():
    assert tsched.make_config(synthetic_snapshot(8, 16)).wave_scheduling is False


def test_differing_priorities_and_new_node_lanes_raise():
    from open_simulator_tpu_torch.encode.snapshot import EncodeOptions
    from open_simulator_tpu_torch.k8s.loader import ClusterResources
    from open_simulator_tpu_torch.k8s.objects import Node, Pod

    def pod(name, prio):
        return Pod.from_dict({"metadata": {"name": name, "namespace": "default"},
                              "spec": {"priority": prio, "containers": [{"name": "c"}]}})

    node = Node.from_dict({"metadata": {"name": "n0"},
                           "status": {"allocatable": {"cpu": "4", "memory": "8Gi", "pods": 10}}})
    cluster = ClusterResources(nodes=[node], pods=[pod("a", 0), pod("b", 1000)])
    with pytest.raises(NotImplementedError, match="preemption.*ROADMAP queue 1, item 4"):
        tcore.simulate(cluster, [], device="cpu")
    # equal priorities: the reference's preemption pass does nothing
    same = ClusterResources(nodes=[node], pods=[pod("a", 1000), pod("b", 1000)])
    assert len(tcore.simulate(same, [], device="cpu").scheduled_pods) == 2
    with pytest.raises(NotImplementedError, match="max_new_nodes.*ROADMAP queue 1, item 5"):
        tcore.simulate(same, [], device="cpu",
                       encode_options=EncodeOptions(max_new_nodes=2, new_node_template=node))


def test_kernel_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.nvcc_path()
    assert build.kernel_names() == ["plain_step"]


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
