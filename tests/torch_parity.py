"""Shared helpers for the tests that hold open_simulator_tpu_torch against
the JAX package: load an example config through each package's own loader,
encode it as simulate() does, and run both engines on the same arrays."""

from __future__ import annotations

import copy
import dataclasses
import os

import jax.numpy as jnp
import numpy as np

from open_simulator_tpu import core as jcore
from open_simulator_tpu.encode import snapshot as jsnapshot
from open_simulator_tpu.engine import scheduler as jsched
from open_simulator_tpu.k8s import loader as jloader
from open_simulator_tpu_torch import convert
from open_simulator_tpu_torch import core as tcore
from open_simulator_tpu_torch.encode import snapshot as tsnapshot
from open_simulator_tpu_torch.engine import scheduler as tsched
from open_simulator_tpu_torch.k8s import loader as tloader

EXAMPLES = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "examples")

# example config -> (cluster dir, [(app name, app dir)]), as in its YAML
CONFIGS = {
    "morepods": ("cluster/demo", [("more-pods", "apps/more-pods")]),
    "controlplane": ("cluster/control-plane", [("payments", "apps/payments")]),
    "stateful": ("cluster/stateful", [("stateful", "apps/stateful")]),
    "config": ("cluster/demo", [("webstack", "apps/webstack")]),
    "constraints": ("cluster/demo", [("constraints", "apps/constraints")]),
    "gpushare": ("cluster/gpushare", [("training", "apps/training")]),
    "openlocal": ("cluster/open-local", [("db", "apps/open-local")]),
}

PKGS = {"jax": (jloader, jcore, jsnapshot), "torch": (tloader, tcore, tsnapshot)}


def load(pkg: str, name: str):
    """(cluster, apps) of an example config through `pkg`'s own loader."""
    loader, core, _ = PKGS[pkg]
    cdir, app_dirs = CONFIGS[name]
    cluster = loader.load_resources_from_directory(os.path.join(EXAMPLES, cdir))
    apps = [core.AppResource(an, loader.load_resources_from_directory(os.path.join(EXAMPLES, ad)))
            for an, ad in app_dirs]
    return cluster, apps


def encode(pkg: str, name: str):
    """The snapshot simulate() would schedule for an example config."""
    loader, core, snapshot = PKGS[pkg]
    cluster, apps = load(pkg, name)
    nodes = [loader.make_valid_node(n) for n in cluster.nodes]
    cluster = copy.copy(cluster)
    cluster.nodes = nodes
    pods = core.build_pod_sequence(cluster, apps)
    return snapshot.encode_cluster(nodes, pods, core.with_volume_objects(None, cluster, apps))


def fields(arrs) -> dict:
    return {f.name: np.asarray(getattr(arrs, f.name)) for f in dataclasses.fields(arrs)}


def port_snapshot(snap) -> tsnapshot.ClusterSnapshot:
    """A reference ClusterSnapshot as the port's: the same arrays through
    convert, the same names and vocabularies (the objects stay the
    reference's; the engine reads only the arrays and the counts)."""
    kw = {f.name: getattr(snap, f.name) for f in dataclasses.fields(tsnapshot.ClusterSnapshot)}
    kw["arrays"] = convert.snapshot_arrays_from_numpy(fields(snap.arrays))
    return tsnapshot.ClusterSnapshot(**kw)


def jax_state(state) -> dict:
    return {k: np.asarray(v) for k, v in state._asdict().items()}


def run_jax(snap, state=None, active=None, disabled=None, nominated=None, **overrides):
    """Reference schedule_pods(..., waves=None) -> (cfg, numpy outputs,
    state), on `active` (default: the snapshot's) with the preemption
    columns if given."""
    cfg = jsched.make_config(snap, **overrides)
    cols = {k: None if v is None else jnp.asarray(v)
            for k, v in (("disabled", disabled), ("nominated", nominated))}
    out = jsched.schedule_pods(jsched.device_arrays(snap),
                               jnp.asarray(snap.arrays.active if active is None else active),
                               cfg, state=state, waves=None, **cols)
    outs = {k: np.asarray(getattr(out, k)) for k in OUTPUTS}
    return cfg, outs, jax_state(out.state)


def torch_cfg(jcfg) -> tsched.EngineConfig:
    return tsched.EngineConfig(**{**jcfg._asdict(), "wave_scheduling": False})


def run_torch(arrs_fields: dict, active, cfg, state=None, disabled=None, nominated=None):
    """Port schedule_pods on the CPU -> (numpy outputs, numpy state)."""
    arrs = convert.snapshot_arrays_from_numpy(arrs_fields)
    out = tsched.schedule_pods(arrs, active, cfg, state=state, device="cpu",
                               disabled=disabled, nominated=nominated)
    outs = {k: getattr(out, k).numpy() for k in OUTPUTS}
    return outs, convert.state_to_numpy(out.state)


OUTPUTS = ("node", "fail_counts", "feasible", "gpu_pick", "vol_pick")
CARRY = tsched.STATE_FIELDS


def assert_same(outs_j, st_j, outs_t, st_t):
    for k in OUTPUTS:
        assert outs_j[k].dtype == outs_t[k].dtype, k
        np.testing.assert_array_equal(outs_j[k], outs_t[k], err_msg=k)
    for k in CARRY:
        assert st_j[k].dtype == st_t[k].dtype, k
        np.testing.assert_array_equal(st_j[k].astype(np.float32),
                                      st_t[k].astype(np.float32), err_msg=k)
