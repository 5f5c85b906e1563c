"""The port's engine equals the JAX package's on the same arrays.

Each case encodes one snapshot with the JAX package, hands its arrays to
the port through ``convert``, and runs the reference's
``schedule_pods(..., waves=None)`` and the port's ``schedule_pods``
(plain torch step, ``device="cpu"``). Node, per-op fail counts, feasible
counts and the final carry (headroom, dom_count, group_count as f32,
ports_used) must be equal. Tolerance: exact.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import torch_parity as tp
from open_simulator_tpu.encode.snapshot import encode_cluster as jax_encode
from open_simulator_tpu.engine import scheduler as jsched
from open_simulator_tpu.k8s.loader import make_valid_node as jax_valid_node
from open_simulator_tpu.k8s.objects import Node as JNode, Pod as JPod
from open_simulator_tpu.testing.synthetic import synthetic_snapshot as jax_synthetic
from open_simulator_tpu_torch import convert
from open_simulator_tpu_torch.encode.snapshot import POD_AXIS_FIRST
from open_simulator_tpu_torch.engine import scheduler as tsched
from open_simulator_tpu_torch.kernels import step as tstep
from open_simulator_tpu_torch.testing.synthetic import soft_spread_cluster


def soft_spread_snapshot(n_nodes, n_pods, hostname):
    nd, pd = soft_spread_cluster(n_nodes, n_pods, hostname=hostname)
    return jax_encode([jax_valid_node(JNode.from_dict(x)) for x in nd],
                      [JPod.from_dict(x) for x in pd])


SNAPSHOTS = {
    "synthetic-64x512-bound0.3": lambda: jax_synthetic(64, 512, rich=False, bound=0.3),
    "morepods": lambda: tp.encode("jax", "morepods"),
    "controlplane": lambda: tp.encode("jax", "controlplane"),
    "soft-spread-hostname": lambda: soft_spread_snapshot(64, 384, hostname=True),
    "soft-spread-zone-region": lambda: soft_spread_snapshot(64, 384, hostname=False),
}


def check(snap, **overrides):
    jcfg, outs_j, st_j = tp.run_jax(snap, **overrides)
    outs_t, st_t = tp.run_torch(tp.fields(snap.arrays), snap.arrays.active,
                                tp.torch_cfg(jcfg))
    tp.assert_same(outs_j, st_j, outs_t, st_t)
    return jcfg, outs_j


@pytest.mark.parametrize("fail_reasons", [True, False])
@pytest.mark.parametrize("name", sorted(SNAPSHOTS))
def test_engine_equals_reference(name, fail_reasons):
    jcfg, outs = check(SNAPSHOTS[name](), fail_reasons=fail_reasons)
    assert jcfg.enable_spread_soft
    if fail_reasons and name.startswith("soft-spread"):
        assert (outs["fail_counts"].sum(axis=1) > 0).any()


def test_engine_paths_covered():
    """The cases above reach both spread carries, the bf16 group_count,
    the forced prefix and unschedulable pods."""
    cfgs = {n: jsched.make_config(f()) for n, f in SNAPSHOTS.items()}
    assert cfgs["synthetic-64x512-bound0.3"].maintain_dom_count
    assert cfgs["soft-spread-zone-region"].maintain_dom_count
    assert cfgs["morepods"].needs_group_count and cfgs["morepods"].compact_carry
    assert cfgs["controlplane"].forced_prefix == 12
    hn = cfgs["soft-spread-hostname"]
    assert hn.needs_group_count and hn.enable_ports and hn.enable_unsched
    assert hn.enable_taint_score and hn.enable_node_aff_score


@pytest.mark.parametrize("overrides", [
    dict(compact_carry=False),
    dict(w_most=1.0, w_balanced=0.5, w_spread=3.0),
    dict(w_simon=0.0, w_node_aff=0.0),
])
def test_engine_weights_and_f32_carry(overrides):
    check(SNAPSHOTS["soft-spread-hostname"](), **overrides)


def _slice_pods(arrs, lo, hi):
    return {k: (v[lo:hi] if k in POD_AXIS_FIRST else v) for k, v in arrs.items()}


@pytest.mark.parametrize("name", ["synthetic-64x512-bound0.3", "soft-spread-hostname"])
def test_state_carried_across_from_reference(name):
    """The reference schedules the first half; its carry crosses through
    convert.state_from_numpy and the port schedules the rest: the second
    half and the final carry equal the reference's full run."""
    snap = SNAPSHOTS[name]()
    jcfg, outs_full, st_full = tp.run_jax(snap)
    half = snap.n_pods // 2
    arrs_j = jsched.slice_pods(jsched.device_arrays(snap), 0, half)
    out_first = jsched.schedule_pods(arrs_j, snap.arrays.active, jcfg, waves=None)
    state = convert.state_from_numpy(tp.jax_state(out_first.state))
    assert state.group_count.dtype == (torch.bfloat16 if jcfg.compact_carry else torch.float32)
    outs_t, st_t = tp.run_torch(_slice_pods(tp.fields(snap.arrays), half, snap.n_pods),
                                snap.arrays.active, tp.torch_cfg(jcfg), state=state)
    second = {k: v[half:] for k, v in outs_full.items()}
    tp.assert_same(second, st_full, outs_t, st_t)


def test_state_round_trip_keeps_bf16_bits():
    snap = SNAPSHOTS["soft-spread-hostname"]()
    _, _, st_j = tp.run_jax(snap)
    back = convert.state_to_numpy(convert.state_from_numpy(st_j))
    for k, v in st_j.items():
        assert back[k].dtype == v.dtype, k
        assert back[k].tobytes() == v.tobytes(), k


def test_lanes_equal_single_lane_runs():
    """A lane-batched plain step equals one single-lane run per active mask."""
    snap = SNAPSHOTS["soft-spread-hostname"]()
    cfg = tp.torch_cfg(jsched.make_config(snap))
    arrs = tsched.device_arrays(snap.arrays, "cpu")
    n = snap.n_nodes
    masks = np.stack([np.ones(n, bool), np.arange(n) % 3 != 0])
    active = torch.from_numpy(masks)
    hoist = tsched.hoist_of(arrs, active)
    base = tsched.apply_forced_prefix(arrs, cfg, tsched.init_state(arrs, cfg), cfg.forced_prefix)
    lanes = tsched.SimState(**{f: torch.stack([getattr(base, f)] * 2)
                               for f in tsched.STATE_FIELDS})
    node, fail, feas, *_ = tstep.plain_step(arrs, active, hoist,
                                              tsched.inv_alloc_of(arrs.alloc), lanes, cfg,
                                              cfg.forced_prefix, snap.n_pods)
    for s in range(2):
        out = tsched.schedule_pods(snap.arrays, masks[s], cfg, device="cpu")
        k = cfg.forced_prefix
        np.testing.assert_array_equal(node[s].numpy(), out.node[k:].numpy())
        np.testing.assert_array_equal(fail[s].numpy(), out.fail_counts[k:].numpy())
        np.testing.assert_array_equal(feas[s].numpy(), out.feasible[k:].numpy())
        assert torch.equal(lanes.headroom[s], out.state.headroom)
        assert torch.equal(lanes.group_count[s], out.state.group_count)
    assert not np.array_equal(node[0].numpy(), node[1].numpy())
