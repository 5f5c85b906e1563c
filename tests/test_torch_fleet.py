"""The port's fleet launch equals the JAX package's, and the plain step
holds the reference at the widths past the kernel's per-thread walks.

``engine/exec_cache.run_fleet_batched`` of the port (the plain torch step,
lane by lane, on the CPU) against the reference's ``run_fleet_batched``
(``schedule_pods`` vmapped over per-lane ``SnapshotArrays``) on three
stacked clusters of one shape whose forced binds land on different nodes
(``testing.fleet_variants``), each with its own active mask: node, fail
counts, feasible counts, GPU and PV picks, the top-k tensors under
explain and the final carry of every lane must be equal, and each lane
must equal the port's own lone ``schedule_pods`` of its cluster bit for
bit. The device-resource fleet is widened to 9 volume groups, 33
exclusive devices and 9 WaitForFirstConsumer claims a pod
(``testing.widen_device_resources``): past the kernel's per-thread walk
widths, the plain step holds the reference there too. (Under explain, the
device-resource rows of the top-k parts differ from the reference's by the
FMAs its XLA CPU backend contracts, ROADMAP's known differences held in
``tests/test_torch_explain.py``; the explain case here is the rich
cluster's.) The padding to the reference's bucket shape and the stacking
equal the reference's field for field. Tolerance: exact.
"""

from __future__ import annotations

import copy
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity as tp
from open_simulator_tpu.engine import exec_cache as jcache
from open_simulator_tpu.engine import scheduler as jsched
from open_simulator_tpu.testing.synthetic import synthetic_snapshot as jax_synthetic
from open_simulator_tpu_torch import convert
from open_simulator_tpu_torch.engine import buckets
from open_simulator_tpu_torch.engine import exec_cache as tcache
from open_simulator_tpu_torch.engine import scheduler as tsched
from open_simulator_tpu_torch.testing.synthetic import (
    device_resource_manifests,
    fleet_variants,
    widen_device_resources,
)

OUTPUTS = ("node", "fail_counts", "feasible", "gpu_pick", "vol_pick", "topk_node",
           "topk_score", "topk_parts")


def _devres_snapshot(n_nodes: int, n_pods: int, rich: bool = False):
    """The device-resource manifests through the reference's loader and
    encoder, as simulate() encodes a cluster."""
    loader, core, snapshot = tp.PKGS["jax"]
    cluster = loader.ClusterResources()
    for doc in copy.deepcopy(device_resource_manifests(n_nodes, n_pods, 0, rich)):
        loader.demux_object(doc, cluster)
    cluster.nodes = [loader.make_valid_node(n) for n in cluster.nodes]
    pods = core.build_pod_sequence(cluster, [])
    return snapshot.encode_cluster(cluster.nodes, pods,
                                   core.with_volume_objects(None, cluster, []))


def _wide_devres_snapshot():
    """The device-resource cluster widened past the kernel's per-thread
    walk widths (9 volume groups, 33 devices, 9 WFC claims a pod)."""
    snap = _devres_snapshot(16, 56)
    return dataclasses.replace(snap, arrays=widen_device_resources(snap.arrays, seed=2))


CASES = {
    "rich-explain": (lambda: jax_synthetic(16, 48, rich=True, bound=0.2),
                     dict(explain_topk=3, tie_break_seed=4)),
    "devres-wide": (_wide_devres_snapshot, {}),
}


def _lanes(case):
    make, over = CASES[case]
    snap = make()
    jcfg = jsched.make_config(snap, **over)
    lanes = fleet_variants(snap.arrays, 3, seed=11)
    n, p = snap.arrays.alloc.shape[0], snap.arrays.req.shape[0]
    bn, bp = buckets.bucket_shape(n, p)
    rng = np.random.RandomState(5)
    masks = np.stack([np.asarray(a.active) & (rng.rand(n) < 0.85) for a in lanes])
    masks = np.concatenate([masks, np.zeros((3, bn - n), bool)], axis=1)
    return snap, jcfg, lanes, masks, (bn, bp)


@pytest.mark.parametrize("case", sorted(CASES))
def test_run_fleet_batched_equals_reference(case):
    """Three stacked clusters with different forced prefixes: every lane's
    outputs and final carry equal the reference's fleet launch, bit for
    bit."""
    snap, jcfg, lanes, masks, (bn, bp) = _lanes(case)
    assert jcfg.forced_prefix > 0
    prefixes = {tuple(np.asarray(a.forced_node)[:jcfg.forced_prefix]) for a in lanes}
    assert len(prefixes) == 3
    j_batch = jcache.stack_fleet_arrays([jcache.pad_snapshot_arrays(a, bn, bp) for a in lanes])
    j_out = jcache.run_fleet_batched(j_batch, jnp.asarray(masks), jcfg)
    t_lanes = [tcache.pad_snapshot_arrays(convert.snapshot_arrays_from_numpy(tp.fields(a)), bn, bp)
               for a in lanes]
    t_out = tcache.run_fleet_batched(tcache.stack_fleet_arrays(t_lanes), masks,
                                     tp.torch_cfg(jcfg), device="cpu")
    for name in OUTPUTS:
        ref = np.asarray(getattr(j_out, name))
        got = getattr(t_out, name).numpy()
        assert ref.dtype == got.dtype and ref.shape == got.shape, name
        np.testing.assert_array_equal(ref, got, err_msg=name)
    tcfg = tp.torch_cfg(jcfg)
    for s, arrs in enumerate(t_lanes):
        lone = tsched.schedule_pods(arrs, masks[s], tcfg, device="cpu")
        for name in OUTPUTS:
            assert torch.equal(getattr(lone, name), getattr(t_out, name)[s]), name
        for f in tp.CARRY:
            assert torch.equal(getattr(lone.state, f), getattr(t_out.state, f)[s]), f
    st_j = tp.jax_state(j_out.state)
    st_t = convert.state_to_numpy(t_out.state)
    for f in tp.CARRY:
        np.testing.assert_array_equal(st_j[f].astype(np.float32), st_t[f].astype(np.float32),
                                      err_msg=f)
    placed = np.asarray(j_out.node)
    assert len({tuple(row) for row in placed}) == 3 and (placed >= 0).any()
    if case == "devres-wide":
        # the walks past the widths refuse and bind: the storage row, the
        # PV match, the devices taken and the volume groups debited
        r = snap.arrays.alloc.shape[1]
        fails = np.asarray(j_out.fail_counts)
        assert fails[..., 8 + r].sum() > 0 and fails[..., 11 + r].sum() > 0
        assert st_j["sdev_taken"].any() and st_j["vg_used"].any()


def test_padding_and_stacking_equal_reference():
    snap = jax_synthetic(20, 70, rich=True, bound=0.2)
    bn, bp = buckets.bucket_shape(20, 70)
    assert (bn, bp) == jcache.bucket_shape(20, 70)
    ref = jcache.pad_snapshot_arrays(snap.arrays, bn, bp)
    got = tcache.pad_snapshot_arrays(convert.snapshot_arrays_from_numpy(tp.fields(snap.arrays)),
                                     bn, bp)
    for name, x in tp.fields(ref).items():
        y = np.asarray(getattr(got, name))
        assert x.dtype == y.dtype and x.shape == y.shape, name
        np.testing.assert_array_equal(x, y, err_msg=name)
    assert tcache._shape_sig(got) == tuple((n, s, str(d)) for n, s, d in
                                           ((f, tuple(np.shape(v)), np.asarray(v).dtype)
                                            for f, v in tp.fields(ref).items()))
    other = tcache.pad_snapshot_arrays(got, bn, bp + 1)
    with pytest.raises(ValueError, match="shape-identical"):
        tcache.stack_fleet_arrays([got, other])


def test_fleet_launch_refuses_masks_of_another_width():
    snap, jcfg, lanes, masks, (bn, bp) = _lanes("devres-wide")
    t_lanes = [tcache.pad_snapshot_arrays(convert.snapshot_arrays_from_numpy(tp.fields(a)), bn, bp)
               for a in lanes]
    with pytest.raises(ValueError, match="masks must be"):
        tcache.run_fleet_batched(tcache.stack_fleet_arrays(t_lanes), masks[:, :-1],
                                 tp.torch_cfg(jcfg), device="cpu")
