"""The port's lane launch equals the JAX package's lanes.

``schedule_lanes`` (one launch for S active masks, every lane started from
one template carry by the lane prologue) against the reference's
``parallel/sweep.batched_schedule`` (vmapped lanes, each reset to a fresh
carry by ``_fresh_lane_state`` and folding the forced prefix itself), on
the same arrays: node, fail counts, feasible counts and every carry field
of every lane must be equal (``np.array_equal``; bf16 carries compared by
their bits). The port's one-lane runs are held to the reference's
``schedule_pods``. The port runs its plain torch step on the CPU.
Tolerance: exact.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity as tp
from open_simulator_tpu.encode.snapshot import encode_cluster as jax_encode
from open_simulator_tpu.engine import exec_cache as jexec
from open_simulator_tpu.engine import scheduler as jsched
from open_simulator_tpu.k8s.loader import make_valid_node as jax_valid_node
from open_simulator_tpu.k8s.objects import Node as JNode, Pod as JPod
from open_simulator_tpu.parallel import sweep as jsweep
from open_simulator_tpu.testing.synthetic import synthetic_snapshot as jax_synthetic
from open_simulator_tpu_torch import convert
from open_simulator_tpu_torch.engine import scheduler as tsched
from open_simulator_tpu_torch.kernels import step as tstep
from open_simulator_tpu_torch.testing.synthetic import soft_spread_cluster


def soft_spread_prefix():
    """The soft-spread cluster: a leading nodeName run, so the lanes'
    template holds a folded prefix."""
    nd, pd = soft_spread_cluster(48, 192, hostname=True)
    return jax_encode([jax_valid_node(JNode.from_dict(x)) for x in nd],
                      [JPod.from_dict(x) for x in pd])


SNAPSHOTS = {
    "synthetic-64x256-new8": lambda: jax_synthetic(64, 256, max_new=8),
    "rich-64x256-new8": lambda: jax_synthetic(64, 256, max_new=8, rich=True),
    "soft-spread-prefix": soft_spread_prefix,
}


def lane_masks(snap) -> np.ndarray:
    """Five lanes: new-node counts 0, 3, max and max again (a bisection
    round repeats its last probe), and a random subset of the real nodes
    plus every new slot."""
    n, n_real = snap.n_nodes, snap.n_real_nodes
    rng = np.random.RandomState(5)
    if n > n_real:
        counts = [0, 3, n - n_real, n - n_real]
        masks = list(jsweep.active_masks_for_counts(snap, counts))
    else:
        masks = [np.ones(n, bool), np.arange(n) % 3 != 1, np.arange(n) >= n // 4,
                 np.arange(n) >= n // 4]
    masks.append(np.concatenate([rng.rand(n_real) < 0.7, np.ones(n - n_real, bool)]))
    return np.stack(masks)


def reference_lanes(snap, masks, **overrides):
    jcfg = jsched.make_config(snap, **overrides)
    out = jsweep.batched_schedule(jsched.device_arrays(snap), jnp.asarray(masks), jcfg)
    outs = {k: np.asarray(getattr(out, k)) for k in ("node", "fail_counts", "feasible")}
    return jcfg, outs, tp.jax_state(out.state)


def assert_lanes_equal(outs_j, st_j, out_t):
    for k in ("node", "fail_counts", "feasible"):
        got = getattr(out_t, k).numpy()
        assert got.dtype == outs_j[k].dtype, k
        assert np.array_equal(got, outs_j[k]), k
    st_t = convert.state_to_numpy(out_t.state)
    assert set(st_t) == set(st_j)
    for f, ref in st_j.items():
        assert st_t[f].dtype == ref.dtype, f
        assert st_t[f].shape == ref.shape, f
        assert st_t[f].tobytes() == ref.tobytes(), f


@pytest.mark.parametrize("fail_reasons", [True, False])
@pytest.mark.parametrize("name", sorted(SNAPSHOTS))
def test_lanes_equal_reference_lanes(name, fail_reasons):
    snap = SNAPSHOTS[name]()
    masks = lane_masks(snap)
    jcfg, outs_j, st_j = reference_lanes(snap, masks, fail_reasons=fail_reasons)
    out_t = tsched.schedule_lanes(convert.snapshot_arrays_from_numpy(tp.fields(snap.arrays)),
                                  masks, tp.torch_cfg(jcfg), device="cpu")
    assert_lanes_equal(outs_j, st_j, out_t)
    assert len({tuple(r) for r in outs_j["node"].tolist()}) >= 3
    if name == "soft-spread-prefix":
        assert jcfg.forced_prefix > 0
    if not fail_reasons:
        # no [S, P, OPS] buffer: a zero-stride view of one int32
        assert out_t.fail_counts.stride() == (0, 0, 0)
        assert out_t.fail_counts.untyped_storage().nbytes() == 4


def test_single_lanes_equal_reference_schedule_pods():
    """The port at one lane (``schedule_pods``) and each lane of the port's
    batch equal the reference's single run on that mask."""
    snap = SNAPSHOTS["rich-64x256-new8"]()
    masks = lane_masks(snap)
    jcfg = jsched.make_config(snap)
    cfg = tp.torch_cfg(jcfg)
    arrs = convert.snapshot_arrays_from_numpy(tp.fields(snap.arrays))
    lanes = tsched.schedule_lanes(arrs, masks, cfg, device="cpu")
    for s in (0, 1, 4):
        out = jsched.schedule_pods(jsched.device_arrays(snap), jnp.asarray(masks[s]), jcfg,
                                   waves=None)
        ref = {k: np.asarray(getattr(out, k)) for k in ("node", "fail_counts", "feasible")}
        single = tsched.schedule_pods(arrs, masks[s], cfg, device="cpu")
        for k, v in ref.items():
            assert np.array_equal(getattr(single, k).numpy(), v), k
            assert np.array_equal(getattr(lanes, k)[s].numpy(), v), k
        st_ref = tp.jax_state(out.state)
        st_single = convert.state_to_numpy(single.state)
        for f in tp.CARRY:
            assert st_single[f].tobytes() == st_ref[f].tobytes(), f


@pytest.mark.parametrize("name", ["rich-64x256-new8", "soft-spread-prefix"])
def test_lane_prologue_equals_fresh_lane_state_and_prefix(name):
    """Each lane's carry after the prologue (no pod stepped) equals the
    reference's ``_fresh_lane_state`` of a used carry with the forced
    prefix folded in; the carry buffer passed in is the one written."""
    snap = SNAPSHOTS[name]()
    masks = lane_masks(snap)
    jcfg = jsched.make_config(snap)
    jarrs = jsched.device_arrays(snap)
    used = jsweep.batched_schedule(jarrs, jnp.asarray(masks), jcfg).state
    k = jcfg.forced_prefix
    ref = []
    for s in range(masks.shape[0]):
        row = type(used)(*(x[s] for x in used))
        fresh = jexec._fresh_lane_state(row, jarrs)
        ref.append(tp.jax_state(jsched.apply_forced_prefix(jarrs, jcfg, fresh, k) if k
                                else fresh))

    cfg = tp.torch_cfg(jcfg)
    arrs = tsched.device_arrays(convert.snapshot_arrays_from_numpy(tp.fields(snap.arrays)),
                                "cpu")
    template = tsched.init_state(arrs, cfg)
    if cfg.forced_prefix:
        template = tsched.apply_forced_prefix(arrs, cfg, template, cfg.forced_prefix)
    garbage = convert.state_from_numpy(tp.jax_state(used))
    active = torch.from_numpy(masks)
    n_pods = snap.n_pods
    node = tstep.plain_step(arrs, active, tsched.hoist_of(arrs, active),
                            tsched.inv_alloc_of(arrs.alloc), garbage, cfg, n_pods,
                            n_pods, template=template)[0]
    assert node.shape == (masks.shape[0], 0)
    got = convert.state_to_numpy(garbage)
    for s, st in enumerate(ref):
        for f, v in st.items():
            assert got[f][s].dtype == v.dtype, f
            assert got[f][s].tobytes() == v.tobytes(), (s, f)


def test_carry_is_reused_across_launches():
    """A second launch handed the first launch's state writes into the same
    buffers and gives the same answer as a launch from a new buffer; a
    carry of the wrong shape is refused."""
    snap = SNAPSHOTS["soft-spread-prefix"]()
    cfg = tp.torch_cfg(jsched.make_config(snap, fail_reasons=False))
    arrs = convert.snapshot_arrays_from_numpy(tp.fields(snap.arrays))
    masks = lane_masks(snap)
    first = tsched.schedule_lanes(arrs, masks[::-1].copy(), cfg, device="cpu")
    ptrs = {f: getattr(first.state, f).data_ptr() for f in tsched.STATE_FIELDS}
    again = tsched.schedule_lanes(arrs, masks, cfg, device="cpu", carry=first.state)
    fresh = tsched.schedule_lanes(arrs, masks, cfg, device="cpu")
    assert {f: getattr(again.state, f).data_ptr() for f in tsched.STATE_FIELDS} == ptrs
    assert torch.equal(again.node, fresh.node)
    for f in tsched.STATE_FIELDS:
        assert torch.equal(getattr(again.state, f), getattr(fresh.state, f)), f
    with pytest.raises(ValueError, match="carry.headroom"):
        tsched.schedule_lanes(arrs, masks[:2], cfg, device="cpu", carry=fresh.state)
