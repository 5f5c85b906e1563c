"""The port's checkpoint and resume, the pinned-consumption hoist and its
fold equal the JAX package's.

``apply_forced_mask`` (the ``forced_fold`` kernel's plain version on the
CPU) against the reference's on a plain, a rich (bf16 carry, the term
and preference paints, ``slot_paint``) and a device-resource snapshot
(attach limits; the masked pods hold no GPU, storage or WFC pick), each
tiled past one 4,096-pod chunk, with a random mask over sentinel, pinned
and free pods. ``schedule_pods(hoist_forced=True)`` on a forced column
mixing -4 sentinels, pins and free pods through the whole pod axis, with
no state, a fresh state and a resumed one; ``slice_pods`` and the split
scan; the cases of ``tests/test_checkpoint.py`` through the port; and
checkpoints written by either package loaded by the other. Tolerance:
exact (carries by their bits).
"""

from __future__ import annotations

import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity as tp
from open_simulator_tpu.encode import snapshot as jsnapshot
from open_simulator_tpu.engine import exec_cache as jexec
from open_simulator_tpu.engine import scheduler as jsched
from open_simulator_tpu.testing.synthetic import synthetic_snapshot as jsynthetic
from open_simulator_tpu.utils import checkpoint as jckpt
from open_simulator_tpu_torch import convert
from open_simulator_tpu_torch.engine import scheduler as tsched
from open_simulator_tpu_torch.testing.synthetic import (
    device_resource_snapshot,
    synthetic_snapshot,
)
from open_simulator_tpu_torch.utils import checkpoint as tckpt

CHUNK = tsched._PREFIX_CHUNK
PREFIX = 40


def _jarrs(fields):
    return jsnapshot.SnapshotArrays(**{k: jnp.asarray(v) for k, v in fields.items()})


def _jcfg(cfg):
    return jsched.EngineConfig(**cfg._asdict())


def _tstate(st_np):
    return convert.state_from_numpy(st_np)


def _assert_states(a: dict, b: dict):
    for k in tsched.STATE_FIELDS:
        assert a[k].dtype == b[k].dtype, k
        assert a[k].shape == b[k].shape, k
        np.testing.assert_array_equal(a[k].astype(np.float32), b[k].astype(np.float32),
                                      err_msg=k)


def _tiled(snap, n_pods: int):
    """The snapshot's pod axis repeated to `n_pods` rows (the node axis as
    it is): a universe wider than one fold chunk without encoding one."""
    fields = tp.fields(snap.arrays)
    reps = -(-n_pods // snap.n_pods)
    for name in tsched.POD_FIELDS:
        a = fields[name]
        fields[name] = np.ascontiguousarray(np.concatenate([a] * reps)[:n_pods])
    return fields


FOLD_CASES = {
    "plain": lambda: synthetic_snapshot(24, 64),
    "rich": lambda: synthetic_snapshot(24, 64, rich=True),
    "devres": lambda: device_resource_snapshot(24, 96),
}


@pytest.fixture(scope="module", params=sorted(FOLD_CASES))
def fold_case(request):
    snap = FOLD_CASES[request.param]()
    n_pods = CHUNK + 300
    fields = _tiled(snap, n_pods)
    rng = np.random.default_rng(7)
    n = snap.n_nodes
    kind = rng.integers(0, 3, n_pods)                # sentinel / free / pinned
    forced = np.where(kind == 0, -4, np.where(kind == 1, -1, rng.integers(0, n, n_pods)))
    forced[:PREFIX] = rng.integers(0, n, PREFIX)   # a prefix fold's pods are all forced
    fields["forced_node"] = forced.astype(fields["forced_node"].dtype)
    a = fields
    # the fold's callers never mask an order-dependent GPU, storage, WFC or
    # shared-volume pod
    plain = ~((a["gpu_cnt"] > 0) | np.any(a["lvm_req"] > 0, axis=1)
              | np.any(a["sdev_req"] > 0, axis=1) | np.any(a["wfc_valid"], axis=1)
              | np.any(a["svol_id"] >= 0, axis=1))
    cfg = tsched.make_config(snap)  # the tiled pods are the snapshot's
    return request.param, fields, cfg, plain, rng


def test_apply_forced_mask_equals_the_reference(fold_case):
    """A random mask over sentinel, free and pinned pods (a masked pod with
    no forced node folds at node 0, as the reference's clamped one-hot),
    across two chunks, from a carry that already holds counts."""
    name, fields, cfg, plain, rng = fold_case
    if name == "plain":
        assert cfg.maintain_dom_count
    if name == "rich":
        assert cfg.compact_carry and cfg.slot_paint and cfg.enable_pref
        assert cfg.enable_anti_affinity and cfg.enable_ports
    if name == "devres":
        assert cfg.enable_vol_limits
    mask = (rng.random(len(plain)) < 0.5) & plain
    jarrs = _jarrs(fields)
    jcfg = _jcfg(cfg)
    base_j = jsched.apply_forced_prefix(jarrs, jcfg, jsched.init_state(jarrs, jcfg), PREFIX)
    want = tp.jax_state(jsched.apply_forced_mask(jarrs, jcfg, base_j, jnp.asarray(mask)))
    tarrs = tsched.device_arrays(convert.snapshot_arrays_from_numpy(fields), "cpu")
    base_t = tsched.apply_forced_prefix(tarrs, cfg, tsched.init_state(tarrs, cfg), PREFIX)
    got = tsched.apply_forced_mask(tarrs, cfg, base_t, torch.from_numpy(mask))
    _assert_states(want, convert.state_to_numpy(got))
    # the fold works on a copy
    _assert_states(tp.jax_state(base_j), convert.state_to_numpy(base_t))


@pytest.mark.parametrize("case", ["plain", "rich", "devres"])
def test_hoisted_scan_equals_the_reference(case):
    """schedule_pods(hoist_forced=True) on a forced column with sentinels,
    pins and free pods everywhere in pod order; with no state and with a
    fresh state passed in (which hoists like None), and a resumed state
    (no hoist). The passed state is left as it was."""
    snap = FOLD_CASES[case]()
    fields = tp.fields(snap.arrays)
    rng = np.random.default_rng(3)
    p, n = snap.n_pods, snap.n_nodes
    kind = rng.integers(0, 3, p)
    pinned = rng.integers(0, n, p)
    if case == "devres":  # the replay gate: no order-dependent pod is pinned
        a = fields
        dep = ((a["gpu_cnt"] > 0) | np.any(a["lvm_req"] > 0, axis=1)
               | np.any(a["sdev_req"] > 0, axis=1) | np.any(a["wfc_valid"], axis=1)
               | np.any(a["svol_id"] >= 0, axis=1))
        kind = np.where(dep & (kind == 2), 1, kind)
    fields["forced_node"] = np.where(kind == 0, -4, np.where(kind == 1, -1, pinned)).astype(
        fields["forced_node"].dtype)
    jarrs = _jarrs(fields)
    cfg = tsched.make_config(snap)._replace(forced_prefix=0, fail_reasons=False)
    jcfg = _jcfg(cfg)
    active = np.asarray(snap.arrays.active)
    tarrs = convert.snapshot_arrays_from_numpy(fields)
    outs = {}
    for mode in ("none", "fresh", "resumed"):
        jstate = None if mode == "none" else jsched.SimState(
            *[np.array(v) for v in jsched.init_state(jarrs, jcfg)])
        jout = jsched.schedule_pods(jarrs, jnp.asarray(active), jcfg, state=jstate,
                                    state_is_fresh=mode == "fresh", hoist_forced=True)
        tstate = None if mode == "none" else tsched.init_state(
            tsched.device_arrays(tarrs, "cpu"), cfg)
        before = None if tstate is None else convert.state_to_numpy(tstate)
        tout = tsched.schedule_pods(tarrs, active, cfg, state=tstate, device="cpu",
                                    state_is_fresh=mode == "fresh", hoist_forced=True)
        np.testing.assert_array_equal(np.asarray(jout.node), tout.node.numpy(), err_msg=mode)
        _assert_states(tp.jax_state(jout.state), convert.state_to_numpy(tout.state))
        if before is not None:
            _assert_states(before, convert.state_to_numpy(tstate))
        outs[mode] = tout
    assert torch.equal(outs["none"].node, outs["fresh"].node)
    # pins keep their node, sentinels bind nothing
    forced = fields["forced_node"]
    assert np.all(outs["none"].node.numpy()[forced >= 0] == forced[forced >= 0])
    assert np.all(outs["none"].node.numpy()[forced < -1] < 0)


def _split_case():
    snap = synthetic_snapshot(12, 64)
    return snap, tsched.make_config(snap)


def test_resume_equals_full_run(tmp_path):
    """scan(pods[:k]) saved, loaded and resumed over pods[k:] equals one
    scan, and the reference's scan."""
    snap, cfg = _split_case()
    arrs, active = snap.arrays, snap.arrays.active
    full = tsched.schedule_pods(arrs, active, cfg, device="cpu")
    k = 30
    first = tsched.schedule_pods(tsched.slice_pods(arrs, 0, k), active, cfg, device="cpu")
    ckpt = tmp_path / "sim.npz"
    tckpt.save_simulation(str(ckpt), first.state, first.node, meta={"k": k})
    state, node_first, meta = tckpt.load_simulation(str(ckpt))
    assert meta["k"] == k
    resumed = tsched.schedule_pods(tsched.slice_pods(arrs, k, snap.n_pods), active, cfg,
                                   state=state, device="cpu")
    np.testing.assert_array_equal(full.node.numpy()[:k], node_first)
    np.testing.assert_array_equal(full.node.numpy()[k:], resumed.node.numpy())
    _assert_states(convert.state_to_numpy(full.state), convert.state_to_numpy(resumed.state))
    jcfg, jouts, jst = tp.run_jax(jsynthetic(12, 64))
    np.testing.assert_array_equal(jouts["node"], full.node.numpy())
    _assert_states(jst, convert.state_to_numpy(resumed.state))


def _legacy(path, alloc):
    """Rewrite a checkpoint in the older form: state_used, no headroom."""
    with np.load(str(path)) as z:
        entries = {kk: z[kk] for kk in z.files}
    entries["state_used"] = alloc - entries.pop("state_headroom")
    raw = json.loads(bytes(entries["meta_json"]).decode())
    raw["state_dtypes"]["used"] = raw["state_dtypes"].pop("headroom")
    entries["meta_json"] = np.frombuffer(json.dumps(raw).encode(), dtype=np.uint8)
    np.savez_compressed(str(path), **entries)


def test_legacy_used_checkpoint_converts_once(tmp_path):
    snap, cfg = _split_case()
    arrs, active = snap.arrays, snap.arrays.active
    full = tsched.schedule_pods(arrs, active, cfg, device="cpu")
    k = 30
    first = tsched.schedule_pods(tsched.slice_pods(arrs, 0, k), active, cfg, device="cpu")
    ckpt = tmp_path / "legacy.npz"
    tckpt.save_simulation(str(ckpt), first.state, first.node, resources=snap.resources)
    _legacy(ckpt, np.asarray(arrs.alloc, dtype=np.float32))
    state, _, meta = tckpt.load_simulation(str(ckpt))
    assert meta.get("_headroom_is_legacy_used") is True
    state = tckpt.resume_state(state, arrs, meta, resources=snap.resources)
    assert torch.equal(state.headroom, first.state.headroom)
    state2 = tckpt.resume_state(state, arrs, meta, resources=snap.resources)
    assert torch.equal(state2.headroom, state.headroom)
    ckpt2 = tmp_path / "converted.npz"
    tckpt.save_simulation(str(ckpt2), state, meta=meta)
    _, _, meta2 = tckpt.load_simulation(str(ckpt2))
    assert "_headroom_is_legacy_used" not in meta2
    resumed = tsched.schedule_pods(tsched.slice_pods(arrs, k, snap.n_pods), active, cfg,
                                   state=state, device="cpu")
    np.testing.assert_array_equal(full.node.numpy()[k:], resumed.node.numpy())


def test_legacy_copy_without_resume_stays_legacy(tmp_path):
    snap, cfg = _split_case()
    arrs = snap.arrays
    first = tsched.schedule_pods(tsched.slice_pods(arrs, 0, 30), arrs.active, cfg, device="cpu")
    ckpt = tmp_path / "legacy.npz"
    tckpt.save_simulation(str(ckpt), first.state)
    _legacy(ckpt, np.asarray(arrs.alloc, dtype=np.float32))
    state, node_assign, meta = tckpt.load_simulation(str(ckpt))
    copied = tmp_path / "copied.npz"
    tckpt.save_simulation(str(copied), state, node_assign, meta=meta)
    with np.load(str(copied)) as z:
        assert "state_used" in z.files and "state_headroom" not in z.files
    state2, _, meta2 = tckpt.load_simulation(str(copied))
    assert meta2.get("_headroom_is_legacy_used") is True
    state2 = tckpt.resume_state(state2, arrs, meta2)
    assert torch.equal(state2.headroom, first.state.headroom)


def test_resume_rejects_mismatched_resources_and_shapes(tmp_path):
    snap, cfg = _split_case()
    arrs = snap.arrays
    first = tsched.schedule_pods(tsched.slice_pods(arrs, 0, 30), arrs.active, cfg, device="cpu")
    ckpt = tmp_path / "sim.npz"
    tckpt.save_simulation(str(ckpt), first.state, resources=snap.resources)
    state, _, meta = tckpt.load_simulation(str(ckpt))
    swapped = list(snap.resources)
    swapped[-1], swapped[-2] = swapped[-2], swapped[-1]
    with pytest.raises(ValueError, match="resource columns"):
        tckpt.resume_state(state, arrs, meta, resources=swapped)
    other = synthetic_snapshot(8, 16)
    with pytest.raises(ValueError, match="carry shape"):
        tckpt.resume_state(state, other.arrays, meta)
    with pytest.raises(TypeError, match="meta dict"):
        tckpt.resume_state(state, arrs, None)


def test_pre_round4_checkpoint_loads_and_resumes(tmp_path):
    """A checkpoint without dom_count loads (shape-safe fill) and resumes
    exactly after resume_state rebuilds the table from group_count."""
    snap = synthetic_snapshot(12, 64)
    cfg = tsched.make_config(snap, spread_hostname=True)
    arrs, active = snap.arrays, snap.arrays.active
    full = tsched.schedule_pods(arrs, active, cfg, device="cpu")
    k = 30
    first = tsched.schedule_pods(tsched.slice_pods(arrs, 0, k), active, cfg, device="cpu")
    ckpt = tmp_path / "old.npz"
    tckpt.save_simulation(str(ckpt), first.state, first.node)
    with np.load(str(ckpt)) as z:
        stripped = {kk: z[kk] for kk in z.files if kk not in ("state_dom_count",
                                                               "state_vol_cnt")}
    np.savez_compressed(str(ckpt), **stripped)
    state, _, meta = tckpt.load_simulation(str(ckpt))
    assert state.dom_count.ndim == 3 and tuple(state.vol_cnt.shape) == (0, 0)
    state = tckpt.resume_state(state, arrs, meta)
    want = np.einsum("knd,ns->kds", np.asarray(arrs.topo_onehot),
                     first.state.group_count.to(torch.float32).numpy())
    np.testing.assert_array_equal(state.dom_count.numpy(), want)
    assert tuple(state.vol_cnt.shape) == (snap.n_nodes, arrs.vol_limit_cap.shape[1])
    resumed = tsched.schedule_pods(tsched.slice_pods(arrs, k, snap.n_pods), active, cfg,
                                   state=state, device="cpu")
    np.testing.assert_array_equal(full.node.numpy()[k:], resumed.node.numpy())


def test_slice_pods_full_range_is_noop_and_matches_the_reference():
    snap = synthetic_snapshot(8, 48, rich=True)
    arrs = snap.arrays
    full = tsched.slice_pods(arrs, 0, snap.n_pods)
    part = tsched.slice_pods(arrs, 5, 17)
    jpart = jsched.slice_pods(_jarrs(tp.fields(arrs)), 5, 17)
    for f in dataclasses.fields(arrs):
        np.testing.assert_array_equal(getattr(full, f.name), getattr(arrs, f.name), f.name)
        np.testing.assert_array_equal(getattr(part, f.name),
                                      np.asarray(getattr(jpart, f.name)), f.name)


def test_slice_pods_empty_slice_schedules_nothing():
    snap = synthetic_snapshot(8, 48)
    cfg = tsched.make_config(snap)
    arrs, active = snap.arrays, snap.arrays.active
    first = tsched.schedule_pods(tsched.slice_pods(arrs, 0, 20), active, cfg, device="cpu")
    empty = tsched.slice_pods(arrs, 20, 20)
    assert empty.req.shape[0] == 0
    out = tsched.schedule_pods(empty, active, cfg, state=first.state, device="cpu")
    assert out.node.shape[0] == 0
    _assert_states(convert.state_to_numpy(first.state), convert.state_to_numpy(out.state))


def test_slice_pods_across_the_reference_bucket_pad():
    """The reference's padded master sliced across the real/pad boundary:
    the pad rows are sentinels, so the port's scan of [k, P_pad) equals
    its scan of [k, P) and binds nothing past P."""
    snap = synthetic_snapshot(8, 48)
    cfg = tsched.make_config(snap)._replace(forced_prefix=0)
    nb, pb = jexec.bucket_shape(snap.n_nodes, snap.n_pods)
    assert pb > snap.n_pods
    from open_simulator_tpu_torch.engine.buckets import bucket_shape

    assert bucket_shape(snap.n_nodes, snap.n_pods) == (nb, pb)
    padded = jexec.pad_snapshot_arrays(_jarrs(tp.fields(snap.arrays)), nb, pb)
    padded = convert.snapshot_arrays_from_numpy(tp.fields(padded))
    active = np.zeros(nb, dtype=bool)
    active[: snap.n_nodes] = snap.arrays.active
    full = tsched.schedule_pods(snap.arrays, snap.arrays.active, cfg, device="cpu")
    first = tsched.schedule_pods(tsched.slice_pods(padded, 0, 20), active, cfg, device="cpu")
    rest = tsched.schedule_pods(tsched.slice_pods(padded, 20, pb), active, cfg,
                                state=first.state, device="cpu")
    nodes = torch.cat([first.node, rest.node]).numpy()
    np.testing.assert_array_equal(nodes[: snap.n_pods], full.node.numpy())
    assert np.all(nodes[snap.n_pods:] < 0)
    for name in ("headroom", "group_count"):
        assert torch.equal(getattr(rest.state, name)[: snap.n_nodes], getattr(full.state, name))


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_checkpoints_cross_load_between_the_packages(tmp_path, writer):
    """A rich carry (bf16 group_count and term_block, the paints) saved by
    one package loads bit-equal in the other, node_assign, meta and the
    resource record included."""
    snap = jsynthetic(12, 64, rich=True)
    jcfg, jouts, jst = tp.run_jax(snap)
    assert jst["group_count"].dtype.name == "bfloat16"
    path = str(tmp_path / f"{writer}.npz")
    meta = {"k": 64, "note": "rich"}
    if writer == "jax":
        jstate = jsched.SimState(**{k: jnp.asarray(v) for k, v in jst.items()})
        jckpt.save_simulation(path, jstate, jouts["node"], meta=meta, resources=snap.resources)
        state, node, meta2 = tckpt.load_simulation(path)
        assert state.group_count.dtype == torch.bfloat16
        _assert_states(jst, convert.state_to_numpy(state))
    else:
        tckpt.save_simulation(path, _tstate(jst), torch.from_numpy(jouts["node"]), meta=meta,
                              resources=snap.resources)
        state, node, meta2 = jckpt.load_simulation(path)
        _assert_states(jst, tp.jax_state(state))
    np.testing.assert_array_equal(node, jouts["node"])
    assert meta2["k"] == 64 and meta2["note"] == "rich"
    assert meta2["_resources"] == list(snap.resources)
