"""The port's device-resource ops equal the JAX package's, op by op.

``open_simulator_tpu_torch.ops.{gpu_share, storage, volumes}`` against
``open_simulator_tpu.ops.{gpu_share, storage, volumes}`` on the same
seeded numpy inputs, on the CPU. Every output must be equal
(``np.array_equal``, dtypes included where both sides define them).
The inputs aim at the edges: free memory at exact multiples of the
request, ties among devices, volume groups and PVs, pinned pods (one
pinned to a device the node lacks), requests of 0, 1 and more GPUs with
two-pointers that cannot complete, no PVs at all, and pods with several
claims that must land on distinct PVs. Tolerance: exact.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from open_simulator_tpu.ops import gpu_share as jgpu
from open_simulator_tpu.ops import storage as jsto
from open_simulator_tpu.ops import volumes as jvol
from open_simulator_tpu_torch.ops import gpu_share as tgpu
from open_simulator_tpu_torch.ops import storage as tsto
from open_simulator_tpu_torch.ops import volumes as tvol


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def same(ref, got):
    ref, got = np.asarray(ref), got.numpy()
    assert ref.shape == got.shape
    assert np.array_equal(ref, got), (ref, got)


def gpu_case(rng, n=6, g=8):
    """Per-device capacity, used memory (often at exact multiples of the
    request, often equal across devices), slots, and one pod's request."""
    cap = rng.choice([8.0, 16.0, 32.0], size=n).astype(np.float32)
    slot = np.zeros((n, g), np.float32)
    for i in range(n):
        slot[i, :rng.randint(0, g + 1)] = 1.0
    mem = np.float32(rng.choice([0.0, 1.0, 2.0, 4.0, 8.0, 16.0]))
    unit = mem if mem > 0 else np.float32(4.0)
    # used in whole requests (free = k * mem), a shared level (ties), or any
    level = rng.randint(0, 5, size=(n, 1)).astype(np.float32) * unit
    used = np.where(rng.rand(n, g) < 0.5, level,
                    rng.randint(0, 5, size=(n, g)).astype(np.float32) * unit)
    used = np.where(rng.rand(n, g) < 0.2, rng.randint(0, 33, size=(n, g)), used)
    used = np.minimum(used, cap[:, None]).astype(np.float32) * slot
    cnt = np.float32(rng.choice([0.0, 1.0, 1.0, 2.0, 3.0, 4.0, 8.0]))
    return used, cap, slot, mem, cnt


@pytest.mark.parametrize("seed", range(8))
def test_gpu_fit_and_raw(seed):
    rng = np.random.RandomState(seed)
    for _ in range(40):
        used, cap, slot, mem, cnt = gpu_case(rng)
        forced = np.bool_(rng.rand() < 0.2)
        ref = jgpu.gpu_fit(jnp.asarray(used), jnp.asarray(cap), jnp.asarray(slot),
                           jnp.float32(mem), jnp.float32(cnt), jnp.bool_(forced))
        got = tgpu.gpu_fit(t(used), t(cap), t(slot), torch.tensor(mem), torch.tensor(cnt),
                           torch.tensor(bool(forced)))
        same(ref, got)
        same(jgpu.gpu_share_raw(jnp.asarray(used), jnp.asarray(cap), jnp.asarray(slot),
                                jnp.float32(mem), jnp.float32(cnt)),
             tgpu.gpu_share_raw(t(used), t(cap), t(slot), torch.tensor(mem), torch.tensor(cnt)))
        same(jgpu._slots_per_device(jnp.asarray(used), jnp.asarray(cap)[:, None],
                                    jnp.asarray(slot), jnp.float32(mem)),
             tgpu.slots_per_device(t(used), t(cap)[:, None], t(slot), torch.tensor(mem)))


def pick_both(used_n, cap_n, slot_n, mem, cnt, forced_counts, has_forced):
    ref = jgpu.gpu_pick_devices(jnp.asarray(used_n), jnp.float32(cap_n), jnp.asarray(slot_n),
                                jnp.float32(mem), jnp.float32(cnt),
                                jnp.asarray(forced_counts), jnp.bool_(has_forced))
    got = tgpu.gpu_pick_devices(t(used_n), torch.tensor(np.float32(cap_n)), t(slot_n),
                                torch.tensor(np.float32(mem)), torch.tensor(np.float32(cnt)),
                                t(forced_counts), torch.tensor(bool(has_forced)))
    assert got.dtype == torch.int32
    same(ref, got)
    return got.numpy()


@pytest.mark.parametrize("seed", range(8))
def test_gpu_pick_devices(seed):
    rng = np.random.RandomState(100 + seed)
    for _ in range(40):
        used, cap, slot, mem, cnt = gpu_case(rng, n=1)
        g = slot.shape[1]
        pinned = rng.rand() < 0.2
        forced = np.zeros(g, np.int32)
        if pinned:
            for d in rng.randint(0, g, size=max(int(cnt), 1)):
                forced[d] += 1
        pick_both(used[0], cap[0], slot[0], mem, cnt, forced, pinned)


def test_gpu_pick_edges():
    g = 4
    slot = np.array([1, 1, 1, 0], np.float32)
    none = np.zeros(g, np.int32)
    # ties: three devices equally free -> the lowest id
    assert pick_both(np.array([8, 8, 8, 0], np.float32), 16, slot, 4, 1, none, False).tolist() \
        == [1, 0, 0, 0]
    # exact multiples: free = 2 x mem on device 0 takes two of three GPUs
    assert pick_both(np.array([8, 12, 12, 0], np.float32), 16, slot, 4, 3, none, False).tolist() \
        == [2, 1, 0, 0]
    # an incomplete two-pointer picks nothing
    assert pick_both(np.array([12, 12, 12, 0], np.float32), 16, slot, 4, 4, none, False).tolist() \
        == [0, 0, 0, 0]
    # cnt 0 picks nothing, even pinned
    pin = np.array([0, 0, 0, 1], np.int32)
    assert pick_both(np.zeros(g, np.float32), 16, slot, 4, 0, pin, True).tolist() == [0, 0, 0, 0]
    # a pin to a device the node lacks is taken verbatim
    assert pick_both(np.zeros(g, np.float32), 16, slot, 4, 1, pin, True).tolist() == [0, 0, 0, 1]


def test_gpu_fit_pinned_to_a_missing_device():
    """A pinned pod skips the allocation check but not the capacity
    precheck or the device presence; the pin itself is not checked."""
    used = np.array([[16, 16, 0, 0], [0, 0, 0, 0]], np.float32)
    slot = np.array([[1, 1, 0, 0], [0, 0, 0, 0]], np.float32)
    cap = np.array([16, 16], np.float32)
    for forced in (False, True):
        ref = jgpu.gpu_fit(jnp.asarray(used), jnp.asarray(cap), jnp.asarray(slot),
                           jnp.float32(8), jnp.float32(1), jnp.bool_(forced))
        got = tgpu.gpu_fit(t(used), t(cap), t(slot), torch.tensor(np.float32(8)),
                           torch.tensor(np.float32(1)), torch.tensor(forced))
        same(ref, got)
        assert got.tolist() == [forced, False]


def storage_case(rng, n=6, v=3, e=3, lv=3, ev=2):
    gib = 1024.0
    vg_cap = (rng.choice([0, 50, 100], size=(n, v)) * gib).astype(np.float32)
    vg_used = (np.floor(rng.rand(n, v) * 4) * 25 * gib).astype(np.float32)
    vg_used = np.minimum(vg_used, vg_cap)
    sdev_cap = (rng.choice([0, 100, 100, 200], size=(n, e)) * gib).astype(np.float32)
    sdev_ssd = rng.rand(n, e) < 0.5
    taken = rng.rand(n, e) < 0.3
    lvm = np.sort(rng.choice([0, 5, 25, 40, 50], size=lv) * gib)[::-1].astype(np.float32)
    dreq = np.sort(rng.choice([0, 50, 100, 150], size=ev) * gib)[::-1].astype(np.float32)
    dssd = rng.rand(ev) < 0.5
    return vg_used, vg_cap, taken, sdev_cap, sdev_ssd, lvm, dreq, dssd


@pytest.mark.parametrize("seed", range(8))
def test_storage_fit_and_plan(seed):
    rng = np.random.RandomState(200 + seed)
    for _ in range(30):
        args = storage_case(rng)
        ref = jsto.storage_fit_and_plan(*(jnp.asarray(a) for a in args))
        got = tsto.storage_fit_and_plan(*(t(a) for a in args))
        for r, g in zip(ref, got):
            same(r, g)


def test_lvm_pack_and_device_match_ties():
    gib = 1024.0
    # equal free space in both VGs: the first VG takes the first volume,
    # the second takes the next (it is now the most free)
    cap = np.array([[100, 100]], np.float32) * gib
    ok_r, add_r = jsto.lvm_pack(jnp.zeros((1, 2)), jnp.asarray(cap),
                                jnp.asarray(np.array([40, 40], np.float32) * gib))
    ok_t, add_t = tsto.lvm_pack(torch.zeros((1, 2)), t(cap),
                                t(np.array([40, 40], np.float32) * gib))
    same(ok_r, ok_t)
    same(add_r, add_t)
    assert add_t.tolist() == [[40 * gib, 40 * gib]]
    # two equal devices of the right media: the lower index
    dcap = np.array([[200, 100, 100]], np.float32) * gib
    ssd = np.array([[True, True, True]])
    ok_r, take_r = jsto.device_match(jnp.zeros((1, 3), bool), jnp.asarray(dcap),
                                     jnp.asarray(ssd), jnp.asarray(np.float32([80 * gib])),
                                     jnp.asarray([True]))
    ok_t, take_t = tsto.device_match(torch.zeros((1, 3), dtype=torch.bool), t(dcap), t(ssd),
                                     t(np.float32([80 * gib])), t(np.array([True])))
    same(ok_r, ok_t)
    same(take_r, take_t)
    assert take_t.tolist() == [[False, True, False]]


def volume_case(rng, n_nodes=5, n_pv=8, cc=3, lw=3):
    pv_node_ok = rng.rand(n_pv, n_nodes) < 0.4
    pv_node_ok[:, 0] = True  # node 0 admits every PV: ties between PVs
    pv_cand = rng.rand(cc, n_pv) < 0.6
    taken = rng.rand(n_pv) < 0.25
    ccid = rng.randint(0, cc, size=lw).astype(np.int64)
    valid = np.sort(rng.rand(lw) < 0.7)[::-1].copy()
    return taken, pv_cand, pv_node_ok, ccid, valid


@pytest.mark.parametrize("seed", range(8))
def test_wfc_claims_and_picks(seed):
    rng = np.random.RandomState(300 + seed)
    for _ in range(30):
        taken, cand, node_ok, ccid, valid = volume_case(rng)
        same(jvol.wfc_claims_ok(jnp.asarray(taken), jnp.asarray(cand), jnp.asarray(node_ok),
                                jnp.asarray(ccid), jnp.asarray(valid)),
             tvol.wfc_claims_ok(t(taken), t(cand), t(node_ok), ccid, valid))
        node = rng.randint(node_ok.shape[1])
        bound = bool(rng.rand() < 0.8)
        ref = jvol.wfc_pick_for_node(jnp.asarray(taken), jnp.asarray(cand),
                                     jnp.asarray(node_ok[:, node]), jnp.asarray(ccid),
                                     jnp.asarray(valid), jnp.bool_(bound))
        got = tvol.wfc_pick_for_node(t(taken), t(cand), t(node_ok[:, node].copy()), ccid, valid,
                                     bound)
        same(ref[0], got[0])
        same(ref[1], got[1])


def test_wfc_zero_pvs_and_disjoint_claims():
    # no PVs: every valid claim fails on every node; no valid claim passes
    empty_ok = np.zeros((0, 3), bool)
    for valid in (np.array([True, False]), np.array([False, False])):
        ref = jvol.wfc_claims_ok(jnp.zeros((0,), bool), jnp.zeros((1, 0), bool),
                                 jnp.asarray(empty_ok), jnp.zeros(2, jnp.int32),
                                 jnp.asarray(valid))
        got = tvol.wfc_claims_ok(torch.zeros((0,), dtype=torch.bool),
                                 torch.zeros((1, 0), dtype=torch.bool), t(empty_ok),
                                 np.zeros(2, np.int64), valid)
        same(ref, got)
    ref = jvol.wfc_pick_for_node(jnp.zeros((0,), bool), jnp.zeros((1, 0), bool),
                                 jnp.zeros((0,), bool), jnp.zeros(2, jnp.int32),
                                 jnp.asarray([True, True]), jnp.bool_(True))
    got = tvol.wfc_pick_for_node(torch.zeros((0,), dtype=torch.bool),
                                 torch.zeros((1, 0), dtype=torch.bool),
                                 torch.zeros((0,), dtype=torch.bool), np.zeros(2, np.int64),
                                 np.array([True, True]), True)
    same(ref[1], got[1])
    assert got[1].tolist() == [-1, -1]
    # two claims of one class, one PV on node 0 and two on node 1: the
    # claims need distinct PVs, so only node 1 passes; it takes PVs 1, 2
    node_ok = np.array([[True, False], [False, True], [False, True]])
    cand = np.ones((1, 3), bool)
    ccid, valid = np.zeros(2, np.int64), np.array([True, True])
    ref = jvol.wfc_claims_ok(jnp.zeros(3, bool), jnp.asarray(cand), jnp.asarray(node_ok),
                             jnp.asarray(ccid), jnp.asarray(valid))
    got = tvol.wfc_claims_ok(torch.zeros(3, dtype=torch.bool), t(cand), t(node_ok), ccid, valid)
    same(ref, got)
    assert got.tolist() == [False, True]
    _, picks = tvol.wfc_pick_for_node(torch.zeros(3, dtype=torch.bool), t(cand),
                                      t(node_ok[:, 1].copy()), ccid, valid, True)
    assert picks.tolist() == [1, 2]
