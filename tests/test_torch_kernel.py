"""The plain_step kernel's wrapper, binding and parity.

This file imports only the port, so it also runs on a machine with the
card and no JAX. There, from the repository root:

    python -m pytest --noconftest -q tests/test_torch_kernel.py

runs the card-only tests (marked ``cuda``): the kernel against the plain
torch step, bit for bit, on both spread carries, on the rich synthetic
cluster (pod affinity, anti-affinity in the slot and the dense form, hard
spread, the interpod preference), on the device-resource cluster (GPU
share, open-local storage, the volume masks, PV matching, attach limits
and dedup, with mid-sequence pinned GPU pods), on lanes, on the lane
prologue (lanes started from one template carry, with and without reason
accounting), at the edges of the cluster geometry (fewer nodes than
blocks, a ragged last slice, an odd number of lanes) and through
``schedule_lanes``. Without CUDA they skip with the reason; the binding
checks and the launch plan's tests (cluster size, block size, node
slices, shared-memory accounting) run everywhere.
"""

from __future__ import annotations

import os
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from open_simulator_tpu_torch.encode.snapshot import encode_cluster
from open_simulator_tpu_torch.engine import scheduler as sched
from open_simulator_tpu_torch.k8s.loader import make_valid_node
from open_simulator_tpu_torch.k8s.objects import Node, Pod
from open_simulator_tpu_torch.kernels import build, step
from open_simulator_tpu_torch.testing.synthetic import (
    device_resource_snapshot,
    soft_spread_cluster,
    synthetic_snapshot,
)

SOURCE = os.path.join(build.CSRC_DIR, "plain_step.cu")


def test_ctypes_struct_matches_the_c_struct():
    """StepArgs in kernels/step.py lists the C struct's fields in order
    with matching types: a mismatch would pass garbage pointers."""
    src = Path(SOURCE).read_text(encoding="utf-8")
    body = re.search(r"struct StepArgs \{(.*?)\};", src, re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    c_fields = []
    for decl in body.split(";"):
        decl = decl.strip()
        if not decl:
            continue
        ctype, names = re.match(r"(.*?\*|int|float)\s+(.*)", decl).groups()
        kind = "ptr" if ctype.endswith("*") else ctype
        c_fields += [(n.strip(), kind) for n in names.split(",")]
    kinds = {"c_void_p": "ptr", "c_int": "int", "c_float": "float"}
    py_fields = [(name, kinds[ctype.__name__]) for name, ctype in step.StepArgs._fields_]
    assert py_fields == c_fields
    # the lane prologue's template carry: one pointer per carry field the
    # kernel reads and writes
    assert [n for n, _ in c_fields if n.startswith("tmpl_")] == [
        f"tmpl_{f}" for f in step.KERNEL_CARRY]


def test_flag_bits_match_the_c_constants():
    src = Path(SOURCE).read_text(encoding="utf-8")
    bits = dict(re.findall(r"constexpr int (F_\w+) = 1 << (\d+);", src))
    assert len(bits) == 28
    assert bits["F_TEMPLATE"] == "21" and bits["F_VOL_DEDUP"] == "27"
    assert set(bits) == {n for n in dir(step) if n.startswith("F_")}
    for name, shift in bits.items():
        assert getattr(step, name) == 1 << int(shift), name


def test_node_domains():
    topo = torch.zeros((2, 3, 4))
    topo[0, 0, 2] = topo[0, 2, 1] = topo[1, 1, 3] = 1
    assert step.node_domains(topo).tolist() == [[2, -1, 1], [-1, 3, -1]]


def test_dispatch_refuses_other_devices():
    snap = synthetic_snapshot(4, 8)
    cfg = sched.make_config(snap)
    arrs = sched.device_arrays(snap.arrays, "cpu")
    with pytest.raises(ValueError, match="no plain_step for device meta"):
        step.plain_step(arrs, torch.empty((1, 4), dtype=torch.bool, device="meta"),
                        None, None, None, cfg, 0, 8)


def test_kernel_wrapper_refuses_cpu_tensors():
    """On CPU tensors the kernel wrapper raises; only plain_step's dispatch
    picks the plain version, and only for CPU tensors."""
    snap = synthetic_snapshot(4, 8)
    cfg = sched.make_config(snap)
    arrs = sched.device_arrays(snap.arrays, "cpu")
    active = torch.ones((1, 4), dtype=torch.bool)
    hoist = sched.hoist_of(arrs, active)
    st = sched.init_state(arrs, cfg)
    lanes = sched.SimState(**{f: getattr(st, f)[None] for f in sched.STATE_FIELDS})
    with pytest.raises(ValueError, match="not on the card"):
        step.plain_step_cuda(arrs, active, hoist, sched.inv_alloc_of(arrs.alloc),
                             lanes, cfg, 0, 8)


def test_kernel_wrapper_refuses_widths_over_shared_memory(monkeypatch):
    """The per-domain column sums, the raw scores of a block's node slice
    and the replicas of the lane-wide carry live in the block's shared
    memory; widths that do not fit even the largest cluster's slices raise
    before anything is launched, naming the need."""
    snap = synthetic_snapshot(8, 16, rich=True)
    cfg = sched.make_config(snap)
    arrs = sched.device_arrays(snap.arrays, "cpu")
    active = torch.ones((1, 8), dtype=torch.bool)
    st = sched.init_state(arrs, cfg)
    lanes = sched.SimState(**{f: getattr(st, f)[None] for f in sched.STATE_FIELDS})
    widths = step.smem_widths(arrs, cfg, step._flags(cfg, lanes, False))
    sl = step.block_geometry(8, step.CLUSTER_SIZES[0])[0]
    need = step.smem_bytes(widths, sl, False)
    monkeypatch.setattr(step, "_SMEM_LIMIT", need - 1)
    with pytest.raises(ValueError, match=f"need {need} bytes of shared memory"):
        step.plain_step_cuda(arrs, active, sched.hoist_of(arrs, active),
                             sched.inv_alloc_of(arrs.alloc), lanes, cfg, 0, 16)


# the card's answer to cudaOccupancyMaxActiveClusters in these tests: one
# block per SM on 132 SMs, clusters inside GPCs of 16 or more SMs
_OCCUPANCY = {16: 7, 8: 15, 4: 32, 2: 66, 1: 132}
_WIDTHS = step.SmemWidths(ops=21, q=8, d=12, cs=2, dom=0, rows=4, r=4, npv=0)


@pytest.mark.parametrize("n_lanes,n_nodes,cluster", [
    (1, 5184, 16), (7, 5184, 16), (8, 5184, 8), (3, 509, 16), (64, 5184, 2),
    (65, 5184, 2), (67, 5184, 1), (256, 5184, 1), (1, 3, 16), (1, 1000, 16),
    (64, 20000, 2)])
@pytest.mark.parametrize("cap", [step.MAX_THREADS, step.MAX_THREADS_DEVRES])
def test_launch_plan_slices_cover_the_nodes(n_lanes, n_nodes, cluster, cap):
    """The largest cluster size whose lanes the card holds at once (else
    the smallest that fits); block slices cover 0..N-1 once, ascending in
    rank order; every block has whole warps under the instantiation's cap
    and as few nodes a thread as the cap allows."""
    plan = step.plan_launch(n_lanes, n_nodes, _WIDTHS, lambda c, *_: _OCCUPANCY[c], cap)
    assert plan.cluster == cluster
    assert plan.cluster in (1, 2, 4, 8, 16) and plan.cluster & (plan.cluster - 1) == 0
    slices = step.node_slices(plan, n_nodes)
    assert len(slices) == plan.cluster
    assert [n for lo, hi in slices for n in range(lo, hi)] == list(range(n_nodes))
    assert all(a[1] <= b[0] for a, b in zip(slices, slices[1:]))
    assert plan.threads % 32 == 0 and 32 <= plan.threads <= cap
    per_thread = -(-plan.slice_len // plan.threads)
    assert per_thread == -(-plan.slice_len // cap)
    assert plan.smem == step.smem_bytes(_WIDTHS, plan.slice_len, plan.headroom)
    assert plan.smem <= step._SMEM_LIMIT


def test_launch_plan_empty_slices_when_nodes_are_fewer_than_blocks():
    """N < C: the trailing blocks own no node; they still run (and take
    part in every cluster reduction), with one warp each."""
    plan = step.plan_launch(1, 3, _WIDTHS, lambda c, *_: _OCCUPANCY[c])
    assert (plan.cluster, plan.slice_len, plan.threads) == (16, 1, 32)
    assert step.node_slices(plan, 3) == [(0, 1), (1, 2), (2, 3)] + [(3, 3)] * 13


def test_launch_plan_takes_8_when_the_card_will_not_place_16():
    plan = step.plan_launch(1, 5184, _WIDTHS, lambda c, *_: 0 if c == 16 else _OCCUPANCY[c])
    assert plan.cluster == 8 and plan.slice_len == 648 and plan.threads == 352


@pytest.mark.parametrize("kind,cap", [("plain", step.MAX_THREADS), ("rich", step.MAX_THREADS),
                                      ("devres", step.MAX_THREADS_DEVRES)])
def test_block_size_cap_follows_the_instantiation(kind, cap):
    """The launcher's plan for a snapshot: blocks as large as the
    instantiation's cap allows, one node a thread where the slice fits."""
    snap = (device_resource_snapshot(400, 96) if kind == "devres"
            else synthetic_snapshot(2000, 64, rich=kind == "rich"))
    cfg = sched.make_config(snap)
    arrs = sched.device_arrays(snap.arrays, "cpu")
    st = sched.init_state(arrs, cfg)
    lanes = sched.SimState(**{f: getattr(st, f)[None] for f in sched.STATE_FIELDS})
    flags = step._flags(cfg, lanes, True)
    assert step.max_threads(flags) == cap
    plan = step.plan_for(arrs, cfg, flags, 2, lambda c, *_: 0 if c > 1 else 132)
    assert plan.cluster == 1 and plan.slice_len == snap.n_nodes
    assert plan.threads == step.block_geometry(snap.n_nodes, 1, cap)[1]
    assert plan.threads > cap // 2


def test_launch_plan_keeps_headroom_in_shared_memory_where_it_fits():
    """One lane per block (C = 1) at 5,184 nodes: with rich widths the
    raw scores fit, the headroom rows do not; at C = 16 both do."""
    w = _WIDTHS._replace(q=40, d=60, r=12)
    at_16 = step.plan_launch(1, 5184, w, lambda c, *_: _OCCUPANCY[c])
    assert at_16.cluster == 16 and at_16.headroom
    at_1 = step.plan_launch(256, 5184, w, lambda c, *_: _OCCUPANCY[c])
    assert at_1.cluster == 1 and not at_1.headroom
    assert step.smem_bytes(w, 5184, True) > step._SMEM_LIMIT >= at_1.smem


@pytest.mark.parametrize("what", ["columns", "nodes"])
def test_launch_plan_refuses_widths_over_shared_memory(what):
    """No cluster size fits: a ValueError names the need at 16 blocks."""
    w = _WIDTHS._replace(q=300, d=200) if what == "columns" else _WIDTHS
    n_nodes = 5184 if what == "columns" else 16 * 60000
    with pytest.raises(ValueError, match="bytes of shared memory, over the block's"):
        step.plan_launch(1, n_nodes, w, lambda c, *_: _OCCUPANCY[c])


def test_smem_bytes_counts_the_kernel_layout():
    """smem_bytes mirrors layout_of in the .cu: the partials twice, the
    merged column read, the needs, the minima, the dom_count replica, the
    slice's score rows (and headroom) as words, then flags and the
    pv_taken replica as bytes."""
    w = step.SmemWidths(ops=5, q=3, d=4, cs=2, dom=24, rows=5, r=6, npv=7)
    qd = 3 * 4 + 2 * 3
    words = 2 * 5 + 3 * qd + 3 + 2 + 24 + 5 * 10
    assert step.smem_bytes(w, 10, False) == 4 * words + 10 + 7
    assert step.smem_bytes(w, 10, True) == 4 * (words + 60) + 10 + 7
    src = Path(SOURCE).read_text(encoding="utf-8")
    body = re.search(r"inline Layout layout_of\(const StepArgs& a\) \{(.*?)\n\}", src, re.S).group(1)
    for part in ("2 * a.ops", "2 * qd", "w += qd", "w += q;", "w += a.cs", "a.k1 * a.d * a.sg",
                 "score_rows(a.flags) * a.sl", "a.sl * a.r", "l.pv = l.flag + a.sl", "a.npv"):
        assert part in body, part


def test_kernel_wrapper_checks_indices():
    """Indices the kernel reads without bounds checks are checked first."""
    import dataclasses

    snap = synthetic_snapshot(4, 8)
    cfg = sched.make_config(snap)
    bad = dataclasses.replace(snap.arrays, forced_node=snap.arrays.forced_node + 9)
    arrs = sched.device_arrays(bad, "cpu")
    with pytest.raises(ValueError, match="forced_node holds"):
        step._check_index("forced_node", arrs.forced_node, 4)
    step._check_index("class_id", arrs.class_id, arrs.class_affinity.shape[0])


def _soft_spread(n_nodes, n_pods, hostname):
    nd, pd = soft_spread_cluster(n_nodes, n_pods, hostname=hostname)
    return encode_cluster([make_valid_node(Node.from_dict(x)) for x in nd],
                          [Pod.from_dict(x) for x in pd])


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the plain_step CUDA kernel has no CPU mode")
    return torch.device("cuda")


RICH_CASES = {
    "rich": dict(),
    "rich-dense": dict(slot_paint=False),
    "rich-f32-no-reasons": dict(compact_carry=False, fail_reasons=False),
    "devres": dict(),
    "devres-no-dedup-no-reasons": dict(enable_vol_dedup=False, fail_reasons=False),
    "devres-f32-gpu-weight": dict(compact_carry=False, w_gpu=3.0),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["hostname-bf16", "hostname-f32", "zone-region", "synthetic",
                                  "rich", "rich-dense", "rich-bound", "rich-f32-no-reasons",
                                  "devres", "devres-no-dedup-no-reasons",
                                  "devres-f32-gpu-weight"])
def test_kernel_equals_plain_step_on_card(cuda_device, case):
    """Two lanes with different active masks: the kernel and the plain
    torch step give the same outputs and carry, bit for bit."""
    overrides = {"compact_carry": False} if case == "hostname-f32" else RICH_CASES.get(case, {})
    if case == "synthetic":
        snap = synthetic_snapshot(96, 512, bound=0.2)
    elif case.startswith("rich"):
        snap = synthetic_snapshot(96, 512, rich=True, bound=0.3 if case == "rich-bound" else 0.0)
    elif case.startswith("devres"):
        snap = device_resource_snapshot(96, 768)
    else:
        snap = _soft_spread(96, 512, hostname=case != "zone-region")
    cfg = sched.make_config(snap, **overrides)
    arrs = sched.device_arrays(snap.arrays, cuda_device)
    masks = np.stack([np.ones(snap.n_nodes, bool), np.arange(snap.n_nodes) % 3 != 0])
    active = torch.from_numpy(masks).to(cuda_device)
    hoist = sched.hoist_of(arrs, active)
    inv = sched.inv_alloc_of(arrs.alloc)
    base = sched.apply_forced_prefix(arrs, cfg, sched.init_state(arrs, cfg), cfg.forced_prefix)
    runs = []
    for fn in (step.plain_step_cuda, step.plain_step_torch):
        lanes = sched.SimState(**{f: torch.stack([getattr(base, f)] * 2).contiguous()
                                  for f in sched.STATE_FIELDS})
        outs = fn(arrs, active, hoist, inv, lanes, cfg, cfg.forced_prefix, snap.n_pods)
        torch.cuda.synchronize()
        runs.append((outs, lanes))
    (out_k, st_k), (out_p, st_p) = runs
    for a, b in zip(out_k, out_p):
        assert torch.equal(a, b)
    for f in sched.STATE_FIELDS:
        assert torch.equal(getattr(st_k, f), getattr(st_p, f)), f
    assert (out_k[0] >= 0).any()
    if case.startswith("devres"):
        assert out_k[3].shape[2] == 8 and out_k[4].shape[2] == 1
        assert (out_k[3] > 0).any() and (out_k[4] >= 0).any()


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["tiny-3-rich", "tiny-3-dom_count", "ragged-devres",
                                  "odd-lanes-3-rich"])
def test_kernel_geometry_edges_on_card(cuda_device, case):
    """The edges of the cluster geometry, bit for bit against the plain
    step: fewer nodes than blocks (empty slices in every reduction), a
    ragged last slice, an odd number of lanes (of clusters)."""
    if case == "tiny-3-rich":
        snap, n_lanes = synthetic_snapshot(3, 48, rich=True), 1
    elif case == "tiny-3-dom_count":
        snap, n_lanes = synthetic_snapshot(3, 48), 2
    elif case == "ragged-devres":
        snap, n_lanes = device_resource_snapshot(200, 512), 1
    else:
        snap, n_lanes = synthetic_snapshot(131, 384, rich=True), 3
    cfg = sched.make_config(snap)
    n = snap.n_nodes
    masks = np.stack([np.ones(n, bool), np.arange(n) % 3 != 1, np.arange(n) % 4 != 0])[:n_lanes]
    arrs = sched.device_arrays(snap.arrays, cuda_device)
    active = torch.from_numpy(masks).to(cuda_device)
    hoist = sched.hoist_of(arrs, active)
    inv = sched.inv_alloc_of(arrs.alloc)
    tmpl = sched.init_state(arrs, cfg)
    if cfg.forced_prefix:
        tmpl = sched.apply_forced_prefix(arrs, cfg, tmpl, cfg.forced_prefix)
    tmpl = sched.SimState(**{f: getattr(tmpl, f).contiguous() for f in sched.STATE_FIELDS})
    runs = []
    for fn in (step.plain_step_cuda, step.plain_step_torch):
        carry = sched.lane_carry(tmpl, n_lanes)
        outs = fn(arrs, active, hoist, inv, carry, cfg, cfg.forced_prefix, snap.n_pods,
                  template=tmpl)
        torch.cuda.synchronize()
        runs.append((outs, carry))
    plan = step.LAST_PLAN
    (out_k, st_k), (out_p, st_p) = runs
    for a, b in zip(out_k, out_p):
        assert torch.equal(a, b)
    for f in sched.STATE_FIELDS:
        assert torch.equal(getattr(st_k, f), getattr(st_p, f)), f
    assert (out_k[0] >= 0).any()
    slices = step.node_slices(plan, n)
    if case.startswith("tiny"):
        assert slices[-1] == (n, n)
    elif case == "ragged-devres":
        assert 0 < slices[-1][1] - slices[-1][0] < plan.slice_len or plan.cluster == 1
    else:
        assert plan.cluster > 1


@pytest.mark.cuda
def test_schedule_pods_launches_the_kernel_on_card(cuda_device):
    snap = _soft_spread(64, 256, hostname=True)
    cfg = sched.make_config(snap)
    before = step.LAUNCHES["plain_step"]
    out_gpu = sched.schedule_pods(snap.arrays, snap.arrays.active, cfg)
    assert step.LAUNCHES["plain_step"] == before + 1
    out_cpu = sched.schedule_pods(snap.arrays, snap.arrays.active, cfg, device="cpu")
    assert torch.equal(out_gpu.node.cpu(), out_cpu.node)
    assert torch.equal(out_gpu.fail_counts.cpu(), out_cpu.fail_counts)
    assert torch.equal(out_gpu.state.headroom.cpu(), out_cpu.state.headroom)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["synthetic-new8", "rich-new8", "hostname-prefix",
                                  "devres-new8"])
@pytest.mark.parametrize("fail_reasons", [True, False])
def test_lane_prologue_equals_plain_on_card(cuda_device, case, fail_reasons):
    """Five lanes started from one template by the kernel's prologue, into
    carry buffers holding garbage, against the plain version of the
    prologue: outputs and carries equal bit for bit; with reasons off no
    fail-count buffer is made."""
    if case == "hostname-prefix":
        snap = _soft_spread(96, 384, hostname=True)
    elif case == "devres-new8":
        snap = device_resource_snapshot(64, 512, max_new=8)
    else:
        snap = synthetic_snapshot(64, 384, max_new=8, rich=case.startswith("rich"))
    cfg = sched.make_config(snap, fail_reasons=fail_reasons)
    n = snap.n_nodes
    rng = np.random.RandomState(11)
    masks = np.stack([np.arange(n) < snap.n_real_nodes, np.ones(n, bool),
                      np.arange(n) < snap.n_real_nodes + 3, rng.rand(n) < 0.8,
                      np.arange(n) % 5 != 2])
    arrs = sched.device_arrays(snap.arrays, cuda_device)
    active = torch.from_numpy(masks).to(cuda_device)
    hoist = sched.hoist_of(arrs, active)
    inv = sched.inv_alloc_of(arrs.alloc)
    tmpl = sched.init_state(arrs, cfg)
    if cfg.forced_prefix:
        tmpl = sched.apply_forced_prefix(arrs, cfg, tmpl, cfg.forced_prefix)
    tmpl = sched.SimState(**{f: getattr(tmpl, f).contiguous() for f in sched.STATE_FIELDS})
    runs = []
    for fn in (step.plain_step_cuda, step.plain_step_torch):
        carry = sched.lane_carry(tmpl, 5)
        for f in sched.STATE_FIELDS:
            t = getattr(carry, f)
            t.copy_(torch.randint(0, 7, t.shape, device=cuda_device).to(t.dtype))
        outs = fn(arrs, active, hoist, inv, carry, cfg, cfg.forced_prefix, snap.n_pods,
                  template=tmpl)
        torch.cuda.synchronize()
        runs.append((outs, carry))
    (out_k, st_k), (out_p, st_p) = runs
    for a, b in zip(out_k, out_p):
        assert torch.equal(a, b)
    for f in sched.STATE_FIELDS:
        assert torch.equal(getattr(st_k, f), getattr(st_p, f)), f
    if not fail_reasons:
        assert out_k[1].stride() == (0, 0, 0)
    assert len({tuple(r) for r in out_k[0].cpu().tolist()}) >= 3


@pytest.mark.cuda
def test_schedule_lanes_on_card_equals_cpu(cuda_device):
    """schedule_lanes: one launch for all lanes on the card, equal to the
    plain step on the CPU; a second launch reuses the first's carry."""
    snap = synthetic_snapshot(64, 256, max_new=8, rich=True)
    cfg = sched.make_config(snap, fail_reasons=False)
    masks = np.stack([np.arange(snap.n_nodes) < snap.n_real_nodes + c for c in (0, 2, 5, 8)])
    before = step.LAUNCHES["plain_step"]
    first = sched.schedule_lanes(snap.arrays, masks[::-1].copy(), cfg)
    gpu = sched.schedule_lanes(snap.arrays, masks, cfg, carry=first.state)
    assert step.LAUNCHES["plain_step"] == before + 2
    assert gpu.state.headroom.data_ptr() == first.state.headroom.data_ptr()
    cpu = sched.schedule_lanes(snap.arrays, masks, cfg, device="cpu")
    assert torch.equal(gpu.node.cpu(), cpu.node)
    assert torch.equal(gpu.feasible.cpu(), cpu.feasible)
    for f in sched.STATE_FIELDS:
        assert torch.equal(getattr(gpu.state, f).cpu(), getattr(cpu.state, f)), f


def _devres_launch_args(snap, **replace):
    import dataclasses

    arrays = dataclasses.replace(snap.arrays, **replace)
    cfg = sched.make_config(snap)
    arrs = sched.device_arrays(arrays, "cpu")
    active = torch.ones((1, snap.n_nodes), dtype=torch.bool)
    st = sched.init_state(arrs, cfg)
    lanes = sched.SimState(**{f: getattr(st, f)[None] for f in sched.STATE_FIELDS})
    return (arrs, active, sched.hoist_of(arrs, active), sched.inv_alloc_of(arrs.alloc), lanes,
            cfg, cfg.forced_prefix, snap.n_pods)


def test_kernel_wrapper_refuses_devres_widths_and_slot_order(monkeypatch):
    """The device-resource walks keep per-thread arrays: wider snapshots
    raise naming the width; the PV walk stops at a pod's first padded
    claim slot, so valid slots after a padded one are refused."""
    snap = device_resource_snapshot(16, 64)
    monkeypatch.setattr(step, "MAX_VG", 1)
    with pytest.raises(ValueError, match="2 volume groups per node, over the kernel's 1"):
        step.plain_step_cuda(*_devres_launch_args(snap))
    monkeypatch.undo()
    p = snap.n_pods
    valid = np.zeros((p, 2), bool)
    valid[3, 1] = True
    with pytest.raises(ValueError, match="valid WaitForFirstConsumer slots must come before"):
        step.plain_step_cuda(*_devres_launch_args(
            snap, wfc_ccid=np.zeros((p, 2), np.int64), wfc_valid=valid))


def test_admitted_pv_lists():
    """Each node's PVs in ascending id, without the PVs no claim class
    can take."""
    node_ok = torch.tensor([[True, False, True], [True, True, False], [False, True, True],
                            [True, True, True]])
    cand = torch.tensor([[True, False, True, False], [False, False, True, False]])
    ptr, idx = step.admitted_pv_lists(node_ok, cand)
    lists = [idx[ptr[i]:ptr[i + 1]].tolist() for i in range(3)]
    assert lists == [[0], [2], [0, 2]]
    ptr, idx = step.admitted_pv_lists(node_ok, torch.zeros((0, 4), dtype=torch.bool))
    assert ptr.tolist() == [0, 0, 0, 0] and idx.numel() == 0


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["stateful", "gpushare", "openlocal"])
def test_device_resource_examples_on_card(cuda_device, name):
    """simulate() on the card gives the CPU's answer, GPU and PV picks
    included. The stateful example's pods use no topology key but the
    hostname, so the hoist has one log row more than there are keys: the
    launcher passes the kernel the first K."""
    from open_simulator_tpu_torch.api.v1alpha1 import load_config
    from open_simulator_tpu_torch.apply.applier import (
        build_apps_from_config, build_cluster_from_config)
    from open_simulator_tpu_torch.core import simulate

    examples = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                            "examples")
    runs = []
    for device in ("cuda", "cpu"):
        cfg = load_config(os.path.join(examples, f"{name}-config.yaml"))
        res = simulate(build_cluster_from_config(cfg, examples),
                       build_apps_from_config(cfg, examples), device=device)
        runs.append((res.placements(), {u.pod.key: u.reason for u in res.unscheduled_pods},
                     res.volume_bindings, res.gpu_assignments))
    assert runs[0] == runs[1]
    assert runs[0][0]
