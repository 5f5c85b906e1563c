"""The plain_step kernel's wrapper, binding and parity.

This file imports only the port, so it also runs on a machine with the
card and no JAX. There, from the repository root:

    python -m pytest --noconftest -q tests/test_torch_kernel.py

runs the card-only tests (marked ``cuda``): the kernel against the plain
torch step, bit for bit, on both spread carries, on the rich synthetic
cluster (pod affinity, anti-affinity in the slot and the dense form, hard
spread, the interpod preference), on the device-resource cluster (GPU
share, open-local storage, the volume masks, PV matching, attach limits
and dedup, with mid-sequence pinned GPU pods), on the device-resource
cluster with the inter-pod constraints too (``plain_step<1,1>``), with
the preemption columns in each of the four instantiations, on lanes, on
the lane prologue (lanes started from one template carry, with and without reason
accounting), at the edges of the cluster geometry (fewer nodes than
blocks, a ragged last slice, an odd number of lanes) and through
``schedule_lanes``; the frozen wave form of each instantiation against
the plain step's frozen form, and the ``wave_merge`` kernel against the
plain merge (``kernels/wave.py``), on pools clusters the wave planner
batches, and a wave run through ``schedule_pods``; the per-lane weight
row (the traced weights) through the four scan builds and the four frozen
builds, a different row in each lane, one all zeros, and through
``schedule_lanes``; the extension rows (seeded masks and raw scores, a
NaN among them) through the 16 scan builds and the wide library, the
"max" row's edges, and the per-pod loop of ``schedule_lanes`` with torch
extension ops against the CPU's. Without CUDA they skip
with the reason; the binding checks and the launch plan's tests (cluster
size, block size, node slices, shared-memory accounting) run everywhere.
"""

from __future__ import annotations

import dataclasses
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
from open_simulator_tpu_torch.engine import waves as wave_plans
from open_simulator_tpu_torch.kernels import build, step, wave
from open_simulator_tpu_torch.testing.synthetic import (
    device_resource_snapshot,
    preemption_columns,
    soft_spread_cluster,
    synthetic_snapshot,
    wave_pools_snapshot,
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
        ctype, names = re.match(r"(.*?\*|int|float|unsigned)\s+(.*)", decl).groups()
        kind = "ptr" if ctype.endswith("*") else ctype
        c_fields += [(n.strip(), kind) for n in names.split(",")]
    kinds = {"c_void_p": "ptr", "c_int": "int", "c_float": "float", "c_uint": "unsigned"}
    py_fields = [(name, kinds[ctype.__name__]) for name, ctype in step.StepArgs._fields_]
    assert py_fields == c_fields
    # the preemption columns: pod arrays every instantiation reads
    names = [n for n, _ in c_fields]
    at = names.index("hit_pref")
    assert names[at + 1:at + 3] == ["disabled", "nominated"] and at + 3 < step._N_BASE_PTRS
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
    """The raw scores of a block's node slice, the merged column read, the
    column needs and the pv_taken replica live in the block's shared memory
    whatever the plan (the column-read partials and the dom_count replica
    can move to global memory); widths that do not fit even the largest
    cluster's slices with both moved raise before anything is launched,
    naming the need."""
    snap = synthetic_snapshot(8, 16, rich=True)
    cfg = sched.make_config(snap)
    arrs = sched.device_arrays(snap.arrays, "cpu")
    active = torch.ones((1, 8), dtype=torch.bool)
    st = sched.init_state(arrs, cfg)
    lanes = sched.SimState(**{f: getattr(st, f)[None] for f in sched.STATE_FIELDS})
    widths = step.smem_widths(arrs, cfg, step._flags(cfg, lanes, False))
    sl = step.block_geometry(8, step.CLUSTER_SIZES[0])[0]
    need = step.smem_bytes(widths, sl, False, True, True)
    assert need < step.smem_bytes(widths, sl, False)
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
    """No cluster size fits, even with the column-read partials in global
    memory (the merged column read stays in shared memory): a ValueError
    names the need at 16 blocks."""
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
    "devres-rich": dict(),
}


def test_rich_devres_input_sets_both_slices_gates():
    """The device-resource cluster with the inter-pod constraints runs
    plain_step<1,1>, with every device-resource gate and the group_count
    carry on."""
    snap = device_resource_snapshot(48, 256, rich=True)
    cfg = sched.make_config(snap)
    arrs = sched.device_arrays(snap.arrays, "cpu")
    assert step.instantiation(cfg, sched.init_state(arrs, cfg)) == "<1,1>"
    assert cfg.needs_group_count and step.devres_on(cfg)
    assert all(getattr(cfg, g) for g in ("enable_gpu", "enable_storage", "enable_vol_static",
                                         "enable_pv_match", "enable_vol_limits",
                                         "enable_vol_dedup"))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["hostname-bf16", "hostname-f32", "zone-region", "synthetic",
                                  "rich", "rich-dense", "rich-bound", "rich-f32-no-reasons",
                                  "devres", "devres-no-dedup-no-reasons",
                                  "devres-f32-gpu-weight", "devres-rich"])
def test_kernel_equals_plain_step_on_card(cuda_device, case):
    """Two lanes with different active masks: the kernel and the plain
    torch step give the same outputs and carry, bit for bit."""
    overrides = {"compact_carry": False} if case == "hostname-f32" else RICH_CASES.get(case, {})
    if case == "synthetic":
        snap = synthetic_snapshot(96, 512, bound=0.2)
    elif case.startswith("rich"):
        snap = synthetic_snapshot(96, 512, rich=True, bound=0.3 if case == "rich-bound" else 0.0)
    elif case.startswith("devres"):
        snap = device_resource_snapshot(96, 768, rich=case == "devres-rich")
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


COLUMN_CASES = {"<0,0>": lambda: synthetic_snapshot(96, 512, bound=0.2),
                "<1,0>": lambda: synthetic_snapshot(96, 512, rich=True, bound=0.2),
                "<0,1>": lambda: device_resource_snapshot(96, 640),
                "<1,1>": lambda: device_resource_snapshot(96, 640, rich=True)}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(COLUMN_CASES))
def test_kernel_preemption_columns_equal_plain_step_on_card(cuda_device, case):
    """Each instantiation with random preemption columns (victims,
    nominations of feasible, inactive, forced and victim pods, -1 and
    out-of-range values), two lanes from a template carry with no prefix
    fold: the kernel and the plain step agree bit for bit."""
    snap = COLUMN_CASES[case]()
    cfg = sched.make_config(snap, forced_prefix=0)
    n = snap.n_nodes
    masks = np.stack([np.arange(n) % 9 != 4, np.arange(n) % 3 != 0])
    disabled, nominated = preemption_columns(snap.arrays.forced_node, masks[0], seed=5)
    arrs = sched.device_arrays(snap.arrays, cuda_device)
    active = torch.from_numpy(masks).to(cuda_device)
    hoist = sched.hoist_of(arrs, active)
    inv = sched.inv_alloc_of(arrs.alloc)
    tmpl = sched.init_state(arrs, cfg)
    assert step.instantiation(cfg, tmpl, columns=True) == case + "+columns"
    cols = dict(disabled=torch.from_numpy(disabled).to(cuda_device),
                nominated=torch.from_numpy(nominated).to(cuda_device))
    runs = []
    for fn in (step.plain_step_cuda, step.plain_step_torch):
        carry = sched.lane_carry(tmpl, 2)
        outs = fn(arrs, active, hoist, inv, carry, cfg, 0, snap.n_pods, template=tmpl, **cols)
        torch.cuda.synchronize()
        runs.append((outs, carry))
    (out_k, st_k), (out_p, st_p) = runs
    for a, b in zip(out_k, out_p):
        assert torch.equal(a, b)
    for f in sched.STATE_FIELDS:
        assert torch.equal(getattr(st_k, f), getattr(st_p, f)), f
    node = out_k[0].cpu().numpy()
    assert (node[:, disabled] == -3).all() and (node[:, ~disabled] != -3).all()
    held = (node[0] == nominated) & (nominated >= 0) & (snap.arrays.forced_node == -1)
    assert held.sum() > 10


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
    # with the preemption columns: one launch, no prefix fold, the CPU's answer
    disabled, nominated = preemption_columns(snap.arrays.forced_node, snap.arrays.active)
    outs = [sched.schedule_pods(snap.arrays, snap.arrays.active, cfg, device=dev,
                                disabled=disabled, nominated=nominated) for dev in (None, "cpu")]
    assert step.LAUNCHES["plain_step"] == before + 2
    for a, b in zip(outs[0][:5], outs[1][:5]):
        assert torch.equal(a.cpu(), b)


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
    """The device-resource walks keep per-thread arrays up to MAX_VG,
    MAX_DEVICES and MAX_WFC_CLAIMS and walk a window of global memory past
    them: a wider snapshot is no longer refused for its width (only the
    CPU tensors stop this launch); the PV walk stops at a pod's first
    padded claim slot, so valid slots after a padded one are refused."""
    snap = device_resource_snapshot(16, 64)
    monkeypatch.setattr(step, "MAX_VG", 1)
    args = _devres_launch_args(snap)
    assert step.walk_width(args[0], args[5]) == 2 * (2 + snap.arrays.sdev_cap.shape[1]) + \
        snap.arrays.wfc_ccid.shape[1]
    with pytest.raises(ValueError, match="not on the card"):
        step.plain_step_cuda(*args)
    monkeypatch.undo()
    assert step.walk_width(args[0], args[5]) == 0
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


# ---- the wave form ---------------------------------------------------------

# the frozen instantiation each pools cluster runs
FROZEN_CASES = {"<0,0>": dict(), "<1,0>": dict(interpod=True), "<0,1>": dict(gpu=True),
                "<1,1>": dict(gpu=True, interpod=True)}
MERGE_SOURCE = os.path.join(build.CSRC_DIR, "wave_merge.cu")


@pytest.mark.parametrize("case", sorted(FROZEN_CASES))
def test_wave_inputs_run_their_frozen_instantiation(case):
    """Each pools cluster plans one GRID of width 8 over every pod and
    launches the instantiation it is named for."""
    snap = wave_pools_snapshot(48, 256, 8, **FROZEN_CASES[case])
    cfg = sched.make_config(snap)
    plan = wave_plans.waves_for(snap.arrays, cfg)
    assert plan.segments == ((0, 256, wave_plans.GRID, 8),)
    arrs = sched.device_arrays(snap.arrays, "cpu")
    assert step.instantiation(cfg, sched.init_state(arrs, cfg)) == case
    if "gpu" in FROZEN_CASES[case]:
        assert cfg.enable_gpu and (snap.arrays.gpu_cnt == 2).any()
    if "interpod" in FROZEN_CASES[case]:
        assert cfg.needs_group_count and cfg.enable_anti_affinity and cfg.enable_pref


def test_frozen_form_refuses_a_template_and_columns():
    snap = wave_pools_snapshot(16, 32, 4)
    cfg = sched.make_config(snap)
    arrs = sched.device_arrays(snap.arrays, "cpu")
    active = torch.ones((1, 16), dtype=torch.bool)
    st = sched.init_state(arrs, cfg)
    lanes = sched.SimState(**{f: getattr(st, f)[None].clone() for f in sched.STATE_FIELDS})
    args = (arrs, active, sched.hoist_of(arrs, active), sched.inv_alloc_of(arrs.alloc), lanes,
            cfg, 0, 4)
    for fn in (step.plain_step_torch, step.plain_step_cuda):
        with pytest.raises(ValueError, match="frozen wave form takes no template"):
            fn(*args, template=st, frozen=True)
        with pytest.raises(ValueError, match="frozen wave form takes no template"):
            fn(*args, disabled=torch.zeros(32, dtype=torch.bool), frozen=True)


def test_merge_struct_and_flags_match_the_c_source():
    """MergeArgs in kernels/wave.py lists the C struct's fields in order,
    and the flag bits match the C constants."""
    src = Path(MERGE_SOURCE).read_text(encoding="utf-8")
    body = re.sub(r"//[^\n]*", "", re.search(r"struct MergeArgs \{(.*?)\};", src, re.S).group(1))
    c_fields = []
    for decl in body.split(";"):
        decl = decl.strip()
        if decl:
            ctype, names = re.match(r"(.*?\*|int)\s+(.*)", decl).groups()
            c_fields += [(n.strip(), "ptr" if ctype.endswith("*") else ctype)
                         for n in names.split(",")]
    kinds = {"c_void_p": "ptr", "c_int": "int"}
    assert [(n, kinds[t.__name__]) for n, t in wave.MergeArgs._fields_] == c_fields
    bits = dict(re.findall(r"constexpr int (M_\w+) = 1 << (\d+);", src))
    assert bits and {n: 1 << int(b) for n, b in bits.items()} == {
        n: getattr(wave, n) for n in dir(wave) if re.fullmatch(r"M_[A-Z0-9_]+", n)}


def test_plain_step_kernel_has_the_frozen_instantiations():
    """kernel_of picks the frozen form from StepArgs.frozen, never with
    the columns: four frozen builds beside the eight scan builds (in each
    library; the fifth flag, kExplain, is the library's)."""
    src = Path(SOURCE).read_text(encoding="utf-8")
    insts = set(re.findall(r"plain_step_kernel<(true|false), (true|false), (true|false), "
                           r"(true|false), X>", src))
    assert len(insts) == 12
    assert {i[:3] for i in insts if i[3] == "true"} == {
        (a, b, "false") for a in ("true", "false") for b in ("true", "false")}


def _clone(st):
    return sched.SimState(**{f: getattr(st, f).clone() for f in sched.STATE_FIELDS})


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(FROZEN_CASES))
@pytest.mark.parametrize("fail_reasons", [True, False])
def test_frozen_step_and_merge_equal_plain_on_card(cuda_device, case, fail_reasons):
    """Three lanes over the first waves of a pools GRID: each wave's frozen
    kernel launch equals the plain step's frozen form (outputs, and the
    carry left as it was), and the wave_merge kernel equals the plain
    merge on every carry field, bit for bit."""
    snap = wave_pools_snapshot(96, 768, 8, **FROZEN_CASES[case])
    cfg = sched.make_config(snap, fail_reasons=fail_reasons)
    lo, _, kind, w = wave_plans.waves_for(snap.arrays, cfg).segments[0]
    assert kind == wave_plans.GRID
    arrs = sched.device_arrays(snap.arrays, cuda_device)
    n = snap.n_nodes
    masks = np.stack([np.ones(n, bool), np.arange(n) % 5 != 2, np.arange(n) % 7 != 3])
    active = torch.from_numpy(masks).to(cuda_device)
    hoist = sched.hoist_of(arrs, active)
    inv = sched.inv_alloc_of(arrs.alloc)
    tmpl = sched.init_state(arrs, cfg)
    st = sched.lane_carry(tmpl, 3)
    step.copy_template(st, tmpl)
    inputs, before = {}, dict(step.LAUNCHES)
    for w0 in range(lo, lo + 6 * w, w):
        st_p = _clone(st)
        out_k = step.plain_step_cuda(arrs, active, hoist, inv, st, cfg, w0, w0 + w, frozen=True,
                                     inputs=inputs)
        out_p = step.plain_step_torch(arrs, active, hoist, inv, st_p, cfg, w0, w0 + w,
                                      frozen=True)
        torch.cuda.synchronize()
        for a, b in zip(out_k, out_p):
            assert torch.equal(a, b)
        for f in sched.STATE_FIELDS:
            assert torch.equal(getattr(st, f), getattr(st_p, f)), f
        pick = out_k[3] if cfg.enable_gpu else None
        wave.wave_merge_cuda(arrs, cfg, st, w0, w0 + w, out_k[0], pick)
        wave.wave_merge_torch(arrs, cfg, st_p, w0, w0 + w, out_k[0], pick)
        torch.cuda.synchronize()
        for f in sched.STATE_FIELDS:
            assert torch.equal(getattr(st, f), getattr(st_p, f)), f
    assert step.LAUNCHES["plain_step_frozen"] == before["plain_step_frozen"] + 6
    assert step.LAUNCHES["plain_step"] == before["plain_step"]
    assert (st.headroom != tmpl.headroom).any()
    if cfg.enable_gpu:
        assert (st.gpu_used > 0).any()


@pytest.mark.cuda
def test_wave_merge_of_forced_nodes_on_card(cuda_device):
    """A FORCED segment's merge: one node row for every lane (stride 0),
    in chunks, equal to the plain merge."""
    snap = synthetic_snapshot(96, 512, bound=0.6)
    cfg = sched.make_config(snap, fail_reasons=False)
    arrs = sched.device_arrays(snap.arrays, cuda_device)
    st = sched.lane_carry(sched.init_state(arrs, cfg), 2)
    step.copy_template(st, sched.init_state(arrs, cfg))
    st_p = _clone(st)
    forced = arrs.forced_node.to(torch.int32)
    for lo, hi in ((0, 100), (100, 512)):
        wave.wave_merge_cuda(arrs, cfg, st, lo, hi, forced[lo:hi].contiguous())
        wave.wave_merge_torch(arrs, cfg, st_p, lo, hi, forced[lo:hi])
    torch.cuda.synchronize()
    for f in sched.STATE_FIELDS:
        assert torch.equal(getattr(st, f), getattr(st_p, f)), f


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["<0,0>", "<1,1>"])
def test_schedule_pods_runs_the_waves_on_card(cuda_device, case):
    """schedule_pods with a plan: one frozen launch and one merge per wave,
    no scan launch, and the CPU's answer (which is the scan's)."""
    snap = wave_pools_snapshot(64, 384, 8, **FROZEN_CASES[case])
    cfg = sched.make_config(snap)
    plan = wave_plans.waves_for(snap.arrays, cfg)
    before, merges = dict(step.LAUNCHES), wave.LAUNCHES["wave_merge"]
    gpu = sched.schedule_pods(snap.arrays, snap.arrays.active, cfg, waves=plan)
    assert step.LAUNCHES["plain_step_frozen"] == before["plain_step_frozen"] + plan.n_waves
    assert step.LAUNCHES["plain_step"] == before["plain_step"]
    assert wave.LAUNCHES["wave_merge"] == merges + plan.n_waves
    cpu = sched.schedule_pods(snap.arrays, snap.arrays.active, cfg, device="cpu")
    for a, b in zip(gpu[:5], cpu[:5]):
        assert torch.equal(a.cpu(), b)
    for f in sched.STATE_FIELDS:
        assert torch.equal(getattr(gpu.state, f).cpu(), getattr(cpu.state, f)), f


# the explain builds (the fifth flag, kExplain: the top-k candidates and the
# seeded tie-break jitter) of each instantiation: scan, with the preemption
# columns, and frozen
EXPLAIN_MODES = {"topk": dict(explain_topk=3), "seed": dict(tie_break_seed=7),
                 "topk-seed": dict(explain_topk=4, tie_break_seed=2**31 - 1)}
EXPLAIN_SNAPSHOTS = {"<0,0>": lambda: synthetic_snapshot(96, 512, bound=0.2),
                     "<1,0>": lambda: synthetic_snapshot(96, 512, rich=True, bound=0.2),
                     "<0,1>": lambda: device_resource_snapshot(96, 640),
                     "<1,1>": lambda: device_resource_snapshot(96, 640, rich=True),
                     "tiny-3": lambda: synthetic_snapshot(3, 40, rich=True)}


def _assert_runs_equal(runs):
    (out_k, st_k), (out_p, st_p) = runs
    for name, a, b in zip(step.StepOutputs._fields, out_k, out_p):
        assert torch.equal(a, b), name
    for f in sched.STATE_FIELDS:
        assert torch.equal(getattr(st_k, f), getattr(st_p, f)), f


def test_explain_gates_pick_the_explain_builds():
    """explain_topk or tie_break_seed runs the "+explain" twin of the
    launch's instantiation; the shared memory grows by the top-k's row."""
    snap = synthetic_snapshot(24, 64, rich=True)
    arrs = sched.device_arrays(snap.arrays, "cpu")
    for mode, over in EXPLAIN_MODES.items():
        cfg = sched.make_config(snap, **over)
        st = sched.init_state(arrs, cfg)
        assert step.instantiation(cfg, st) == "<1,0>+explain", mode
        assert step.instantiation(cfg, st, frozen=True) == "<1,0>+frozen+explain", mode
        flags = step._flags(cfg, st, False)
        base = step.smem_widths(arrs, sched.make_config(snap), flags).rows
        assert step.smem_widths(arrs, cfg, flags).rows == base + bool(cfg.explain_topk)
    assert step.instantiation(sched.make_config(snap), st) == "<1,0>"


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(EXPLAIN_SNAPSHOTS))
@pytest.mark.parametrize("mode", sorted(EXPLAIN_MODES))
def test_explain_builds_equal_plain_step_on_card(cuda_device, case, mode):
    """Each instantiation's explain build, two lanes: the top-k tensors,
    the seeded placements and every carry field equal the plain step's,
    bit for bit (tiny-3: K clamped to the 3 nodes)."""
    snap = EXPLAIN_SNAPSHOTS[case]()
    cfg = sched.make_config(snap, **EXPLAIN_MODES[mode])
    arrs = sched.device_arrays(snap.arrays, cuda_device)
    masks = np.stack([np.ones(snap.n_nodes, bool), np.arange(snap.n_nodes) % 3 != 0])
    active = torch.from_numpy(masks).to(cuda_device)
    hoist = sched.hoist_of(arrs, active)
    inv = sched.inv_alloc_of(arrs.alloc)
    tmpl = sched.apply_forced_prefix(arrs, cfg, sched.init_state(arrs, cfg), cfg.forced_prefix)
    before = dict(step.LAUNCHES)
    runs = []
    for fn in (step.plain_step_cuda, step.plain_step_torch):
        carry = sched.lane_carry(tmpl, 2)
        outs = fn(arrs, active, hoist, inv, carry, cfg, cfg.forced_prefix, snap.n_pods,
                  template=tmpl)
        torch.cuda.synchronize()
        runs.append((outs, carry))
    _assert_runs_equal(runs)
    assert step.LAUNCHES["plain_step_explain"] == before["plain_step_explain"] + 1
    assert step.LAUNCHES["plain_step"] == before["plain_step"]
    out = runs[0][0]
    k_top = min(cfg.explain_topk, snap.n_nodes)
    assert out.topk_node.shape[2] == k_top
    if k_top:
        feasible = out.topk_score > -1e37
        assert feasible.any() and (out.topk_node[..., 0] >= 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(COLUMN_CASES))
def test_explain_builds_with_preemption_columns_on_card(cuda_device, case):
    """The "+columns+explain" builds: random preemption columns with the
    top-k and the jitter, equal to the plain step bit for bit."""
    snap = COLUMN_CASES[case]()
    cfg = sched.make_config(snap, forced_prefix=0, explain_topk=3, tie_break_seed=11)
    n = snap.n_nodes
    masks = np.stack([np.arange(n) % 9 != 4, np.arange(n) % 3 != 0])
    disabled, nominated = preemption_columns(snap.arrays.forced_node, masks[0], seed=5)
    arrs = sched.device_arrays(snap.arrays, cuda_device)
    active = torch.from_numpy(masks).to(cuda_device)
    hoist = sched.hoist_of(arrs, active)
    inv = sched.inv_alloc_of(arrs.alloc)
    tmpl = sched.init_state(arrs, cfg)
    assert step.instantiation(cfg, tmpl, columns=True) == case + "+columns+explain"
    cols = dict(disabled=torch.from_numpy(disabled).to(cuda_device),
                nominated=torch.from_numpy(nominated).to(cuda_device))
    runs = []
    for fn in (step.plain_step_cuda, step.plain_step_torch):
        carry = sched.lane_carry(tmpl, 2)
        outs = fn(arrs, active, hoist, inv, carry, cfg, 0, snap.n_pods, template=tmpl, **cols)
        torch.cuda.synchronize()
        runs.append((outs, carry))
    _assert_runs_equal(runs)


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(FROZEN_CASES))
def test_frozen_explain_builds_equal_plain_on_card(cuda_device, case):
    """The "+frozen+explain" builds over the first waves of a pools GRID,
    three lanes, with the top-k and the jitter: equal to the plain step's
    frozen form, bit for bit."""
    snap = wave_pools_snapshot(96, 768, 8, **FROZEN_CASES[case])
    cfg = sched.make_config(snap, explain_topk=3, tie_break_seed=5)
    lo, _, kind, w = wave_plans.waves_for(snap.arrays, cfg).segments[0]
    assert kind == wave_plans.GRID
    arrs = sched.device_arrays(snap.arrays, cuda_device)
    n = snap.n_nodes
    masks = np.stack([np.ones(n, bool), np.arange(n) % 5 != 2, np.arange(n) % 7 != 3])
    active = torch.from_numpy(masks).to(cuda_device)
    hoist = sched.hoist_of(arrs, active)
    inv = sched.inv_alloc_of(arrs.alloc)
    tmpl = sched.init_state(arrs, cfg)
    st = sched.lane_carry(tmpl, 3)
    step.copy_template(st, tmpl)
    before = dict(step.LAUNCHES)
    for w0 in range(lo, lo + 4 * w, w):
        st_p = _clone(st)
        out_k = step.plain_step_cuda(arrs, active, hoist, inv, st, cfg, w0, w0 + w, frozen=True)
        out_p = step.plain_step_torch(arrs, active, hoist, inv, st_p, cfg, w0, w0 + w,
                                      frozen=True)
        torch.cuda.synchronize()
        _assert_runs_equal([(out_k, st), (out_p, st_p)])
        pick = out_k.gpu_pick if cfg.enable_gpu else None
        wave.wave_merge_cuda(arrs, cfg, st, w0, w0 + w, out_k.node, pick)
    assert step.LAUNCHES["plain_step_frozen_explain"] == before["plain_step_frozen_explain"] + 4


@pytest.mark.cuda
@pytest.mark.parametrize("over", [dict(explain_topk=3), dict(explain_topk=2, tie_break_seed=3)])
def test_schedule_pods_explain_waves_on_card(cuda_device, over):
    """schedule_pods with a wave plan under explain: the card's top-k
    tensors and placements are the CPU's (which are the scan's)."""
    snap = wave_pools_snapshot(64, 384, 8, gpu=True, interpod=True)
    cfg = sched.make_config(snap, **over)
    plan = wave_plans.waves_for(snap.arrays, cfg)
    gpu = sched.schedule_pods(snap.arrays, snap.arrays.active, cfg, waves=plan)
    cpu = sched.schedule_pods(snap.arrays, snap.arrays.active, cfg, device="cpu")
    for name in ("node", "feasible", "gpu_pick", "topk_node", "topk_score", "topk_parts"):
        assert torch.equal(getattr(gpu, name).cpu(), getattr(cpu, name)), name


# ---- the forced fold ---------------------------------------------------------

FOLD_SOURCE = os.path.join(build.CSRC_DIR, "forced_fold.cu")


def test_fold_struct_and_flags_match_the_c_source():
    """FoldArgs in kernels/wave.py lists the C struct's fields in order,
    and the fold's flag bits are the merge's bits of the same names."""
    src = Path(FOLD_SOURCE).read_text(encoding="utf-8")
    body = re.sub(r"//[^\n]*", "", re.search(r"struct FoldArgs \{(.*?)\};", src, re.S).group(1))
    c_fields = []
    for decl in body.split(";"):
        decl = decl.strip()
        if decl:
            ctype, names = re.match(r"(.*?\*|int)\s+(.*)", decl).groups()
            c_fields += [(n.strip(), "ptr" if ctype.endswith("*") else ctype)
                         for n in names.split(",")]
    kinds = {"c_void_p": "ptr", "c_int": "int"}
    assert [(n, kinds[t.__name__]) for n, t in wave.FoldArgs._fields_] == c_fields
    bits = dict(re.findall(r"constexpr int F_(\w+) = 1 << (\d+);", src))
    assert bits and {n: 1 << int(b) for n, b in bits.items()} == {
        n: getattr(wave, "M_" + n) for n in bits}


def test_fold_flags_drop_the_slot_rows_and_the_gpu():
    snap = synthetic_snapshot(16, 64, rich=True)
    cfg = sched.make_config(snap)
    st = sched.init_state(sched.device_arrays(snap.arrays, "cpu"), cfg)
    fl = wave.fold_flags(cfg._replace(enable_gpu=True), st)
    assert cfg.slot_paint and not fl & (wave.M_SLOT | wave.M_GPU)
    assert fl & wave.M_ANTI and fl & wave.M_PREF and fl & wave.M_GC_BF16


FOLD_CASES = {"dom_count": lambda: synthetic_snapshot(96, 512, bound=0.3),
              "rich": lambda: synthetic_snapshot(96, 512, rich=True),
              "rich-f32": lambda: synthetic_snapshot(96, 512, rich=True),
              "devres": lambda: device_resource_snapshot(96, 640)}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(FOLD_CASES))
def test_forced_fold_equals_plain_on_card(cuda_device, case):
    """The fold kernel against its plain version on every carry field: a
    random mask over sentinel, free and pinned pods, past one 4,096-pod
    chunk (the pod axis tiled), from a carry that already holds counts."""
    snap = FOLD_CASES[case]()
    cfg = sched.make_config(snap, compact_carry=case != "rich-f32")
    fields = {f: getattr(snap.arrays, f) for f in snap.arrays.__dataclass_fields__}
    n_pods = sched._PREFIX_CHUNK + 700
    reps = -(-n_pods // snap.n_pods)
    for f in sched.POD_FIELDS:
        fields[f] = np.ascontiguousarray(np.concatenate([fields[f]] * reps)[:n_pods])
    rng = np.random.default_rng(11)
    kind = rng.integers(0, 3, n_pods)
    fields["forced_node"] = np.where(kind == 0, -4, np.where(
        kind == 1, -1, rng.integers(0, snap.n_nodes, n_pods))).astype(np.int32)
    a = fields
    plain = ~((a["gpu_cnt"] > 0) | np.any(a["lvm_req"] > 0, axis=1)
              | np.any(a["sdev_req"] > 0, axis=1) | np.any(a["wfc_valid"], axis=1)
              | np.any(a["svol_id"] >= 0, axis=1))
    draw = rng.random(n_pods)
    first = torch.from_numpy((draw < 0.2) & plain & (kind == 2))
    mask = torch.from_numpy((draw >= 0.2) & (draw < 0.7) & plain & (kind == 2))
    arrs_np = type(snap.arrays)(**fields)
    arrs = sched.device_arrays(arrs_np, cuda_device)
    base = sched.apply_forced_mask(arrs, cfg, sched.init_state(arrs, cfg), first.to(cuda_device))
    before = wave.LAUNCHES["forced_fold"]
    got = sched.apply_forced_mask(arrs, cfg, base, mask.to(cuda_device))
    assert wave.LAUNCHES["forced_fold"] == before + 2
    cpu = sched.device_arrays(arrs_np, "cpu")
    want = sched.apply_forced_mask(cpu, cfg, sched.apply_forced_mask(
        cpu, cfg, sched.init_state(cpu, cfg), first), mask)
    torch.cuda.synchronize()
    for f in sched.STATE_FIELDS:
        assert torch.equal(getattr(got, f).cpu(), getattr(want, f)), f
    assert (got.headroom != base.headroom).any()
    # chunk by chunk, the kernel against the plain version on the card
    nodes = torch.where(mask, arrs.forced_node.cpu().int(), -1).to(cuda_device)
    st_k, st_p = _clone(got), _clone(got)
    for lo, hi in ((0, 1000), (1000, n_pods)):
        wave.forced_fold_cuda(arrs, cfg, st_k, lo, hi, nodes[lo:hi].contiguous())
        wave.forced_fold_torch(arrs, cfg, st_p, lo, hi, nodes[lo:hi])
    torch.cuda.synchronize()
    for f in sched.STATE_FIELDS:
        assert torch.equal(getattr(st_k, f), getattr(st_p, f)), f


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["dom_count", "rich"])
@pytest.mark.parametrize("fresh", [False, True])
def test_hoisted_scan_on_card_equals_cpu(cuda_device, case, fresh):
    """schedule_pods(hoist_forced=True) on the card: the pins folded by
    the fold kernel and scanned as sentinels by plain_step; the CPU's
    answer in every output and carry field, the passed state unchanged."""
    snap = FOLD_CASES[case]()
    rng = np.random.default_rng(5)
    kind = rng.integers(0, 3, snap.n_pods)
    forced = np.where(kind == 0, -4, np.where(kind == 1, -1, rng.integers(0, snap.n_nodes,
                                                                         snap.n_pods)))
    arrs_np = dataclasses.replace(snap.arrays, forced_node=forced.astype(np.int32))
    cfg = sched.make_config(snap, forced_prefix=0, fail_reasons=False)
    runs = []
    for dev in (cuda_device, torch.device("cpu")):
        state = sched.init_state(sched.device_arrays(arrs_np, dev), cfg) if fresh else None
        keep = None if state is None else _clone(state)
        before = (step.LAUNCHES["plain_step"], wave.LAUNCHES["forced_fold"])
        out = sched.schedule_pods(arrs_np, snap.arrays.active, cfg, state=state,
                                  state_is_fresh=fresh, hoist_forced=True, device=dev)
        if dev.type == "cuda":
            assert step.LAUNCHES["plain_step"] == before[0] + 1
            assert wave.LAUNCHES["forced_fold"] == before[1] + 1
        if keep is not None:
            assert all(torch.equal(getattr(state, f), getattr(keep, f))
                       for f in sched.STATE_FIELDS)
        runs.append(out)
    gpu, cpu = runs
    for name in ("node", "feasible"):
        assert torch.equal(getattr(gpu, name).cpu(), getattr(cpu, name)), name
    for f in sched.STATE_FIELDS:
        assert torch.equal(getattr(gpu.state, f).cpu(), getattr(cpu.state, f)), f
    assert np.all(gpu.node.cpu().numpy()[forced >= 0] == forced[forced >= 0])


@pytest.mark.cuda
def test_replay_on_card_equals_cpu(cuda_device):
    """A small replay (arrivals, a departure, a node failure, the
    autoscaler and the descheduler) on the card gives the CPU's rows and
    digest, through plain_step and forced_fold."""
    from open_simulator_tpu_torch import replay

    td = replay.synthetic_trace_dict(n_batches=5, batch_pods=24, depart_every=2,
                                     max_new_nodes=8)
    reports = []
    for dev in ("cuda", "cpu"):
        before = (step.LAUNCHES["plain_step"], wave.LAUNCHES["forced_fold"])
        reports.append(replay.run_replay(
            replay.synthetic_replay_cluster(n_nodes=12, n_initial_pods=12),
            replay.ReplayTrace.from_dict(td),
            replay.ReplayOptions(controllers=[replay.AutoscalerPolicy(scale_step=2),
                                              replay.DeschedulerPolicy(period=3)],
                                 checkpoint=False), device=dev))
        if dev == "cuda":
            assert step.LAUNCHES["plain_step"] > before[0]
            assert wave.LAUNCHES["forced_fold"] > before[1]
    assert reports[0]["steps"] == reports[1]["steps"]
    assert reports[0]["digest"] == reports[1]["digest"]


# ---- the per-lane weight row (traced weights) -----------------------------

# four lanes' weight rows: the config's own vector (filled in per config),
# all zeros (every live row adds 0 x value in its place), a bin-packing
# lean and a spread lean
WEIGHT_ROWS = (None, [0.0] * 9, [1, 0, 1, 2, 0, 1, 0, 1, 1], [0, 2, 0.5, 0, 1, 0, 4, 0, 3])


def _weight_matrix(cfg, device):
    rows = [sched.weight_vector(cfg) if r is None else np.asarray(r, np.float32)
            for r in WEIGHT_ROWS]
    return torch.from_numpy(np.stack(rows)).to(device)


def test_traced_weights_keep_every_row_live():
    """Under the traced weights every enabled score row and resource term
    is flagged, even at a zero weight; the instantiation is the constant
    mode's (the weight row is a runtime pointer, not a build)."""
    snap = synthetic_snapshot(24, 64, rich=True)
    arrs = sched.device_arrays(snap.arrays, "cpu")
    cfg = sched.make_config(snap, w_most=0.0, w_taint=0.0, w_simon=0.0)
    st = sched.init_state(arrs, cfg)
    traced = cfg._replace(traced_weights=True)
    fl_c, fl_t = step._flags(cfg, st, False), step._flags(traced, st, False)
    assert not fl_c & (step.F_MOST | step.F_SI)
    assert fl_t & step.F_MOST and fl_t & step.F_SI and fl_t & step.F_BAL and fl_t & step.F_LEAST
    assert bool(fl_t & step.F_TT) == cfg.enable_taint_score
    assert fl_t & ~fl_c == fl_t ^ fl_c  # the traced flags only add rows
    assert step.instantiation(traced, st) == step.instantiation(cfg, st) == "<1,0>"
    assert "Simon" in sched.score_part_names(traced)
    assert "Simon" not in sched.score_part_names(cfg)


def test_weight_row_is_checked_before_a_launch():
    snap = synthetic_snapshot(16, 32)
    cfg = sched.make_config(snap)
    arrs = sched.device_arrays(snap.arrays, "cpu")
    active = torch.ones((2, 16), dtype=torch.bool)
    st = sched.init_state(arrs, cfg)
    lanes = sched.SimState(**{f: torch.stack([getattr(st, f)] * 2) for f in sched.STATE_FIELDS})
    args = (arrs, active, sched.hoist_of(arrs, active), sched.inv_alloc_of(arrs.alloc), lanes)
    w = torch.zeros((2, 9))
    for fn in (step.plain_step_torch, step.plain_step_cuda):
        with pytest.raises(ValueError, match="without cfg.traced_weights"):
            fn(*args, cfg, 0, 4, weights=w)
        with pytest.raises(ValueError, match="no weights were given"):
            fn(*args, cfg._replace(traced_weights=True), 0, 4)
        with pytest.raises(ValueError, match=r"expected torch.float32\(2, 9\)"):
            fn(*args, cfg._replace(traced_weights=True), 0, 4, weights=w[:1])


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(COLUMN_CASES))
def test_weight_row_scan_builds_equal_plain_step_on_card(cuda_device, case):
    """Each scan build with the weight row: four lanes, each with its own
    active mask and weight row (one all zeros), from a template carry:
    every output and carry field equal the plain step's, bit for bit."""
    snap = COLUMN_CASES[case]()
    cfg = sched.make_config(snap)._replace(traced_weights=True)
    arrs = sched.device_arrays(snap.arrays, cuda_device)
    n = snap.n_nodes
    masks = np.stack([np.ones(n, bool), np.arange(n) % 3 != 0, np.arange(n) % 5 != 1,
                      np.ones(n, bool)])
    active = torch.from_numpy(masks).to(cuda_device)
    hoist = sched.hoist_of(arrs, active)
    inv = sched.inv_alloc_of(arrs.alloc)
    tmpl = sched.apply_forced_prefix(arrs, cfg, sched.init_state(arrs, cfg), cfg.forced_prefix)
    assert step.instantiation(cfg, tmpl) == case
    w = _weight_matrix(cfg, cuda_device)
    before = dict(step.LAUNCHES)
    runs = []
    for fn in (step.plain_step_cuda, step.plain_step_torch):
        carry = sched.lane_carry(tmpl, 4)
        outs = fn(arrs, active, hoist, inv, carry, cfg, cfg.forced_prefix, snap.n_pods,
                  template=tmpl, weights=w)
        torch.cuda.synchronize()
        runs.append((outs, carry))
    _assert_runs_equal(runs)
    assert step.LAUNCHES["plain_step_weights"] == before["plain_step_weights"] + 1
    assert step.LAUNCHES["plain_step"] == before["plain_step"] + 1
    node = runs[0][0].node
    assert not torch.equal(node[0], node[3])  # the same mask, another policy


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(FROZEN_CASES))
def test_weight_row_frozen_builds_equal_plain_on_card(cuda_device, case):
    """Each frozen build with the weight row: four lanes over the first
    waves of a pools GRID, each wave's outputs equal the plain step's
    frozen form, the merges keep the carries equal."""
    snap = wave_pools_snapshot(96, 768, 8, **FROZEN_CASES[case])
    cfg = sched.make_config(snap)._replace(traced_weights=True)
    lo, _, kind, w = wave_plans.waves_for(snap.arrays, cfg).segments[0]
    assert kind == wave_plans.GRID
    arrs = sched.device_arrays(snap.arrays, cuda_device)
    n = snap.n_nodes
    masks = np.stack([np.ones(n, bool), np.arange(n) % 5 != 2, np.arange(n) % 7 != 3,
                      np.ones(n, bool)])
    active = torch.from_numpy(masks).to(cuda_device)
    hoist = sched.hoist_of(arrs, active)
    inv = sched.inv_alloc_of(arrs.alloc)
    tmpl = sched.init_state(arrs, cfg)
    st = sched.lane_carry(tmpl, 4)
    step.copy_template(st, tmpl)
    wm = _weight_matrix(cfg, cuda_device)
    before = dict(step.LAUNCHES)
    for w0 in range(lo, lo + 4 * w, w):
        st_p = _clone(st)
        out_k = step.plain_step_cuda(arrs, active, hoist, inv, st, cfg, w0, w0 + w, frozen=True,
                                     weights=wm)
        out_p = step.plain_step_torch(arrs, active, hoist, inv, st_p, cfg, w0, w0 + w,
                                      frozen=True, weights=wm)
        torch.cuda.synchronize()
        _assert_runs_equal([(out_k, st), (out_p, st_p)])
        pick = out_k[3] if cfg.enable_gpu else None
        wave.wave_merge_cuda(arrs, cfg, st, w0, w0 + w, out_k[0], pick)
        wave.wave_merge_torch(arrs, cfg, st_p, w0, w0 + w, out_k[0], pick)
        torch.cuda.synchronize()
        for f in sched.STATE_FIELDS:
            assert torch.equal(getattr(st, f), getattr(st_p, f)), f
    assert step.LAUNCHES["plain_step_frozen"] == before["plain_step_frozen"] + 4
    assert step.LAUNCHES["plain_step_weights"] == before["plain_step_weights"] + 4


@pytest.mark.cuda
def test_schedule_lanes_with_weights_on_card_equals_cpu(cuda_device):
    """schedule_lanes with an [S, K] weight matrix and a wave plan on the
    card equals the same call on the CPU."""
    snap = wave_pools_snapshot(48, 256, 8, interpod=True)
    cfg = sched.make_config(snap)._replace(traced_weights=True)
    plan = wave_plans.waves_for(snap.arrays, cfg)
    masks = np.stack([np.ones(snap.n_nodes, bool)] * 4)
    w = _weight_matrix(cfg, "cpu").numpy()
    outs = [sched.schedule_lanes(snap.arrays, masks, cfg, device=d, waves=plan, weights=w)
            for d in ("cuda", "cpu")]
    for name in ("node", "fail_counts", "feasible"):
        assert torch.equal(getattr(outs[0], name).cpu(), getattr(outs[1], name)), name
    for f in sched.STATE_FIELDS:
        assert torch.equal(getattr(outs[0].state, f).cpu(), getattr(outs[1].state, f)), f


# ---- the fleet form, the walks past their widths, shared memory spilled --

FLEET_CASES = {"<0,0>": lambda: synthetic_snapshot(96, 384, bound=0.2),
               "<1,0>": lambda: synthetic_snapshot(96, 384, rich=True, bound=0.2),
               "<0,1>": lambda: device_resource_snapshot(96, 384),
               "<1,1>": lambda: device_resource_snapshot(96, 384, rich=True)}


def test_plain_step_kernel_has_the_fleet_instantiations():
    """kernel_of picks the fleet form from StepArgs.fleet: four builds
    (kInterpod x kDevRes, the scan without columns) in each library, each
    running the step's body on its lane's own StepArgs."""
    src = Path(SOURCE).read_text(encoding="utf-8")
    insts = set(re.findall(r"plain_step_fleet_kernel<(true|false), (true|false), X>", src))
    assert insts == {(i, d) for i in ("true", "false") for d in ("true", "false")}
    assert "step_body<kInterpod, kDevRes, false, false, kExplain, true>(s_lane)" in src
    assert "step_body<kInterpod, kDevRes, kCols, kFrozen, kExplain, false>(a)" in src


def _fleet(snap, cfg, n_lanes, device, p1=None):
    """FleetLanes of `n_lanes` variants of `snap` (testing.fleet_variants),
    each with its own active mask, hoist, template and carry."""
    from open_simulator_tpu_torch.testing.synthetic import fleet_variants

    lanes = []
    for s, arrs_np in enumerate(fleet_variants(snap.arrays, n_lanes, seed=3)):
        arrs = sched.device_arrays(arrs_np, device)
        mask = np.asarray(arrs_np.active) & (np.arange(snap.n_nodes) % (s + 2) != 1)
        active = torch.from_numpy(mask).to(device)[None]
        tmpl = sched.init_state(arrs, cfg)
        if cfg.forced_prefix:
            tmpl = sched.apply_forced_prefix(arrs, cfg, tmpl, cfg.forced_prefix)
        tmpl = sched.SimState(**{f: getattr(tmpl, f).contiguous() for f in sched.STATE_FIELDS})
        lanes.append(step.FleetLane(arrs, active, sched.hoist_of(arrs, active),
                                    sched.inv_alloc_of(arrs.alloc), sched.lane_carry(tmpl, 1),
                                    tmpl))
    return lanes


@pytest.mark.parametrize("case", sorted(FLEET_CASES))
@pytest.mark.parametrize("explain", [False, True])
def test_fleet_inputs_run_their_fleet_instantiation(case, explain):
    snap = FLEET_CASES[case]()
    over = dict(explain_topk=3, tie_break_seed=5) if explain else {}
    cfg = sched.make_config(snap, **over)
    arrs = sched.device_arrays(snap.arrays, "cpu")
    got = step.instantiation(cfg, sched.init_state(arrs, cfg), fleet=True)
    assert got == case + "+fleet" + ("+explain" if explain else "")


def test_fleet_refuses_lanes_of_other_shapes():
    snap = synthetic_snapshot(24, 64)
    other = synthetic_snapshot(24, 80)
    cfg = sched.make_config(snap)
    lanes = _fleet(snap, cfg, 2, "cpu") + _fleet(other, cfg, 1, "cpu")
    with pytest.raises(ValueError, match="shape-identical"):
        step.plain_step_fleet(lanes, cfg, 0, 8)


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(FLEET_CASES))
@pytest.mark.parametrize("explain", [False, True])
def test_fleet_builds_equal_lone_launches_and_plain_on_card(cuda_device, case, explain):
    """Three clusters of one shape as one fleet launch: each lane equals a
    one-lane plain_step launch of its cluster alone (every pod after the
    prefix), and the plain fleet over the first pods, bit for bit."""
    snap = FLEET_CASES[case]()
    over = dict(explain_topk=3, tie_break_seed=5) if explain else {}
    cfg = sched.make_config(snap, **over)
    k, p = cfg.forced_prefix, snap.n_pods
    before = dict(step.LAUNCHES)
    lanes = _fleet(snap, cfg, 3, cuda_device)
    outs = step.plain_step_fleet_cuda(lanes, cfg, k, p)
    torch.cuda.synchronize()
    name = "plain_step_fleet" + ("_explain" if explain else "")
    assert step.LAUNCHES[name] == before[name] + 1
    for fleet_lane, lone_lane, out in zip(lanes, _fleet(snap, cfg, 3, cuda_device), outs):
        ln = lone_lane
        lone = step.plain_step_cuda(ln.arrs, ln.active, ln.hoist, ln.inv_alloc, ln.state, cfg,
                                    k, p, template=ln.template)
        torch.cuda.synchronize()
        _assert_runs_equal([(out, fleet_lane.state), (lone, ln.state)])
    assert len({tuple(o[0][0].tolist()) for o in outs}) == 3
    # the plain fleet over the first pods
    lanes_k, lanes_p = _fleet(snap, cfg, 3, cuda_device), _fleet(snap, cfg, 3, cuda_device)
    out_k = step.plain_step_fleet_cuda(lanes_k, cfg, k, k + 48)
    out_p = step.plain_step_fleet_torch(lanes_p, cfg, k, k + 48)
    torch.cuda.synchronize()
    for ok, op, lk, lp in zip(out_k, out_p, lanes_k, lanes_p):
        _assert_runs_equal([(ok, lk.state), (op, lp.state)])


def _wide_devres(rich: bool):
    from open_simulator_tpu_torch.testing.synthetic import widen_device_resources

    snap = device_resource_snapshot(64, 320, rich=rich)
    return dataclasses.replace(snap, arrays=widen_device_resources(snap.arrays))


def test_wide_devres_input_passes_every_walk_width():
    snap = _wide_devres(False)
    a = snap.arrays
    assert a.vg_cap.shape[1] == step.MAX_VG + 1 and a.sdev_cap.shape[1] == step.MAX_DEVICES + 1
    assert a.wfc_ccid.shape[1] == step.MAX_WFC_CLAIMS + 1
    assert a.wfc_valid.all(1).any()
    cfg = sched.make_config(snap)
    assert cfg.enable_storage and cfg.enable_pv_match
    assert step.walk_width(a, cfg) == 2 * (9 + 33) + 9


@pytest.mark.cuda
@pytest.mark.parametrize("rich", [False, True])
def test_walks_past_their_widths_equal_plain_on_card(cuda_device, rich):
    """Nine volume groups, 33 exclusive devices and nine WFC claims a pod:
    the kernel walks them in its global-memory window and equals the
    plain step, bit for bit, on two lanes."""
    snap = _wide_devres(rich)
    cfg = sched.make_config(snap)
    arrs = sched.device_arrays(snap.arrays, cuda_device)
    masks = np.stack([np.asarray(snap.arrays.active),
                      np.asarray(snap.arrays.active) & (np.arange(snap.n_nodes) % 4 != 1)])
    active = torch.from_numpy(masks).to(cuda_device)
    hoist, inv = sched.hoist_of(arrs, active), sched.inv_alloc_of(arrs.alloc)
    tmpl = sched.init_state(arrs, cfg)
    if cfg.forced_prefix:
        tmpl = sched.apply_forced_prefix(arrs, cfg, tmpl, cfg.forced_prefix)
    runs = []
    for fn in (step.plain_step_cuda, step.plain_step_torch):
        st = sched.lane_carry(tmpl, 2)
        outs = fn(arrs, active, hoist, inv, st, cfg, cfg.forced_prefix, snap.n_pods,
                  template=tmpl)
        torch.cuda.synchronize()
        runs.append((outs, st))
    _assert_runs_equal(runs)
    out = runs[0][0]
    assert (out[0] >= 0).any() and (out[4] >= 0).any()
    r = snap.arrays.alloc.shape[1]
    assert out[1][..., 8 + r].sum() > 0 and out[1][..., 11 + r].sum() > 0  # storage, PV match


@pytest.mark.parametrize("affinity", [False, True])
def test_many_domains_move_a_region_to_global_memory(affinity):
    """One domain past what a 5,120-node lane's blocks hold in shared
    memory: the plan moves the dom_count replica (the dom_count path) or
    the column-read partials (the group_count path) to global memory
    instead of raising; one domain fewer keeps both in shared memory."""
    from open_simulator_tpu_torch.testing.synthetic import many_domain_snapshot

    snap = many_domain_snapshot(40, 16, 5, affinity=affinity)
    cfg = sched.make_config(snap)
    arrs = sched.device_arrays(snap.arrays, "cpu")
    st = sched.init_state(arrs, cfg)
    lanes = sched.SimState(**{f: getattr(st, f)[None] for f in sched.STATE_FIELDS})
    flags = step._flags(cfg, lanes, True)
    w = step.smem_widths(arrs, cfg, flags)
    assert bool(w.dom) != affinity
    sl = step.block_geometry(5120, 16)[0]
    d_max = max(d for d in range(1, 20000)
                if step.smem_bytes(w._replace(d=d, dom=w.dom // w.d * d), sl, False)
                <= step._SMEM_LIMIT)
    at = step.plan_launch(1, 5120, w._replace(d=d_max, dom=w.dom // w.d * d_max),
                          lambda *_: 1)
    past = step.plan_launch(1, 5120, w._replace(d=d_max + 1, dom=w.dom // w.d * (d_max + 1)),
                            lambda *_: 1)
    assert at.cluster == past.cluster == 16
    assert not (at.dom_global or at.cols_global)
    assert (past.dom_global, past.cols_global) == ((False, True) if affinity else (True, False))
    assert past.smem <= step._SMEM_LIMIT
    assert step.scratch_bytes(arrs, cfg, flags, past, 1) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("region", ["dom", "cols", "both"])
def test_regions_in_global_memory_equal_plain_on_card(cuda_device, region, monkeypatch):
    """The dom_count replica, the column-read partials, or both, in global
    memory (the shared-memory limit lowered until the plan moves them),
    on two lanes and a frozen wave of 8 pods: the kernel equals the plain
    step, bit for bit."""
    from open_simulator_tpu_torch.testing.synthetic import many_domain_snapshot

    snap = many_domain_snapshot(120, 320, 24, affinity=region != "dom")
    cfg = sched.make_config(snap)
    arrs = sched.device_arrays(snap.arrays, cuda_device)
    masks = np.stack([np.ones(snap.n_nodes, bool), np.arange(snap.n_nodes) % 5 != 2])
    active = torch.from_numpy(masks).to(cuda_device)
    hoist, inv = sched.hoist_of(arrs, active), sched.inv_alloc_of(arrs.alloc)
    tmpl = sched.init_state(arrs, cfg)
    lanes = sched.lane_carry(tmpl, 2)
    flags = step._flags(cfg, lanes, True)
    w = step.smem_widths(arrs, cfg, flags)
    sl = step.block_geometry(snap.n_nodes, 16)[0]
    want = {"dom": (True, False), "cols": (False, True), "both": (True, True)}[region]
    if region == "both":
        cfg = cfg._replace(enable_pod_affinity=False)  # the dom_count path, columns read
        flags = step._flags(cfg, lanes, True)
        w = step.smem_widths(arrs, cfg, flags)
    monkeypatch.setattr(step, "_SMEM_LIMIT", step.smem_bytes(w, sl, False, *want))
    runs = []
    for fn in (step.plain_step_cuda, step.plain_step_torch):
        st = sched.lane_carry(tmpl, 2)
        outs = fn(arrs, active, hoist, inv, st, cfg, 0, snap.n_pods, template=tmpl)
        torch.cuda.synchronize()
        runs.append((outs, st))
    plan = step.LAST_PLAN
    assert (plan.dom_global, plan.cols_global) == want
    _assert_runs_equal(runs)
    assert (runs[0][0][0] >= 0).any()
    st_k, st_p = _clone(runs[0][1]), _clone(runs[0][1])
    out_k = step.plain_step_cuda(arrs, active, hoist, inv, st_k, cfg, 40, 48, frozen=True)
    out_p = step.plain_step_torch(arrs, active, hoist, inv, st_p, cfg, 40, 48, frozen=True)
    torch.cuda.synchronize()
    _assert_runs_equal([(out_k, st_k), (out_p, st_p)])


# ---- the extension rows -------------------------------------------------------


def _ext_cfg(snap, **over):
    from open_simulator_tpu_torch.testing.synthetic import synthetic_extensions

    return sched.make_config(snap, extensions=synthetic_extensions(), **over)


def test_extension_rows_are_checked_before_a_launch():
    """The rows come exactly with the config's extensions, in their
    shapes, and never into the frozen form or the fleet."""
    from open_simulator_tpu_torch.testing.synthetic import random_extension_rows

    snap = synthetic_snapshot(16, 24)
    cfg = _ext_cfg(snap)
    rows = step.extension_rows(cfg)
    assert (len(rows.filters), len(rows.scores), rows.ered) == (2, 3, 3)
    assert cfg.n_ops == sched.make_config(snap).n_ops + 2
    ok, raw = random_extension_rows(cfg, 1, 4, 16)
    step.check_extension_rows(cfg, ok, raw, 1, 4, 16)
    for bad_ok, bad_raw in ((None, raw), (ok, None), (ok[:, :2], raw), (ok, raw.double())):
        with pytest.raises(ValueError, match="ext_"):
            step.check_extension_rows(cfg, bad_ok, bad_raw, 1, 4, 16)
    with pytest.raises(ValueError, match="no such extension"):
        step.check_extension_rows(sched.make_config(snap), ok, None, 1, 4, 16)
    arrs = sched.device_arrays(snap.arrays, "cpu")
    st = sched.lane_carry(sched.init_state(arrs, cfg), 1)
    with pytest.raises(ValueError, match="frozen wave form takes no extension"):
        step.plain_step_torch(arrs, torch.ones((1, 16), dtype=torch.bool),
                              sched.hoist_of(arrs, torch.ones((1, 16), dtype=torch.bool)),
                              sched.inv_alloc_of(arrs.alloc), st, cfg, 0, 4, frozen=True)
    w = step.smem_widths(arrs, cfg, step._flags(cfg, st, False))
    assert w.ext == 3 * 3 + 3 * 3
    flags = step._flags(cfg, st, False)
    assert w.rows == step.smem_widths(arrs, sched.make_config(snap), flags).rows + 4


def test_extension_layout_is_in_the_kernel_source():
    src = Path(SOURCE).read_text(encoding="utf-8")
    assert "w += 3 * a.ered + 3 * a.es + (a.es + (a.ef ? 1 : 0)) * a.sl;" in src
    assert "constexpr bool kExt = !kFrozen && !kFleet;" in src
    assert step.EXT_NORMALIZE == {"none": 0, "minmax": 1, "max": 2}


EXT_CASES = {"<0,0>": lambda: synthetic_snapshot(96, 160, bound=0.2),
             "<1,0>": lambda: synthetic_snapshot(96, 160, rich=True, bound=0.2),
             "<0,1>": lambda: device_resource_snapshot(96, 200),
             "<1,1>": lambda: device_resource_snapshot(96, 200, rich=True)}


def _assert_ext_runs_equal(runs):
    """Every output and carry field equal, a NaN score where the other
    side has one (a NaN candidate's top-k score)."""
    (out_k, st_k), (out_p, st_p) = runs
    pairs = list(zip(step.StepOutputs._fields, out_k, out_p)) + [
        (f, getattr(st_k, f), getattr(st_p, f)) for f in sched.STATE_FIELDS]
    for name, a, b in pairs:
        if a.dtype.is_floating_point:
            assert torch.equal(a.isnan(), b.isnan()), name
            a, b = a.nan_to_num(0.0), b.nan_to_num(0.0)
        assert torch.equal(a, b), name


def _ext_runs(snap, cfg, device, n_lanes=2, columns=False, nan=False, seed=0):
    """The kernel and the plain step over every pod with the same seeded
    extension rows (one launch, P' pods), from a template carry."""
    from open_simulator_tpu_torch.testing.synthetic import random_extension_rows

    arrs = sched.device_arrays(snap.arrays, device)
    n = snap.n_nodes
    masks = np.stack([np.ones(n, bool), np.arange(n) % 3 != 0, np.arange(n) % 4 != 1])[:n_lanes]
    active = torch.from_numpy(masks).to(device)
    hoist, inv = sched.hoist_of(arrs, active), sched.inv_alloc_of(arrs.alloc)
    tmpl = sched.init_state(arrs, cfg)
    p0 = cfg.forced_prefix
    if p0:
        tmpl = sched.apply_forced_prefix(arrs, cfg, tmpl, p0)
    ok, raw = random_extension_rows(cfg, n_lanes, snap.n_pods - p0, n, seed=seed, nan=nan)
    kw = dict(ext_ok=None if ok is None else ok.to(device),
              ext_raw=None if raw is None else raw.to(device))
    if columns:
        dis, nom = preemption_columns(snap.arrays.forced_node, masks[0], seed=seed)
        kw.update(disabled=torch.from_numpy(dis).to(device),
                  nominated=torch.from_numpy(nom.astype(np.int32)).to(device))
    runs = []
    for fn in (step.plain_step_cuda, step.plain_step_torch):
        carry = sched.lane_carry(tmpl, n_lanes)
        outs = fn(arrs, active, hoist, inv, carry, cfg, p0, snap.n_pods, template=tmpl, **kw)
        torch.cuda.synchronize()
        runs.append((outs, carry))
    return runs


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(EXT_CASES))
@pytest.mark.parametrize("columns", [False, True])
@pytest.mark.parametrize("explain", [False, True])
def test_extension_rows_equal_plain_step_on_card(cuda_device, case, columns, explain):
    """Each of the 16 builds the extension rows reach (<I,D>, +columns,
    +explain), two lanes, seeded rows over every pod in one launch, a NaN
    score every third pod: every output (the explain parts with the
    extension rows among them) and carry field equal the plain step's."""
    snap = EXT_CASES[case]()
    over = dict(explain_topk=3, tie_break_seed=5) if explain else {}
    cfg = _ext_cfg(snap, **over)
    arrs = sched.device_arrays(snap.arrays, "cpu")
    want = case + ("+columns" if columns else "") + ("+explain" if explain else "")
    assert step.instantiation(cfg, sched.init_state(arrs, cfg), columns=columns) == want
    before = dict(step.LAUNCHES)
    runs = _ext_runs(snap, cfg, cuda_device, columns=columns, nan=True)
    _assert_ext_runs_equal(runs)
    out = runs[0][0]
    n_ops = cfg.n_ops
    assert out.fail_counts[..., n_ops - 2:].sum() > 0  # the extension reason rows
    assert (out.node == -1).any() and (out.node >= 0).any()  # the NaN pods stay unbound
    assert step.LAUNCHES["plain_step_ext"] == before["plain_step_ext"] + 1
    if explain:
        assert out.topk_parts.shape[2] == len(sched.score_part_names(cfg))


@pytest.mark.cuda
@pytest.mark.parametrize("rich", [False, True])
def test_extension_rows_in_the_wide_library_on_card(cuda_device, rich):
    """The wide library's scan builds with the extension rows: walks past
    their widths, equal to the plain step."""
    snap = _wide_devres(rich)
    cfg = _ext_cfg(snap)
    before = dict(step.LAUNCHES)
    _assert_runs_equal(_ext_runs(snap, cfg, cuda_device, seed=3))
    assert step.LAUNCHES["plain_step_wide"] == before["plain_step_wide"] + 1


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["<0,0>", "<1,1>"])
def test_max_row_edges_on_card(cuda_device, case):
    """The "max" row's zero fill, on three pods of one launch: every node
    feasible, a single node feasible (its minimum takes the other nodes'
    0), and every raw score negative (the maximum is the fill's 0)."""
    snap = EXT_CASES[case]()
    cfg = _ext_cfg(snap)
    n = snap.n_nodes
    arrs = sched.device_arrays(snap.arrays, cuda_device)
    active = torch.ones((1, n), dtype=torch.bool, device=cuda_device)
    hoist, inv = sched.hoist_of(arrs, active), sched.inv_alloc_of(arrs.alloc)
    tmpl = sched.init_state(arrs, cfg)
    ok = torch.ones((1, 3, 2, n), dtype=torch.bool)
    ok[0, 1, 0] = False
    ok[0, 1, 0, 7] = True
    raw = torch.arange(n, dtype=torch.float32).repeat(1, 3, 3, 1) / 4.0
    raw[0, 2, 1] = -raw[0, 2, 1] - 1.0
    runs = []
    for fn in (step.plain_step_cuda, step.plain_step_torch):
        carry = sched.lane_carry(tmpl, 1)
        outs = fn(arrs, active, hoist, inv, carry, cfg, 0, 3, template=tmpl,
                  ext_ok=ok.to(cuda_device), ext_raw=raw.to(cuda_device))
        torch.cuda.synchronize()
        runs.append((outs, carry))
    _assert_runs_equal(runs)
    assert runs[0][0].feasible[0, 1] <= 1


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["<0,0>", "<1,0>", "<0,1>"])
def test_schedule_lanes_with_extensions_on_card_equals_cpu(cuda_device, case):
    """The per-pod loop: the torch extension ops evaluated against the
    live carry on the card (one kernel launch a pod) give the CPU loop's
    outputs and carry on three lanes, and launch once a pod."""
    snap = EXT_CASES[case]()
    cfg = _ext_cfg(snap, explain_topk=2)
    n = snap.n_nodes
    masks = np.stack([np.ones(n, bool), np.arange(n) % 3 != 0, np.arange(n) % 4 != 1])
    before = dict(step.LAUNCHES)
    got = sched.schedule_lanes(snap.arrays, masks, cfg, device="cuda")
    torch.cuda.synchronize()
    assert step.LAUNCHES["plain_step_ext"] - before["plain_step_ext"] == snap.n_pods
    want = sched.schedule_lanes(snap.arrays, masks, cfg, device="cpu")
    for name in step.StepOutputs._fields:
        assert torch.equal(getattr(got, name).cpu(), getattr(want, name)), name
    for f in sched.STATE_FIELDS:
        assert torch.equal(getattr(got.state, f).cpu(), getattr(want.state, f)), f
