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
extension ops against the CPU's; the loop captured as a CUDA graph with
the pod on the device against the eager loop and the plain step (each
kExt build, pod counts of 1, 2, 3 and 37, 64 lanes) and a callable that
cannot be captured. Without CUDA they skip
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


def test_extension_builds_take_their_cap():
    """The extension library's scan builds take 384 threads a block (168
    registers), the .cu's cap; the launcher plans a config with extension
    ops (and only such a config) under it, the fleet and the wide library
    under theirs."""
    src = Path(SOURCE).read_text(encoding="utf-8")
    caps = dict(re.findall(r"constexpr int (kMaxThreadsExt\w*) = (\d+);", src))
    assert int(caps["kMaxThreadsExt"]) == step.MAX_THREADS_EXT == 384
    assert step.max_threads(0, ext=True) == step.max_threads(step.F_GPU, ext=True) == 384
    assert step.max_threads(0, explain=True, ext=True) == 384
    assert step.max_threads(0, wide=True, ext=True) == step.MAX_THREADS_WIDE
    snap = synthetic_snapshot(2000, 64)
    arrs = sched.device_arrays(snap.arrays, "cpu")
    for cfg, cap in ((_ext_cfg(snap), 384), (sched.make_config(snap), step.MAX_THREADS)):
        flags = step._flags(cfg, sched.init_state(arrs, cfg), False)
        plan = step.plan_for(arrs, cfg, flags, 1, lambda c, *_: 132 if c == 1 else 0)
        assert plan.cluster == 1 and plan.threads <= cap
        assert plan.threads == step.block_geometry(snap.n_nodes, 1, cap)[1]


def test_explain_builds_take_their_caps():
    """The explain library's builds take 384 threads a block (168
    registers; its grouped frozen builds spill at 128), its
    device-resource builds 256 (255); the caps are the .cu's, and the
    launcher's plan for an explain config uses them."""
    src = Path(SOURCE).read_text(encoding="utf-8")
    caps = dict(re.findall(r"constexpr int (kMaxThreads\w*) = (\d+);", src))
    assert int(caps["kMaxThreadsExplain"]) == step.MAX_THREADS_EXPLAIN == 384
    assert int(caps["kMaxThreadsExplainDevRes"]) == step.MAX_THREADS_EXPLAIN_DEVRES == 256
    assert step.max_threads(0, explain=True) == 384
    assert step.max_threads(step.F_GPU, explain=True) == 256
    assert step.max_threads(step.F_GPU, fleet=True, explain=True) == step.MAX_THREADS_WIDE_DEVRES
    snap = synthetic_snapshot(2000, 64, rich=True)
    cfg = sched.make_config(snap, explain_topk=3)
    arrs = sched.device_arrays(snap.arrays, "cpu")
    st = sched.init_state(arrs, cfg)
    flags = step._flags(cfg, sched.SimState(**{f: getattr(st, f)[None]
                                               for f in sched.STATE_FIELDS}), True)
    plan = step.plan_for(arrs, cfg, flags, 2, lambda c, *_: 0 if c > 1 else 132)
    assert plan.threads <= 384 < step.plan_for(arrs, cfg._replace(explain_topk=0), flags, 2,
                                               lambda c, *_: 0 if c > 1 else 132).threads


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
    library; the fifth flag, kExplain, is the library's, and so is the
    sixth, kExt, in the scan builds: never in the frozen form)."""
    src = Path(SOURCE).read_text(encoding="utf-8")
    insts = set(re.findall(r"plain_step_kernel<(true|false), (true|false), (true|false), "
                           r"(true|false), X, (false|E)>", src))
    assert len(insts) == 12
    assert {i[:3] for i in insts if i[3] == "true"} == {
        (a, b, "false") for a in ("true", "false") for b in ("true", "false")}
    assert {i[4] for i in insts if i[3] == "true"} == {"false"}
    assert {i[4] for i in insts if i[3] == "false"} == {"E"}


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


def _hostname_only_snapshot():
    """A cluster whose every term and preference is hostname-keyed, with
    its topology keys cut to none (K1 = 0): the fold has no domain."""
    nodes = [make_valid_node(Node.from_dict({"metadata": {"name": f"n{i}"}, "status": {
        "allocatable": {"cpu": "16", "memory": "64Gi", "pods": "110"}}})) for i in range(24)]
    pods = []
    for i in range(160):
        term = {"labelSelector": {"matchLabels": {"app": f"a{i % 3}"}},
                "topologyKey": "kubernetes.io/hostname"}
        pods.append(Pod.from_dict({
            "metadata": {"name": f"p{i}", "namespace": "default", "labels": {"app": f"a{i % 3}"}},
            "spec": {"containers": [{"name": "c", "resources": {"requests": {
                "cpu": f"{100 + i % 7 * 50}m", "memory": "128Mi"}}}],
                "affinity": {"podAntiAffinity": {
                    "requiredDuringSchedulingIgnoredDuringExecution": [term] if i % 2 else [],
                    "preferredDuringSchedulingIgnoredDuringExecution": [
                        {"weight": 5, "podAffinityTerm": term}]}}}}))
    snap = encode_cluster(nodes, pods)
    a = snap.arrays
    assert not a.term_key.any() and not (a.pref_key * a.pref_valid).any()
    return dataclasses.replace(snap, arrays=dataclasses.replace(a, topo_onehot=a.topo_onehot[:0]))


FOLD_EDGE_CASES = {**FOLD_CASES, "k1=0": _hostname_only_snapshot}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(FOLD_EDGE_CASES))
@pytest.mark.parametrize("edge", [1, 31, 32, 33, 4096, "one-node"])
def test_forced_fold_edges_equal_plain_on_card(cuda_device, case, edge):
    """One chunk of c pods (1, a warp's width and its neighbours, a whole
    4,096-pod chunk), or a whole chunk bound to one node, folded by the
    kernel and by its plain version into a carry that already holds
    counts: every carry field equal (bf16 and f32 carries; K1 = 0)."""
    snap = FOLD_EDGE_CASES[case]()
    cfg = sched.make_config(snap, compact_carry=case != "rich-f32")
    fields = {f: getattr(snap.arrays, f) for f in snap.arrays.__dataclass_fields__}
    n_pods = sched._PREFIX_CHUNK
    reps = -(-n_pods // snap.n_pods)
    for f in sched.POD_FIELDS:
        fields[f] = np.ascontiguousarray(np.concatenate([fields[f]] * reps)[:n_pods])
    a = fields
    plain = ~((a["gpu_cnt"] > 0) | np.any(a["lvm_req"] > 0, axis=1)
              | np.any(a["sdev_req"] > 0, axis=1) | np.any(a["wfc_valid"], axis=1)
              | np.any(a["svol_id"] >= 0, axis=1))
    rng = np.random.default_rng(7)
    if edge == "one-node":
        c, nodes = n_pods, np.where(plain, snap.n_nodes // 2, -1)
        assert (a["req"][plain].sum(0) < 2 ** 24).all()  # every sum exact
    else:
        c = edge
        nodes = np.where(plain & (rng.random(n_pods) < 0.8),
                         rng.integers(0, snap.n_nodes, n_pods), -1)
    nodes = torch.from_numpy(nodes[:c].astype(np.int32))
    arrs = sched.device_arrays(type(snap.arrays)(**fields), cuda_device)
    pre = torch.where(torch.from_numpy(plain), arrs.forced_node.cpu().clamp_min(0), -1)
    base = sched.init_state(arrs, cfg)
    wave.forced_fold_cuda(arrs, cfg, base, 0, n_pods, pre.int().to(cuda_device))
    st_k, st_p = _clone(base), _clone(base)
    wave.forced_fold_cuda(arrs, cfg, st_k, 0, c, nodes.to(cuda_device))
    wave.forced_fold_torch(arrs, cfg, st_p, 0, c, nodes.to(cuda_device))
    torch.cuda.synchronize()
    for f in sched.STATE_FIELDS:
        assert torch.equal(getattr(st_k, f), getattr(st_p, f)), f
    assert (st_k.headroom != base.headroom).any() or not (nodes >= 0).any()


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
    assert "step_body<kInterpod, kDevRes, false, kExplain, true, false>(s_lane)" in src
    assert "step_body<kInterpod, kDevRes, kCols, kExplain, false, kExt>(a)" in src


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
    # the rows are a build of their own: the extension library's scan
    # builds and the wide library's, never the frozen form or the fleet
    assert "constexpr bool kExtScan = kExtLib || kWideLib;" in src
    assert 'static_assert(!(kExt && kFleet), "extension rows in a scan build only");' in src
    assert ('static_assert(!(kFrozen && (kCols || kExt)), "the frozen form has no columns and '
            'no rows");') in src
    assert build.VARIANTS["plain_step_ext"] == ("plain_step", ("-DPLAIN_STEP_EXT=1",))
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


# ---- the extension loop as a CUDA graph -----------------------------------------

LOOP_MODES = ("graph", "eager", "plain")


def _loop_runs(snap, cfg, device, n_lanes=2, columns=False, n_out=None, seed=0):
    """The engine's extension loop (``sched._extension_scan``) over the
    pods after the prefix (the first `n_out` of them), from a template
    carry, three ways on the card: the captured graph replayed, the eager
    loop (a launch a pod from the host) and the plain step through the
    same loop; each with the loop's counters and launches it added."""
    arrs = sched.device_arrays(snap.arrays, device)
    n = snap.n_nodes
    masks = np.stack([np.ones(n, bool), np.arange(n) % 3 != 0, np.arange(n) % 4 != 1])
    masks = np.resize(masks, (n_lanes, n))
    active = torch.from_numpy(masks).to(device)
    hoist, inv = sched.hoist_of(arrs, active), sched.inv_alloc_of(arrs.alloc)
    tmpl = sched.init_state(arrs, cfg)
    p0 = cfg.forced_prefix
    if p0:
        tmpl = sched.apply_forced_prefix(arrs, cfg, tmpl, p0)
    p1 = snap.n_pods if n_out is None else p0 + n_out
    dis = nom = None
    if columns:
        d, m = preemption_columns(snap.arrays.forced_node, masks[0], seed=seed)
        dis, nom = torch.from_numpy(d).to(device), torch.from_numpy(m.astype(np.int32)).to(device)
    runs = {}
    for mode in LOOP_MODES:
        carry = sched.lane_carry(tmpl, n_lanes)
        loop0, launch0 = dict(sched.EXTENSION_LOOP), dict(step.LAUNCHES)
        outs = sched._extension_scan(arrs, active, hoist, inv, carry, tmpl, cfg, p0, p1, dis,
                                     nom, None, plain=mode == "plain", graph=mode == "graph")
        torch.cuda.synchronize()
        runs[mode] = ((step.StepOutputs(*outs), carry),
                      {k: v - loop0[k] for k, v in sched.EXTENSION_LOOP.items()},
                      step.LAUNCHES["plain_step_ext"] - launch0["plain_step_ext"])
    return runs, p1 - p0


def _assert_loops_equal(runs, n_out):
    """The graph path equals the eager loop and the plain step, bit for
    bit; it captured one graph, replayed it for every pod after the first
    and counted one launch a pod, as the eager loop did."""
    _assert_ext_runs_equal([runs["graph"][0], runs["eager"][0]])
    _assert_ext_runs_equal([runs["graph"][0], runs["plain"][0]])
    replays = n_out - 1 if n_out > 1 else 0
    assert runs["graph"][1] == {"graphs": int(n_out > 1), "replays": replays, "eager": 0}
    assert runs["eager"][1] == runs["plain"][1] == {"graphs": 0, "replays": 0, "eager": 0}
    assert runs["graph"][2] == runs["eager"][2] == n_out and runs["plain"][2] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(EXT_CASES))
@pytest.mark.parametrize("columns", [False, True])
@pytest.mark.parametrize("explain", [False, True])
def test_extension_graph_equals_eager_and_plain_on_card(cuda_device, case, columns, explain):
    """Every kExt build (<I,D>, +columns, +explain) through the engine's
    loop at two lanes: the graph replayed with the pod on the device
    equals the eager loop and the plain step, every output and carry
    field."""
    snap = EXT_CASES[case]()
    over = dict(explain_topk=3, tie_break_seed=5) if explain else {}
    cfg = _ext_cfg(snap, **over)
    want = case + ("+columns" if columns else "") + ("+explain" if explain else "")
    st = sched.init_state(sched.device_arrays(snap.arrays, "cpu"), cfg)
    assert step.instantiation(cfg, st, columns=columns) == want
    runs, n_out = _loop_runs(snap, cfg, cuda_device, columns=columns)
    _assert_loops_equal(runs, n_out)
    out = runs["graph"][0][0]
    assert (out.node >= 0).any() and out.fail_counts[..., cfg.n_ops - 2:].sum() > 0


@pytest.mark.cuda
@pytest.mark.parametrize("n_out", [1, 2, 3, 37])
def test_extension_graph_pod_counts_on_card(cuda_device, n_out):
    """Pod counts that no unroll divides (and one pod, which captures
    nothing), after a forced prefix that shifts the cursor."""
    snap = synthetic_snapshot(96, 160, bound=0.2)
    cfg = _ext_cfg(snap, forced_prefix=sched.make_config(snap).forced_prefix)
    assert cfg.forced_prefix > 0
    runs, got = _loop_runs(snap, cfg, cuda_device, n_out=n_out)
    assert got == n_out
    _assert_loops_equal(runs, n_out)


@pytest.mark.cuda
def test_extension_graph_at_64_lanes_on_card(cuda_device):
    """64 lanes vmapped through the callables, each lane its own mask:
    the graph path equals the eager loop and the plain step."""
    snap = synthetic_snapshot(96, 160, rich=True, bound=0.2)
    cfg = _ext_cfg(snap)
    runs, n_out = _loop_runs(snap, cfg, cuda_device, n_lanes=64, n_out=48)
    _assert_loops_equal(runs, n_out)


@pytest.mark.cuda
def test_uncapturable_callable_runs_eagerly_on_card(cuda_device, caplog):
    """A callable that copies from host memory cannot be captured: the
    loop names it in a logged warning, counts an eager loop and runs every
    pod eagerly, to the plain step's outputs."""
    from open_simulator_tpu_torch.engine.extensions import ExtensionOp
    from open_simulator_tpu_torch.testing.synthetic import synthetic_extensions

    host_copy = ExtensionOp(name="host-copy", weight=1.0, score_fn=lambda state, arrs, x: (
        torch.tensor([float(i % 3) for i in range(arrs.alloc.shape[0])],
                     device=arrs.alloc.device)))
    snap = synthetic_snapshot(96, 160, bound=0.2)
    cfg = sched.make_config(snap, extensions=synthetic_extensions() + (host_copy,))
    with caplog.at_level("WARNING", logger=sched.__name__):
        runs, n_out = _loop_runs(snap, cfg, cuda_device, n_out=24)
    _assert_ext_runs_equal([runs["graph"][0], runs["plain"][0]])
    assert runs["graph"][1] == {"graphs": 0, "replays": 0, "eager": 1}
    assert runs["graph"][2] == n_out
    msg = " ".join(r.getMessage() for r in caplog.records)
    assert "'host-copy' (score_fn)" in msg and "capture rule" in msg
    assert "prefer-free-cpu" not in msg


# ---- the top-k's passes ------------------------------------------------------

# the top-k's passes (kernels/step.TOPK_PASS candidates a cluster round):
# K of 1 and 3 (one pass), at the pass width, one past it, past two passes,
# and K = N; ties (identical synthetic nodes, no jitter), fewer feasible
# nodes than K (the bound, device-resource and tiny inputs), a NaN
# extension score. No input holds a -0.0 masked score: the score starts
# from +0.0 (scores.resource_scores_fused) and a round-to-nearest sum is
# -0.0 only when every addend is; the +0/-0 order of the key is held to
# lax.top_k on the CPU (tests/test_torch_explain.py).
TOPK_KS = (1, 3, step.TOPK_PASS, step.TOPK_PASS + 1, 2 * step.TOPK_PASS + 1, "N")
TOPK_DEPTH = 48  # pods a launch


def _topk_runs(snap, cfg, device, columns=False, ext=False, n_lanes=2):
    """The kernel and the plain step over the first TOPK_DEPTH pods after
    the prefix, from a template carry (with the preemption columns, or
    seeded extension rows with a NaN score every third pod)."""
    from open_simulator_tpu_torch.testing.synthetic import random_extension_rows

    arrs = sched.device_arrays(snap.arrays, device)
    n = snap.n_nodes
    masks = np.stack([np.ones(n, bool), np.arange(n) % 3 != 0])[:n_lanes]
    active = torch.from_numpy(masks).to(device)
    hoist, inv = sched.hoist_of(arrs, active), sched.inv_alloc_of(arrs.alloc)
    tmpl = sched.init_state(arrs, cfg)
    p0 = cfg.forced_prefix
    if p0:
        tmpl = sched.apply_forced_prefix(arrs, cfg, tmpl, p0)
    p1 = min(snap.n_pods, p0 + TOPK_DEPTH)
    kw = {}
    if columns:
        dis, nom = preemption_columns(snap.arrays.forced_node, masks[0], seed=4)
        kw.update(disabled=torch.from_numpy(dis).to(device),
                  nominated=torch.from_numpy(nom.astype(np.int32)).to(device))
    if ext:
        ok, raw = random_extension_rows(cfg, n_lanes, p1 - p0, n, seed=3, nan=True)
        kw.update(ext_ok=ok.to(device), ext_raw=raw.to(device))
    runs = []
    for fn in (step.plain_step_cuda, step.plain_step_torch):
        carry = sched.lane_carry(tmpl, n_lanes)
        outs = fn(arrs, active, hoist, inv, carry, cfg, p0, p1, template=tmpl, **kw)
        torch.cuda.synchronize()
        runs.append((outs, carry))
    return runs


def _topk(k, n_nodes):
    return n_nodes if k == "N" else k


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(EXPLAIN_SNAPSHOTS))
@pytest.mark.parametrize("k", TOPK_KS)
@pytest.mark.parametrize("columns", [False, True])
def test_topk_passes_equal_plain_step_on_card(cuda_device, case, k, columns):
    """Each scan build's explain twin, and with the preemption columns
    its "+columns+explain" twin, at every K of TOPK_KS: the top-k
    tensors, every output and carry field equal the plain step's, bit
    for bit, and the fillers past the feasible nodes are ranked too."""
    snap = EXPLAIN_SNAPSHOTS[case]()
    over = dict(forced_prefix=0) if columns else {}
    cfg = sched.make_config(snap, explain_topk=_topk(k, snap.n_nodes), **over)
    runs = _topk_runs(snap, cfg, cuda_device, columns=columns)
    _assert_runs_equal(runs)
    out = runs[0][0]
    assert out.topk_node.shape[2] == min(cfg.explain_topk, snap.n_nodes)
    assert (out.topk_node >= 0).all() and (out.topk_node[..., 0] >= 0).all()
    if k == "N":
        assert (out.topk_score <= -1e37).any()  # fewer feasible nodes than K


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(EXT_CASES))
@pytest.mark.parametrize("k", TOPK_KS)
def test_topk_passes_with_extension_rows_on_card(cuda_device, case, k):
    """The scan builds' explain twins with the extension rows: seeded rows,
    a NaN score every third pod (it keys above every node, as in the
    pick), at every K of TOPK_KS, equal to the plain step."""
    snap = EXT_CASES[case]()
    cfg = _ext_cfg(snap, explain_topk=_topk(k, snap.n_nodes))
    runs = _topk_runs(snap, cfg, cuda_device, ext=True)
    _assert_ext_runs_equal(runs)
    assert runs[0][0].topk_score.isnan().any()


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(FROZEN_CASES))
@pytest.mark.parametrize("k", TOPK_KS)
def test_topk_passes_frozen_equal_plain_on_card(cuda_device, case, k):
    """The "+frozen+explain" builds over the first two waves of a pools
    GRID, at every K of TOPK_KS: equal to the plain step's frozen form."""
    snap = wave_pools_snapshot(96, 768, 8, **FROZEN_CASES[case])
    cfg = sched.make_config(snap, explain_topk=_topk(k, snap.n_nodes))
    lo, _, kind, w = wave_plans.waves_for(snap.arrays, cfg).segments[0]
    assert kind == wave_plans.GRID
    arrs = sched.device_arrays(snap.arrays, cuda_device)
    n = snap.n_nodes
    active = torch.from_numpy(np.stack([np.ones(n, bool), np.arange(n) % 5 != 2])).to(cuda_device)
    hoist, inv = sched.hoist_of(arrs, active), sched.inv_alloc_of(arrs.alloc)
    tmpl = sched.init_state(arrs, cfg)
    st = sched.lane_carry(tmpl, 2)
    step.copy_template(st, tmpl)
    for w0 in range(lo, lo + 2 * w, w):
        st_p = _clone(st)
        out_k = step.plain_step_cuda(arrs, active, hoist, inv, st, cfg, w0, w0 + w, frozen=True)
        out_p = step.plain_step_torch(arrs, active, hoist, inv, st_p, cfg, w0, w0 + w,
                                      frozen=True)
        torch.cuda.synchronize()
        _assert_runs_equal([(out_k, st), (out_p, st_p)])
        pick = out_k.gpu_pick if cfg.enable_gpu else None
        wave.wave_merge_cuda(arrs, cfg, st, w0, w0 + w, out_k.node, pick)


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(FLEET_CASES))
@pytest.mark.parametrize("k", TOPK_KS)
def test_topk_passes_fleet_equal_plain_on_card(cuda_device, case, k):
    """The fleet builds' explain twins (three clusters of one shape, one
    launch) at every K of TOPK_KS: equal to the plain fleet."""
    snap = FLEET_CASES[case]()
    cfg = sched.make_config(snap, explain_topk=_topk(k, snap.n_nodes))
    kp = cfg.forced_prefix
    lanes_k, lanes_p = _fleet(snap, cfg, 3, cuda_device), _fleet(snap, cfg, 3, cuda_device)
    out_k = step.plain_step_fleet_cuda(lanes_k, cfg, kp, kp + TOPK_DEPTH)
    out_p = step.plain_step_fleet_torch(lanes_p, cfg, kp, kp + TOPK_DEPTH)
    torch.cuda.synchronize()
    for ok, op, lk, lp in zip(out_k, out_p, lanes_k, lanes_p):
        _assert_runs_equal([(ok, lk.state), (op, lp.state)])


@pytest.mark.cuda
@pytest.mark.parametrize("rich", [False, True])
@pytest.mark.parametrize("k", TOPK_KS)
def test_topk_passes_in_the_wide_library_on_card(cuda_device, rich, k):
    """The wide library's explain builds (the walks past their widths) at
    every K of TOPK_KS: equal to the plain step."""
    snap = _wide_devres(rich)
    cfg = sched.make_config(snap, explain_topk=_topk(k, snap.n_nodes))
    runs = _topk_runs(snap, cfg, cuda_device)
    assert step.LAST_PLAN.wide
    _assert_runs_equal(runs)


# ---- the staged regions: the pod's scalars, the node rows, the class rows --


def _c_sum(exprs, env):
    """The sum of C width expressions (`a.x`, `dev ? a.x : 0`) under env."""
    total = 0
    for e in exprs:
        e = re.sub(r"(\w+) \? ([^:]+) : (\w+)", r"(\2 if \1 else \3)", e)
        total += eval(re.sub(r"a\.(\w+)", r"env['\1']", e), {"env": env}, dict(env))
    return total


@pytest.mark.parametrize("kind", ["northstar", "rich", "devres"])
def test_pod_words_mirror_the_kernels_pod_region(kind):
    """pod_words is pod_lay's size: the term records and word rows, then
    the byte rows rounded up to words, the whole to 4 words, read from the
    .cu and evaluated at the snapshot's widths."""
    snap = {"northstar": lambda: synthetic_snapshot(40, 64),
            "rich": lambda: synthetic_snapshot(40, 64, rich=True),
            "devres": lambda: device_resource_snapshot(40, 96)}[kind]()
    cfg = sched.make_config(snap)
    arrs = sched.device_arrays(snap.arrays, "cpu")
    st = sched.init_state(arrs, cfg)
    flags = step._flags(cfg, sched.SimState(**{f: getattr(st, f)[None]
                                               for f in sched.STATE_FIELDS}), True)
    src = Path(SOURCE).read_text(encoding="utf-8")
    body = re.search(r"inline PodLay pod_lay\(const StepArgs& a\) \{(.*?)\n\}", src, re.S).group(1)
    a = arrs
    env = dict(r=a.alloc.shape[1], cs=a.spread_group.shape[1], a=a.aff_group.shape[1],
               b=a.anti_group.shape[1], ap=a.pref_group.shape[1], pt=a.ports.shape[1],
               sg=a.match_groups.shape[1], t2=a.hit_pref.shape[1], lv=a.lvm_req.shape[1],
               ev=a.sdev_req.shape[1], lw=a.wfc_ccid.shape[1], lk=a.vol_limit_req.shape[1],
               lsv=a.svol_id.shape[1], hit_w=step.hit_width(arrs, cfg),
               dev=bool(flags & step.DEVRES_FLAGS))
    words = _c_sum(re.findall(r"\bw \+= ([^;]+);", body), env)
    bytes_ = _c_sum(re.findall(r"\bb \+= ([^;]+);", body), env)
    assert step.pod_words(arrs, cfg) == -(-(words + -(-bytes_ // 4)) // 4) * 4
    assert "l.words = (w + (b + 3) / 4 + 3) & ~3;" in body
    assert step.smem_widths(arrs, cfg, flags).pod == step.pod_words(arrs, cfg)
    if kind == "rich":
        assert env["hit_w"] == a.hit_terms.shape[1] > 0
    assert step.hit_width(arrs, cfg._replace(enable_anti_affinity=False)) == 0


def test_smem_bytes_counts_the_staged_regions():
    """smem_bytes mirrors layout_of's staged regions: the pod region twice
    (always), the class rows twice at the slice padded to 16 nodes
    (RES_STAGE_CLASS), the node rows' words and bytes a node
    (RES_STAGE_NODE); the .cu's layout_of, slp_of and cls_bytes say the
    same."""
    w = step.SmemWidths(ops=5, q=3, d=4, cs=2, dom=24, rows=5, r=6, npv=7, pod=9, node_w=4,
                        node_b=3, cls=10)
    base = step.smem_bytes(w, 10, True)
    assert base == step.smem_bytes(w._replace(pod=0), 10, True) + 4 * 2 * 9
    assert base == step.smem_bytes(w._replace(node_w=0, node_b=0, cls=0), 10, True)
    assert step.smem_bytes(w, 10, True, stage=step.RES_STAGE_NODE) == base + 4 * 4 * 10 + 3 * 10
    assert step.smem_bytes(w, 10, True, stage=step.RES_STAGE_CLASS) == base + 2 * 10 * 16
    assert step.smem_bytes(w, 33, False, stage=step.STAGE_ALL) == (
        step.smem_bytes(w, 33, False) + 2 * 10 * 48 + 4 * 4 * 33 + 3 * 33)
    src = Path(SOURCE).read_text(encoding="utf-8")
    body = re.search(r"inline Layout layout_of\(const StepArgs& a\) \{(.*?)\n\}", src, re.S).group(1)
    for part in ("2 * cls_bytes(a) / 4", "2 * pod_lay(a).words", "(3 + a.k1) * a.sl",
                 "(2 + a.k) * a.sl", "RES_STAGE_CLASS", "RES_STAGE_NODE"):
        assert part in body, part
    assert "return (a.sl + 15) & ~15;" in src
    assert "inline int cls_bytes(const StepArgs& a) { return 10 * slp_of(a); }" in src
    bits = dict(re.findall(r"constexpr int (RES_\w+) = (\d+);", src))
    assert {k: int(v) for k, v in bits.items()} == {
        n: getattr(step, n) for n in ("RES_HEADROOM", "RES_DOM_GLOBAL", "RES_COLS_GLOBAL",
                                      "RES_STAGE_NODE", "RES_STAGE_CLASS")}


def test_placements_drop_the_staged_regions_first():
    """PLACEMENTS tries every region staged, then drops the class rows'
    copies, then the node rows, and only then the placements of before
    (headroom out of shared memory, the replica and partials in global
    memory); a launch outside the wide library never puts those in global
    memory, and a one-pod launch stages nothing."""
    stages = [pl[3] for pl in step.PLACEMENTS]
    assert stages[:3] == [step.STAGE_ALL, step.RES_STAGE_NODE, step.UNSTAGED]
    assert not any(stages[3:])
    assert [pl[:3] for pl in step.PLACEMENTS[2:]] == [
        (True, False, False), (False, False, False), (False, True, False),
        (False, False, True), (False, True, True)]
    assert step.placements_for(False) == step.PLACEMENTS[:4]
    assert step.placements_for(True) == step.PLACEMENTS
    assert step.placements_for(False, one_pod=True) == (
        (True, False, False, 0), (False, False, False, 0))
    assert all(not pl[3] for pl in step.placements_for(True, one_pod=True))
    assert [pl[3] for pl in step.placements_for(False, flags=step.F_GPU)] == [
        step.RES_STAGE_NODE, step.UNSTAGED, step.UNSTAGED]
    assert [pl[3] for pl in step.placements_for(False, flags=step.F_GPU | step.F_AFF)] == [
        step.UNSTAGED, step.UNSTAGED]
    assert set(step.PLACEMENT_NAMES.values()) == {0, step.RES_STAGE_NODE,
                                                  step.RES_STAGE_CLASS, step.STAGE_ALL}


def test_extension_one_pod_launches_keep_headroom_in_global_memory():
    """The extension loop's one-pod launches never copy the headroom slice
    into shared memory (nor write it all back); the frozen form's one-pod
    launches and the scans keep the placements they had."""
    assert step.placements_for(False, one_pod=True, headroom=False) == ((False, False, False, 0),)
    assert all(not pl[0] for pl in step.placements_for(True, one_pod=True, headroom=False))
    snap = synthetic_snapshot(96, 160, bound=0.2)
    arrs = sched.device_arrays(snap.arrays, "cpu")
    occupancy = lambda *_: 64  # noqa: E731
    for cfg, one_pod, frozen, hr in ((_ext_cfg(snap), True, False, False),
                                     (_ext_cfg(snap), False, False, True),
                                     (sched.make_config(snap), True, True, True),
                                     (sched.make_config(snap), False, False, True)):
        flags = step._flags(cfg, sched.init_state(arrs, cfg), False)
        plan = step.plan_for(arrs, cfg, flags, 1, occupancy, one_pod=one_pod, frozen=frozen)
        assert plan.headroom is hr, (cfg.extensions, one_pod, frozen)


@pytest.mark.parametrize("stage", [step.STAGE_ALL, step.RES_STAGE_NODE, step.UNSTAGED])
def test_launch_plan_drops_staged_regions_that_do_not_fit(stage, monkeypatch):
    """64 lanes of 5,184 nodes (C = 2, 2,592-node slices): with room for
    exactly one of the staged placements, the plan takes it, the headroom
    rows still in shared memory; one byte less and it takes the next."""
    w = _WIDTHS._replace(pod=40, node_w=4, node_b=4, cls=10)
    need = step.smem_bytes(w, 2592, True, stage=stage)
    monkeypatch.setattr(step, "_SMEM_LIMIT", need)
    plan = step.plan_launch(64, 5184, w, lambda c, *_: _OCCUPANCY[c],
                            placements=step.placements_for(False))
    assert (plan.cluster, plan.slice_len, plan.stage, plan.headroom) == (2, 2592, stage, True)
    assert plan.smem == need and step.placement_name(plan) in step.PLACEMENT_NAMES
    monkeypatch.setattr(step, "_SMEM_LIMIT", need - 1)
    nxt = step.plan_launch(64, 5184, w, lambda c, *_: _OCCUPANCY[c],
                           placements=step.placements_for(False))
    order = step.placements_for(False)
    at = next(i for i, pl in enumerate(order) if pl == (True, False, False, stage))
    assert (nxt.headroom, nxt.dom_global, nxt.cols_global, nxt.stage) == order[at + 1]


def test_64_lane_plan_takes_a_larger_cluster_at_two_blocks_an_sm():
    """Where the card holds two blocks an SM (an occupancy answer twice
    the one-block one), the 64-lane plan takes C = 4: half the nodes a
    block, the same warps a block, twice the warps an SM."""
    one_block = step.plan_launch(64, 5184, _WIDTHS, lambda c, *_: _OCCUPANCY[c])
    two = {c: 2 * 132 // c for c in step.CLUSTER_SIZES}
    two_blocks = step.plan_launch(64, 5184, _WIDTHS, lambda c, *_: two[c])
    assert (one_block.cluster, one_block.slice_len, one_block.threads) == (2, 2592, 448)
    assert (two_blocks.cluster, two_blocks.slice_len, two_blocks.threads) == (4, 1296, 448)
    assert two_blocks.resident >= 64


@pytest.mark.parametrize("kind", ["rich", "devres"])
def test_pod_pack_and_class_packs(kind):
    """The bulk copies' host-built sources: each pod's region (its term
    records, request bits, padded hit list, then the port, match-group and
    preferred-hit bytes, pod_words wide), and each class's rows cut into
    the plan's block slices, padded to 16 nodes, f32 rows then byte rows."""
    snap = (synthetic_snapshot(50, 64, rich=True) if kind == "rich"
            else device_resource_snapshot(50, 96))
    cfg = sched.make_config(snap)
    arrs = sched.device_arrays(snap.arrays, "cpu")
    ptr, idx = step.term_lists(arrs.hit_terms)
    pack = step.pod_pack(arrs, cfg, ptr, idx)
    assert pack.shape == (snap.n_pods, step.pod_words(arrs, cfg)) and pack.dtype == torch.int32
    a_, b_, cs, ap = (getattr(arrs, f).shape[1] for f in ("aff_group", "anti_group",
                                                          "spread_group", "pref_group"))
    q, r, hit_w = a_ + b_ + cs + ap, arrs.alloc.shape[1], step.hit_width(arrs, cfg)
    assert bool(hit_w) == (kind == "rich")
    for p in range(0, snap.n_pods, 7):
        rec = pack[p, :4 * q].view(q, 4)
        for i in range(a_):
            assert rec[i].tolist() == [int(arrs.aff_group[p, i]), int(arrs.aff_key[p, i]),
                                       int(arrs.aff_valid[p, i]) | int(arrs.aff_self[p, i]) << 1, 0]
        for c in range(cs):
            row = rec[a_ + b_ + c]
            soft = bool(arrs.spread_valid[p, c] and not arrs.spread_hard[p, c])
            hard = bool(arrs.spread_valid[p, c] and arrs.spread_hard[p, c])
            assert row[:3].tolist() == [int(arrs.spread_group[p, c]), int(arrs.spread_key[p, c]),
                                        int(soft) | int(hard) << 1]
            assert row[3:].view(torch.float32).item() == float(arrs.spread_skew[p, c])
        for i in range(ap):
            row = rec[a_ + b_ + cs + i]
            assert int(row[2]) == (int(arrs.pref_tid[p, i]) if arrs.pref_valid[p, i] else -1)
        assert torch.equal(pack[p, 4 * q:4 * q + r].view(torch.float32), arrs.req[p].float())
        n_hit = int(ptr[p + 1] - ptr[p])
        hits = pack[p, 4 * q + r:4 * q + r + hit_w]
        assert hits[:n_hit].tolist() == idx[ptr[p]:ptr[p + 1]].tolist()
        assert (hits[n_hit:] == -1).all()
        raw = pack[p, 4 * q + r + hit_w:].contiguous().view(torch.uint8)
        pt, sg, t2 = arrs.ports.shape[1], arrs.match_groups.shape[1], arrs.hit_pref.shape[1]
        want = torch.cat([arrs.ports[p], arrs.match_groups[p], arrs.hit_pref[p]]).to(torch.uint8)
        assert torch.equal(raw[:pt + sg + t2], want) and not raw[pt + sg + t2:].any()
    plan = step.LaunchPlan(4, 32, 13, True, 0, 0, stage=step.STAGE_ALL)
    cls = step.class_packs(arrs, plan)
    n_cls, slp = arrs.class_affinity.shape[0], 16
    assert cls.shape == (n_cls, 4, 10 * slp) and cls.dtype == torch.uint8
    for c in range(n_cls):
        for rk in range(4):
            row = cls[c, rk]
            na, tt = row[:4 * slp].view(torch.float32), row[4 * slp:8 * slp].view(torch.float32)
            aff, taint = row[8 * slp:9 * slp], row[9 * slp:]
            lo, hi = rk * 13, min(rk * 13 + 13, 50)
            assert torch.equal(na[:hi - lo], arrs.class_node_aff_score[c, lo:hi].float())
            assert torch.equal(tt[:hi - lo], arrs.class_taint_prefer[c, lo:hi].float())
            assert torch.equal(aff[:hi - lo], arrs.class_affinity[c, lo:hi].to(torch.uint8))
            assert torch.equal(taint[:hi - lo], arrs.class_taint[c, lo:hi].to(torch.uint8))
            for t in (na, tt, aff, taint):
                assert not t[hi - lo:].any()


def _staged_runs(snap, cfg, masks, device, spans, monkeypatch=None, stage=None):
    """The kernel and the plain step over the same pod spans in turn (each
    span a launch on the carry the last one left), from the template:
    (outputs of each span, carry) for each; with `stage`, plan_launch held
    to that staging."""
    if stage is not None:
        monkeypatch.setattr(step, "PLACEMENTS", step.placements_held_to(stage))
    arrs = sched.device_arrays(snap.arrays, device)
    active = torch.from_numpy(masks).to(device)
    hoist, inv = sched.hoist_of(arrs, active), sched.inv_alloc_of(arrs.alloc)
    tmpl = sched.init_state(arrs, cfg)
    if cfg.forced_prefix:
        tmpl = sched.apply_forced_prefix(arrs, cfg, tmpl, cfg.forced_prefix)
    runs, plans = [], []
    for fn in (step.plain_step_cuda, step.plain_step_torch):
        st = sched.lane_carry(tmpl, len(masks))
        outs, inputs = [], {}
        for i, (p0, p1) in enumerate(spans):
            kw = {"inputs": inputs} if fn is step.plain_step_cuda else {}
            outs.append(fn(arrs, active, hoist, inv, st, cfg, p0, p1,
                           template=tmpl if i == 0 else None, **kw))
            if fn is step.plain_step_cuda:
                plans.append(step.LAST_PLAN)
        torch.cuda.synchronize()
        runs.append((outs, st))
    (outs_k, st_k), (outs_p, st_p) = runs
    for ok, op in zip(outs_k, outs_p):
        for a, b in zip(ok, op):
            assert torch.equal(a, b)
    for f in sched.STATE_FIELDS:
        assert torch.equal(getattr(st_k, f), getattr(st_p, f)), f
    return outs_k, plans


@pytest.mark.cuda
@pytest.mark.parametrize("stage", [step.STAGE_ALL, step.RES_STAGE_NODE, step.UNSTAGED])
def test_staged_unaligned_slices_equal_plain_on_card(cuda_device, stage, monkeypatch):
    """The rich cluster at 509 nodes (no class row starts 16-byte aligned)
    on 3 lanes, each staging the plan can take: bit for bit the plain
    step, and the plan records the staging it ran."""
    snap = synthetic_snapshot(509, 384, rich=True)
    cfg = sched.make_config(snap)
    n = snap.n_nodes
    masks = np.stack([np.ones(n, bool), np.arange(n) % 3 != 1, np.arange(n) % 4 != 0])
    outs, plans = _staged_runs(snap, cfg, masks, cuda_device, [(cfg.forced_prefix, snap.n_pods)],
                               monkeypatch, stage)
    assert plans[0].stage == stage and plans[0].cluster > 1
    assert (outs[0].node >= 0).any()


@pytest.mark.cuda
def test_staged_class_changing_every_pod_on_card(cuda_device):
    """A class that changes every pod (the rich cluster's classes dealt
    round robin): every pod's copies land in the other buffer, each pod
    reads its own class rows; bit for bit the plain step."""
    snap = synthetic_snapshot(96, 512, rich=True)
    n_cls = snap.arrays.class_affinity.shape[0]
    cid = (np.arange(snap.n_pods) % n_cls).astype(snap.arrays.class_id.dtype)
    snap = dataclasses.replace(snap, arrays=dataclasses.replace(snap.arrays, class_id=cid))
    cfg = sched.make_config(snap)
    n = snap.n_nodes
    masks = np.stack([np.ones(n, bool), np.arange(n) % 5 != 3])
    outs, plans = _staged_runs(snap, cfg, masks, cuda_device, [(cfg.forced_prefix, snap.n_pods)])
    assert plans[0].stage == step.STAGE_ALL and n_cls > 2
    assert (outs[0].node >= 0).any()


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["<1,0>", "<0,1>"])
def test_staged_one_pod_and_later_launches_on_card(cuda_device, case):
    """A launch of one pod (its region and class rows copied in the
    prologue, no pod ahead), then one from p0 > 0 on the carry it left,
    then the rest: bit for bit the plain step over the same spans (the
    device-resource build stages no class rows)."""
    snap = (synthetic_snapshot(96, 384, rich=True) if case == "<1,0>"
            else device_resource_snapshot(96, 512))
    cfg = sched.make_config(snap)
    k, n = cfg.forced_prefix, snap.n_nodes
    masks = np.stack([np.ones(n, bool), np.arange(n) % 3 != 0])
    spans = [(k, k + 1), (k + 1, k + 37), (k + 37, snap.n_pods)]
    outs, plans = _staged_runs(snap, cfg, masks, cuda_device, spans)
    want = step.RES_STAGE_NODE if case == "<0,1>" else step.STAGE_ALL
    assert all(pl.stage == want for pl in plans)
    assert step.instantiation(cfg, sched.init_state(sched.device_arrays(snap.arrays, "cpu"),
                                                    cfg)) == case


@pytest.mark.cuda
def test_staged_beside_unstaged_launch_on_card(cuda_device, monkeypatch):
    """The same launch staged (the plan's own choice) and held unstaged:
    equal outputs and carries, each equal to the plain step."""
    snap = synthetic_snapshot(200, 512, rich=True, bound=0.2)
    cfg = sched.make_config(snap)
    n = snap.n_nodes
    masks = np.stack([np.ones(n, bool), np.arange(n) % 4 != 1])
    span = [(cfg.forced_prefix, snap.n_pods)]
    staged, plans_s = _staged_runs(snap, cfg, masks, cuda_device, span)
    unstaged, plans_u = _staged_runs(snap, cfg, masks, cuda_device, span, monkeypatch,
                                     step.UNSTAGED)
    assert plans_s[0].stage == step.STAGE_ALL and plans_u[0].stage == step.UNSTAGED
    assert plans_s[0].smem > plans_u[0].smem
    for a, b in zip(staged[0], unstaged[0]):
        assert torch.equal(a, b)


def _many_term_snapshot(n_terms, n_nodes=64, n_pods=384):
    """A cluster of `n_terms` required anti-affinity terms: pod i carries
    app a{i % n_terms} and keeps off the zone (even i) or the node (odd
    i) of app a{(i + 1) % n_terms}, so every pod hits one of n_terms
    distinct (group, key) terms."""
    from open_simulator_tpu_torch.encode.snapshot import encode_cluster
    from open_simulator_tpu_torch.k8s.loader import make_valid_node
    from open_simulator_tpu_torch.k8s.objects import Node, Pod

    rng = np.random.RandomState(3)
    zone, host = "topology.kubernetes.io/zone", "kubernetes.io/hostname"
    nodes = [Node.from_dict({
        "metadata": {"name": f"n{i}", "labels": {zone: f"z{i % 16}", host: f"n{i}"}},
        "status": {"allocatable": {"cpu": "16", "memory": "64Gi", "pods": 110}}})
        for i in range(n_nodes)]
    pods = []
    for i in range(n_pods):
        g = i % n_terms
        spec = {"containers": [{"name": "c", "resources": {"requests": {
                    "cpu": f"{rng.randint(100, 1500)}m",
                    "memory": f"{rng.randint(64, 2048)}Mi"}}}],
                "affinity": {"podAntiAffinity": {
                    "requiredDuringSchedulingIgnoredDuringExecution": [{
                        "labelSelector": {"matchLabels": {"app": f"a{(g + 1) % n_terms}"}},
                        "topologyKey": zone if g % 2 == 0 else host}]}}}
        pods.append(Pod.from_dict({"metadata": {"name": f"p{i}", "namespace": "default",
                                                "labels": {"app": f"a{g}"}},
                                   "spec": spec}))
    return encode_cluster([make_valid_node(n) for n in nodes], pods)


@pytest.mark.parametrize("n_terms", [step.MAX_HITS_STAGED, step.MAX_HITS_STAGED + 12])
def test_hit_lists_past_the_staged_width_stay_in_global_memory(n_terms):
    """Up to MAX_HITS_STAGED hit terms each pod's list is part of its
    staged region; past it the region holds none (hit_w 0: the kernel
    reads hit_ptr / hit_idx), and the pod pack is that much narrower."""
    snap = _many_term_snapshot(n_terms)
    cfg = sched.make_config(snap)
    arrs = sched.device_arrays(snap.arrays, "cpu")
    assert cfg.enable_anti_affinity and arrs.hit_terms.shape[1] == n_terms
    assert arrs.hit_terms.any(1).all()
    staged = n_terms <= step.MAX_HITS_STAGED
    assert step.hit_width(arrs, cfg) == (n_terms if staged else 0)
    hit_ptr, hit_idx = step.term_lists(arrs.hit_terms)
    pack = step.pod_pack(arrs, cfg, hit_ptr, hit_idx)
    assert pack.shape == (snap.n_pods, step.pod_words(arrs, cfg))
    without = step.pod_words(arrs, cfg._replace(enable_anti_affinity=False))
    assert step.pod_words(arrs, cfg) - without == (-(-n_terms // 4) * 4 if staged else 0)


@pytest.mark.cuda
@pytest.mark.parametrize("n_terms", [step.MAX_HITS_STAGED, step.MAX_HITS_STAGED + 12])
def test_hit_lists_past_the_staged_width_equal_plain_on_card(cuda_device, n_terms):
    """The anti-affinity cluster at MAX_HITS_STAGED hit terms (each pod's
    list staged) and past it (read from hit_ptr / hit_idx), on 2 lanes,
    one pod then the rest: bit for bit the plain step."""
    snap = _many_term_snapshot(n_terms)
    cfg = sched.make_config(snap)
    k, n = cfg.forced_prefix, snap.n_nodes
    masks = np.stack([np.ones(n, bool), np.arange(n) % 3 != 2])
    outs, plans = _staged_runs(snap, cfg, masks, cuda_device,
                               [(k, k + 1), (k + 1, snap.n_pods)])
    assert plans[-1].stage == step.STAGE_ALL
    assert (outs[-1].node >= 0).any() and outs[-1].fail_counts.sum() > 0


@pytest.mark.cuda
def test_staged_devres_64_lanes_on_card(cuda_device):
    """plain_step<0,1> over 64 lanes of the capacity sweep's counts: lanes
    0, 21, 42 and 63 of the 64-lane launch equal the plain step over those
    lanes alone."""
    from open_simulator_tpu_torch.parallel.sweep import active_masks_for_counts

    snap = device_resource_snapshot(192, 448, max_new=64)
    cfg = sched.make_config(snap)
    masks = active_masks_for_counts(snap, [min(i % 65, 64) for i in range(64)])
    arrs = sched.device_arrays(snap.arrays, cuda_device)
    inv = sched.inv_alloc_of(arrs.alloc)
    tmpl = sched.apply_forced_prefix(arrs, cfg, sched.init_state(arrs, cfg), cfg.forced_prefix)
    p0 = cfg.forced_prefix
    active = torch.from_numpy(masks).to(cuda_device)
    st_k = sched.lane_carry(tmpl, 64)
    out_k = step.plain_step_cuda(arrs, active, sched.hoist_of(arrs, active), inv, st_k, cfg, p0,
                                 snap.n_pods, template=tmpl)
    assert step.LAST_PLAN.stage != step.UNSTAGED
    pick = [0, 21, 42, 63]
    sub = active[pick]
    st_p = sched.lane_carry(tmpl, len(pick))
    out_p = step.plain_step_torch(arrs, sub, sched.hoist_of(arrs, sub), inv, st_p, cfg, p0,
                                  snap.n_pods, template=tmpl)
    torch.cuda.synchronize()
    for a, b in zip(out_k, out_p):
        assert torch.equal(a[pick], b)
    for f in sched.STATE_FIELDS:
        assert torch.equal(getattr(st_k, f)[pick], getattr(st_p, f)), f
    assert step.instantiation(cfg, tmpl) == "<0,1>"


# ---- the frozen form's groups and the wave loop's CUDA graph ----------------

# each group size a test holds the frozen form to: one pod a cluster, a
# group that straddles the wave's end (3 of an 8-pod wave: 3, 3, 2), the
# whole wave in one cluster, and the launch plan's own (frozen_group)
GROUPS = {"one": 1, "straddle": 3, "wave": 8, "plan": None}
# the frozen builds' explain modes: off, the top-k in one pass with the
# jitter, and the top-k over two passes
FROZEN_EXPLAIN = {"off": {}, "topk3-seed": dict(explain_topk=3, tie_break_seed=7),
                  "topk10": dict(explain_topk=10)}


def _force_group(monkeypatch, g):
    """Hold the frozen form's group size to g (None: the plan's) and, with
    it, its clusters to 4 blocks (the plan would take one at these sizes)."""
    if g is not None:
        monkeypatch.setattr(step, "frozen_group", lambda *a, **k: g)
        monkeypatch.setattr(step, "CLUSTER_SIZES", (16, 4))


@pytest.mark.cuda
@pytest.mark.parametrize("group", sorted(GROUPS))
@pytest.mark.parametrize("weights", [False, True])
@pytest.mark.parametrize("mode", sorted(FROZEN_EXPLAIN))
@pytest.mark.parametrize("case", sorted(FROZEN_CASES))
def test_grouped_frozen_builds_equal_plain_on_card(cuda_device, case, mode, weights, group,
                                                   monkeypatch):
    """Every frozen build (each gate combination, its explain twin, with and
    without the weight row) at each group size: the first two waves of a
    pools GRID on three lanes equal the plain step's frozen form, outputs
    and carry, bit for bit (the plan's own G on 64 lanes, lanes 0 and 63)."""
    _force_group(monkeypatch, GROUPS[group])
    snap = wave_pools_snapshot(96, 768, 8, **FROZEN_CASES[case])
    cfg = sched.make_config(snap, traced_weights=weights, **FROZEN_EXPLAIN[mode])
    lo, _, kind, w = wave_plans.waves_for(snap.arrays, cfg).segments[0]
    assert kind == wave_plans.GRID and w == 8
    arrs = sched.device_arrays(snap.arrays, cuda_device)
    n = snap.n_nodes
    masks = np.stack([np.ones(n, bool), np.arange(n) % 5 != 2, np.arange(n) % 7 != 3])
    if group == "plan":
        masks = np.stack([masks[i % 3] for i in range(64)])
    ends = [0, len(masks) - 1]
    active = torch.from_numpy(masks).to(cuda_device)
    hoist, inv = sched.hoist_of(arrs, active), sched.inv_alloc_of(arrs.alloc)
    wm = _weight_matrix(cfg, cuda_device)[:1].expand(len(masks), -1).contiguous() \
        if weights else None
    if weights:
        wm = wm * torch.linspace(0.5, 1.5, len(masks), device=cuda_device)[:, None]
    tmpl = sched.init_state(arrs, cfg)
    st = sched.lane_carry(tmpl, len(masks))
    step.copy_template(st, tmpl)
    before = dict(step.LAUNCHES)
    for w0 in range(lo, lo + 2 * w, w):
        out_k = step.plain_step_cuda(arrs, active, hoist, inv, st, cfg, w0, w0 + w, frozen=True,
                                     weights=wm)
        sub = sched.SimState(**{f: getattr(st, f)[ends].clone() for f in sched.STATE_FIELDS})
        out_p = step.plain_step_torch(arrs, active[ends], type(hoist)(*(x[ends] for x in hoist)),
                                      inv, sub, cfg, w0, w0 + w, frozen=True,
                                      weights=None if wm is None else wm[ends])
        torch.cuda.synchronize()
        if GROUPS[group]:
            assert (step.LAST_PLAN.group, step.LAST_PLAN.cluster) == (GROUPS[group], 4)
        _assert_runs_equal([([x[ends] for x in out_k],
                             sched.SimState(**{f: getattr(st, f)[ends]
                                               for f in sched.STATE_FIELDS})),
                            (out_p, sub)])
        pick = out_k.gpu_pick if cfg.enable_gpu else None
        wave.wave_merge_cuda(arrs, cfg, st, w0, w0 + w, out_k.node, pick)
    name = "plain_step_frozen" + ("_explain" if step.explain_on(cfg) else "")
    assert step.LAUNCHES[name] == before[name] + 2
    assert (st.headroom != tmpl.headroom[None]).any()


@pytest.mark.cuda
def test_frozen_plan_groups_pods_at_64_lanes_on_card(cuda_device):
    """The launch plan's own G at 64 lanes of a 1,024-node pools cluster
    (32-pod waves: more one-pod clusters than the card holds) is past 1,
    and the grouped launch equals the plain step's frozen form on lanes 0
    and 63."""
    snap = wave_pools_snapshot(1024, 2048, 32)
    cfg = sched.make_config(snap, fail_reasons=False)
    arrs = sched.device_arrays(snap.arrays, cuda_device)
    active = torch.ones((64, snap.n_nodes), dtype=torch.bool, device=cuda_device)
    active[1::2, ::7] = False
    hoist, inv = sched.hoist_of(arrs, active), sched.inv_alloc_of(arrs.alloc)
    tmpl = sched.init_state(arrs, cfg)
    st = sched.lane_carry(tmpl, 64)
    step.copy_template(st, tmpl)
    out_k = step.plain_step_cuda(arrs, active, hoist, inv, st, cfg, 0, 32, frozen=True)
    plan = step.LAST_PLAN
    ends = [0, 63]
    sub = sched.SimState(**{f: getattr(st, f)[ends].clone() for f in sched.STATE_FIELDS})
    out_p = step.plain_step_torch(arrs, active[ends], type(hoist)(*(x[ends] for x in hoist)),
                                  inv, sub, cfg, 0, 32, frozen=True)
    torch.cuda.synchronize()
    assert plan.group > 1 and 64 * -(-32 // plan.group) >= plan.resident, plan
    for name, a, b in zip(step.StepOutputs._fields, out_k, out_p):
        assert torch.equal(a[ends], b), name


@pytest.mark.cuda
@pytest.mark.parametrize("region", ["walk", "cols"])
def test_frozen_launch_split_by_groups_on_card(cuda_device, region, monkeypatch):
    """A frozen launch whose scratch passes the limit (lowered here) runs as
    launches over whole groups of 3 pods into the same outputs, equal to
    the plain step's frozen form: the device-resource walks' windows, and
    the column-read partials in global memory."""
    from open_simulator_tpu_torch.testing.synthetic import many_domain_snapshot

    _force_group(monkeypatch, 3)
    if region == "walk":
        snap = _wide_devres(False)
    else:
        snap = many_domain_snapshot(120, 320, 24, affinity=True)
    cfg = sched.make_config(snap)
    arrs = sched.device_arrays(snap.arrays, cuda_device)
    masks = np.stack([np.ones(snap.n_nodes, bool), np.arange(snap.n_nodes) % 5 != 2])
    active = torch.from_numpy(masks).to(cuda_device)
    hoist, inv = sched.hoist_of(arrs, active), sched.inv_alloc_of(arrs.alloc)
    tmpl = sched.init_state(arrs, cfg)
    lanes = sched.lane_carry(tmpl, 2)
    flags = step._flags(cfg, lanes, False)
    if region == "cols":
        w = step.smem_widths(arrs, cfg, flags)
        sl = step.block_geometry(snap.n_nodes, 16)[0]
        monkeypatch.setattr(step, "_SMEM_LIMIT", step.smem_bytes(w, sl, False, False, True))
    assert step.needs_wide(arrs, cfg, flags)
    plan = step.plan_for(arrs, cfg, flags, 2, lambda *_: 2, frozen=True, n_pods=8)
    assert plan.group == 3 and (plan.cols_global or step.walk_width(arrs, cfg))
    monkeypatch.setattr(step, "_SCRATCH_LIMIT",
                        step.scratch_bytes(arrs, cfg, flags, plan, 2, True))
    assert len(step.frozen_parts(arrs, cfg, flags, plan, 2, 8)) == 3
    step.copy_template(lanes, tmpl)
    st_p = _clone(lanes)
    before = step.LAUNCHES["plain_step_frozen"]
    out_k = step.plain_step_cuda(arrs, active, hoist, inv, lanes, cfg, 40, 48, frozen=True)
    out_p = step.plain_step_torch(arrs, active, hoist, inv, st_p, cfg, 40, 48, frozen=True)
    torch.cuda.synchronize()
    assert step.LAST_PLAN.wide and step.LAUNCHES["plain_step_frozen"] == before + 3
    _assert_runs_equal([(out_k, lanes), (out_p, st_p)])


# the wave loop's inputs: a GRID, a BATCH segment (three 20-pod waves, in
# chunks of 8: two through one graph, the last 4 a run of their own), the
# traced weights and the explain builds
WAVE_LOOPS = {"grid": (lambda: wave_pools_snapshot(96, 768, 8), {}, None),
              "grid-interpod-gpu": (lambda: wave_pools_snapshot(96, 768, 8, gpu=True,
                                                                interpod=True), {}, None),
              "batch": (lambda: wave_pools_snapshot(40, 60, 20), {}, 8),
              "traced": (lambda: wave_pools_snapshot(96, 768, 8),
                         dict(traced_weights=True), None),
              "explain": (lambda: wave_pools_snapshot(96, 768, 8, interpod=True),
                          dict(explain_topk=3, tie_break_seed=7), None)}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(WAVE_LOOPS))
def test_wave_loop_graph_equals_eager_on_card(cuda_device, case, monkeypatch):
    """_run_wave_plan on three lanes: the loop replayed as a CUDA graph (the
    wave on the device cursor, the outputs straight into the full-length
    buffers) equals the eager loop and the CPU's plain loop in every output
    and carry field, bit for bit; one graph a run of waves of one width,
    replayed for all but the run's first wave."""
    make, over, chunk = WAVE_LOOPS[case]
    if chunk:
        monkeypatch.setattr(sched, "_WAVE_CHUNK", chunk)
    snap = make()
    cfg = sched.make_config(snap, **over)
    plan = wave_plans.waves_for(snap.arrays, cfg)
    kinds = {s[2] for s in plan.segments}
    assert (wave_plans.BATCH if case == "batch" else wave_plans.GRID) in kinds
    n = snap.n_nodes
    masks = np.stack([np.ones(n, bool), np.arange(n) % 5 != 2, np.arange(n) % 7 != 3])
    wmat = None
    if cfg.traced_weights:
        wmat = np.tile(sched.weight_vector(cfg), (3, 1)) * np.array([[1.0], [0.5], [2.0]])
    runs = {}
    for label, dev, graph in (("graph", cuda_device, True), ("eager", cuda_device, False),
                              ("cpu", torch.device("cpu"), False)):
        arrs = sched.device_arrays(snap.arrays, dev)
        active = torch.from_numpy(masks).to(dev)
        hoist, inv = sched.hoist_of(arrs, active), sched.inv_alloc_of(arrs.alloc)
        tmpl = sched.init_state(arrs, cfg)
        carry = sched.lane_carry(tmpl, 3)
        w_t = None if wmat is None else torch.from_numpy(wmat.astype(np.float32)).to(dev)
        before = dict(sched.WAVE_LOOP)
        outs = sched._run_wave_plan(arrs, active, hoist, inv, carry, tmpl, cfg, plan, 0,
                                    snap.n_pods, weights=w_t, graph=graph)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        runs[label] = ([o.cpu() for o in outs],
                       {f: getattr(carry, f).cpu() for f in sched.STATE_FIELDS},
                       {k: sched.WAVE_LOOP[k] - before[k] for k in before})
    waves_of = [(hi - lo) // w if kind == wave_plans.GRID else
                -(-(hi - lo) // chunk) for lo, hi, kind, w in plan.segments
                if kind in (wave_plans.GRID, wave_plans.BATCH)]
    graphs = runs["graph"][2]
    if case == "batch":  # each wave: two chunks of 8 through a graph, then 4
        assert graphs == {"wave_graphs": len(waves_of), "wave_replays": len(waves_of)}
    else:
        assert graphs == {"wave_graphs": 1, "wave_replays": waves_of[0] - 1}
    assert runs["eager"][2] == {"wave_graphs": 0, "wave_replays": 0}
    for label in ("eager", "cpu"):
        for name, a, b in zip(step.StepOutputs._fields, runs["graph"][0], runs[label][0]):
            assert torch.equal(a, b), (label, name)
        for f in sched.STATE_FIELDS:
            assert torch.equal(runs["graph"][1][f], runs[label][1][f]), (label, f)
    assert (runs["graph"][0][0] >= 0).any()


@pytest.mark.cuda
def test_simulate_wave_ids_through_the_graph_on_card(cuda_device):
    """simulate() on a pools cluster through the graph loop: the placements,
    reasons and wave_id of the CPU's eager plain loop."""
    from open_simulator_tpu_torch.core import simulate
    from open_simulator_tpu_torch.k8s.loader import ClusterResources
    from open_simulator_tpu_torch.testing.synthetic import wave_pools_objects

    nodes, pods = wave_pools_objects(48, 384, 8, gpu=True)
    before = dict(sched.WAVE_LOOP)
    got = {dev: simulate(ClusterResources(nodes=nodes, pods=pods), [], device=dev)
           for dev in ("cuda", "cpu")}
    assert sched.WAVE_LOOP["wave_graphs"] > before["wave_graphs"]
    a, b = got["cuda"], got["cpu"]
    assert np.array_equal(a.wave_id, b.wave_id) and np.array_equal(a.wave_batched,
                                                                   b.wave_batched)
    assert {sp.pod.key: sp.node_name for sp in a.scheduled_pods} == {
        sp.pod.key: sp.node_name for sp in b.scheduled_pods}
    assert {u.pod.key: u.reason for u in a.unscheduled_pods} == {
        u.pod.key: u.reason for u in b.unscheduled_pods}
    assert a.wave_batched.any()


@pytest.mark.cuda
def test_wave_loop_capture_failure_names_the_launches_on_card(cuda_device, monkeypatch):
    """A wave whose work cannot be captured raises, naming the loop's
    launches: the card has no eager fallback."""
    snap = wave_pools_snapshot(96, 768, 8)
    cfg = sched.make_config(snap)
    plan = wave_plans.waves_for(snap.arrays, cfg)
    arrs = sched.device_arrays(snap.arrays, cuda_device)
    active = torch.ones((1, snap.n_nodes), dtype=torch.bool, device=cuda_device)
    hoist, inv = sched.hoist_of(arrs, active), sched.inv_alloc_of(arrs.alloc)
    tmpl = sched.init_state(arrs, cfg)

    def refuse(fn):
        raise RuntimeError("operation not permitted when stream is capturing")

    monkeypatch.setattr(sched, "_capture", refuse)
    with pytest.raises(RuntimeError, match="wave loop's frozen plain_step launch, wave_merge "
                                           "launch and cursor step"):
        sched._run_wave_plan(arrs, active, hoist, inv, sched.lane_carry(tmpl, 1), tmpl, cfg,
                             plan, 0, snap.n_pods)
