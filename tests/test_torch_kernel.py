"""The plain_step kernel's wrapper, binding and parity.

This file imports only the port, so it also runs on a machine with the
card and no JAX. There, from the repository root:

    python -m pytest --noconftest -q tests/test_torch_kernel.py

runs the card-only tests (marked ``cuda``): the kernel against the plain
torch step, bit for bit, on both spread carries, on the rich synthetic
cluster (pod affinity, anti-affinity in the slot and the dense form, hard
spread, the interpod preference) and on lanes. Without CUDA they skip
with the reason; the binding checks run everywhere.
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
from open_simulator_tpu_torch.testing.synthetic import soft_spread_cluster, synthetic_snapshot

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


def test_flag_bits_match_the_c_constants():
    src = Path(SOURCE).read_text(encoding="utf-8")
    bits = dict(re.findall(r"constexpr int (F_\w+) = 1 << (\d+);", src))
    assert len(bits) == 21
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
    """The per-domain column sums live in the block's shared memory; widths
    that do not fit raise before anything is launched, naming the need."""
    snap = synthetic_snapshot(8, 16, rich=True)
    cfg = sched.make_config(snap)
    arrs = sched.device_arrays(snap.arrays, "cpu")
    active = torch.ones((1, 8), dtype=torch.bool)
    st = sched.init_state(arrs, cfg)
    lanes = sched.SimState(**{f: getattr(st, f)[None] for f in sched.STATE_FIELDS})
    q = sum(getattr(arrs, f).shape[1] for f in ("aff_group", "anti_group", "spread_group",
                                                "pref_group"))
    need = step.smem_bytes(cfg.n_ops, q, arrs.topo_onehot.shape[2], arrs.spread_group.shape[1])
    monkeypatch.setattr(step, "_SMEM_LIMIT", need - 1)
    with pytest.raises(ValueError, match=f"need {need} bytes of shared memory"):
        step.plain_step_cuda(arrs, active, sched.hoist_of(arrs, active),
                             sched.inv_alloc_of(arrs.alloc), lanes, cfg, 0, 16)


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
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["hostname-bf16", "hostname-f32", "zone-region", "synthetic",
                                  "rich", "rich-dense", "rich-bound", "rich-f32-no-reasons"])
def test_kernel_equals_plain_step_on_card(cuda_device, case):
    """Two lanes with different active masks: the kernel and the plain
    torch step give the same outputs and carry, bit for bit."""
    overrides = {"compact_carry": False} if case == "hostname-f32" else RICH_CASES.get(case, {})
    if case == "synthetic":
        snap = synthetic_snapshot(96, 512, bound=0.2)
    elif case.startswith("rich"):
        snap = synthetic_snapshot(96, 512, rich=True, bound=0.3 if case == "rich-bound" else 0.0)
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
    for f in ("headroom", "group_count", "dom_count", "ports_used", "term_block", "pref_paint"):
        assert torch.equal(getattr(st_k, f), getattr(st_p, f)), f
    assert (out_k[0] >= 0).any()


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
