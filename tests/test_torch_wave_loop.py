"""The wave loop with the wave on a device cursor, and the frozen form's
group size.

The port's ``engine/scheduler._run_wave_plan`` runs a GRID segment's waves
and a BATCH segment's chunks as runs of one width: each wave's frozen step
and merge read the wave's first pod from an int32 cursor and write
straight into the full-length outputs (``kernels/step.wave_launcher``,
``kernels/wave.merge_launcher``). On the CPU they are the plain versions,
the cursor a CPU tensor; the card replays the same work as a CUDA graph
(tests/test_torch_kernel.py). Here the CPU loop equals the JAX package's
``_run_wave_plan`` (through its ``schedule_pods`` and ``batched_schedule``)
on GRID and BATCH plans, at one lane and at three, in every output and
carry field, exactly. The launch plan's group size (``frozen_group``)
keeps one pod a cluster at one lane and never passes a block's shared
memory; ``frozen_smem_bytes`` mirrors the kernel's ``frozen_layout_of``.
"""

from __future__ import annotations

import os
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity as tp
from open_simulator_tpu.encode.snapshot import encode_cluster as jencode
from open_simulator_tpu.engine import scheduler as jsched
from open_simulator_tpu.engine import waves as JW
from open_simulator_tpu.parallel import sweep as jsweep
from open_simulator_tpu.testing.builders import make_fake_node, make_fake_pod
from open_simulator_tpu.testing.synthetic import synthetic_snapshot as jsynthetic
from open_simulator_tpu_torch import convert
from open_simulator_tpu_torch.engine import scheduler as tsched
from open_simulator_tpu_torch.engine import waves as TW
from open_simulator_tpu_torch.kernels import build, step



def _gpu_share():
    """32 GPU-share pods over 8 pools: a GRID whose merges add GPU picks."""
    nodes = [make_fake_node(f"n{i}", labels={"pool": f"p{i % 8}"},
                            extra_allocatable={"alibabacloud.com/gpu-count": "4",
                                               "alibabacloud.com/gpu-mem": "32"})
             for i in range(8)]
    pods = [make_fake_pod(f"g{i}", labels={"app": f"a{i % 8}"},
                          node_selector={"pool": f"p{i % 8}"},
                          annotations={"alibabacloud.com/gpu-mem": str(2 + i % 3),
                                       "alibabacloud.com/gpu-count": "1"})
            for i in range(32)]
    return jencode(nodes, pods)


def _anti_pref():
    """16 pods over 16 pools, each with a hostname anti-affinity term, a
    preferred term and a spread: one BATCH wave through the group_count,
    term and preference paints."""
    pods = []
    for i in range(16):
        aff = {
            "podAntiAffinity": {"requiredDuringSchedulingIgnoredDuringExecution": [{
                "labelSelector": {"matchLabels": {"anti": f"g{i}"}},
                "topologyKey": "kubernetes.io/hostname"}]},
            "podAffinity": {"preferredDuringSchedulingIgnoredDuringExecution": [{
                "weight": 7, "podAffinityTerm": {
                    "labelSelector": {"matchLabels": {"app": f"a{i}"}},
                    "topologyKey": "kubernetes.io/hostname"}}]},
        }
        pods.append(make_fake_pod(
            f"p{i}", labels={"app": f"a{i}", "anti": f"g{i}"},
            node_selector={"pool": f"p{i}"}, affinity=aff,
            topology_spread=[{"maxSkew": 2, "topologyKey": "kubernetes.io/hostname",
                              "whenUnsatisfiable": "ScheduleAnyway",
                              "labelSelector": {"matchLabels": {"app": f"a{i}"}}}]))
    return jencode([make_fake_node(f"n{i}", labels={"pool": f"p{i % 16}"}) for i in range(16)],
                   pods)


# (reference snapshot, config overrides, the port's BATCH chunk): a GRID of
# 8-pod waves (with and without reasons), a GRID of GPU-share pods, three
# BATCH waves of 10 pods and one of 16 over the paints, cut into chunks of
# 4 (the full chunks of a wave through one run, a shorter last one a run
# of its own)
CASES = {
    "grid": (lambda: jsynthetic(16, 96, 0, pools=8), {}, None),
    "grid-reasons": (lambda: jsynthetic(16, 96, 0, pools=8), {"fail_reasons": True}, None),
    "gpu-grid": (_gpu_share, {}, None),
    "batch": (lambda: jsynthetic(20, 30, 0, pools=10), {}, 4),
    "batch-paints": (_anti_pref, {}, 4),
}
_SNAPS: dict = {}


def _case(name):
    if name not in _SNAPS:
        snap = CASES[name][0]()
        _SNAPS[name] = (snap, tp.port_snapshot(snap))
    snap, tsnap = _SNAPS[name]
    jcfg = jsched.make_config(snap, **{"fail_reasons": False, **CASES[name][1]})
    return snap, tsnap, jcfg, tsched.EngineConfig(**jcfg._asdict())


@pytest.mark.parametrize("n_lanes", [1, 3])
@pytest.mark.parametrize("case", sorted(CASES))
def test_cursor_wave_loop_equals_reference(case, n_lanes, monkeypatch):
    snap, tsnap, jcfg, tcfg = _case(case)
    jplan, plan = JW.waves_for(snap.arrays, jcfg), TW.waves_for(tsnap.arrays, tcfg)
    assert plan is not None and tuple(plan) == tuple(jplan)
    kinds = {s[2] for s in plan.segments}
    assert (TW.BATCH if case.startswith("batch") else TW.GRID) in kinds
    if CASES[case][2]:
        monkeypatch.setattr(tsched, "_WAVE_CHUNK", CASES[case][2])
    widths = []
    real = step.wave_launcher
    monkeypatch.setattr(step, "wave_launcher",
                        lambda *a, **k: widths.append(a[9]) or real(*a, **k))
    active = np.asarray(snap.arrays.active, bool)
    n = active.shape[0]
    masks = np.stack([active, active & (np.arange(n) % 5 != 2),
                      active & (np.arange(n) % 7 != 3)])[:n_lanes]
    got = tsched.schedule_lanes(tsnap.arrays, masks, tcfg, device="cpu", waves=plan)
    # the GRID waves, and the BATCH chunks of one width, each one run
    want = {"batch": [4, 2], "batch-paints": [4]}.get(case, [plan.segments[0][3]])
    assert widths == want
    if n_lanes == 1:
        ref = jsched.schedule_pods(jsched.device_arrays(snap), jnp.asarray(active), jcfg,
                                   waves=jplan)
        outs_j = {k: np.asarray(getattr(ref, k))[None] for k in tp.OUTPUTS}
        st_j = {f: v[None] for f, v in tp.jax_state(ref.state).items()}
    else:
        ref = jsweep.batched_schedule(jsched.device_arrays(snap), jnp.asarray(masks), jcfg,
                                      waves=jplan)
        outs_j = {k: np.asarray(getattr(ref, k)) for k in tp.OUTPUTS}
        st_j = tp.jax_state(ref.state)
    for k in tp.OUTPUTS:
        np.testing.assert_array_equal(getattr(got, k).numpy(), outs_j[k], err_msg=k)
    st_t = convert.state_to_numpy(got.state)
    for f, want in st_j.items():
        np.testing.assert_array_equal(st_t[f].astype(np.float32), want.astype(np.float32),
                                      err_msg=f)
    assert (got.node >= 0).any()


# the pools preset's widths (bench.py:351, 1,024 nodes in 32 pools) and a
# wider one (the top-k's masked scores, the inter-pod rows)
POOLS_W = step.SmemWidths(ops=17, q=4, d=4, cs=1, dom=128, rows=3, r=3, npv=0, pod=28,
                          node_w=4, node_b=4, cls=10)
WIDE_W = POOLS_W._replace(q=12, rows=5, keys=step.TOPK_WORDS, pod=96)


def _smem(w, sl, stage=step.STAGE_ALL):
    return lambda g: step.frozen_smem_bytes(w, sl, True, stage=stage, group=g)


def test_frozen_group_is_one_at_one_lane():
    """The pools preset at one lane: 32 one-pod clusters of C = 16 are fewer
    than the 58 the card holds at once, so G stays 1 (any G would leave
    SMs idle); at 64 lanes (2,048 clusters of C = 1, 132 at once) G grows."""
    assert step.frozen_group(1, 32, 58, _smem(POOLS_W, 64)) == 1
    assert step.frozen_group(1, 32, 32, _smem(POOLS_W, 64)) == 1
    g = step.frozen_group(64, 32, 132, _smem(POOLS_W, 1024))
    assert g > 1 and 64 * -(-32 // g) >= 132


@pytest.mark.parametrize("w", [POOLS_W, WIDE_W], ids=["pools", "wide"])
@pytest.mark.parametrize("sl", [64, 256, 1024, 2592])
@pytest.mark.parametrize("n_lanes,n_pods,resident", [(64, 32, 132), (8, 512, 66), (1, 512, 33),
                                                     (64, 8, 132), (3, 7, 1)])
def test_frozen_group_never_passes_shared_memory(w, sl, n_lanes, n_pods, resident):
    """G is at most the pods, its group fits a block's shared memory (where
    one pod does), it leaves at least as many clusters as the card holds
    (where one pod a cluster does), and it is the least G of its number of
    groups."""
    smem = _smem(w, sl)
    g = step.frozen_group(n_lanes, n_pods, resident, smem)
    assert 1 <= g <= n_pods
    if smem(1) <= step._SMEM_LIMIT:
        assert smem(g) <= step._SMEM_LIMIT
    if n_lanes * n_pods >= resident:
        assert n_lanes * -(-n_pods // g) >= resident
    assert g == -(-n_pods // -(-n_pods // g))


def test_frozen_plan_takes_the_group_after_the_geometry():
    """plan_for(frozen=True): the geometry of S x P' one-pod clusters, then
    the staging whose G gives the shortest launch (pods a cluster times
    rounds), its smem the group's; one pod a cluster stages nothing."""
    from open_simulator_tpu_torch.testing.synthetic import wave_pools_snapshot

    snap = wave_pools_snapshot(64, 256, 8)
    cfg = tsched.make_config(snap, fail_reasons=False)
    arrs = tsched.device_arrays(snap.arrays, "cpu")
    flags = step._flags(cfg, tsched.lane_carry(tsched.init_state(arrs, cfg), 1), False)
    w = step.smem_widths(arrs, cfg, flags)
    one = step.plan_for(arrs, cfg, flags, 1, lambda *_: 64, frozen=True, n_pods=8)
    # every one-pod cluster fits at once: the smallest cluster that keeps a
    # node a thread (64 nodes: one block)
    assert (one.group, one.stage, one.cluster) == (1, step.UNSTAGED, 1)
    plan = step.plan_for(arrs, cfg, flags, 64, lambda *_: 40, frozen=True, n_pods=8)
    assert plan.group > 1
    assert plan.smem == step.frozen_smem_bytes(w, plan.slice_len, plan.headroom,
                                               stage=plan.stage, group=plan.group)
    cost = step.frozen_cost(64, 8, 40, plan.group)
    for stage in (step.STAGE_ALL, step.RES_STAGE_NODE, step.UNSTAGED):
        g = step.frozen_group(64, 8, 40, lambda n: step.frozen_smem_bytes(
            w, plan.slice_len, plan.headroom, stage=stage, group=n))
        assert cost <= step.frozen_cost(64, 8, 40, g)


@pytest.mark.parametrize("n_lanes,resident,want", [
    (1, {16: 58, 8: 116, 4: 232, 2: 464, 1: 132}, 2),
    (1, {16: 32, 8: 32, 4: 16, 2: 8, 1: 4}, 8),
    (64, {16: 8, 8: 16, 4: 33, 2: 66, 1: 132}, 1)])
def test_frozen_plan_takes_the_smallest_cluster_that_keeps_a_node_a_thread(n_lanes, resident,
                                                                           want):
    """1,024 nodes, 32-pod waves: where every one-pod cluster fits at once,
    the geometry is the smallest cluster size whose blocks still give each
    thread one node (C = 2: 512 threads) and whose clusters all fit at
    once (with fewer resident, the next size up); where no size holds them
    all (64 lanes), the smallest size, as for the scan."""
    snap = _pools_1024()
    cfg = tsched.make_config(snap, fail_reasons=False)
    arrs = tsched.device_arrays(snap.arrays, "cpu")
    flags = step._flags(cfg, tsched.lane_carry(tsched.init_state(arrs, cfg), 1), False)
    plan = step.plan_for(arrs, cfg, flags, n_lanes, lambda c, *_: resident[c], frozen=True,
                         n_pods=32)
    assert plan.cluster == want
    assert -(-plan.slice_len // plan.threads) == (2 if want == 1 else 1)


_POOLS = []


def _pools_1024():
    from open_simulator_tpu_torch.testing.synthetic import wave_pools_snapshot

    if not _POOLS:
        _POOLS.append(wave_pools_snapshot(1024, 64, 32))
    return _POOLS[0]


def test_frozen_smem_bytes_counts_the_kernel_layout():
    """frozen_smem_bytes mirrors frozen_layout_of in the .cu."""
    w = step.SmemWidths(ops=5, q=3, d=4, cs=2, dom=24, rows=5, r=6, npv=7, pod=8)
    qd = 3 * 4 + 2 * 3
    per = 4 + 8 + 5 + 2 * (step.K_ROWS + 1) + step.K_NORM + 2 + 4 + 2 * qd + 3 + 2 + 5 * 10
    assert step.frozen_smem_bytes(w, 10, False, group=3) == 4 * (3 * per + 24) + 3 * 10 + 7
    assert step.frozen_smem_bytes(w, 10, True, group=1) == 4 * (per + 24 + 60) + 10 + 7
    src = Path(os.path.join(build.CSRC_DIR, "plain_step.cu")).read_text(encoding="utf-8")
    body = re.search(r"inline FrozenLayout frozen_layout_of\(const StepArgs& a\) \{(.*?)\n\}",
                     src, re.S).group(1)
    for part in ("2 * (kTopkLists + 3 + g) * kTopkPass", "w += 4 * g;", "g * cls_bytes(a) / 4",
                 "g * pod_lay(a).words", "g * a.ops", "g * (kRows + 1)", "g * kNorm",
                 "w += 2 * g;", "w += 4 * g;", "g * qd", "g * q;", "g * a.cs", "a.k1 * a.d * a.sg",
                 "g * (score_rows(a.flags) + (topk ? 1 : 0)) * a.sl", "a.sl * a.r",
                 "(3 + a.k1) * a.sl", "l.pv = l.flag + g * a.sl", "(2 + a.k) * a.sl"):
        assert part in body, part
    assert re.search(r"constexpr int kNorm = (\d+);", src).group(1) == str(step.K_NORM)
    assert re.search(r"constexpr int kRows = (\d+);", src).group(1) == str(step.K_ROWS)


def test_frozen_parts_cut_at_group_boundaries(monkeypatch):
    """A frozen launch whose scratch passes the limit runs as launches over
    whole groups, covering every pod once."""
    from open_simulator_tpu_torch.testing.synthetic import wave_pools_snapshot

    snap = wave_pools_snapshot(16, 64, 4)
    cfg = tsched.make_config(snap, fail_reasons=False)
    arrs = tsched.device_arrays(snap.arrays, "cpu")
    plan = step.LaunchPlan(1, 32, 16, True, 0, 1, cols_global=True, wide=True, group=3)
    flags = step._flags(cfg, tsched.lane_carry(tsched.init_state(arrs, cfg), 1), False)
    assert step.frozen_parts(arrs, cfg, flags, plan, 4, 32) == [(0, 32)]
    per_group = step.scratch_bytes(arrs, cfg, flags, plan, 4, True)
    monkeypatch.setattr(step, "_SCRATCH_LIMIT", 4 * per_group)
    parts = step.frozen_parts(arrs, cfg, flags, plan, 4, 32)
    assert len(parts) > 1 and all(lo % 3 == 0 for lo, _ in parts)
    assert [lo for lo, _ in parts] == list(np.cumsum([0] + [n for _, n in parts[:-1]]))
    assert sum(n for _, n in parts) == 32
