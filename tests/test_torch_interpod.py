"""The port's inter-pod slice equals the JAX package's on the same arrays.

Required pod affinity (with the first-pod bootstrap), anti-affinity in
both directions and both forms (``slot_paint`` and dense), hard and soft
PodTopologySpread on both carries, the interpod preference score and its
``pref_paint`` carry, and the forced-prefix fold of the term and
preferred-term paints. Each engine case encodes one snapshot with the JAX
package, hands its arrays to the port through ``convert`` and runs the
reference's ``schedule_pods(..., waves=None)`` and the port's plain torch
step (``device="cpu"``) with the same config. Node, per-op fail counts,
feasible counts and every carry in ``torch_parity.CARRY`` must be equal.
Tolerance: exact (``np.array_equal``), with ``fail_reasons`` on and off.

The gate-equality cases rebuild ``tests/test_gate_equality.py``'s
snapshots and hold the port to the reference on each, with the same
gate overrides.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

import torch_parity as tp
from open_simulator_tpu import core as jcore
from open_simulator_tpu.encode.snapshot import EncodeOptions, encode_cluster
from open_simulator_tpu.engine import scheduler as jsched
from open_simulator_tpu.ops import domains as jdom
from open_simulator_tpu.ops import filters as jfil
from open_simulator_tpu.ops import scores as jsc
from open_simulator_tpu.testing.synthetic import synthetic_snapshot as jax_synthetic
from open_simulator_tpu_torch import convert
from open_simulator_tpu_torch import core as tcore
from open_simulator_tpu_torch.encode.snapshot import POD_AXIS_FIRST
from open_simulator_tpu_torch.engine import scheduler as tsched
from open_simulator_tpu_torch.kernels import step as tstep
from open_simulator_tpu_torch.ops import domains as tdom
from open_simulator_tpu_torch.ops import filters as tfil
from open_simulator_tpu_torch.ops import scores as tsc
from tests.conftest import make_node, make_pod

ALL_GATES = dict(
    enable_ports=True, enable_pod_affinity=True, enable_anti_affinity=True,
    enable_spread_hard=True, enable_spread_soft=True, enable_pref=True,
    enable_node_aff_score=True, enable_taint_score=True, spread_hostname=True,
    enable_unsched=True, enable_class_aff=True, enable_class_taint=True,
)


def check(snap, **overrides):
    """Both engines on `snap` with the same overrides; equal or fail."""
    jcfg, outs_j, st_j = tp.run_jax(snap, **overrides)
    outs_t, st_t = tp.run_torch(tp.fields(snap.arrays), snap.arrays.active,
                                tp.torch_cfg(jcfg))
    tp.assert_same(outs_j, st_j, outs_t, st_t)
    return jcfg, outs_j, st_j


# ---- the rich synthetic cluster -------------------------------------------

RICH = {
    "rich-64x512": lambda: jax_synthetic(64, 512, rich=True),
    "rich-128x1024": lambda: jax_synthetic(128, 1024, rich=True),
    "rich-64x512-bound0.3": lambda: jax_synthetic(64, 512, rich=True, bound=0.3),
}


@pytest.mark.parametrize("fail_reasons", [True, False])
@pytest.mark.parametrize("name", sorted(RICH))
def test_rich_synthetic_equals_reference(name, fail_reasons):
    jcfg, outs, st = check(RICH[name](), fail_reasons=fail_reasons)
    assert jcfg.enable_pod_affinity and jcfg.enable_anti_affinity and jcfg.enable_pref
    assert jcfg.enable_spread_hard and jcfg.spread_hostname and jcfg.slot_paint
    assert st["term_block"].astype(np.float32).sum() > 0
    assert np.abs(st["pref_paint"]).sum() > 0
    if fail_reasons:
        fails = outs["fail_counts"].sum(axis=0)
        r = jcfg.n_resources
        # the affinity, anti-affinity and hard-spread rows all charge nodes
        assert fails[4 + r] > 0 and fails[5 + r] > 0 and fails[6 + r] > 0


def test_rich_dense_form_equals_reference():
    check(RICH["rich-64x512"](), slot_paint=False)


def test_rich_weights_and_f32_carry():
    check(RICH["rich-64x512-bound0.3"](), compact_carry=False, w_interpod=2.5,
          w_spread=0.0)


def test_rich_state_carried_across_from_reference():
    """The reference schedules the first half; its carry (term_block and
    pref_paint included) crosses through convert and the port schedules
    the rest: equal to the reference's full run."""
    snap = RICH["rich-64x512"]()
    jcfg, outs_full, st_full = tp.run_jax(snap)
    half = snap.n_pods // 2
    arrs_j = jsched.slice_pods(jsched.device_arrays(snap), 0, half)
    out_first = jsched.schedule_pods(arrs_j, snap.arrays.active, jcfg, waves=None)
    state = convert.state_from_numpy(tp.jax_state(out_first.state))
    rest = {k: (v[half:] if k in POD_AXIS_FIRST else v)
            for k, v in tp.fields(snap.arrays).items()}
    outs_t, st_t = tp.run_torch(rest, snap.arrays.active, tp.torch_cfg(jcfg), state=state)
    tp.assert_same({k: v[half:] for k, v in outs_full.items()}, st_full, outs_t, st_t)


def test_rich_lanes_equal_single_lane_runs():
    """A 4-lane plain step with four active masks equals four single-lane
    schedule_pods runs."""
    snap = RICH["rich-64x512"]()
    cfg = tp.torch_cfg(jsched.make_config(snap))
    arrs = tsched.device_arrays(snap.arrays, "cpu")
    n = snap.n_nodes
    rng = np.random.RandomState(3)
    masks = np.stack([np.ones(n, bool), np.arange(n) % 3 != 0, np.arange(n) >= n // 4,
                      rng.rand(n) < 0.7])
    active = torch.from_numpy(masks)
    base = tsched.init_state(arrs, cfg)
    lanes = tsched.SimState(**{f: torch.stack([getattr(base, f)] * 4)
                               for f in tsched.STATE_FIELDS})
    node, fail, feas = tstep.plain_step(arrs, active, tsched.hoist_of(arrs, active),
                                        tsched.inv_alloc_of(arrs.alloc), lanes, cfg, 0,
                                        snap.n_pods)
    for s in range(4):
        out = tsched.schedule_pods(snap.arrays, masks[s], cfg, device="cpu")
        np.testing.assert_array_equal(node[s].numpy(), out.node.numpy())
        np.testing.assert_array_equal(fail[s].numpy(), out.fail_counts.numpy())
        np.testing.assert_array_equal(feas[s].numpy(), out.feasible.numpy())
        for f in tp.CARRY:
            assert torch.equal(getattr(lanes, f)[s], getattr(out.state, f)), f
    assert len({tuple(node[s].tolist()) for s in range(4)}) == 4


# ---- the example configs ---------------------------------------------------

@pytest.mark.parametrize("fail_reasons", [True, False])
@pytest.mark.parametrize("name", ["config", "constraints"])
def test_example_config_engine_equals_reference(name, fail_reasons):
    jcfg, _, _ = check(tp.encode("jax", name), fail_reasons=fail_reasons)
    assert jcfg.enable_anti_affinity


@pytest.mark.parametrize("name", ["config", "constraints"])
def test_example_config_simulate_equals_reference(name):
    """simulate() through the port gives the reference's placements,
    reason strings and node status (equal priorities: no preemption)."""
    rj = jcore.simulate(*tp.load("jax", name))
    rt = tcore.simulate(*tp.load("torch", name), device="cpu")

    def answer(r):
        return ({sp.pod.key: sp.node_name for sp in r.scheduled_pods},
                {up.pod.key: up.reason for up in r.unscheduled_pods},
                [(ns.node.name, [p.key for p in ns.pods]) for ns in r.node_status])

    assert answer(rt) == answer(rj)
    assert rt.op_names == rj.op_names
    assert rt.scheduled_pods


# ---- tests/test_gate_equality.py's snapshots --------------------------------

def _zone_nodes(n):
    return [make_node(f"n{i}", cpu_m=8000, mem_mib=16384,
                      labels={"topology.kubernetes.io/zone": f"z{i % 3}"})
            for i in range(n)]


def _anti(sel, pref_sel=None, weight=5):
    aff = {"podAntiAffinity": {"requiredDuringSchedulingIgnoredDuringExecution": [{
        "labelSelector": {"matchLabels": sel}, "topologyKey": "kubernetes.io/hostname"}]}}
    if pref_sel is not None:
        aff["podAntiAffinity"]["preferredDuringSchedulingIgnoredDuringExecution"] = [{
            "weight": weight, "podAffinityTerm": {
                "labelSelector": {"matchLabels": pref_sel},
                "topologyKey": "topology.kubernetes.io/zone"}}]
    return aff


def _spread(key, hard, sel, skew):
    return [{"maxSkew": skew, "topologyKey": key,
             "whenUnsatisfiable": "DoNotSchedule" if hard else "ScheduleAnyway",
             "labelSelector": {"matchLabels": sel}}]


ZONE = "topology.kubernetes.io/zone"


def _plain_fit():
    rng = np.random.RandomState(3)
    pods = [make_pod(f"p{i}", cpu=f"{rng.randint(100, 1500)}m", mem=f"{rng.randint(64, 1024)}Mi",
                     labels={"app": f"a{i % 4}"}) for i in range(40)]
    return encode_cluster(_zone_nodes(6), pods)


def _soft_zone():
    rng = np.random.RandomState(4)
    pods = [make_pod(f"p{i}", cpu=f"{rng.randint(100, 900)}m", mem="256Mi", labels={"app": "a0"},
                     spread=_spread(ZONE, False, {"app": "a0"}, 2)) for i in range(30)]
    return encode_cluster(_zone_nodes(6), pods)


def _zone_hard_soft():
    rng = np.random.RandomState(5)
    pods = [make_pod(f"p{i}", cpu=f"{rng.randint(100, 700)}m", mem="128Mi",
                     labels={"app": f"a{i % 2}"},
                     spread=_spread(ZONE, i % 2 == 1, {"app": f"a{i % 2}"}, 1))
            for i in range(36)]
    return encode_cluster(_zone_nodes(9), pods)


def _constraint_rich():
    rng = np.random.RandomState(6)
    pods = []
    for i in range(24):
        kw = dict(cpu=f"{rng.randint(100, 800)}m", mem="128Mi", labels={"app": f"a{i % 3}"})
        if i % 4 == 0:
            kw["host_ports"] = [8000 + (i % 2)]
        if i % 5 == 0:
            kw["affinity"] = _anti({"app": f"a{i % 3}"}, {"app": f"a{(i + 1) % 3}"})
        if i % 6 == 0:
            kw["spread"] = _spread("kubernetes.io/hostname", True, {"app": f"a{i % 3}"}, 3)
        pods.append(make_pod(f"p{i}", **kw))
    return encode_cluster(_zone_nodes(8), pods)


def _padded(max_new):
    rng = np.random.RandomState(7)
    pods = [make_pod(f"p{i}", cpu=f"{rng.randint(200, 900)}m", mem="256Mi", labels={"app": "a0"},
                     spread=_spread(ZONE, True, {"app": "a0"}, 1)) for i in range(18)]
    opts = None
    if max_new:
        opts = EncodeOptions(max_new_nodes=max_new, new_node_template=_zone_nodes(1)[0])
    return encode_cluster(_zone_nodes(6), pods, opts)


def _forced_prefix():
    """30 bound pods painting anti-affinity and preferred terms, ports and
    counts into the carry, then 24 unbound pods that read it."""
    rng = np.random.RandomState(11)
    pods = []
    for i in range(30):
        kw = dict(cpu=f"{rng.randint(100, 600)}m", mem="128Mi",
                  labels={"app": f"a{i % 3}", "anti": f"g{i % 5}"}, node_name=f"n{i % 8}")
        if i % 3 == 0:
            kw["host_ports"] = [7000 + i]
        if i % 4 == 0:
            kw["affinity"] = _anti({"anti": f"g{i % 5}"}, {"app": f"a{(i + 1) % 3}"}, weight=7)
        pods.append(make_pod(f"bound{i}", **kw))
    for i in range(24):
        kw = dict(cpu=f"{rng.randint(100, 500)}m", mem="128Mi",
                  labels={"app": f"a{i % 3}", "anti": f"g{i % 5}"},
                  spread=_spread(ZONE, i % 2 == 1, {"app": f"a{i % 3}"}, 1))
        if i % 3 == 0:
            kw["host_ports"] = [7000 + (i % 30)]
        if i % 4 == 1:
            kw["affinity"] = _anti({"anti": f"g{i % 5}"})
        pods.append(make_pod(f"free{i}", **kw))
    return encode_cluster(_zone_nodes(8), pods)


def _slot_vs_dense():
    rng = np.random.RandomState(7)
    pods = []
    for i in range(40):
        kw = dict(cpu=f"{rng.randint(100, 900)}m", mem="256Mi",
                  labels={"app": f"a{i % 4}", "anti": f"g{i % 7}"},
                  spread=_spread(ZONE, i % 2 == 1, {"app": f"a{i % 4}"}, 2))
        if i % 3 == 0:
            kw["affinity"] = _anti({"anti": f"g{i % 7}"}, {"app": f"a{(i + 1) % 4}"}, weight=4)
        pods.append(make_pod(f"p{i}", **kw))
    return encode_cluster(_zone_nodes(8), pods)


GATE_CASES = {
    "plain-fit-all-gates": (_plain_fit, ALL_GATES),
    "soft-zone-all-gates": (_soft_zone, ALL_GATES),
    "zone-hard-soft-dom_count": (_zone_hard_soft, {}),
    "zone-hard-soft-group_count": (_zone_hard_soft, dict(spread_hostname=True)),
    "constraint-rich-all-gates": (_constraint_rich, ALL_GATES),
    "padded-0-all-gates": (lambda: _padded(0), ALL_GATES),
    "padded-4-all-gates": (lambda: _padded(4), ALL_GATES),
    "padded-4-dom_count": (lambda: _padded(4), {}),
    "forced-prefix": (_forced_prefix, {}),
    "forced-prefix-scanned": (_forced_prefix, dict(forced_prefix=0)),
    "slot-paint": (_slot_vs_dense, {}),
    "dense": (_slot_vs_dense, dict(slot_paint=False)),
}


@pytest.mark.parametrize("name", sorted(GATE_CASES))
def test_gate_variant_equals_reference(name):
    build, overrides = GATE_CASES[name]
    snap = build()
    jcfg, _, _ = check(snap, **overrides)
    if name.startswith("forced-prefix"):
        assert jcfg.forced_prefix == (0 if name.endswith("scanned") else 30)
        assert jcfg.enable_anti_affinity and jcfg.enable_pref
    if name == "zone-hard-soft-dom_count":
        assert jcfg.maintain_dom_count and jcfg.enable_spread_hard
    if name.startswith("padded-4"):
        assert not snap.arrays.active.all()


def test_forced_prefix_fold_equals_the_scanned_prefix():
    """The port's apply_forced_prefix (term and preferred-term paints
    included) leaves the carry the scanned prefix leaves."""
    snap = _forced_prefix()
    cfg = tp.torch_cfg(jsched.make_config(snap))
    fields = tp.fields(snap.arrays)
    folded = tp.run_torch(fields, snap.arrays.active, cfg)
    scanned = tp.run_torch(fields, snap.arrays.active, cfg._replace(forced_prefix=0))
    np.testing.assert_array_equal(folded[0]["node"], scanned[0]["node"])
    for k in tp.CARRY:
        np.testing.assert_array_equal(folded[1][k].astype(np.float32),
                                      scanned[1][k].astype(np.float32), err_msg=k)
    assert folded[1]["term_block"].astype(np.float32).sum() > 0


# ---- the ops ---------------------------------------------------------------

def _topology(rng, n, k1, d):
    dom = rng.randint(-1, d, size=(k1, n))
    topo = np.zeros((k1, n, d), np.float32)
    for k in range(k1):
        for i in range(n):
            if dom[k, i] >= 0:
                topo[k, i, dom[k, i]] = 1.0
    has_key = np.concatenate([np.ones((1, n), np.float32), (dom >= 0).astype(np.float32)])
    return topo, has_key


def same(j, t):
    j = np.asarray(j)
    t = t.numpy()
    assert j.dtype == t.dtype and j.shape == t.shape, (j.dtype, t.dtype, j.shape, t.shape)
    np.testing.assert_array_equal(j, t)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_hoist_eligibility_tables(seed):
    """elig_host, domain_has and any_elig equal the reference's, for one
    active mask and lane-batched over three."""
    rng = np.random.RandomState(seed)
    n, k1, d, c = 48, 2, 5, 4
    topo, has_key = _topology(rng, n, k1, d)
    cls = rng.rand(c, n) < 0.7
    masks = rng.rand(3, n) < 0.6
    args = [torch.from_numpy(x) for x in (topo, has_key, cls)]
    batched = tdom.hoist_active_stats(*args, torch.from_numpy(masks))
    for s in range(3):
        hj = jdom.hoist_active_stats(topo, has_key, cls, masks[s])
        ht = tdom.hoist_active_stats(*args, torch.from_numpy(masks[s]))
        for f in ("dom_counts", "log_dom", "elig_host", "domain_has", "any_elig"):
            same(getattr(hj, f), getattr(ht, f))
            same(getattr(hj, f), getattr(batched, f)[s])


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_anti_blocked_dense(dtype):
    rng = np.random.RandomState(4)
    tb = (rng.rand(40, 9) < 0.2).astype(np.float32) * rng.randint(1, 5, size=(40, 9))
    for seed in range(4):
        hit = np.random.RandomState(seed).rand(9) < 0.3
        tj = jax.numpy.asarray(tb, dtype=dtype)
        tt = torch.from_numpy(tb).to(getattr(torch, dtype))
        same(jfil.anti_blocked_dense(tj, hit), tfil.anti_blocked_dense(tt, torch.from_numpy(hit)))


def _group_counts(rng, n, s):
    return (rng.randint(0, 4, size=(n, s)) * (rng.rand(n, s) < 0.3)).astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_interpod_preference_raw(seed):
    rng = np.random.RandomState(seed)
    n, k1, d, s, ap = 40, 2, 4, 6, 3
    topo, has_key = _topology(rng, n, k1, d)
    gc = _group_counts(rng, n, s)
    group = rng.randint(0, s, size=ap).astype(np.int32)
    key = rng.randint(0, k1 + 1, size=ap).astype(np.int32)
    weight = rng.choice([-7.0, 3.0, 10.0, 100.0], size=ap).astype(np.float32)
    valid = np.array([True, True, bool(seed % 2)])
    extra = rng.randint(-20, 20, size=n).astype(np.float32)
    for ex in (None, extra):
        rj = jsc.interpod_preference_raw(gc, topo, has_key, group, key, weight, valid,
                                         extra_raw=ex)
        rt = tsc.interpod_preference_raw(
            torch.from_numpy(gc), torch.from_numpy(topo), torch.from_numpy(has_key), group, key,
            weight, valid, extra_raw=None if ex is None else torch.from_numpy(ex))
        same(rj, rt)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_pod_affinity_oracles(seed):
    """pod_affinity_ok (with the bootstrap) and pod_anti_affinity_ok equal
    the reference's, on carries with and without matching pods."""
    rng = np.random.RandomState(seed)
    n, k1, d, s, a = 40, 2, 4, 6, 3
    topo, has_key = _topology(rng, n, k1, d)
    gc = _group_counts(rng, n, s)
    gc[:, 0] = 0.0  # a group with no pod anywhere: the bootstrap decides
    group = np.array([0, rng.randint(1, s), rng.randint(0, s)], np.int32)
    key = rng.randint(0, k1 + 1, size=a).astype(np.int32)
    valid = np.array([True, True, bool(seed % 2)])
    self_m = np.array([bool(seed % 3), True, False])
    blocked = rng.rand(n) < 0.2
    tt = [torch.from_numpy(x) for x in (gc, topo, has_key)]
    same(jfil.pod_affinity_ok(gc, topo, has_key, group, key, valid, self_m),
         tfil.pod_affinity_ok(*tt, group, key, valid, self_m))
    same(jfil.pod_anti_affinity_ok(gc, topo, has_key, group, key, valid, blocked),
         tfil.pod_anti_affinity_ok(tt[0], tt[1], group, key, valid, torch.from_numpy(blocked)))


def test_domain_count():
    rng = np.random.RandomState(5)
    topo, _ = _topology(rng, 30, 2, 4)
    vec = rng.randint(0, 5, size=30).astype(np.float32)
    for key in range(3):
        same(jdom.domain_count(vec, key, topo),
             tdom.domain_count(torch.from_numpy(vec), key, torch.from_numpy(topo)))
