"""The port's wave scheduling equals the JAX package's.

The planner (``engine/waves.py``, a copy of the reference's) gives the
reference's WavePlan and per-pod decode on the hand-built conflict graphs
of ``tests/test_waves.py`` and on small pools snapshots. The wave runner
(``schedule_pods(..., waves=plan)``: scan segments through the step,
batched waves through the frozen step and the merge) equals the
reference's ``schedule_pods(..., waves=plan)`` and the port's own scan on
the ``test_equiv_*`` cases, bit for bit in every output and carry field.
The plain merge equals the reference's ``_wave_merge`` on random carries.
Lanes, the sweeps and ``simulate()`` plan and decode as the reference
does. The port runs its plain torch versions on the CPU. Tolerance:
exact.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity as tp
from open_simulator_tpu.core import AppResource as JApp, simulate as jsimulate
from open_simulator_tpu.encode.snapshot import encode_cluster as jencode
from open_simulator_tpu.engine import exec_cache as jexec
from open_simulator_tpu.engine import scheduler as jsched
from open_simulator_tpu.engine import waves as JW
from open_simulator_tpu.k8s.loader import ClusterResources as JResources
from open_simulator_tpu.parallel import sweep as jsweep
from open_simulator_tpu.telemetry.ledger import plan_digest, result_digest
from open_simulator_tpu.testing.builders import make_fake_node, make_fake_pod
from open_simulator_tpu.testing.synthetic import synthetic_snapshot as jsynthetic
from open_simulator_tpu_torch import convert
from open_simulator_tpu_torch import core as tcore
from open_simulator_tpu_torch import testing as ttesting
from open_simulator_tpu_torch.engine import buckets as tbuckets
from open_simulator_tpu_torch.engine import scheduler as tsched
from open_simulator_tpu_torch.engine import waves as TW
from open_simulator_tpu_torch.k8s.loader import ClusterResources as TResources
from open_simulator_tpu_torch.kernels import wave as twave
from open_simulator_tpu_torch.parallel import sweep as tsweep
from open_simulator_tpu_torch.testing.synthetic import synthetic_snapshot as tsynthetic
from open_simulator_tpu_torch.testing.synthetic import wave_pools_snapshot as tsynthetic_pools


# ---- the snapshots of tests/test_waves.py --------------------------------

def _pool_nodes(n, pools, **kw):
    return [make_fake_node(f"n{i}", labels={"pool": f"p{i % pools}"}, **kw) for i in range(n)]


def _spread(app):
    return [{"maxSkew": 1, "topologyKey": "kubernetes.io/hostname",
             "whenUnsatisfiable": "ScheduleAnyway",
             "labelSelector": {"matchLabels": {"app": app}}}]


def all_conflicting():
    return jencode([make_fake_node(f"n{i}") for i in range(4)],
                   [make_fake_pod(f"p{i}") for i in range(16)])


def chain():
    return jencode(_pool_nodes(16, 16), [
        make_fake_pod(f"p{i}", labels={"app": f"a{i}"}, node_selector={"pool": f"p{i}"},
                      topology_spread=_spread(f"a{max(i - 1, 0)}")) for i in range(16)])


def star():
    pods = [make_fake_pod("hub", labels={"app": "hub"}, node_selector={"pool": "p0"})]
    pods += [make_fake_pod(f"s{i}", labels={"app": f"spoke{i}"},
                           node_selector={"pool": f"p{i}"}, topology_spread=_spread("hub"))
             for i in range(1, 17)]
    return jencode(_pool_nodes(17, 17), pods)


def forced_run():
    pods = [make_fake_pod(f"b{i}", node_name=f"n{i % 4}") for i in range(12)]
    pods += [make_fake_pod(f"p{i}") for i in range(4)]
    return jencode([make_fake_node(f"n{i}") for i in range(4)], pods)


def forced_then_free():
    pods = [make_fake_pod(f"b{i}", node_name=f"n{i % 4}") for i in range(8)]
    pods += [make_fake_pod("free")]
    pods += [make_fake_pod(f"b2{i}", node_name=f"n{i % 4}") for i in range(6)]
    return jencode([make_fake_node(f"n{i}") for i in range(4)], pods)


def gpu_share():
    nodes = [make_fake_node(f"n{i}", labels={"pool": f"p{i % 8}"},
                            extra_allocatable={"alibabacloud.com/gpu-count": "4",
                                               "alibabacloud.com/gpu-mem": "32"})
             for i in range(8)]
    pods = [make_fake_pod(f"g{i}", labels={"app": f"a{i % 8}"},
                          node_selector={"pool": f"p{i % 8}"},
                          annotations={"alibabacloud.com/gpu-mem": "2",
                                       "alibabacloud.com/gpu-count": "1"})
            for i in range(32)]
    return jencode(nodes, pods)


def group_anti_pref():
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
            topology_spread=[{**_spread(f"a{i}")[0], "maxSkew": 2}]))
    return jencode(_pool_nodes(16, 16), pods)


def host_ports():
    return jencode(_pool_nodes(8, 8), [
        make_fake_pod(f"p{i}", node_selector={"pool": f"p{i % 8}"}, host_ports=[8080])
        for i in range(32)])


def grid_scan_grid():
    """Four waves of four pools, four conflicting pods, four waves of four
    pools: the run of width-1 waves between the GRIDs is four wide and must
    not join either."""
    pods = [make_fake_pod(f"a{i}", node_selector={"pool": f"p{i % 4}"}) for i in range(16)]
    pods += [make_fake_pod(f"c{i}") for i in range(4)]
    pods += [make_fake_pod(f"b{i}", node_selector={"pool": f"p{i % 4}"}) for i in range(16)]
    return jencode(_pool_nodes(8, 4), pods)


def random_mix():
    """Seeded blocks of random kind and length: pods over eight pools in
    turn, unselected pods, forced binds, forced GPU-share binds and GPU-share
    pods over the pools."""
    rng = np.random.default_rng(7)
    nodes = [make_fake_node(f"n{i}", labels={"pool": f"p{i % 8}"},
                            extra_allocatable={"alibabacloud.com/gpu-count": "4",
                                               "alibabacloud.com/gpu-mem": "32"})
             for i in range(16)]
    gpu = {"alibabacloud.com/gpu-mem": "2", "alibabacloud.com/gpu-count": "1"}
    pods = []
    while len(pods) < 160:
        kind, n = int(rng.integers(0, 5)), int(rng.integers(1, 25))
        for _ in range(n):
            i, pool = len(pods), {"pool": f"p{len(pods) % 8}"}
            node = f"n{int(rng.integers(0, 16))}"
            pods.append(make_fake_pod(f"x{i}") if kind == 0 else
                        make_fake_pod(f"x{i}", node_name=node) if kind == 1 else
                        make_fake_pod(f"x{i}", node_name=node, annotations=gpu) if kind == 2
                        else make_fake_pod(f"x{i}", node_selector=pool, annotations=gpu)
                        if kind == 3 else make_fake_pod(f"x{i}", node_selector=pool))
    return jencode(nodes, pods)


SNAPSHOTS = {
    "all-conflicting": all_conflicting,
    "chain": chain,
    "star": star,
    "forced-run": forced_run,
    "forced-then-free": forced_then_free,
    "gpu-share": gpu_share,
    "group-anti-pref": group_anti_pref,
    "host-ports": host_ports,
    "grid-scan-grid": grid_scan_grid,
    "random-mix": random_mix,
    "pools-16x64": lambda: jsynthetic(16, 64, 0, pools=8),
    "pools-16x96": lambda: jsynthetic(16, 96, 0, pools=8),
    "rich-pools-16x96": lambda: jsynthetic(16, 96, 0, rich=True, pools=4),
    "rich-16x96": lambda: jsynthetic(16, 96, 0, rich=True),
    "bound-16x128": lambda: jsynthetic(16, 128, 0, bound=0.6),
    "pools-new8-16x96": lambda: jsynthetic(16, 96, 8, pools=8),
}
_CACHE = {}


def snapshots(name):
    """(reference snapshot, the port's snapshot of the same arrays)."""
    if name not in _CACHE:
        snap = SNAPSHOTS[name]()
        _CACHE[name] = (snap, tp.port_snapshot(snap))
    return _CACHE[name]


def configs(name, **overrides):
    """(reference cfg, port cfg): the same fields, waves on."""
    snap, _ = snapshots(name)
    jcfg = jsched.make_config(snap, **overrides)
    assert jcfg.wave_scheduling
    return jcfg, tsched.EngineConfig(**jcfg._asdict())


# ---- the planner ------------------------------------------------------------

PLAN_CASES = [(name, fr, total) for name in sorted(SNAPSHOTS) for fr in (False, True)
              for total in (None, "bucket")]


@pytest.mark.parametrize("name,fail_reasons,total", PLAN_CASES)
def test_wave_plan_equals_reference(name, fail_reasons, total):
    snap, tsnap = snapshots(name)
    over = {"fail_reasons": fail_reasons}
    if name == "forced-run":
        over["forced_prefix"] = 0
    jcfg, tcfg = configs(name, **over)
    n_total = None if total is None else tbuckets.bucket_pods(snap.n_pods)
    ref = JW.compute_wave_plan(snap.arrays, jcfg, n_pods_total=n_total)
    got = TW.compute_wave_plan(tsnap.arrays, tcfg, n_pods_total=n_total)
    assert (got.segments, got.start, got.n_pods) == (ref.segments, ref.start, ref.n_pods)
    assert got.stats() == ref.stats()
    for a, b in zip(got.pod_waves(), ref.pod_waves()):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    ref_w = JW.waves_for(snap.arrays, jcfg, n_pods_total=n_total)
    got_w = TW.waves_for(tsnap.arrays, tcfg, n_pods_total=n_total)
    assert (got_w is None) == (ref_w is None)
    if ref_w is not None:
        assert tuple(got_w) == tuple(ref_w)
        assert TW.waves_for(tsnap.arrays, tcfg, n_pods_total=n_total) is got_w  # cached


def test_the_port_encodes_the_reference_plan():
    """The port's own encoding of the pools cluster plans as the
    reference's does (one GRID over every pod)."""
    ref_snap, snap = jsynthetic(16, 96, 4, pools=8), tsynthetic(16, 96, 4, pools=8)
    for fr in (False, True):
        ref = JW.waves_for(ref_snap.arrays, jsched.make_config(ref_snap, fail_reasons=fr),
                           n_pods_total=128)
        got = TW.waves_for(snap.arrays, tsched.make_config(snap, fail_reasons=fr),
                           n_pods_total=128)
        assert tuple(got) == tuple(ref)
        assert got.segments[0] == (0, 96, TW.GRID, 8)


def test_plan_cache_keys_on_the_analysis_inputs():
    """Cordoning a node changes no shape but the plan: the cache must not
    serve the uncordoned cluster's plan (tests/test_waves.py's
    regression)."""
    def snap_for(cordoned):
        nodes = [ttesting.make_fake_node(f"n{i}", labels={"pool": f"p{i % 8}"},
                                         unschedulable=(cordoned and i == 0)) for i in range(8)]
        pods = [ttesting.make_fake_pod(f"p{i}", node_selector={"pool": f"p{i % 8}"})
                for i in range(32)]
        from open_simulator_tpu_torch.encode.snapshot import encode_cluster

        return encode_cluster(nodes, pods)

    a, b = snap_for(False), snap_for(True)
    plan_a = TW.waves_for(a.arrays, tsched.make_config(a, fail_reasons=False))
    plan_b = TW.waves_for(b.arrays, tsched.make_config(b, fail_reasons=False))
    assert plan_a is not plan_b


def test_bucket_pods_equals_reference():
    for n in (1, 3, 16, 96, 2047, 2048, 2049, 10240, 10241, 51200):
        assert tbuckets.bucket_pods(n) == jexec.bucket_shape(1, n)[1]


def test_simon_waves_0_gives_no_plan(monkeypatch):
    snap = tsynthetic(16, 64, 0, pools=8)
    assert tsched.make_config(snap).wave_scheduling
    monkeypatch.setenv("SIMON_WAVES", "0")
    cfg = tsched.make_config(snap, fail_reasons=False)
    assert not cfg.wave_scheduling
    assert TW.waves_for(snap.arrays, cfg) is None
    # a config that still asks for waves gets none either: the switch is
    # process-wide
    assert TW.waves_for(snap.arrays, cfg._replace(wave_scheduling=True)) is None


# ---- the wave runner ------------------------------------------------------

EQUIV = {
    "pools-grid": ("pools-16x96", {"fail_reasons": False}),
    "pools-fail-reasons": ("pools-16x96", {}),
    "rich-pools": ("rich-pools-16x96", {"fail_reasons": False}),
    "rich-fail-reasons": ("rich-16x96", {}),
    "interleaved-forced": ("bound-16x128", {"fail_reasons": False, "forced_prefix": 0}),
    "star-no-explain": ("star", {"fail_reasons": False}),
    "gpu-share": ("gpu-share", {"fail_reasons": False}),
    "group-anti-pref": ("group-anti-pref", {"fail_reasons": False}),
    "host-ports": ("host-ports", {"fail_reasons": False}),
}
# the cases whose plan must batch (tests/test_waves.py asserts it there)
MUST_BATCH = {"pools-grid", "pools-fail-reasons", "interleaved-forced", "star-no-explain",
              "gpu-share", "group-anti-pref", "host-ports"}


@pytest.mark.parametrize("case", sorted(EQUIV))
def test_wave_run_equals_reference_and_scan(case, monkeypatch):
    name, over = EQUIV[case]
    snap, tsnap = snapshots(name)
    jcfg, tcfg = configs(name, **over)
    jplan = JW.waves_for(snap.arrays, jcfg)
    plan = TW.waves_for(tsnap.arrays, tcfg)
    assert (plan is None) == (jplan is None) and (plan is None or tuple(plan) == tuple(jplan))
    if case in MUST_BATCH:
        assert plan is not None and any(s[2] != TW.SCAN for s in plan.segments)
    if case == "gpu-share":
        assert tcfg.enable_gpu and plan.max_wave_width >= 8
    if case == "group-anti-pref":
        assert tcfg.needs_group_count and tcfg.enable_anti_affinity and tcfg.enable_pref
    merges = []
    real_merge = twave.wave_merge_torch
    monkeypatch.setattr(twave, "wave_merge_torch",
                        lambda *a, **k: merges.append(a[3]) or real_merge(*a, **k))
    ref = jsched.schedule_pods(jsched.device_arrays(snap), jnp.asarray(snap.arrays.active),
                               jcfg, waves=jplan)
    outs_j = {k: np.asarray(getattr(ref, k)) for k in tp.OUTPUTS}
    st_j = tp.jax_state(ref.state)
    active = snap.arrays.active
    runs = {}
    for label, wp in (("waves", plan), ("scan", None)):
        out = tsched.schedule_pods(tsnap.arrays, active, tcfg, device="cpu", waves=wp)
        runs[label] = ({k: getattr(out, k).numpy() for k in tp.OUTPUTS},
                       convert.state_to_numpy(out.state))
    for label in runs:
        tp.assert_same(outs_j, st_j, *runs[label])
    if plan is not None and any(s[2] in (TW.GRID, TW.BATCH, TW.FORCED) for s in plan.segments):
        assert merges  # the batched segments went through the merge


def test_resumed_state_and_columns_drop_the_plan():
    """The reference's rules: a plan is dropped for a resumed carry, under
    the preemption columns and for another pod count."""
    _, tsnap = snapshots("pools-16x96")
    _, tcfg = configs("pools-16x96", fail_reasons=False)
    plan = TW.waves_for(tsnap.arrays, tcfg)
    n = tsnap.n_pods
    assert tsched.usable_plan(plan, n, tcfg, False, False) is plan
    assert tsched.usable_plan(plan, n, tcfg, True, False) is None
    assert tsched.usable_plan(plan, n, tcfg, False, True) is None
    assert tsched.usable_plan(plan, n + 1, tcfg, False, False) is None
    padded = plan._replace(n_pods=tbuckets.bucket_pods(n))
    assert tsched.usable_plan(padded, n, tcfg, False, False) is padded


# ---- the merge ----------------------------------------------------------

MERGE_CASES = {
    "rich-slot-bf16": ("rich-16x96", {}),
    "rich-dense-f32": ("rich-16x96", {"slot_paint": False, "compact_carry": False}),
    "group-anti-pref": ("group-anti-pref", {}),
    "gpu-share": ("gpu-share", {}),
    "pools-dom_count": ("pools-16x96", {}),
}


def random_state(snap, jcfg, rng):
    """A reference carry of small integer values (exact in bf16)."""
    st = jsched.init_state(jsched.device_arrays(snap), jcfg)
    out = {}
    for f, v in st._asdict().items():
        a = np.asarray(v)
        if a.dtype == bool:
            out[f] = jnp.asarray(rng.rand(*a.shape) < 0.3)
        elif f == "headroom":
            out[f] = jnp.asarray(a - rng.randint(0, 8, a.shape).astype(np.float32))
        else:
            out[f] = jnp.asarray(rng.randint(0, 40, a.shape).astype(np.float32)).astype(a.dtype)
    return jsched.SimState(**out)


@pytest.mark.parametrize("case", sorted(MERGE_CASES))
def test_wave_merge_equals_reference(case):
    name, over = MERGE_CASES[case]
    snap, tsnap = snapshots(name)
    jcfg, tcfg = configs(name, **over)
    rng = np.random.RandomState(11)
    arrs_j = jsched.device_arrays(snap)
    xs = jsched._pod_xs(arrs_j)
    n, g = snap.n_nodes, snap.arrays.gpu_slot.shape[1]
    state = random_state(snap, jcfg, rng)
    if case == "rich-slot-bf16":
        assert state.group_count.dtype == jnp.bfloat16 and jcfg.slot_paint
    arrs_t = tsched.device_arrays(tsnap.arrays, "cpu")
    for lo, hi in ((0, 7), (5, min(37, snap.n_pods)), (snap.n_pods // 2, snap.n_pods)):
        nodes = rng.randint(-2, n, hi - lo).astype(np.int32)   # negatives bind nothing
        pick = (rng.randint(0, 3, (hi - lo, g)).astype(np.int32) if jcfg.enable_gpu else None)
        x = {k: v[lo:hi] for k, v in xs.items()}
        ref = jsched._wave_merge(arrs_j, jcfg, state, x, jnp.asarray(nodes),
                                 None if pick is None else jnp.asarray(pick))
        st_t = convert.state_from_numpy(tp.jax_state(state))
        lanes = tsched.SimState(**{f: getattr(st_t, f)[None].clone()
                                   for f in tsched.STATE_FIELDS})
        twave.wave_merge(arrs_t, tcfg, lanes, lo, hi, torch.from_numpy(nodes)[None],
                         None if pick is None else torch.from_numpy(pick)[None])
        got = convert.state_to_numpy(tsched.SimState(**{f: getattr(lanes, f)[0]
                                                        for f in tsched.STATE_FIELDS}))
        for f, want in tp.jax_state(ref).items():
            assert got[f].dtype == want.dtype, f
            np.testing.assert_array_equal(got[f].astype(np.float32), want.astype(np.float32),
                                          err_msg=f)
        state = ref


def test_wave_merge_shares_forced_nodes_across_lanes():
    """A FORCED segment's nodes are one [c] row every lane binds."""
    _, tsnap = snapshots("bound-16x128")
    cfg = tsched.make_config(tsnap, fail_reasons=False)
    arrs = tsched.device_arrays(tsnap.arrays, "cpu")
    st = tsched.init_state(arrs, cfg)
    lanes = tsched.SimState(**{f: getattr(st, f)[None].repeat((3,) + (1,) * getattr(st, f).dim())
                               for f in tsched.STATE_FIELDS})
    forced = arrs.forced_node[:40].to(torch.int32)
    twave.wave_merge(arrs, cfg, lanes, 0, 40, forced)
    one = tsched.SimState(**{f: getattr(st, f)[None].clone() for f in tsched.STATE_FIELDS})
    twave.wave_merge(arrs, cfg, one, 0, 40, forced[None])
    for f in tsched.STATE_FIELDS:
        for s in range(3):
            assert torch.equal(getattr(lanes, f)[s], getattr(one, f)[0]), f


# ---- lanes, sweeps, simulate() -------------------------------------------

def test_schedule_lanes_with_a_plan_equals_reference():
    snap, tsnap = snapshots("pools-new8-16x96")
    jcfg, tcfg = configs("pools-new8-16x96", fail_reasons=False)
    plan, jplan = TW.waves_for(tsnap.arrays, tcfg), JW.waves_for(snap.arrays, jcfg)
    assert plan is not None and tuple(plan) == tuple(jplan)
    masks = np.stack(jsweep.active_masks_for_counts(snap, [0, 3, 8, 8]))
    ref = jsweep.batched_schedule(jsched.device_arrays(snap), jnp.asarray(masks), jcfg,
                                  waves=jplan)
    got = tsched.schedule_lanes(tsnap.arrays, masks, tcfg, device="cpu", waves=plan)
    for k in ("node", "fail_counts", "feasible"):
        assert np.array_equal(getattr(got, k).numpy(), np.asarray(getattr(ref, k))), k
    st_t = convert.state_to_numpy(got.state)
    for f, want in tp.jax_state(ref.state).items():
        np.testing.assert_array_equal(st_t[f].astype(np.float32), want.astype(np.float32),
                                      err_msg=f)


def test_capacity_bisect_digest_with_waves_equals_reference(monkeypatch):
    """tests/test_waves.py::test_equiv_sweep_digest through both packages:
    the bisection's plan digest with waves on equals the reference's, and
    both equal the port's with waves off."""
    monkeypatch.delenv("SIMON_LEDGER_DIR", raising=False)
    monkeypatch.delenv("SIMON_CHECKPOINT_DIR", raising=False)
    snap, tsnap = snapshots("pools-new8-16x96")
    digests = {}
    for env in ("1", "0"):
        monkeypatch.setenv("SIMON_WAVES", env)
        jcfg = jsched.make_config(snap)
        tcfg = tsched.EngineConfig(**jcfg._asdict())
        assert tcfg.wave_scheduling == (env == "1")
        assert (tsweep._wave_plan(tsnap, tcfg._replace(fail_reasons=False)) is None) == (env == "0")
        ref = jsweep.capacity_bisect(snap, jcfg, max_new=8, lanes=4)
        got = tsweep.capacity_bisect(tsnap, tcfg, max_new=8, lanes=4, device="cpu")
        digests[env] = (plan_digest(ref)["digest"], plan_digest(got)["digest"])
        assert digests[env][0] == digests[env][1]
    assert digests["1"] == digests["0"]


def _pools_cluster(pkg_builders, resources_cls):
    cluster = resources_cls()
    cluster.nodes = [pkg_builders.make_fake_node(f"n{i}", labels={"pool": f"p{i % 8}"})
                     for i in range(8)]
    app = resources_cls()
    app.pods = [pkg_builders.make_fake_pod(f"p{i}", node_selector={"pool": f"p{i % 8}"})
                for i in range(24)]
    return cluster, app


@pytest.mark.parametrize("waves_env", ["1", "0"])
def test_simulate_reports_the_reference_waves(waves_env, monkeypatch):
    """tests/test_waves.py::test_simulate_reports_waves and
    ::test_equiv_simulate_result_digest through both packages."""
    from open_simulator_tpu import testing as jtesting

    monkeypatch.setenv("SIMON_WAVES", waves_env)
    cluster_j, app_j = _pools_cluster(jtesting, JResources)
    cluster_t, app_t = _pools_cluster(ttesting, TResources)
    ref = jsimulate(cluster_j, [JApp(name="a", resources=app_j)])
    got = tcore.simulate(cluster_t, [tcore.AppResource(name="a", resources=app_t)],
                         device="cpu")
    if waves_env == "1":
        assert ref.wave_batched.any()
        for a, b in ((got.wave_id, ref.wave_id), (got.wave_batched, ref.wave_batched)):
            assert a.dtype == b.dtype and np.array_equal(a, b)
    else:
        assert got.wave_id is None and ref.wave_id is None
    assert result_digest(got)["digest"] == result_digest(ref)["digest"]


@pytest.mark.parametrize("gpu,interpod", [(False, False), (False, True), (True, False),
                                          (True, True)])
def test_wave_pools_clusters_run_as_the_scan(gpu, interpod):
    """The card's wave parity clusters (``testing/synthetic.wave_pools_snapshot``,
    one per frozen instantiation), small: the port's wave run equals its
    scan in every output and carry field, with reasons on and off."""
    snap = tsynthetic_pools(16, 96, 4, gpu=gpu, interpod=interpod)
    for fr in (True, False):
        cfg = tsched.make_config(snap, fail_reasons=fr)
        plan = TW.waves_for(snap.arrays, cfg, n_pods_total=tbuckets.bucket_pods(snap.n_pods))
        assert plan.segments[0] == (0, 96, TW.GRID, 4)
        runs = [tsched.schedule_pods(snap.arrays, snap.arrays.active, cfg, device="cpu",
                                     waves=wp) for wp in (plan, None)]
        for a, b in zip(runs[0][:5], runs[1][:5]):
            assert torch.equal(a, b)
        for f in tsched.STATE_FIELDS:
            assert torch.equal(getattr(runs[0].state, f), getattr(runs[1].state, f)), f
        assert (runs[0].node >= 0).any()
