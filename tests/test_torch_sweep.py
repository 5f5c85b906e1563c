"""The port's capacity plans equal the JAX package's.

``capacity_sweep`` (one lane per candidate count) and ``capacity_bisect``
(rounds of a fixed number of lanes over a shrinking bracket) of
``open_simulator_tpu_torch.parallel.sweep`` against the reference's, on
the same synthetic snapshots with 16 new-node slots and a CPU threshold
that puts the answer inside (0, 16). The reference runs as it does by
default (bucketed arrays, its wave plan); the port runs its plain torch
step on the CPU. Equal: the probed counts, the verdicts, the occupancy
floats, the best count, every lane's node assignments and the
reference's ``telemetry/ledger.plan_digest`` of both plans. Tolerance:
exact.
"""

from __future__ import annotations

import numpy as np
import pytest

import torch_parity as tp
from open_simulator_tpu.engine import scheduler as jsched
from open_simulator_tpu.parallel import sweep as jsweep
from open_simulator_tpu.telemetry.ledger import plan_digest
from open_simulator_tpu.testing.synthetic import synthetic_snapshot as jax_synthetic
from open_simulator_tpu_torch.parallel import sweep as tsweep

MAX_NEW = 16
SNAPSHOTS = {
    "synthetic-64x256-new16": lambda: jax_synthetic(64, 256, max_new=MAX_NEW),
    "rich-64x256-new16": lambda: jax_synthetic(64, 256, max_new=MAX_NEW, rich=True),
}
_CACHE = {}


def case(name):
    """(reference snapshot, port snapshot, reference cfg, port cfg,
    thresholds): the CPU limit lies between the occupancy at 5 and at 4
    new nodes, so the smallest satisfying count is 5."""
    if name not in _CACHE:
        snap = SNAPSHOTS[name]()
        jcfg = jsched.make_config(snap)
        probe = jsweep.capacity_sweep(snap, jcfg, [4, 5])
        assert all(probe.all_scheduled)
        limit = (probe.cpu_occupancy_pct[0] + probe.cpu_occupancy_pct[1]) / 2
        _CACHE[name] = (snap, tp.port_snapshot(snap), jcfg, tp.torch_cfg(jcfg),
                        jsweep.SweepThresholds(max_cpu_pct=limit))
    return _CACHE[name]


def assert_same_plan(ref, got):
    for f in ("counts", "all_scheduled", "satisfied", "cpu_occupancy_pct",
              "mem_occupancy_pct", "best_count", "trial_errors", "sweep_id"):
        assert getattr(got, f) == getattr(ref, f), f
    for f in ("nodes_per_scenario", "fail_counts"):
        a, b = getattr(ref, f), getattr(got, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    assert got.gpu_pick is None and got.vol_pick is None
    assert plan_digest(got) == plan_digest(ref)


@pytest.mark.parametrize("name", sorted(SNAPSHOTS))
def test_capacity_sweep_equals_reference(name):
    snap, tsnap, jcfg, cfg, th = case(name)
    counts = list(range(MAX_NEW + 1))[::-2]          # descending, not sorted
    ref = jsweep.capacity_sweep(snap, jcfg, counts, jsweep.SweepThresholds(*th))
    got = tsweep.capacity_sweep(tsnap, cfg, counts, tsweep.SweepThresholds(*th), device="cpu")
    assert_same_plan(ref, got)
    assert ref.best_count == 6 and not ref.satisfied[-3]


def test_capacity_sweep_with_reasons_equals_reference():
    snap, tsnap, jcfg, cfg, th = case("synthetic-64x256-new16")
    counts = [0, 1, 5, 9]
    tight = jsweep.SweepThresholds(max_cpu_pct=th.max_cpu_pct, max_memory_pct=1.0)
    ref = jsweep.capacity_sweep(snap, jcfg, counts, tight, fail_reasons=True)
    got = tsweep.capacity_sweep(tsnap, cfg, counts, tsweep.SweepThresholds(*tight),
                                fail_reasons=True, device="cpu")
    assert_same_plan(ref, got)
    assert ref.best_count is None


@pytest.mark.parametrize("name,lanes", [("synthetic-64x256-new16", 4),
                                        ("synthetic-64x256-new16", 8),
                                        ("rich-64x256-new16", 4)])
def test_capacity_bisect_equals_reference(name, lanes):
    snap, tsnap, jcfg, cfg, th = case(name)
    ref = jsweep.capacity_bisect(snap, jcfg, MAX_NEW, jsweep.SweepThresholds(*th), lanes=lanes)
    got = tsweep.capacity_bisect(tsnap, cfg, MAX_NEW, tsweep.SweepThresholds(*th),
                                 lanes=lanes, device="cpu")
    assert_same_plan(ref, got)
    assert got.best_count == 5 and len(got.counts) > lanes   # more than one round


def test_unported_sweep_options_raise():
    _, tsnap, _, cfg, _ = case("synthetic-64x256-new16")
    with pytest.raises(NotImplementedError, match="mesh.*ROADMAP queue 1, item 13"):
        tsweep.capacity_sweep(tsnap, cfg, [0], mesh=object(), device="cpu")
    with pytest.raises(NotImplementedError, match="retries.*ROADMAP queue 1, item 8"):
        tsweep.capacity_sweep(tsnap, cfg, [0], retries=2, device="cpu")
    with pytest.raises(NotImplementedError, match="journals.*ROADMAP queue 1, item 8"):
        tsweep.capacity_bisect(tsnap, cfg, 4, resume="last", device="cpu")
    with pytest.raises(ValueError, match="exceeds padded new-node slots"):
        tsweep.active_masks_for_counts(tsnap, [MAX_NEW + 1])


def test_probe_ladder_equals_reference():
    for max_new in (0, 1, 5, 16, 64, 128):
        for lanes in (1, 4, 8):
            assert tsweep._probe_ladder(max_new, lanes) == jsweep._probe_ladder(max_new, lanes)
