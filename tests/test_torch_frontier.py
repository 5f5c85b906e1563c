"""The port's cost frontier equals the JAX package's.

The frontier cases of ``tests/test_replay.py`` through the port's
``replay/frontier.py`` on the CPU, each against the reference's run of
the same cluster, apps and specs: every point, the Pareto set and the
digest, with the mixes run 4 lanes a launch, one a launch (the
exhaustive enumeration) and 3 lanes a launch (a padded tail round); the
Pareto set against a brute-force dominance scan; ``max_total``, the lazy
grid guardrail, the spec validation and the Pareto rule, each error with
the reference's code and field; and ``replay --frontier --json`` through
both CLIs, the same report on stdout. Tolerance: exact.
"""

from __future__ import annotations

import json
import os
import time

import pytest
import yaml

from open_simulator_tpu import replay as J
from open_simulator_tpu.core import AppResource as JApp
from open_simulator_tpu.errors import SimulationError as JError
from open_simulator_tpu.k8s import loader as jloader
from open_simulator_tpu_torch import replay as T
from open_simulator_tpu_torch.core import AppResource as TApp
from open_simulator_tpu_torch.errors import SimulationError as TError
from open_simulator_tpu_torch.k8s import loader as tloader
from open_simulator_tpu_torch.replay.frontier import NodeSpec as TNodeSpec
from open_simulator_tpu_torch.replay.synthetic import _deployment_yaml

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _fixture(pkg):
    """tests/test_replay.py's frontier workload: a 2-node cluster with 2
    pods and a 14-replica app, through `pkg`'s own loader."""
    R, loader, App = (J, jloader, JApp) if pkg == "jax" else (T, tloader, TApp)
    cluster = R.synthetic_replay_cluster(n_nodes=2, n_initial_pods=2)
    res = loader.ClusterResources()
    for doc in loader.parse_yaml_documents(_deployment_yaml("load", 14, 1200, 1024)):
        loader.demux_object(doc, res)
    return cluster, [App(name="load", resources=res)]


def both(**kw):
    """The reference's frontier and the port's on the same request:
    equal. Returns the port's."""
    cluster, apps = _fixture("jax")
    ref = J.capacity_frontier(cluster, apps, J.parse_specs(J.synthetic_frontier_specs()), **kw)
    cluster, apps = _fixture("torch")
    got = T.capacity_frontier(cluster, apps, T.parse_specs(T.synthetic_frontier_specs()),
                              device="cpu", **kw)
    assert got == ref
    return got


@pytest.mark.parametrize("lane_width", [4, 1, 3])
def test_frontier_equals_reference(lane_width):
    """Every lane width gives the reference's points, Pareto set and
    digest (lane_width=1 is the one-mix-at-a-time enumeration)."""
    got = both(lane_width=lane_width)
    brute = {tuple(p["counts"]) for p in got["points"]
             if not any(T.dominates(q, p) for q in got["points"])}
    assert {tuple(p["counts"]) for p in got["pareto"]} == brute
    assert len(got["pareto"]) > 1
    assert got["pareto"][0]["counts"] == [0, 0]
    assert min(p["unplaced"] for p in got["points"]) == 0
    assert T.format_frontier(got) == J.format_frontier(got)


def test_frontier_max_total_and_grid_guardrail():
    capped = both(max_total=2)
    assert all(sum(p["counts"]) <= 2 for p in capped["points"])
    cluster, apps = _fixture("torch")
    with pytest.raises(TError) as ei:
        T.capacity_frontier(cluster, apps, T.parse_specs(T.synthetic_frontier_specs()),
                            max_mixes=3, device="cpu")
    assert ei.value.code == "E_SPEC" and ei.value.field == "specs[].max_count"


def test_frontier_guardrail_is_lazy_on_huge_grids():
    huge = [TNodeSpec(name="s", cost=1.0, max_count=10**9, spec_yaml="x"),
            TNodeSpec(name="b", cost=2.0, max_count=10**9, spec_yaml="x")]
    t0 = time.perf_counter()
    with pytest.raises(TError) as ei:
        T.enumerate_mixes(huge, max_mixes=64)
    assert ei.value.code == "E_SPEC"
    assert time.perf_counter() - t0 < 5.0
    mixes = T.enumerate_mixes(huge, max_total=2, max_mixes=64)
    assert sorted(mixes) == [(0, 0), (0, 1), (0, 2), (1, 0), (1, 1), (2, 0)]


BAD_SPECS = {
    "no-name": [{"cost": 1, "max_count": 1, "spec_yaml": "x"}],
    "bad-cost": [{"name": "a", "cost": "free", "max_count": 1, "spec_yaml": "x"}],
    "negative-count": [{"name": "a", "cost": 1, "max_count": -1, "spec_yaml": "x"}],
    "no-yaml": [{"name": "a", "cost": 1, "max_count": 1}],
    "inf-cost": [{"name": "a", "cost": float("inf"), "max_count": 1, "spec_yaml": "x"}],
    "not-object": ["small"],
    "empty": [],
    "not-list": {"name": "a"},
    "duplicate": "duplicate",
}


@pytest.mark.parametrize("case", sorted(BAD_SPECS))
def test_frontier_spec_validation_equals_reference(case):
    got = []
    for R, err in ((J, JError), (T, TError)):
        raw = BAD_SPECS[case]
        if raw == "duplicate":
            raw = R.synthetic_frontier_specs() + [R.synthetic_frontier_specs()[0]]
        with pytest.raises(err) as ei:
            R.parse_specs(raw)
        got.append((ei.value.code, ei.value.field, str(ei.value)))
    assert got[0] == got[1]


def test_pareto_set_rule():
    pts = [
        {"cost": 0.0, "unplaced": 5, "util_pct": 50.0, "counts": [0]},
        {"cost": 1.0, "unplaced": 0, "util_pct": 40.0, "counts": [1]},
        {"cost": 2.0, "unplaced": 0, "util_pct": 40.0, "counts": [2]},
        {"cost": 1.0, "unplaced": 0, "util_pct": 60.0, "counts": [3]},
    ]
    front = T.pareto_set(pts)
    assert [p["counts"] for p in front] == [[0], [3]]
    assert front == J.pareto_set(pts)


def test_cli_replay_frontier_json_equals_reference(tmp_path, capsys):
    """``replay --frontier <specs> --json`` over a synthetic trace through
    both CLIs prints the same report."""
    from open_simulator_tpu.cli.main import main as jmain
    from open_simulator_tpu_torch.cli.main import main as tmain

    trace = tmp_path / "trace.json"
    trace.write_text(json.dumps(T.synthetic_trace_dict(n_batches=2, batch_pods=4,
                                                       chaos_target="worker-a-0")))
    specs = tmp_path / "specs.yaml"
    specs.write_text(yaml.safe_dump({"specs": T.synthetic_frontier_specs(max_small=3,
                                                                         max_big=1),
                                     "max_total": 3}))
    args = ["replay", "--cluster-config", os.path.join(REPO, "examples", "cluster", "demo"),
            "--trace", str(trace), "--frontier", str(specs), "--lane-width", "3", "--json"]
    capsys.readouterr()
    assert jmain(args) == 0
    want = capsys.readouterr().out
    assert tmain(args + ["--device", "cpu"]) == 0
    got = capsys.readouterr().out
    assert json.loads(got) == json.loads(want) and got == want
    assert tmain(args[:-1] + ["--device", "cpu", "--max-mixes", "2"]) == 1
    assert "E_SPEC" in capsys.readouterr().err
