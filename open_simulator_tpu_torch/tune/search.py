"""Scheduler-policy search on the lane axis, on the port's engine (the
reference's ``tune/search.py``).

The traced-weights engine mode (``EngineConfig.traced_weights``) turns
the scheduler's Score plugin weight table (the v1beta2 plugin weights)
into a per-lane [K] row of the step, so W *policy variants* run as the W
lanes of one ``schedule_lanes`` launch (``plain_step`` with its
``w_lane`` row on the card), exactly like the capacity sweep runs node
counts as lanes; each round's carry is the next round's output buffer.

Each lane is scored on the tune objectives, all minimized:

    unplaced    pods left unschedulable under the variant
    cost        distinct nodes the variant placed pods on (consolidation
                pressure — fewer occupied nodes is cheaper to keep)
    disruption  pods whose placement differs from the BASELINE policy
                (the config's own weight vector, always lane one of
                round one) — a variant that wins without reshuffling the
                incumbent's placements is operationally cheaper

and the report carries the **Pareto set** under the frontier's shared
dominance machinery (``replay/frontier.py dominates_on``), held in the
tests against one-variant-at-a-time enumeration and a brute-force
O(W^2) dominance check.

Search modes:

* ``grid`` — coordinate grid around the baseline: for every weight
  field, every value in ``grid_values`` (baseline kept for the other
  axes). Deterministic, exhaustive over its own grid.
* ``cem`` — cross-entropy-style mutation/selection: each round samples
  ``variants`` vectors around the elite mean/std of everything seen so
  far (the host's ``np.random.default_rng(seed)``, deterministic),
  clipped to ``[0, max_weight]``.

Cancellation (deadlines, drain) is observed at ROUND boundaries with
partial results. A round whose launch fails with a deterministic device
fault (``resilience/faults.run_launch``) is re-run as two half-width
launches, which give the same points. The per-round run records of the
reference's ledger are ROADMAP queue 1, item 11.
"""

from __future__ import annotations

import hashlib
import json
import time
import uuid
from dataclasses import dataclass, field as dc_field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from open_simulator_tpu_torch.engine.sched_config import MAX_SCORE_WEIGHT
from open_simulator_tpu_torch.engine.scheduler import WEIGHT_FIELDS, weight_vector
from open_simulator_tpu_torch.errors import SimulationError
from open_simulator_tpu_torch.replay.frontier import dominates_on, pareto_front

TUNE_OBJECTIVES: Tuple[str, ...] = ("unplaced", "cost", "disruption")
DEFAULT_GRID_VALUES: Tuple[float, ...] = (0.0, 0.5, 1.0, 2.0, 4.0)
MAX_LANES = 64          # request guardrail: lanes multiply device memory
MAX_ROUNDS = 256        # request guardrail: rounds multiply wall time
MAX_GRID_VALUES = 64    # request guardrail: the grid materializes
#                         1 + K*len(grid_values) vectors up front
MAX_WEIGHT_CAP = MAX_SCORE_WEIGHT  # f32-safe; one bound, both validators


def _bad(msg: str, field_name: str, hint: str = "") -> SimulationError:
    return SimulationError(msg, code="E_BAD_REQUEST", ref="request",
                           field=field_name, hint=hint)


@dataclass
class TuneOptions:
    """One tune run's knobs (CLI flags / REST body fields map 1:1)."""

    mode: str = "grid"              # grid | cem
    variants: int = 8               # W: policy lanes per device round
    rounds: int = 0                 # cem generations (0 = 4); grid: 0 =
    #                                 the whole grid, >0 caps the rounds
    #                                 (reported as grid_truncated)
    seed: int = 0                   # cem sampling seed (deterministic)
    grid_values: Tuple[float, ...] = DEFAULT_GRID_VALUES
    elite_frac: float = 0.25        # cem selection fraction
    sigma: float = 0.75             # cem initial mutation scale
    max_weight: float = 8.0         # weight-space clip ceiling
    # center/default weight overrides by EngineConfig field name
    # (w_balanced, ...): the search starts from — and reports disruption
    # against — this vector
    weights: Dict[str, float] = dc_field(default_factory=dict)
    config_overrides: Dict[str, Any] = dc_field(default_factory=dict)

    @classmethod
    def from_body(cls, body: Dict[str, Any]) -> "TuneOptions":
        """Validate a REST body into options — every malformation is a
        structured 400, never a 500 (the tune-knob fuzz holds this)."""

        def req_int(name: str, default: int, lo: int, hi: int) -> int:
            raw = body.get(name, default)
            if isinstance(raw, bool):
                # bools float()-coerce to 0/1 — reject before coercion
                raise _bad(f"{name} must be an integer, got {raw!r}", name)
            if not isinstance(raw, int):
                # "8" and 8.0 coerce; 8.9 is the caller's mistake — a
                # silent truncation would answer with a lane_width the
                # caller never asked for
                try:
                    coerced = int(float(raw))
                    if coerced != float(raw):
                        raise ValueError
                    raw = coerced
                except (TypeError, ValueError):
                    raise _bad(f"{name} must be an integer, got {raw!r}",
                               name, f'e.g. {{"{name}": {default}}}'
                               ) from None
            if not (lo <= raw <= hi):
                raise _bad(f"{name} must be in [{lo}, {hi}], got {raw}",
                           name)
            return int(raw)

        def req_float(name: str, default: float, lo: float,
                      hi: float) -> float:
            raw = body.get(name, default)
            if isinstance(raw, bool):
                raise _bad(f"{name} must be a number, got {raw!r}", name)
            try:
                v = float(raw)
            except (TypeError, ValueError):
                raise _bad(f"{name} must be a number, got {raw!r}",
                           name) from None
            if not (lo <= v <= hi) or v != v:
                raise _bad(f"{name} must be in [{lo}, {hi}], got {v}", name)
            return v

        mode = str(body.get("mode", "grid"))
        if mode not in ("grid", "cem"):
            raise _bad(f"mode must be 'grid' or 'cem', got {mode!r}",
                       "mode")
        config_overrides: Dict[str, Any] = {}
        raw_w = body.get("weights") or {}
        if not isinstance(raw_w, dict):
            raise _bad(f"weights must be an object, got "
                       f"{type(raw_w).__name__}", "weights",
                       '{"weights": {"w_spread": 0.0}}')
        weights: Dict[str, float] = {}
        for k, v in raw_w.items():
            if k not in WEIGHT_FIELDS:
                raise SimulationError(
                    f"unknown weight field {k!r}", code="E_SPEC",
                    ref="request", field=f"weights.{k}",
                    hint="known fields: " + ", ".join(WEIGHT_FIELDS))
            if isinstance(v, bool):
                raise SimulationError(
                    f"weights.{k} must be a number, got {v!r}",
                    code="E_SPEC", ref="request", field=f"weights.{k}")
            try:
                fv = float(v)
            except (TypeError, ValueError):
                raise SimulationError(
                    f"weights.{k} must be a number, got {v!r}",
                    code="E_SPEC", ref="request", field=f"weights.{k}"
                ) from None
            if not (0.0 <= fv <= MAX_WEIGHT_CAP) or fv != fv:
                # same bound as sched_config._score_weight: the engine
                # multiplies weights in f32, where a f64-finite 1e39 is
                # inf and inf * 0.0 poisons every score with NaN
                raise SimulationError(
                    f"weights.{k} must be in [0, {MAX_WEIGHT_CAP:g}], "
                    f"got {fv}", code="E_SPEC", ref="request",
                    field=f"weights.{k}")
            weights[k] = fv
        max_weight = req_float("max_weight", 8.0, 0.0, MAX_WEIGHT_CAP)
        # the default grid self-trims to the ceiling; only EXPLICIT
        # out-of-bound values are the caller's error (below)
        grid_raw = body.get("grid_values",
                            [v for v in DEFAULT_GRID_VALUES
                             if v <= max_weight])
        if not isinstance(grid_raw, (list, tuple)) or not grid_raw:
            raise _bad("grid_values must be a non-empty list of numbers",
                       "grid_values")
        if len(grid_raw) > MAX_GRID_VALUES:
            raise _bad(
                f"grid_values must hold at most {MAX_GRID_VALUES} "
                f"values, got {len(grid_raw)}", "grid_values")
        grid_values = []
        for i, v in enumerate(grid_raw):
            if isinstance(v, bool):
                raise _bad(f"grid_values[{i}] must be a number, got {v!r}",
                           f"grid_values[{i}]")
            try:
                fv = float(v)
            except (TypeError, ValueError):
                raise _bad(f"grid_values[{i}] must be a number, got {v!r}",
                           f"grid_values[{i}]") from None
            if not (0.0 <= fv <= max_weight) or fv != fv:
                # a grid value past the clip ceiling would be silently
                # flattened to max_weight and dedup'd away — the search
                # would cover less space than the caller asked for
                raise _bad(f"grid_values[{i}] must be in "
                           f"[0, max_weight={max_weight:g}], got {fv}",
                           f"grid_values[{i}]",
                           "raise max_weight to widen the grid")
            grid_values.append(fv)
        sched_cfg = body.get("scheduler_config")
        if sched_cfg is not None:
            # inline KubeSchedulerConfiguration (YAML text or a parsed
            # object): its score weights become the search center
            from open_simulator_tpu_torch.engine.sched_config import (
                weight_overrides_from_doc,
                weight_overrides_from_text,
            )

            if isinstance(sched_cfg, str):
                ov = weight_overrides_from_text(sched_cfg,
                                                source="scheduler_config")
            else:
                ov = weight_overrides_from_doc(sched_cfg,
                                               source="scheduler_config")
            ov.pop("_disable_preemption", None)  # no preemption pass here
            for k, v in ov.items():
                if k in WEIGHT_FIELDS:
                    # explicit body weights win over the config file
                    weights.setdefault(k, float(v))
                else:
                    # filter-gate disables etc. stay STATIC engine config
                    config_overrides[k] = v
        return cls(
            mode=mode,
            variants=req_int("variants", 8, 1, MAX_LANES),
            rounds=req_int("rounds", 4 if mode == "cem" else 0, 0,
                           MAX_ROUNDS),
            seed=req_int("seed", 0, 0, 2**31 - 1),
            grid_values=tuple(grid_values),
            elite_frac=req_float("elite_frac", 0.25, 0.01, 1.0),
            sigma=req_float("sigma", 0.75, 0.0, 100.0),
            max_weight=max_weight,
            weights=weights,
            config_overrides=config_overrides,
        )


def _key(vec: np.ndarray) -> Tuple[float, ...]:
    """Dedup key: weight space quantized past float noise."""
    return tuple(round(float(v), 6) for v in vec)


def _objectives(nodes_row: np.ndarray,
                baseline_row: Optional[np.ndarray]) -> Dict[str, int]:
    placed = nodes_row >= 0
    unplaced = int(np.sum(~placed))
    cost = int(np.unique(nodes_row[placed]).size)
    if baseline_row is None:
        disruption = 0
    else:
        disruption = int(np.sum(nodes_row != baseline_row))
    return {"unplaced": unplaced, "cost": cost, "disruption": disruption,
            "placed": int(np.sum(placed))}


def _grid_variants(base: np.ndarray, values: Sequence[float],
                   max_weight: float) -> List[np.ndarray]:
    """Coordinate grid: baseline first, then one variant per (field,
    value) with the other axes held at the baseline."""
    out = [base.copy()]
    for k in range(len(WEIGHT_FIELDS)):
        for v in values:
            v = min(float(v), max_weight)
            if abs(v - float(base[k])) < 1e-9:
                continue
            vec = base.copy()
            vec[k] = v
            out.append(vec)
    return out


def pareto_points(points: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """The tune Pareto set: non-dominated under minimize-(unplaced,
    cost, disruption), sorted lexicographically (the frontier's shared
    dominance machinery; re-verified brute force in tier-1)."""
    return pareto_front(
        points, minimize=TUNE_OBJECTIVES,
        sort_key=lambda p: (p["unplaced"], p["cost"], p["disruption"],
                            p["vector"]))


def tune_search(cluster, apps, opts: Optional[TuneOptions] = None,
                validate: bool = True, device=None) -> Dict[str, Any]:
    """Search the score-weight space over one workload; returns the
    report dict (points, Pareto set, baseline, digest).

    One encode; every round runs ``opts.variants`` weight vectors as the
    lanes of one ``schedule_lanes`` launch on `device` (None = the card),
    the previous round's carry reused as its output buffer."""
    from open_simulator_tpu_torch.core import (
        _with_nodes,
        build_pod_sequence,
        with_volume_objects,
    )
    from open_simulator_tpu_torch.encode.snapshot import encode_cluster
    from open_simulator_tpu_torch.engine import scheduler
    from open_simulator_tpu_torch.k8s.loader import make_valid_node
    from open_simulator_tpu_torch.resilience import faults, lifecycle

    opts = opts or TuneOptions()
    t0 = time.perf_counter()
    tune_id = uuid.uuid4().hex[:12]
    nodes = [make_valid_node(n) for n in cluster.nodes]
    cluster = _with_nodes(cluster, nodes)
    apps = list(apps)
    if validate:
        from open_simulator_tpu_torch.resilience.admission import admit

        admit(cluster, apps)
    overrides = dict(opts.config_overrides)
    overrides.update({k: float(v) for k, v in opts.weights.items()})
    pods = build_pod_sequence(cluster, apps)
    snapshot = encode_cluster(nodes, pods, with_volume_objects(None, cluster, apps))
    cfg = scheduler.make_config(snapshot, traced_weights=True,
                                **overrides)._replace(fail_reasons=False)
    arrs, n_pods = snapshot.arrays, snapshot.n_pods
    active = np.asarray(arrs.active, dtype=bool)
    lanes = max(1, int(opts.variants))
    masks = np.tile(active, (lanes, 1))

    # The baseline is the incumbent policy and runs EXACTLY as
    # configured — max_weight bounds only the searched variants (a kube
    # weight of e.g. 100 must stay the disruption reference, not be
    # silently clipped to the search ceiling).
    base = weight_vector(cfg).astype(np.float32)
    seen: Dict[Tuple[float, ...], Dict[str, Any]] = {}
    points: List[Dict[str, Any]] = []
    baseline_row: Optional[np.ndarray] = None
    baseline_point: Optional[Dict[str, Any]] = None
    carry = None
    rounds_run = 0
    grid_truncated = False

    def _partial() -> Dict[str, Any]:
        return {"tune_id": tune_id, "rounds_done": rounds_run,
                "variants_done": len(points),
                "pareto_so_far": len(pareto_points(points)) if points else 0}

    def launch(m: np.ndarray, w: np.ndarray, c):
        return scheduler.schedule_lanes(arrs, m, cfg, device=device, carry=c, weights=w)

    def run_round(vecs: List[np.ndarray]) -> None:
        """Evaluate up to `lanes` FRESH vectors as one launch."""
        nonlocal carry, baseline_row, baseline_point, rounds_run
        fresh = []
        for v in vecs:
            k = _key(v)
            if k not in seen and all(_key(f) != k for f in fresh):
                fresh.append(v)
        if not fresh:
            return
        # the deadline/drain boundary: a cancelled request stops HERE,
        # between rounds, with the evaluated points as partials
        lifecycle.check_current("tune round boundary", partial=_partial)
        wmat = np.stack(fresh + [fresh[-1]] * (lanes - len(fresh)))
        try:
            out = faults.run_launch("tune_round", lambda: launch(masks, wmat, carry))
            nodes_out = out.node.cpu().numpy()[:, :n_pods]
            carry = out.state  # the next round's output buffer
        except faults.DeviceFault as f:
            if f.transient or lanes == 1:
                raise  # retries spent / nothing left to split
            # batch-split rung: this round's fresh vectors as two
            # half-width launches. A lane's outputs depend on its own
            # mask and weights only, so the points (and the report
            # digest) equal the full-width round's; the halves and the
            # next round start from new carries.
            faults.record_rung("tune_round", "batch_split", f.code)
            half = max(1, lanes // 2)
            rows = []
            for lo in range(0, len(fresh), half):
                seg = fresh[lo: lo + half]
                wm = np.stack(seg + [seg[-1]] * (half - len(seg)))
                out = launch(masks[:half], wm, None)
                rows.append(out.node.cpu().numpy()[: len(seg), :n_pods])
            nodes_out = np.concatenate(rows, axis=0)
            carry = None
        for i, vec in enumerate(fresh):
            row = nodes_out[i].copy()
            if baseline_row is None:
                baseline_row = row  # lane one of round one IS the baseline
            obj = _objectives(row, baseline_row)
            point = {
                "weights": {f: round(float(vec[j]), 6)
                            for j, f in enumerate(WEIGHT_FIELDS)},
                "vector": [round(float(v), 6) for v in vec],
                **obj,
            }
            seen[_key(vec)] = point
            points.append(point)
            if baseline_point is None:
                baseline_point = point
        rounds_run += 1

    if opts.mode == "grid":
        grid = _grid_variants(base, opts.grid_values, opts.max_weight)
        max_rounds = opts.rounds if opts.rounds > 0 else MAX_ROUNDS
        for lo in range(0, len(grid), lanes):
            if rounds_run >= max_rounds:
                # a bounded grid is NOT exhaustive — say so loudly
                grid_truncated = True
                break
            run_round(grid[lo: lo + lanes])
    else:  # cem
        rng = np.random.default_rng(opts.seed)
        sigma = np.full(len(WEIGHT_FIELDS), float(opts.sigma))
        mean = base.astype(np.float64)
        rounds = opts.rounds if opts.rounds > 0 else 4
        for ri in range(rounds):
            vecs = [base.copy()] if ri == 0 else []
            while len(vecs) < lanes:
                sample = rng.normal(mean, np.maximum(sigma, 1e-3))
                vecs.append(np.clip(sample, 0.0, opts.max_weight).astype(np.float32))
            run_round(vecs)
            # mutation/selection: elites (lexicographic over the tune
            # objectives) re-center the sampling distribution
            ranked = sorted(points, key=lambda p: (
                p["unplaced"], p["cost"], p["disruption"]))
            n_elite = max(2, int(round(len(ranked) * opts.elite_frac)))
            elite = np.asarray([p["vector"] for p in ranked[:n_elite]], dtype=np.float64)
            mean = elite.mean(axis=0)
            sigma = np.clip(elite.std(axis=0), 0.05, opts.sigma)

    front = pareto_points(points)
    digest = hashlib.sha256(json.dumps(points, sort_keys=True).encode()).hexdigest()[:16]
    report = {
        "tune_id": tune_id,
        "mode": opts.mode,
        "lane_width": lanes,
        "rounds_run": rounds_run,
        "n_variants": len(points),
        "n_pods": int(n_pods),
        "weight_fields": list(WEIGHT_FIELDS),
        "objectives": list(TUNE_OBJECTIVES),
        "baseline": baseline_point,
        "points": points,
        "pareto": front,
        "best": front[0] if front else None,
        "digest": digest,
        "wall_s": round(time.perf_counter() - t0, 6),
    }
    if grid_truncated:
        report["grid_truncated"] = True
    return report


def brute_force_pareto(points: List[Dict[str, Any]]
                       ) -> List[Dict[str, Any]]:
    """Reference O(W^2) dominance sweep over the tune objectives — the
    independent implementation the tier-1 tests hold `pareto_points`
    against (deliberately NOT sharing dominates_on)."""
    front = []
    for p in points:
        dominated = False
        for q in points:
            if (q["unplaced"] <= p["unplaced"] and q["cost"] <= p["cost"]
                    and q["disruption"] <= p["disruption"]
                    and (q["unplaced"] < p["unplaced"]
                         or q["cost"] < p["cost"]
                         or q["disruption"] < p["disruption"])):
                dominated = True
                break
        if not dominated:
            front.append(p)
    return sorted(front, key=lambda p: (p["unplaced"], p["cost"],
                                        p["disruption"], p["vector"]))


def format_tune(report: Dict[str, Any]) -> str:
    lines = [
        f"policy tune [{report['mode']}]: {report['n_variants']} "
        f"variant(s) over {report['rounds_run']} round(s) x "
        f"{report['lane_width']} lane(s) -> {len(report['pareto'])} "
        f"Pareto point(s) (digest {report['digest']})",
        f"  {'WEIGHTS (non-default)':<44} {'UNPLACED':>9} {'COST':>6} "
        f"{'DISRUPT':>8}",
    ]
    base = report.get("baseline") or {}
    base_w = base.get("weights", {})
    # the report's pareto list keeps EVERY non-dominated point (ties
    # included — that is what the brute-force check verifies); the human
    # view collapses objective-identical rows to one line with a count
    by_obj: Dict[Tuple[int, int, int], List[Dict[str, Any]]] = {}
    for p in report["pareto"]:
        by_obj.setdefault(
            (p["unplaced"], p["cost"], p["disruption"]), []).append(p)
    for (unp, cost, dis), ps in sorted(by_obj.items()):
        p = ps[0]
        delta = ",".join(
            f"{k.removeprefix('w_')}={v:g}"
            for k, v in p["weights"].items()
            if abs(v - base_w.get(k, v)) > 1e-9) or "(baseline)"
        if len(ps) > 1:
            delta += f" (+{len(ps) - 1} tied)"
        lines.append(f"  {delta:<44} {unp:>9} {cost:>6} {dis:>8}")
    if report.get("grid_truncated"):
        lines.append("  (grid truncated by --rounds: NOT exhaustive)")
    return "\n".join(lines)
