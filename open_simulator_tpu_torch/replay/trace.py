"""The replay trace model: an ordered sequence of timed cluster events
(a copy of the reference's ``replay/trace.py``).

A ``ReplayTrace`` is the time axis the one-shot simulator does not have:
pods arrive and leave, nodes join and fail, and the
whole trajectory is executed as a closed loop over the bucketed scan
(replay/engine.py). The model is deliberately JSON/YAML-native — a trace
file round-trips through ``from_dict``/``to_dict`` byte-stably, and its
``digest()`` anchors the replay journal's resume fingerprint.

Event kinds:

  ``arrive``       a pod batch lands: ``app`` = {"name", "yaml"} with a
                   multi-doc k8s manifest (Deployments/Pods/...), expanded
                   exactly like an apply app
  ``depart``       pods complete/leave: ``app`` names a prior arrival
                   (the whole batch departs) or ``pods`` lists ns/name keys
  ``node_add``     activate ``count`` new nodes cloned from the trace's
                   ``node_template`` (the capacity the autoscaler also
                   draws from)
  ``node_remove``  gracefully remove one node by name: its pods unbind
                   and reschedule (DaemonSet pods die with the node)
  ``kill_node`` / ``kill_zone`` / ``drain_node``
                   the ChaosPlan fault kinds (resilience/chaos.py),
                   replayed mid-trajectory instead of as a standalone plan

Timestamps are opaque non-decreasing numbers (seconds, minutes — the
engine only uses their order; the values ride into the report rows).

Validation raises the structured ``SimulationError`` taxonomy (code
``E_SPEC`` with the offending ``events[i].field`` named): a malformed
trace is the client's error, never a traceback.
"""

from __future__ import annotations

import hashlib
import json
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from open_simulator_tpu_torch.errors import SimulationError
from open_simulator_tpu_torch.resilience.chaos import ZONE_KEY_DEFAULT

CHAOS_KINDS = ("kill_node", "kill_zone", "drain_node")
KINDS = ("arrive", "depart", "node_add", "node_remove") + CHAOS_KINDS
# the synthetic step-0 row every trajectory starts with (not a trace kind)
BASELINE_KIND = "baseline"


def _spec_err(message: str, field_name: str, hint: str = "") -> SimulationError:
    return SimulationError(message, code="E_SPEC", ref="replay_trace",
                           field=field_name, hint=hint)


@dataclass(frozen=True)
class TraceEvent:
    """One timed event. Only the fields its kind uses are meaningful."""

    t: float
    kind: str
    app: Optional[Dict[str, str]] = None   # arrive: {"name", "yaml"}
    app_name: str = ""                     # depart: a prior arrival's name
    pods: Tuple[str, ...] = ()             # depart: explicit ns/name keys
    count: int = 0                         # node_add
    target: str = ""                       # node_remove + chaos kinds

    @classmethod
    def from_dict(cls, d: Dict[str, Any], index: int = 0) -> "TraceEvent":
        if not isinstance(d, dict):
            raise _spec_err(
                f"event must be an object, got {type(d).__name__}",
                f"events[{index}]",
                hint='e.g. {"t": 0, "kind": "arrive", "app": {...}}')
        raw_t = d.get("t", None)
        try:
            t = float(raw_t)
        except (TypeError, ValueError):
            raise _spec_err(
                f"event timestamp must be a number, got {raw_t!r}",
                f"events[{index}].t",
                hint='e.g. {"t": 10, "kind": "depart", ...}') from None
        app = d.get("app")
        app_name = ""
        if d.get("kind") == "depart" and isinstance(app, str):
            # depart's app is a NAME reference; arrive's is an object
            app, app_name = None, app
        elif app is not None and not isinstance(app, dict):
            raise _spec_err(
                f"app must be an object, got {type(app).__name__}",
                f"events[{index}].app",
                hint='{"app": {"name": "a1", "yaml": "..."}} (arrive) or '
                     '{"app": "a1"} (depart)')
        raw_pods = d.get("pods") or ()
        if not isinstance(raw_pods, (list, tuple)):
            raise _spec_err(
                f"pods must be a list of ns/name keys, got "
                f"{type(raw_pods).__name__}", f"events[{index}].pods")
        try:
            count = int(d.get("count", 0))
        except (TypeError, ValueError):
            raise _spec_err(
                f"count must be an integer, got {d.get('count')!r}",
                f"events[{index}].count") from None
        return cls(t=t, kind=str(d.get("kind", "")), app=app,
                   app_name=app_name,
                   pods=tuple(str(p) for p in raw_pods),
                   count=count, target=str(d.get("target", "")))

    def to_dict(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {"t": self.t, "kind": self.kind}
        if self.kind == "arrive":
            out["app"] = dict(self.app or {})
        elif self.kind == "depart":
            if self.app_name:
                out["app"] = self.app_name
            if self.pods:
                out["pods"] = list(self.pods)
        elif self.kind == "node_add":
            out["count"] = int(self.count)
        else:
            out["target"] = self.target
        return out

    def row_dict(self) -> Dict[str, Any]:
        """The event as a journal/report row: app yaml bodies are elided
        to their names (rows must stay small and deterministic; the full
        manifest already anchors the trace digest)."""
        out = self.to_dict()
        if self.kind == "arrive":
            out["app"] = (self.app or {}).get("name", "")
        return out


@dataclass
class ReplayTrace:
    """An ordered, validated event sequence plus the node headroom the
    trajectory may scale into (``max_new_nodes`` template-cloned slots)."""

    events: List[TraceEvent] = field(default_factory=list)
    max_new_nodes: int = 0
    node_template: str = ""               # Node spec YAML (one document)
    zone_key: str = ZONE_KEY_DEFAULT

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ReplayTrace":
        if not isinstance(d, dict):
            raise _spec_err(
                f"trace must be an object, got {type(d).__name__}", "trace",
                hint='{"events": [...], "max_new_nodes": 4, ...}')
        raw_events = d.get("events")
        if raw_events is None:
            raise _spec_err("trace has no events", "events",
                            hint='add events like {"t": 0, "kind": "arrive", '
                                 '"app": {"name": "a", "yaml": "..."}}')
        if not isinstance(raw_events, list):
            raise _spec_err(
                f"events must be a list, got {type(raw_events).__name__}",
                "events")
        raw_max = d.get("max_new_nodes", 0)
        try:
            max_new = int(raw_max)
        except (TypeError, ValueError):
            raise _spec_err(
                f"max_new_nodes must be an integer, got {raw_max!r}",
                "max_new_nodes") from None
        tmpl = d.get("node_template") or ""
        if isinstance(tmpl, dict):  # {"spec_yaml": "..."} REST convenience
            tmpl = tmpl.get("spec_yaml") or ""
        return cls(
            events=[TraceEvent.from_dict(e, i)
                    for i, e in enumerate(raw_events)],
            max_new_nodes=max_new,
            node_template=str(tmpl),
            zone_key=str(d.get("zone_key") or ZONE_KEY_DEFAULT),
        )

    def to_dict(self) -> Dict[str, Any]:
        return {
            "events": [e.to_dict() for e in self.events],
            "max_new_nodes": int(self.max_new_nodes),
            "node_template": self.node_template,
            "zone_key": self.zone_key,
        }

    def digest(self) -> str:
        """Content hash of the canonical trace dict — part of the replay
        journal's resume fingerprint (a changed trace answers a
        different question)."""
        return hashlib.sha256(
            json.dumps(self.to_dict(), sort_keys=True).encode()
        ).hexdigest()[:16]

    def arrivals(self) -> List[TraceEvent]:
        return [e for e in self.events if e.kind == "arrive"]

    def validate(self, allow_empty: bool = False) -> None:
        """Structural validation with structured errors. Does NOT parse
        app manifests (that needs the k8s loaders and happens at build
        time, still behind the same taxonomy). ``allow_empty`` is the
        digital-twin session case: a freshly created session holds a
        baseline trajectory with no events yet."""
        if not self.events and not allow_empty:
            raise _spec_err(
                "trace has no events", "events",
                hint='add events like {"t": 0, "kind": "arrive", ...}')
        if self.max_new_nodes < 0:
            raise _spec_err(
                f"max_new_nodes must be >= 0, got {self.max_new_nodes}",
                "max_new_nodes")
        needs_template = self.max_new_nodes > 0 or any(
            e.kind == "node_add" for e in self.events)
        if needs_template and not self.node_template.strip():
            raise _spec_err(
                "node_add events / max_new_nodes > 0 need a node_template "
                "(a Node spec YAML the new slots are cloned from)",
                "node_template",
                hint='add node_template: "<Node yaml>" to the trace')
        seen_apps: set = set()
        prev_t: Optional[float] = None
        total_added = 0
        for i, ev in enumerate(self.events):
            if ev.kind not in KINDS:
                raise _spec_err(
                    f"unknown event kind {ev.kind!r}", f"events[{i}].kind",
                    hint=f"one of {', '.join(KINDS)}")
            if ev.t != ev.t or ev.t in (float("inf"), float("-inf")):
                raise _spec_err(
                    f"event timestamp must be finite, got {ev.t!r}",
                    f"events[{i}].t")
            if prev_t is not None and ev.t < prev_t:
                raise _spec_err(
                    f"timestamps must be non-decreasing: t={ev.t} after "
                    f"t={prev_t}", f"events[{i}].t",
                    hint="sort the events by t (ties are fine — they run "
                         "in list order)")
            prev_t = ev.t
            if ev.kind == "arrive":
                app = ev.app or {}
                if not isinstance(app, dict):
                    # directly-constructed events (from_dict already
                    # rejects this shape with the event index named)
                    raise _spec_err(
                        f"app must be an object, got "
                        f"{type(app).__name__}", f"events[{i}].app")
                name = str(app.get("name") or "")
                if not name:
                    raise _spec_err(
                        "arrive event needs app.name",
                        f"events[{i}].app.name",
                        hint='{"app": {"name": "a1", "yaml": "..."}}')
                if not str(app.get("yaml") or "").strip():
                    raise _spec_err(
                        f"arrive event for app {name!r} has no manifest",
                        f"events[{i}].app.yaml",
                        hint="a multi-doc k8s YAML of the arriving workload")
                if name in seen_apps:
                    raise _spec_err(
                        f"duplicate arrival app name {name!r} (names key "
                        f"departures and batch bookkeeping)",
                        f"events[{i}].app.name")
                seen_apps.add(name)
            elif ev.kind == "depart":
                if not ev.app_name and not ev.pods:
                    raise _spec_err(
                        "depart event needs an app name or a pods list",
                        f"events[{i}]",
                        hint='{"kind": "depart", "app": "a1"} or '
                             '{"kind": "depart", "pods": ["default/p0"]}')
                if ev.app_name and ev.app_name not in seen_apps:
                    raise _spec_err(
                        f"depart references app {ev.app_name!r} which never "
                        f"arrived earlier in the trace",
                        f"events[{i}].app")
            elif ev.kind == "node_add":
                if ev.count < 1:
                    raise _spec_err(
                        f"node_add count must be >= 1, got {ev.count}",
                        f"events[{i}].count")
                total_added += ev.count
                if total_added > self.max_new_nodes:
                    raise _spec_err(
                        f"node_add events total {total_added} nodes but "
                        f"max_new_nodes is {self.max_new_nodes}",
                        f"events[{i}].count",
                        hint="raise max_new_nodes (template slots are "
                             "encoded once, up front)")
            else:  # node_remove + chaos kinds
                if not ev.target:
                    raise _spec_err(
                        f"{ev.kind} event has no target",
                        f"events[{i}].target",
                        hint="node kinds take a node name, kill_zone a "
                             "zone label value")


def clone_template_nodes(template, count: int, prefix: str = "sim-new"):
    """Deterministically-named clones of a node template (the new-node
    slots replay scales into). ``k8s.loader.new_fake_nodes`` draws RANDOM
    names, which would leak nondeterminism into re-encoded resume
    fingerprints and journal rows — replay names its slots by index
    (now the shared ``k8s.loader.deterministic_fake_nodes``, which the
    serving snapshot cache uses for the same reason)."""
    from open_simulator_tpu_torch.k8s.loader import deterministic_fake_nodes

    return deterministic_fake_nodes(template, count, prefix=prefix)


def parse_node_template(yaml_text: str):
    """Parse + validate the trace's node template YAML into a Node."""
    import yaml as _yaml

    from open_simulator_tpu_torch.k8s.loader import make_valid_node
    from open_simulator_tpu_torch.k8s.objects import Node

    try:
        doc = _yaml.safe_load(yaml_text)
    except _yaml.YAMLError as e:
        raise _spec_err(f"node_template is not valid YAML: {e}",
                        "node_template") from None
    if not isinstance(doc, dict):
        raise _spec_err(
            f"node_template must be a Node object, got "
            f"{type(doc).__name__}", "node_template")
    return make_valid_node(Node.from_dict(doc))
