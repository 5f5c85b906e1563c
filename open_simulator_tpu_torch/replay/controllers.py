"""Step controllers: the closed-loop half of trace replay (a copy of the
reference's ``replay/controllers.py``).

Between trace events the engine hands each registered controller a
``StepView`` (a host-side, read-only snapshot of the trajectory) and
applies the actions it proposes, re-simulating until no controller wants
anything more (or ``max_control_iters`` trips). Two policies ship:

``AutoscalerPolicy``
    The cluster-autoscaler loop: scale a node group UP when pods are
    pending (activating template-cloned slots the trace encoded up
    front), scale DOWN slots that sat empty for ``idle_steps``
    consecutive events — both honoring per-direction cooldowns measured
    in trace events. Only slots the autoscaler's group owns (the
    template range) are ever removed; the cluster's real nodes are not
    its to delete.

``DeschedulerPolicy``
    A periodic defrag loop generalizing ``apply/migrate.py``'s one-shot
    pass: every ``period`` events it asks the engine to unpin every
    *movable* placed pod and re-place the world under the bin-packing
    score profile (MostAllocated), consolidating fragmentation; pods
    that changed nodes are the recorded moves.

Controller contract: controllers are pure
HOST logic — they see a ``StepView``, return JSON-native action dicts,
and keep ALL internal state in a JSON-native ``state_dict()`` that the
replay journal records per step, so a resumed trajectory restores the
exact controller state and the continuation is bit-identical. Nothing
here touches the device.
"""

from __future__ import annotations

from typing import Any, Dict, List, NamedTuple

import numpy as np

from open_simulator_tpu_torch.errors import SimulationError


class StepView(NamedTuple):
    """What a controller may observe: the settled outcome of the current
    step's last simulation. Arrays are copies — controllers cannot
    mutate the trajectory directly."""

    step: int                 # step index (0 = baseline)
    t: float                  # the driving event's timestamp
    event_kind: str
    pending: int              # live pods with no node (retried every step)
    lost: int                 # live pods whose pinned node died (DaemonSets)
    placed: int
    active: np.ndarray        # [N] bool — node liveness incl. template slots
    pods_per_node: np.ndarray  # [N] int — live bound pods per node
    n_cluster_nodes: int      # real cluster nodes; template slots follow
    n_slots: int              # template slot count (the autoscaler's group)


def _int_dict(d: Dict[str, Any]) -> Dict[str, int]:
    return {str(k): int(v) for k, v in (d or {}).items()}


class AutoscalerPolicy:
    """Pending pods scale the group up; sustained idle scales it down."""

    kind = "autoscaler"

    def __init__(self, scale_step: int = 1, idle_steps: int = 2,
                 up_cooldown: int = 1, down_cooldown: int = 2,
                 max_nodes: int = 0):
        self.scale_step = max(1, int(scale_step))
        self.idle_steps = max(1, int(idle_steps))
        self.up_cooldown = max(1, int(up_cooldown))
        self.down_cooldown = max(1, int(down_cooldown))
        self.max_nodes = max(0, int(max_nodes))  # 0 = every template slot
        self._state: Dict[str, Any] = {"last_up": None, "last_down": None,
                                       "idle": {}}

    # -- identity / journal ------------------------------------------------

    @property
    def name(self) -> str:
        return self.kind

    def spec_dict(self) -> Dict[str, Any]:
        return {"kind": self.kind, "scale_step": self.scale_step,
                "idle_steps": self.idle_steps,
                "up_cooldown": self.up_cooldown,
                "down_cooldown": self.down_cooldown,
                "max_nodes": self.max_nodes}

    def state_dict(self) -> Dict[str, Any]:
        return {"last_up": self._state["last_up"],
                "last_down": self._state["last_down"],
                "idle": _int_dict(self._state["idle"])}

    def load_state(self, d: Dict[str, Any]) -> None:
        self._state = {"last_up": d.get("last_up"),
                       "last_down": d.get("last_down"),
                       "idle": _int_dict(d.get("idle") or {})}

    # -- the loop ----------------------------------------------------------

    def _cooled(self, last, step: int, cooldown: int) -> bool:
        # within one step the policy may keep acting (that IS convergence);
        # across steps the cooldown gates the next first action
        return last is None or last == step or step - last >= cooldown

    def _slot_indices(self, view: StepView) -> range:
        return range(view.n_cluster_nodes,
                     view.n_cluster_nodes + view.n_slots)

    def actions(self, view: StepView) -> List[Dict[str, Any]]:
        slots = self._slot_indices(view)
        if view.pending > 0:
            if not self._cooled(self._state["last_up"], view.step,
                                self.up_cooldown):
                return []
            inactive = [i for i in slots if not view.active[i]]
            cap = self.max_nodes or view.n_slots
            in_use = sum(1 for i in slots if view.active[i])
            take = min(self.scale_step, len(inactive), max(0, cap - in_use))
            if take <= 0:
                return []
            self._state["last_up"] = view.step
            return [{"kind": "scale_up", "nodes": [int(i) for i in
                                                   inactive[:take]]}]
        if not self._cooled(self._state["last_down"], view.step,
                            self.down_cooldown):
            return []
        idle = self._state["idle"]
        victims = [i for i in slots
                   if view.active[i] and view.pods_per_node[i] == 0
                   and idle.get(str(i), 0) >= self.idle_steps]
        if not victims:
            return []
        self._state["last_down"] = view.step
        return [{"kind": "scale_down", "nodes": [int(i) for i in victims]}]

    def observe(self, view: StepView) -> None:
        """End-of-step bookkeeping (after convergence): idle streaks per
        active template slot; inactive slots drop out of the table."""
        idle = {}
        for i in self._slot_indices(view):
            if view.active[i]:
                prev = self._state["idle"].get(str(i), 0)
                idle[str(i)] = prev + 1 if view.pods_per_node[i] == 0 else 0
        self._state["idle"] = idle


class DeschedulerPolicy:
    """Periodic defrag: every ``period`` events, re-place every movable
    pod under the bin-packing profile (the engine owns the mechanics —
    this policy only decides WHEN)."""

    kind = "descheduler"

    def __init__(self, period: int = 4):
        self.period = max(1, int(period))
        self._state: Dict[str, Any] = {"last_run": None}

    @property
    def name(self) -> str:
        return self.kind

    def spec_dict(self) -> Dict[str, Any]:
        return {"kind": self.kind, "period": self.period}

    def state_dict(self) -> Dict[str, Any]:
        return {"last_run": self._state["last_run"]}

    def load_state(self, d: Dict[str, Any]) -> None:
        self._state = {"last_run": d.get("last_run")}

    def actions(self, view: StepView) -> List[Dict[str, Any]]:
        if view.step == 0 or view.step % self.period != 0:
            return []
        if self._state["last_run"] == view.step:
            return []  # once per step — defrag converges in one pass
        if view.pending > 0:
            # defragging under pressure would thrash against the
            # autoscaler; wait for a quiet step
            return []
        self._state["last_run"] = view.step
        return [{"kind": "defrag"}]

    def observe(self, view: StepView) -> None:
        return None


_CONTROLLER_KINDS = {
    AutoscalerPolicy.kind: AutoscalerPolicy,
    DeschedulerPolicy.kind: DeschedulerPolicy,
}


def controller_from_dict(d: Dict[str, Any]):
    """Build one controller from a JSON spec ({"kind": "autoscaler",
    "scale_step": 2, ...}) with structured errors for unknown kinds or
    parameters (REST 400s, not 500s)."""
    if not isinstance(d, dict):
        raise SimulationError(
            f"controller spec must be an object, got {type(d).__name__}",
            code="E_SPEC", ref="replay_controllers", field="controllers[]",
            hint='e.g. {"kind": "autoscaler", "scale_step": 2}')
    kind = str(d.get("kind", ""))
    cls = _CONTROLLER_KINDS.get(kind)
    if cls is None:
        raise SimulationError(
            f"unknown controller kind {kind!r}", code="E_SPEC",
            ref="replay_controllers", field="controllers[].kind",
            hint=f"one of {', '.join(sorted(_CONTROLLER_KINDS))}")
    params = {k: v for k, v in d.items() if k != "kind"}
    try:
        params = {k: int(v) for k, v in params.items()}
        return cls(**params)
    except (TypeError, ValueError) as e:
        raise SimulationError(
            f"bad {kind} controller parameters {params!r}: {e}",
            code="E_SPEC", ref="replay_controllers", field="controllers[]",
            hint=f"known knobs: {sorted(cls().spec_dict())}") from None


def controller_from_arg(arg: str):
    """Parse the CLI form ``name[:k=v,k=v]`` (e.g.
    ``autoscaler:scale_step=2,idle_steps=3``)."""
    name, _, rest = arg.partition(":")
    spec: Dict[str, Any] = {"kind": name.strip()}
    for part in filter(None, (p.strip() for p in rest.split(","))):
        k, eq, v = part.partition("=")
        if not eq:
            raise SimulationError(
                f"bad controller parameter {part!r} (want k=v)",
                code="E_SPEC", ref="replay_controllers",
                field="--controller",
                hint="e.g. --controller autoscaler:scale_step=2")
        spec[k.strip()] = v.strip()
    return controller_from_dict(spec)


def controllers_digest(controllers) -> str:
    """Stable hash of the controller roster + parameters: part of the
    resume fingerprint (resuming with a different loop would diverge)."""
    import hashlib
    import json

    return hashlib.sha256(json.dumps(
        [c.spec_dict() for c in controllers], sort_keys=True
    ).encode()).hexdigest()[:16]
