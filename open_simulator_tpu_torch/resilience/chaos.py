"""What replay's node-failure events need of the reference's
``resilience/chaos.py``: the zone label, ``FaultEvent`` and
``_resolve_event`` (a fault's target -> the failed node indices). The
chaos plan, its re-simulation and the ``chaos`` CLI are ROADMAP queue 1,
item 8.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List

import numpy as np

from open_simulator_tpu_torch.errors import SimulationError

ZONE_KEY_DEFAULT = "topology.kubernetes.io/zone"


@dataclass(frozen=True)
class FaultEvent:
    """One fault: kill_node / drain_node target a node name; kill_zone
    targets a zone label value (all nodes carrying it fail together)."""

    kind: str
    target: str


def _resolve_event(ev: FaultEvent, zone_key: str, node_names: List[str],
                   node_labels: List[Dict[str, str]],
                   alive: np.ndarray) -> List[int]:
    if ev.kind in ("kill_node", "drain_node"):
        if ev.target not in node_names:
            raise SimulationError(
                f"node {ev.target!r} not found in cluster", code="E_SPEC",
                ref=f"node/{ev.target}", field="chaos_plan.events[].target",
                hint="targets must name nodes present in the snapshot")
        idx = node_names.index(ev.target)
        return [idx] if alive[idx] else []
    hit = [i for i, lb in enumerate(node_labels)
           if alive[i] and lb.get(zone_key) == ev.target]
    if not hit and not any(lb.get(zone_key) == ev.target for lb in node_labels):
        raise SimulationError(
            f"no node carries {zone_key}={ev.target!r}", code="E_SPEC",
            ref="chaos_plan", field="events[].target",
            hint=f"zone values present: "
                 f"{sorted({lb.get(zone_key) for lb in node_labels if zone_key in lb})}")
    return hit
