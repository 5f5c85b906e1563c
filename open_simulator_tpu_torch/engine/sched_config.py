"""What the port needs so far of the reference's ``engine/sched_config.py``:
the bin-packing score profile. Parsing a KubeSchedulerConfiguration file
(``--default-scheduler-config``) is ROADMAP queue 1, item 15.
"""

from __future__ import annotations

from typing import Dict

# Bin-packing score profile: MostAllocated replaces LeastAllocated /
# Balanced (and drops spread) so re-placement consolidates instead of
# spreading — the replay descheduler's defrag pass
# (replay/engine.py DEFRAG_OVERRIDES). Copy it (dict(...)) before
# mutating.
MOST_ALLOCATED_OVERRIDES: Dict[str, float] = {
    "w_least": 0.0, "w_balanced": 0.0, "w_most": 1.0, "w_spread": 0.0}
