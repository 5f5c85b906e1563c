"""What replay's descheduler needs of the reference's ``apply/migrate.py``:
which pods a defrag may move. The one-shot migration planner and its CLI
are ROADMAP queue 1, item 8.
"""

from __future__ import annotations

from open_simulator_tpu_torch.k8s.local_storage import RES_DEVICE_HDD, RES_DEVICE_SSD
from open_simulator_tpu_torch.k8s.objects import Pod


def is_movable(pod: Pod) -> bool:
    """Owned by a rescheduling-tolerant controller (not a DaemonSet, not a
    bare unowned pod) and holding no exclusive local-storage device."""
    if pod.meta.owner_kind in ("", "DaemonSet"):
        return False
    req = pod.requests()
    if req.get(RES_DEVICE_HDD, 0) or req.get(RES_DEVICE_SSD, 0):
        return False  # exclusive local devices pin the pod
    return True
