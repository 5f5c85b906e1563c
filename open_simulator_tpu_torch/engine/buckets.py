"""The reference's bucketed pod count (``engine/exec_cache.py``'s
``bucket_dim`` and the pod half of ``bucket_shape``), host only.

The port pads nothing: it runs every launch at the snapshot's own shapes.
It still needs the reference's bucketed pod count, because the reference
plans its waves over the padded pod axis (``core.simulate`` passes
``n_pods_total`` = the bucketed count to ``waves_for``), and the padded
tail can change the plan (``waves._coalesce`` counts its segment). The
port plans with the same count, so its plan and its per-pod wave decode
are the reference's, and its runner skips the segments past the real
pods.
"""

from __future__ import annotations

import os

# the reference's pod-axis ladder: powers of two up to POD_LINEAR_FROM,
# then multiples of POD_LINEAR_STEP
POD_LINEAR_FROM = 2048
POD_LINEAR_STEP = 2048


def bucket_dim(n: int, linear_from: int, linear_step: int) -> int:
    """Smallest bucket boundary >= n (n <= 0 passes through untouched)."""
    if n <= 0:
        return n
    if n <= linear_from:
        p = 1
        while p < n:
            p *= 2
        return p
    return -(-n // linear_step) * linear_step


def bucket_pods(n_pods: int) -> int:
    """The reference's padded pod-axis length for `n_pods` pods
    (SIMON_BUCKETING=0 turns the padding off, as in the reference)."""
    if os.environ.get("SIMON_BUCKETING", "1") == "0":
        return n_pods
    return bucket_dim(n_pods, POD_LINEAR_FROM, POD_LINEAR_STEP)
