"""The reference's bucketed shapes (``engine/exec_cache.py``'s
``bucket_dim`` and ``bucket_shape``), host only.

The port pads only a fleet campaign's clusters (``engine/exec_cache.
pad_snapshot_arrays``): the reference groups a fleet's clusters by their
padded shape, so the report's ``buckets`` and ``launches`` are the
reference's only when the port pads and groups the same way. Every other
launch runs at the snapshot's own shapes. The port still needs the
reference's bucketed pod count there, because the reference plans its
waves over the padded pod axis (``core.simulate`` passes
``n_pods_total`` = the bucketed count to ``waves_for``), and the padded
tail can change the plan (``waves._coalesce`` counts its segment). The
port plans with the same count, so its plan and its per-pod wave decode
are the reference's, and its runner skips the segments past the real
pods. Replay's resume fingerprint and a campaign row's ``bucket`` record
the reference's bucketed shape (``bucket_shape``) for the same reason:
both packages ask the same question. Padding changes no real pod's
result (padded nodes are inactive, padded pods bind-nothing sentinels).
"""

from __future__ import annotations

import os
from typing import Tuple

# the reference's ladders: powers of two up to *_LINEAR_FROM, then
# multiples of *_LINEAR_STEP
NODE_LINEAR_FROM = 1024
NODE_LINEAR_STEP = 1024
POD_LINEAR_FROM = 2048
POD_LINEAR_STEP = 2048


def _bucketing() -> bool:
    return os.environ.get("SIMON_BUCKETING", "1") != "0"


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
    if not _bucketing():
        return n_pods
    return bucket_dim(n_pods, POD_LINEAR_FROM, POD_LINEAR_STEP)


def bucket_shape(n_nodes: int, n_pods: int) -> Tuple[int, int]:
    """The reference's padded (nodes, pods) shape for a snapshot
    (SIMON_BUCKETING=0: the shape itself)."""
    if not _bucketing():
        return n_nodes, n_pods
    return (bucket_dim(n_nodes, NODE_LINEAR_FROM, NODE_LINEAR_STEP),
            bucket_dim(n_pods, POD_LINEAR_FROM, POD_LINEAR_STEP))
