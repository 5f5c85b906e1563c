"""What replay's resume fingerprint needs of the reference's
``telemetry/ledger.py``: the engine config hash and the workload digest,
computed as there (the same arrays and config give the same strings in
both packages). RunRecords, the ledger directory and ``runs`` are ROADMAP
queue 1, item 11.
"""

from __future__ import annotations

import dataclasses
import hashlib

import numpy as np

# the content fields the workload digest hashes, besides every field's
# name and shape
_WORKLOAD_CONTENT_FIELDS = ("alloc", "req", "forced_node", "active",
                            "class_id", "gpu_cnt", "spread_valid")


def _sha(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()[:16]


def engine_config_hash(cfg) -> str:
    """Content hash of an EngineConfig, stable across processes (the
    extensions tuple hashes by the extensions' names)."""
    d = cfg._asdict()
    d["extensions"] = tuple(getattr(e, "name", repr(e)) for e in d.get("extensions", ()))
    return _sha(repr(sorted(d.items())).encode())


def workload_digest(arrs) -> str:
    """Digest of the encoded workload (host numpy): every field's name and
    shape, plus the raw bytes of the discriminative content fields."""
    h = hashlib.sha256()
    for f in dataclasses.fields(arrs):
        h.update(f"{f.name}:{tuple(np.shape(getattr(arrs, f.name)))};".encode())
    for name in _WORKLOAD_CONTENT_FIELDS:
        h.update(np.ascontiguousarray(np.asarray(getattr(arrs, name))).tobytes())
    return h.hexdigest()[:16]
