"""Fleet discovery: a directory or manifest of recorded cluster dumps (the
reference's ``campaign/fleet.py``).

A *fleet* is the campaign runner's input: an ordered list of named
cluster sources, each with a content digest. Three spellings resolve to
the same ``ClusterEntry`` list:

* a **directory**: every ``*.json`` / ``*.yaml`` / ``*.yml`` file is one
  recorded API dump (``k8s/cluster_source.ApiDumpSource`` semantics), and
  every subdirectory is one manifest-dir cluster (``DirectorySource``);
* a **manifest file** (YAML/JSON): either a plain list of paths or
  ``{"clusters": [{"name": ..., "path": ...} | "<path>", ...]}``, paths
  relative to the manifest's directory;
* an explicit **list of paths** (the REST body's ``clusters`` field).

The digest is a content hash of the source bytes — it joins the
EngineConfig hash in the campaign journal's per-cluster fingerprint, so
``campaign run --resume`` can prove a replayed cluster is the same
question the crashed run answered (ARCHITECTURE.md §13).

Everything here is host-side stdlib (PyYAML only where a manifest is
read); errors are structured ``E_SOURCE``.
"""

from __future__ import annotations

import hashlib
import json
import os
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence

from open_simulator_tpu_torch.k8s.cluster_source import (
    ClusterSourceError,
    resolve_cluster_source,
)

DUMP_EXTENSIONS = (".json", ".yaml", ".yml")


@dataclass
class ClusterEntry:
    """One cluster in a fleet: a name, a loader, and a source digest.

    ``error`` marks an entry whose source was missing/unreadable at
    discovery time: the entry still joins the fleet (fault isolation is
    PER CLUSTER — one bad file must not abort the campaign) and its
    ``load()`` raises the structured error inside the runner's
    quarantine boundary."""

    name: str
    path: str
    digest: str
    # deferred so a fleet of thousands only pays parse cost per cluster,
    # inside the campaign's per-cluster fault boundary
    loader: Optional[Callable[[], Any]] = None
    error: Optional[ClusterSourceError] = None

    def load(self):
        if self.error is not None:
            raise self.error
        if self.loader is not None:
            return self.loader()
        return resolve_cluster_source(self.path).load()


def _hash_file(h, path: str) -> None:
    # fixed-size chunks: real cluster dumps run to hundreds of MB, and
    # discovery must not spike RAM to the largest dump in the fleet
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)


def source_digest(path: str) -> str:
    """Content hash of a cluster source: file bytes, or for a manifest
    directory every contained file's (relative name, bytes), sorted."""
    h = hashlib.sha256()
    try:
        if os.path.isdir(path):
            for root, dirs, files in os.walk(path):
                dirs.sort()
                for fn in sorted(files):
                    full = os.path.join(root, fn)
                    h.update(os.path.relpath(full, path).encode())
                    _hash_file(h, full)
        else:
            _hash_file(h, path)
    except OSError as e:
        raise ClusterSourceError(
            f"{path}: cannot read cluster source ({e})",
            ref=f"source/{path}") from e
    return h.hexdigest()[:16]


def _entry_for(path: str, name: Optional[str] = None) -> ClusterEntry:
    """Build one fleet entry. A missing/unreadable source does NOT raise
    here — discovery happens before the per-cluster fault boundary and
    the journal exist, so an error now would let one bad file kill the
    whole campaign; instead the entry carries the structured error (and
    a deterministic sentinel digest) and quarantines when it runs."""
    name = name or os.path.splitext(os.path.basename(path))[0]
    err: Optional[ClusterSourceError] = None
    digest = ""
    if not os.path.exists(path):
        err = ClusterSourceError(
            f"cluster source {path!r} does not exist",
            ref=f"source/{path}")
    else:
        try:
            digest = source_digest(path)
        except ClusterSourceError as e:
            err = e
    if err is not None:
        # deterministic stand-in so fleet/journal digests stay stable
        # while the source stays broken (it becoming readable is real
        # fleet drift and correctly refuses a resume)
        digest = "unreadable-" + hashlib.sha256(
            path.encode()).hexdigest()[:8]
    return ClusterEntry(name=name, path=path, digest=digest, error=err)


def _unique_names(entries: List[ClusterEntry]) -> List[ClusterEntry]:
    """Names key journal replay — a fleet with two ``a.json`` files (in
    different subtrees) must not alias; collide into name#2, name#3."""
    seen: Dict[str, int] = {}
    for e in entries:
        n = seen.get(e.name, 0) + 1
        seen[e.name] = n
        if n > 1:
            e.name = f"{e.name}#{n}"
    return entries


def discover_fleet(spec: str) -> List[ClusterEntry]:
    """Resolve a fleet spec (directory or manifest file) to entries,
    sorted by path for a deterministic campaign order."""
    if not spec:
        raise ClusterSourceError(
            "no fleet given", ref="fleet",
            hint="pass a directory of recorded dumps or a manifest file")
    if os.path.isdir(spec):
        entries = []
        for name in sorted(os.listdir(spec)):
            full = os.path.join(spec, name)
            if os.path.isdir(full):
                entries.append(_entry_for(full, name=name))
            elif name.lower().endswith(DUMP_EXTENSIONS):
                entries.append(_entry_for(full))
        if not entries:
            raise ClusterSourceError(
                f"{spec}: fleet directory holds no cluster dumps "
                f"({'/'.join(DUMP_EXTENSIONS)} files or subdirectories)",
                ref=f"fleet/{spec}")
        return _unique_names(entries)
    if not os.path.exists(spec):
        raise ClusterSourceError(
            f"fleet spec {spec!r} does not exist", ref=f"fleet/{spec}")
    return _unique_names(_parse_manifest(spec))


def entries_for_paths(paths: Sequence[str]) -> List[ClusterEntry]:
    """Entries for an explicit path list (the REST ``clusters`` field)."""
    if not paths:
        raise ClusterSourceError("empty cluster list", ref="fleet")
    return _unique_names([_entry_for(str(p)) for p in paths])


def _parse_manifest(path: str) -> List[ClusterEntry]:
    import yaml

    base = os.path.dirname(os.path.abspath(path))
    try:
        with open(path, "r", encoding="utf-8") as f:
            doc = yaml.safe_load(f.read())
    except (OSError, UnicodeDecodeError, yaml.YAMLError) as e:
        raise ClusterSourceError(
            f"{path}: unreadable fleet manifest ({e})",
            ref=f"fleet/{path}") from e
    if isinstance(doc, dict):
        items = doc.get("clusters")
    else:
        items = doc
    if not isinstance(items, list) or not items:
        raise ClusterSourceError(
            f"{path}: a fleet manifest is a list of dump paths or "
            f"{{'clusters': [...]}}; got "
            f"{type(doc).__name__ if doc is not None else 'an empty file'}",
            ref=f"fleet/{path}")
    entries = []
    for item in items:
        if isinstance(item, dict):
            p, name = item.get("path", ""), item.get("name") or None
        else:
            p, name = str(item), None
        if not p:
            raise ClusterSourceError(
                f"{path}: manifest entry {item!r} has no path",
                ref=f"fleet/{path}")
        if not os.path.isabs(p):
            p = os.path.join(base, p)
        entries.append(_entry_for(p, name=name))
    return entries


def fleet_digest(entries: Sequence[ClusterEntry], scenario: str,
                 overrides: Optional[Dict[str, Any]] = None) -> str:
    """The campaign-scope fingerprint: (name, source digest) per cluster
    plus the scenario name and engine overrides. A resumed campaign must
    match it exactly — replayed rows answer a different question
    otherwise (the §11 SweepJournal verify contract, fleet-shaped)."""
    body = {
        "clusters": [[e.name, e.digest] for e in entries],
        "scenario": scenario,
        "overrides": {str(k): repr(v)
                      for k, v in sorted((overrides or {}).items())},
    }
    return hashlib.sha256(
        json.dumps(body, sort_keys=True).encode()).hexdigest()[:16]


# ---- synthetic fleets (bench / smoke / tests) ----------------------------


def write_synthetic_fleet(root: str, n_clusters: int = 3,
                          nodes: int = 4, pods: int = 12,
                          malformed: int = 0, seed: int = 0) -> List[str]:
    """Write a deterministic fleet of recorded-API-dump JSON files under
    ``root`` and return their paths. Clusters alternate between two sizes
    so a heterogeneous fleet still lands in a handful of shape buckets
    (the executable-sharing property §9/§13 campaigns exploit). The last
    ``malformed`` files are deliberately truncated mid-object — the
    quarantine fixtures for smoke and tests."""
    from open_simulator_tpu_torch.resilience import faults

    os.makedirs(root, exist_ok=True)
    paths = []
    for ci in range(n_clusters):
        name = f"cluster-{ci:02d}"
        path = os.path.join(root, name + ".json")
        paths.append(path)
        if ci >= n_clusters - malformed:
            def write_torn(p: str = path) -> None:
                # cut off mid-write: the classic torn dump
                with open(p, "w", encoding="utf-8") as f:
                    f.write('{"kind": "List", "items": [{"kind": "Node", ')

            faults.run_io("fleet_fixture", write_torn)
            continue
        # two shapes across the fleet -> two exec-cache buckets
        n_n = nodes if ci % 2 == 0 else max(2, nodes // 2)
        n_p = pods if ci % 2 == 0 else max(2, pods // 2)
        items = []
        for i in range(n_n):
            items.append({
                "kind": "Node", "apiVersion": "v1",
                "metadata": {
                    "name": f"{name}-n{i}",
                    "labels": {
                        "kubernetes.io/hostname": f"{name}-n{i}",
                        "topology.kubernetes.io/zone": f"z{i % 2}",
                    }},
                "status": {"allocatable": {
                    "cpu": "4", "memory": "8Gi", "pods": "110"}},
            })
        for i in range(n_p):
            # a mix of recorded Running pods (forced binds the audit must
            # see honored) and Pending pods the campaign re-schedules
            running = i % 3 != 0
            pod = {
                "kind": "Pod", "apiVersion": "v1",
                "metadata": {"name": f"app-{i}", "namespace": "prod",
                             "labels": {"app": f"w{(seed + i) % 4}"}},
                "spec": {"containers": [{
                    "name": "c",
                    "resources": {"requests": {
                        "cpu": f"{100 + ((seed + i) % 5) * 50}m",
                        "memory": f"{128 + ((seed + i) % 3) * 64}Mi"}}}]},
                "status": {"phase": "Running" if running else "Pending"},
            }
            if running:
                pod["spec"]["nodeName"] = f"{name}-n{i % n_n}"
            items.append(pod)
        def write_dump(p: str = path, payload: List[Dict] = items) -> None:
            with open(p, "w", encoding="utf-8") as f:
                json.dump({"kind": "List", "apiVersion": "v1",
                           "items": payload}, f, indent=1)

        faults.run_io("fleet_fixture", write_dump)
    return paths
