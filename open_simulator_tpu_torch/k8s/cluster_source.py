"""Cluster sources: where a campaign's cluster state comes from (the
reference's ``k8s/cluster_source.py``).

Two are ported: a YAML directory (``DirectorySource``) and a RECORDED API
DUMP (``ApiDumpSource``): the output of

    kubectl get nodes,pods,pdb,svc,sc,pvc,pv,configmaps,daemonsets \
        -A -o json > dump.json

(or any YAML/JSON stream of objects and v1 Lists), replayed with the
reference's snapshot semantics:

  * DaemonSet-owned and terminating pods are dropped — DS pods are
    regenerated by workload expansion;
  * Running pods are kept (carrying their nodeName binding), then Pending
    pods appended for re-scheduling;
  * Succeeded/Failed pods are dropped;
  * Deployments/ReplicaSets/StatefulSets/Jobs/CronJobs in the dump are
    dropped — their pods are already instances in the dump.

A kubeconfig file is refused: that source is ROADMAP queue 1, item 15.
PyYAML is imported where a YAML document is read, so the package imports
without it.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List

from open_simulator_tpu_torch.errors import SimulationError
from open_simulator_tpu_torch.k8s.loader import (
    ClusterResources,
    demux_object,
    load_resources_from_directory,
    parse_yaml_documents,
)


class ClusterSourceError(SimulationError, ValueError):
    """Unreadable or unparseable cluster source. Subclasses ValueError so
    pre-taxonomy `except ValueError` call sites keep working; carries the
    structured E_SOURCE code so fleet campaigns can quarantine the
    cluster with a machine-readable record instead of a traceback."""

    code = "E_SOURCE"


class DirectorySource:
    """The customConfig path: a directory of YAML manifests."""

    def __init__(self, path: str):
        self.path = path

    def load(self) -> ClusterResources:
        try:
            return load_resources_from_directory(self.path, strict=False)
        except ClusterSourceError:
            raise
        except Exception as e:  # noqa: BLE001 — any loader crash on a
            # mangled manifest becomes the structured E_SOURCE boundary
            raise ClusterSourceError(
                f"{self.path}: unreadable manifest directory "
                f"({type(e).__name__}: {e})", ref=f"source/{self.path}",
                hint="every file must hold parseable k8s YAML/JSON "
                     "objects") from e


class ApiDumpSource:
    """A recorded kubectl/API dump file (JSON or YAML, objects or Lists)."""

    def __init__(self, path: str):
        self.path = path

    def load(self) -> ClusterResources:
        try:
            return self._load()
        except ClusterSourceError:
            raise
        except Exception as e:  # noqa: BLE001 — a dump mangled ANYWHERE
            # (string metadata, list spec, ...) must surface as the
            # structured E_SOURCE taxonomy, never a loader traceback: the
            # campaign runner's quarantine boundary depends on it
            raise ClusterSourceError(
                f"{self.path}: unparseable recorded API dump "
                f"({type(e).__name__}: {e})", ref=f"source/{self.path}",
                hint="re-record with: kubectl get nodes,pods,... -A -o json"
            ) from e

    def _load(self) -> ClusterResources:
        docs = _read_documents(self.path)
        flat: List[Dict[str, Any]] = []
        for doc in docs:
            _flatten_lists(doc, flat)
        res = ClusterResources()
        running: List[Dict[str, Any]] = []
        pending: List[Dict[str, Any]] = []
        for obj in flat:
            kind = obj.get("kind", "")
            if kind == "Pod":
                if _owned_by_daemonset(obj) or _is_deleting(obj):
                    continue
                phase = ((obj.get("status") or {}).get("phase")) or "Pending"
                if phase == "Running":
                    running.append(obj)
                elif phase == "Pending":
                    pending.append(obj)
                continue  # Succeeded/Failed dropped
            if kind in ("Deployment", "ReplicaSet", "StatefulSet", "Job", "CronJob"):
                # live-snapshot semantics: these pods are already instances
                continue
            try:
                demux_object(obj, res)
            except Exception:
                continue  # unknown kinds in a dump are ignored
        for obj in running + pending:
            demux_object(obj, res)
        if not res.nodes:
            raise ClusterSourceError(
                f"{self.path}: recorded API dump contains no Node objects",
                ref=f"source/{self.path}",
                hint="include nodes in the recording: kubectl get "
                     "nodes,pods,... -A -o json")
        return res


def _read_documents(path: str) -> List[Dict[str, Any]]:
    """Parse a dump file into its mapping documents, or raise a structured
    ClusterSourceError (E_SOURCE) naming the path and the first bad line —
    an empty, truncated, or non-mapping file must never surface a raw
    json/yaml parser traceback (one malformed dump in a fleet campaign
    quarantines that cluster; it must not kill the batch)."""
    try:
        with open(path, "r", encoding="utf-8") as f:
            text = f.read()
    except (OSError, UnicodeDecodeError) as e:
        raise ClusterSourceError(
            f"{path}: cannot read recorded API dump ({e})",
            ref=f"source/{path}") from e
    stripped = text.lstrip()
    if not stripped:
        raise ClusterSourceError(
            f"{path}: file is empty — not a recorded API dump",
            ref=f"source/{path}",
            hint="record one with: kubectl get nodes,pods,... -A -o json")
    if stripped.startswith("{"):
        try:
            doc = json.loads(text)
        except json.JSONDecodeError as e:
            raise ClusterSourceError(
                f"{path}: truncated or invalid JSON at line {e.lineno}: "
                f"{e.msg}", ref=f"source/{path}", field=f"line {e.lineno}",
                hint="the dump was likely cut off mid-write; re-record it"
            ) from e
        if not isinstance(doc, dict):
            raise ClusterSourceError(
                f"{path}: top-level JSON is {type(doc).__name__}, expected "
                f"an object (a v1 List or a single resource)",
                ref=f"source/{path}", field="line 1") from None
        return [doc]
    import yaml

    try:
        docs = parse_yaml_documents(text)
    except yaml.YAMLError as e:
        mark = getattr(e, "problem_mark", None)
        line = (mark.line + 1) if mark is not None else "?"
        problem = getattr(e, "problem", None) or str(e).split("\n")[0]
        raise ClusterSourceError(
            f"{path}: invalid YAML at line {line}: {problem}",
            ref=f"source/{path}", field=f"line {line}",
            hint="the dump was likely cut off mid-write; re-record it"
        ) from e
    if not docs:
        kinds = {type(d).__name__ for d in yaml.safe_load_all(text)
                 if d is not None}
        what = (f"only top-level {'/'.join(sorted(kinds))} documents"
                if kinds else "no documents")
        raise ClusterSourceError(
            f"{path}: {what}, expected mappings with a 'kind' field",
            ref=f"source/{path}", field="line 1",
            hint="a dump is a stream of k8s objects or v1 Lists")
    return docs


def _flatten_lists(doc: Dict[str, Any], out: List[Dict[str, Any]]) -> None:
    if doc.get("kind") == "List" or "items" in doc and not doc.get("kind"):
        for item in doc.get("items") or []:
            if isinstance(item, dict):
                _flatten_lists(item, out)
    else:
        out.append(doc)


def _owned_by_daemonset(pod: Dict[str, Any]) -> bool:
    for ref in (pod.get("metadata") or {}).get("ownerReferences") or []:
        if ref.get("kind") == "DaemonSet":
            return True
    return False


def _is_deleting(pod: Dict[str, Any]) -> bool:
    return bool((pod.get("metadata") or {}).get("deletionTimestamp"))


def _looks_like_kubeconfig(path: str) -> bool:
    """Is the file a kubeconfig (kind Config with clusters)? A JSON file is
    read as JSON (YAML's superset gives the same mapping, at a fraction of
    the cost on a recorded dump of thousands of pods)."""
    try:
        with open(path, "r", encoding="utf-8") as f:
            text = f.read()
        if text.lstrip().startswith("{"):
            doc = json.loads(text)
        else:
            import yaml

            doc = yaml.safe_load(text)
    except Exception:
        return False
    return isinstance(doc, dict) and doc.get("kind") == "Config" and "clusters" in doc


def resolve_cluster_source(spec: str):
    """Path -> ClusterSource. Directories are manifest dirs; files are
    recorded API dumps; an actual kubeconfig gets the actionable error."""
    if os.path.isdir(spec):
        return DirectorySource(spec)
    if not os.path.exists(spec):
        raise ClusterSourceError(f"cluster source {spec!r} does not exist")
    if _looks_like_kubeconfig(spec):
        raise ClusterSourceError(
            f"{spec} is a kubeconfig: that cluster source is not ported yet "
            f"(ROADMAP queue 1, item 15). Record the cluster instead:\n"
            f"  kubectl get nodes,pods,pdb,svc,sc,pvc,pv,configmaps,daemonsets "
            f"-A -o json > dump.json\n"
            f"and point kubeConfig/--kubeconfig at dump.json"
        )
    return ApiDumpSource(spec)
