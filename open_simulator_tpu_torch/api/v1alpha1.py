"""The `simon/v1alpha1 Config` file schema.

Field-compatible with the reference's CR-style config
(pkg/api/v1alpha1/types.go:3-29, example/simon-config.yaml):

    apiVersion: simon/v1alpha1
    kind: Config
    metadata: {name: ...}
    spec:
      cluster:
        customConfig: <dir of cluster YAML>     # one of
        kubeConfig:  <kubeconfig path>          # the other
      appList:
        - {name: <app>, path: <dir|chart>, chart: <bool>}
      newNode: <dir or file with one Node yaml>
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import List


class ConfigError(ValueError):
    pass


@dataclass
class ClusterConfig:
    custom_config: str = ""
    kube_config: str = ""


@dataclass
class AppListEntry:
    name: str
    path: str
    chart: bool = False


@dataclass
class SimonConfig:
    name: str = ""
    cluster: ClusterConfig = field(default_factory=ClusterConfig)
    app_list: List[AppListEntry] = field(default_factory=list)
    new_node: str = ""

    def validate(self, base_dir: str = ".") -> None:
        """Path/shape validation (reference: pkg/apply/apply.go:268-306)."""
        if not self.cluster.custom_config and not self.cluster.kube_config:
            raise ConfigError("spec.cluster must set customConfig or kubeConfig")
        if self.cluster.custom_config and self.cluster.kube_config:
            raise ConfigError("spec.cluster: customConfig and kubeConfig are mutually exclusive")
        if self.cluster.custom_config:
            p = os.path.join(base_dir, self.cluster.custom_config)
            if not os.path.exists(p):
                raise ConfigError(f"cluster customConfig path not found: {p}")
        for app in self.app_list:
            p = os.path.join(base_dir, app.path)
            if not os.path.exists(p):
                raise ConfigError(f"app {app.name!r} path not found: {p}")
        if self.new_node:
            p = os.path.join(base_dir, self.new_node)
            if not os.path.exists(p):
                raise ConfigError(f"newNode path not found: {p}")


def load_config(path: str) -> SimonConfig:
    import yaml  # only where a config file is read

    with open(path, "r", encoding="utf-8") as f:
        doc = yaml.safe_load(f)
    if not isinstance(doc, dict):
        raise ConfigError(f"config {path}: not a YAML mapping")
    api = doc.get("apiVersion", "")
    kind = doc.get("kind", "")
    if api != "simon/v1alpha1" or kind != "Config":
        raise ConfigError(
            f"config {path}: expected apiVersion simon/v1alpha1 kind Config, got {api}/{kind}"
        )
    spec = doc.get("spec") or {}
    cluster = spec.get("cluster") or {}
    apps = []
    for a in spec.get("appList") or []:
        if not a.get("name") or not a.get("path"):
            raise ConfigError(f"config {path}: appList entries need name and path")
        apps.append(AppListEntry(name=a["name"], path=a["path"], chart=bool(a.get("chart", False))))
    return SimonConfig(
        name=(doc.get("metadata") or {}).get("name", ""),
        cluster=ClusterConfig(
            custom_config=cluster.get("customConfig", "") or "",
            kube_config=cluster.get("kubeConfig", "") or "",
        ),
        app_list=apps,
        new_node=spec.get("newNode", "") or "",
    )
