"""KubeSchedulerConfiguration -> engine overrides: a copy of the
reference's ``engine/sched_config.py``.

The file's Score plugin enable/disable/weight lists map onto EngineConfig
weight fields, and Filter/PreFilter plugin DISABLES map onto the engine's
feature gates (a disabled filter op contributes a constant-true mask,
exactly like the vendored framework skipping a de-registered plugin).
``tune --scheduler-config`` reads it; ``apply`` and ``explain``'s
``--default-scheduler-config`` is ROADMAP queue 1, item 15. PyYAML is
imported only where a text is parsed.
"""

from __future__ import annotations

import logging
from typing import Any, Dict

from open_simulator_tpu_torch.errors import SimulationError

log = logging.getLogger(__name__)

# plugin name -> EngineConfig weight field
_SCORE_PLUGIN_FIELDS = {
    "NodeResourcesBalancedAllocation": "w_balanced",
    "NodeResourcesFit": "w_least",
    "NodeResourcesLeastAllocated": "w_least",
    "NodeResourcesMostAllocated": "w_most",
    "NodeAffinity": "w_node_aff",
    "TaintToleration": "w_taint",
    "InterPodAffinity": "w_interpod",
    "PodTopologySpread": "w_spread",
    "Simon": "w_simon",
    "Open-Gpu-Share": "w_gpu",
}

# In-tree score plugins with no engine analog (image locality, volume
# topology scoring, legacy spread): a real KubeSchedulerConfiguration
# listing them must keep working on every surface (apply/explain/tune),
# so they warn and are ignored — only names outside BOTH tables are the
# structured E_SPEC reject (typos, out-of-tree plugins).
_SCORE_PLUGINS_UNMODELED = frozenset({
    "ImageLocality", "NodePreferAvoidPods", "RequestedToCapacityRatio",
    "SelectorSpread", "ServiceAffinity", "VolumeBinding", "NodeLabel",
    "EvenPodsSpread", "DefaultPodTopologySpread",
})

# Bin-packing score profile: MostAllocated replaces LeastAllocated /
# Balanced (and drops spread) so re-placement consolidates instead of
# spreading — the replay descheduler's defrag pass (replay/engine.py
# DEFRAG_OVERRIDES). Copy it (dict(...)) before mutating.
MOST_ALLOCATED_OVERRIDES: Dict[str, float] = {
    "w_least": 0.0, "w_balanced": 0.0, "w_most": 1.0, "w_spread": 0.0}

# Upper bound every score-weight validator enforces (here and the tune
# request body): far above kube's 1-100 plugin-weight range, far below
# float32 overflow — the engine multiplies weights in f32.
MAX_SCORE_WEIGHT = 1000.0

# filter/preFilter plugin name -> EngineConfig gate(s) a DISABLE turns off.
# NodeResourcesFit/NodeName have no gate (fit and forced binds are the
# engine's substrate) — disables of those warn and are ignored.
_FILTER_PLUGIN_GATES = {
    "NodeUnschedulable": ("enable_unsched",),
    "NodeAffinity": ("enable_class_aff",),
    "TaintToleration": ("enable_class_taint",),
    "NodePorts": ("enable_ports",),
    "InterPodAffinity": ("enable_pod_affinity", "enable_anti_affinity"),
    "PodTopologySpread": ("enable_spread_hard",),
    "VolumeBinding": ("enable_vol_static", "enable_pv_match"),
    "VolumeZone": (),   # folded into the vol_static masks; warn below
    "Open-Gpu-Share": ("enable_gpu",),
}


class SchedulerConfigError(SimulationError):
    """Malformed KubeSchedulerConfiguration — a structured E_SPEC (CLI
    `error:` exit, REST 400), never a traceback. (Historically a plain
    ValueError; the taxonomy subsumes it.)"""

    def __init__(self, message: str, **kw):
        kw.setdefault("code", "E_SPEC")
        kw.setdefault("ref", "scheduler_config")
        super().__init__(message, **kw)


def _req_list(container, key: str, where: str) -> list:
    v = container.get(key)
    if v is None:
        return []
    if not isinstance(v, list):
        raise SchedulerConfigError(
            f"{key} must be a list, got {type(v).__name__}",
            field=f"{where}.{key}")
    return v


def _entry_name(entry, where: str) -> str:
    """A plugin list entry must be a mapping with a string `name` —
    dropped keys / wrong types are the user's spec error (E_SPEC)."""
    if not isinstance(entry, dict):
        raise SchedulerConfigError(
            f"plugin entry must be an object, got {type(entry).__name__}",
            field=where, hint='e.g. {"name": "PodTopologySpread"}')
    name = entry.get("name")
    if not isinstance(name, str) or not name:
        raise SchedulerConfigError(
            "plugin entry needs a name", field=f"{where}.name",
            hint='e.g. {"name": "NodeResourcesFit", "weight": 5}')
    return name


def _score_weight(entry, where: str) -> float:
    """Score weights must be finite nonnegative numbers (the framework's
    own weight table holds small positive ints)."""
    raw = entry.get("weight", 1)
    if isinstance(raw, bool) or not isinstance(raw, (int, float)):
        raise SchedulerConfigError(
            f"weight must be a number, got {raw!r}",
            field=f"{where}.weight")
    w = float(raw)
    # the bound is not just sanity: the engine multiplies weights as
    # float32, where a f64-finite 1e39 is inf and inf * 0.0 poisons
    # every score with NaN (kube's own weight range is 1-100)
    if not (0.0 <= w <= MAX_SCORE_WEIGHT) or w != w:
        raise SchedulerConfigError(
            f"weight must be in [0, {MAX_SCORE_WEIGHT:g}], got {w}",
            field=f"{where}.weight")
    return w


def weight_overrides_from_doc(doc: Any,
                              source: str = "scheduler_config"
                              ) -> Dict[str, float]:
    """Parse a KubeSchedulerConfiguration document (already-loaded YAML)
    into EngineConfig kwargs. Every malformation — wrong container
    types, entries without names, non-numeric or negative weights,
    unknown SCORE plugin names — is a structured `SchedulerConfigError`
    (E_SPEC) naming the offending field; the ~50-seed mutation fuzz of the
    tests holds this boundary. Unknown FILTER plugin disables
    keep their documented warn-and-ignore behavior (they map to engine
    gates, and out-of-tree filter plugins are a legitimate thing to
    disable); unknown score names are errors because they silently
    change the weight question being asked."""
    if doc is None:
        doc = {}
    if not isinstance(doc, dict):
        raise SchedulerConfigError(
            f"{source}: document must be a mapping, got "
            f"{type(doc).__name__}", field="")
    kind = doc.get("kind", "")
    if kind and kind != "KubeSchedulerConfiguration":
        raise SchedulerConfigError(
            f"{source}: expected KubeSchedulerConfiguration, got {kind}",
            field="kind")
    profiles = doc.get("profiles") or []
    if not isinstance(profiles, list):
        raise SchedulerConfigError(
            f"profiles must be a list, got {type(profiles).__name__}",
            field="profiles")
    if not profiles:
        return {}
    prof = profiles[0] or {}
    if not isinstance(prof, dict):
        raise SchedulerConfigError(
            f"profile must be an object, got {type(prof).__name__}",
            field="profiles[0]")
    plugins = prof.get("plugins") or {}
    if not isinstance(plugins, dict):
        raise SchedulerConfigError(
            f"plugins must be an object, got {type(plugins).__name__}",
            field="profiles[0].plugins")
    overrides: Dict[str, Any] = {}
    for point in ("filter", "preFilter"):
        section = plugins.get(point) or {}
        if not isinstance(section, dict):
            raise SchedulerConfigError(
                f"{point} must be an object, got {type(section).__name__}",
                field=f"profiles[0].plugins.{point}")
        where = f"profiles[0].plugins.{point}"
        disabled = _req_list(section, "disabled", where)
        names = [_entry_name(e, f"{where}.disabled[{i}]")
                 for i, e in enumerate(disabled)]
        # shape-validate `enabled` whether or not the star branch reads
        # it: a malformed entry must be the same structured E_SPEC on
        # every path, not depend on which sub-list it landed in
        enabled_names = [
            _entry_name(e, f"{where}.enabled[{i}]")
            for i, e in enumerate(_req_list(section, "enabled", where))]
        star = "*" in names
        if star:
            for gates in _FILTER_PLUGIN_GATES.values():
                for g in gates:
                    overrides[g] = False
            # kube semantics: with `disabled: ['*']` the enabled list IS
            # the plugin set — those gates come back on
            for name in enabled_names:
                for g in _FILTER_PLUGIN_GATES.get(name, ()):
                    overrides[g] = True
        # explicit named disables always win (plain `enabled` entries
        # without a star merely append to the default set, which is the
        # autodetected-gate status quo — no override needed)
        for name in names:
            if name == "*":
                continue
            gates = _FILTER_PLUGIN_GATES.get(name)
            if gates:
                for g in gates:
                    overrides[g] = False
            else:
                log.warning(
                    "%s: cannot disable %s plugin %r — it has no engine "
                    "gate (resource fit and forced binds are the engine's "
                    "substrate; VolumeZone folds into the VolumeBinding "
                    "masks)", source, point, name,
                )
    post = plugins.get("postFilter") or {}
    if not isinstance(post, dict):
        raise SchedulerConfigError(
            f"postFilter must be an object, got {type(post).__name__}",
            field="profiles[0].plugins.postFilter")
    for i, entry in enumerate(
            _req_list(post, "disabled", "profiles[0].plugins.postFilter")):
        # DefaultPreemption disable is honored by the callers (simulate /
        # Simulator / Applier pop this pseudo-override before make_config)
        name = _entry_name(
            entry, f"profiles[0].plugins.postFilter.disabled[{i}]")
        if name in ("DefaultPreemption", "*"):
            overrides["_disable_preemption"] = True
    score = plugins.get("score") or {}
    if not isinstance(score, dict):
        raise SchedulerConfigError(
            f"score must be an object, got {type(score).__name__}",
            field="profiles[0].plugins.score")
    s_where = "profiles[0].plugins.score"
    for i, entry in enumerate(_req_list(score, "enabled", s_where)):
        where = f"{s_where}.enabled[{i}]"
        name = _entry_name(entry, where)
        field = _SCORE_PLUGIN_FIELDS.get(name)
        if field is None:
            if name in _SCORE_PLUGINS_UNMODELED:
                _score_weight(entry, where)  # malformed weight still rejects
                log.warning("%s: score plugin %r has no engine analog — "
                            "its weight is ignored", source, name)
                continue
            raise SchedulerConfigError(
                f"unknown score plugin {name!r}", field=f"{where}.name",
                hint="known score plugins: "
                     + ", ".join(sorted(_SCORE_PLUGIN_FIELDS)))
        overrides[field] = _score_weight(entry, where)
    for i, entry in enumerate(_req_list(score, "disabled", s_where)):
        where = f"{s_where}.disabled[{i}]"
        name = _entry_name(entry, where)
        if name == "*":
            overrides = {f: 0.0 for f in set(_SCORE_PLUGIN_FIELDS.values())} | overrides
            continue
        field = _SCORE_PLUGIN_FIELDS.get(name)
        if field is None:
            if name in _SCORE_PLUGINS_UNMODELED:
                continue  # nothing to disable — it never scores here
            raise SchedulerConfigError(
                f"unknown score plugin {name!r}", field=f"{where}.name",
                hint="known score plugins: "
                     + ", ".join(sorted(_SCORE_PLUGIN_FIELDS)))
        if field not in overrides:
            overrides[field] = 0.0
    plugin_config = prof.get("pluginConfig") or []
    if not isinstance(plugin_config, list):
        raise SchedulerConfigError(
            f"pluginConfig must be a list, got "
            f"{type(plugin_config).__name__}",
            field="profiles[0].pluginConfig")
    _apply_plugin_config(plugin_config, overrides)
    return overrides


def weight_overrides_from_text(text: str,
                               source: str = "scheduler_config"
                               ) -> Dict[str, float]:
    """Inline-YAML variant (the REST tune surface): parse errors are the
    caller's structured E_SPEC, never a yaml traceback."""
    import yaml

    try:
        doc = yaml.safe_load(text) or {}
    except yaml.YAMLError as e:
        raise SchedulerConfigError(
            f"{source}: not valid YAML/JSON: {e}", field="") from None
    return weight_overrides_from_doc(doc, source)


def weight_overrides_from_file(path: str) -> Dict[str, float]:
    """Parse a KubeSchedulerConfiguration file into EngineConfig kwargs."""
    with open(path, "r", encoding="utf-8") as f:
        text = f.read()
    return weight_overrides_from_text(text, source=path)


def _apply_plugin_config(plugin_config, overrides: Dict[str, float]) -> None:
    """pluginConfig args. NodeResourcesFitArgs.scoringStrategy selects the
    allocation-scoring direction (LeastAllocated default / MostAllocated
    bin-packing), the v1beta2+ replacement for the separate
    NodeResources{Least,Most}Allocated plugins."""
    for i, entry in enumerate(plugin_config):
        if not isinstance(entry, dict):
            raise SchedulerConfigError(
                f"pluginConfig entry must be an object, got "
                f"{type(entry).__name__}",
                field=f"profiles[0].pluginConfig[{i}]")
        if entry.get("name") != "NodeResourcesFit":
            continue
        args = entry.get("args") or {}
        if not isinstance(args, dict):
            raise SchedulerConfigError(
                f"args must be an object, got {type(args).__name__}",
                field=f"profiles[0].pluginConfig[{i}].args")
        strategy = args.get("scoringStrategy") or {}
        if not isinstance(strategy, dict):
            raise SchedulerConfigError(
                f"scoringStrategy must be an object, got "
                f"{type(strategy).__name__}",
                field=f"profiles[0].pluginConfig[{i}].args.scoringStrategy")
        stype = strategy.get("type", "")
        if stype == "MostAllocated":
            weight = overrides.get("w_least", 1.0)
            overrides["w_least"] = 0.0
            overrides["w_most"] = weight
        elif stype == "LeastAllocated":
            overrides["w_least"] = overrides.get("w_least", 1.0)
        # other strategy types / args (ignoredResources etc.) leave the
        # enable/disable weights untouched
