"""Checkpoint and resume for simulations: the reference's
``utils/checkpoint.py`` over the port's ``SimState``.

A checkpoint is one ``.npz``: every carry field as ``state_<name>``, the
optional ``node_assign``, and ``meta_json`` (the user's meta, each field's
recorded dtype, and the snapshot's resource columns). The layout is the
reference's, so a file written by either package loads in the other:
``.npz`` cannot hold bfloat16, so a compact carry (``group_count``,
``term_block``) is stored widened to float32 with ``"bfloat16"`` recorded,
and comes back bit-equal (every bfloat16 value is a float32 value). The
port maps the recorded name to ``torch.bfloat16`` itself.

``slice_pods`` (``engine/scheduler.py``) is the unit of resume:
``schedule_pods(slice_pods(arrs, k, P), ..., state=carry)`` after
``schedule_pods(slice_pods(arrs, 0, k), ...)`` equals one scan of all P
pods.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional, Tuple

import numpy as np
import torch

from open_simulator_tpu_torch.engine.scheduler import STATE_FIELDS, SimState

# recorded dtype name -> torch dtype (the names numpy gives, as the
# reference records them)
_TORCH_DTYPES = {"float32": torch.float32, "float64": torch.float64, "int32": torch.int32,
                 "int64": torch.int64, "bool": torch.bool, "bfloat16": torch.bfloat16}
_STORED = (np.float32, np.float64, np.int32, np.int64, np.bool_)


def _host(x) -> Tuple[np.ndarray, str]:
    """A carry field as a storable numpy array and its dtype's name."""
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.to(torch.float32).numpy(), "bfloat16"
        a = t.numpy()
    else:
        a = np.asarray(x)
    name = str(a.dtype)
    if a.dtype not in _STORED:
        a = a.astype(np.float32)
    return a, name


def _tensor(a: np.ndarray, dtype_name: Optional[str] = None) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(a))
    want = _TORCH_DTYPES.get(dtype_name or str(a.dtype))
    if want is None:
        raise ValueError(f"checkpoint field dtype {dtype_name!r} is not a carry dtype")
    return t.to(want)


def save_simulation(
    path: str,
    state: SimState,
    node_assign=None,
    meta: Optional[dict] = None,
    resources: Optional[list] = None,
) -> None:
    """Write one .npz checkpoint. Pass `resources` (snapshot.resources) so
    a resume against a re-encoded cluster can detect a changed resource
    column order (the [N, R] carry records no names itself). A state
    loaded from a legacy file and not passed through ``resume_state``
    still holds `used` in its headroom field: it is written back in the
    legacy form (``state_used``), so the next load flags it again."""
    legacy_unconverted = bool(meta and meta.get("_headroom_is_legacy_used"))
    if meta:
        if resources is None and meta.get("_resources") is not None:
            resources = meta["_resources"]
        # other underscore keys are loader-internal
        meta = {k: v for k, v in meta.items() if not k.startswith("_")}
    arrays = {}
    dtypes = {}
    for k in STATE_FIELDS:
        a, name = _host(getattr(state, k))
        if k == "headroom" and legacy_unconverted:
            k = "used"
        dtypes[k] = name
        arrays[f"state_{k}"] = a
    if node_assign is not None:
        arrays["node_assign"] = _host(node_assign)[0]
    wrapper = {"user": meta or {}, "state_dtypes": dtypes}
    if resources is not None:
        wrapper["resources"] = list(resources)
    arrays["meta_json"] = np.frombuffer(json.dumps(wrapper).encode(), dtype=np.uint8)
    np.savez_compressed(path, **arrays)


def load_simulation(path: str) -> Tuple[SimState, Optional[np.ndarray], dict]:
    """(state on the CPU, node_assign or None, meta). Fields the file
    predates are filled as the reference fills them (``dom_count``,
    ``vol_cnt`` and ``svol_on_node`` with sentinel shapes that
    ``resume_state`` rebuilds or widens); a legacy ``state_used`` comes
    back in the headroom field, flagged in meta for ``resume_state``."""
    with np.load(path) as z:
        raw = json.loads(bytes(z["meta_json"]).decode()) if "meta_json" in z.files else {}
        if "state_dtypes" in raw:
            meta, dtypes = raw.get("user", {}), raw["state_dtypes"]
            if "resources" in raw:
                meta = dict(meta)
                meta["_resources"] = raw["resources"]
        else:  # a checkpoint with meta only, dtypes as stored
            meta, dtypes = raw, {}
        fields = {}
        for k in z.files:
            if k.startswith("state_"):
                name = k[len("state_"):]
                fields[name] = _tensor(z[k], dtypes.get(name))
        if "used" in fields and "headroom" not in fields:
            fields["headroom"] = fields.pop("used")
            meta = dict(meta)
            meta["_headroom_is_legacy_used"] = True
        n = fields["headroom"].shape[0] if "headroom" in fields else 0
        for name in STATE_FIELDS:
            if name in fields:
                continue
            if name == "dom_count":
                # (0, 0, S): resume_state rebuilds it from group_count
                s_cols = fields["group_count"].shape[1] if "group_count" in fields else 1
                fields[name] = torch.zeros((0, 0, s_cols), dtype=torch.float32)
            elif name == "pv_taken":
                fields[name] = torch.zeros((0,), dtype=torch.bool)
            elif name == "vol_cnt":
                fields[name] = torch.zeros((0, 0), dtype=torch.float32)
            elif name == "svol_on_node":
                fields[name] = torch.zeros((0, 0), dtype=torch.bool)
            else:
                fields[name] = torch.zeros(
                    (n, 1), dtype=torch.bool if name == "sdev_taken" else torch.float32)
        state = SimState(**{f: fields[f] for f in STATE_FIELDS})
        node_assign = z["node_assign"] if "node_assign" in z.files else None
    return state, node_assign, meta


def _host_array(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def resume_state(state: SimState, arrs, meta: dict,
                 resources: Optional[list] = None) -> SimState:
    """Make a loaded state resumable against its snapshot arrays (host
    numpy or tensors): rebuild a back-filled dom_count from the per-node
    group_count (dom_count[k,d,s] = sum_n topo_onehot[k,n,d] *
    group_count[n,s]; 0/1 counts, so exact in any order), widen the
    attachment carries, and convert a legacy `used` carry to headroom =
    alloc - used. `meta` is the dict ``load_simulation`` returned (it
    carries the legacy marker, popped here so a second call cannot
    convert twice). With `resources`, the checkpoint's [N, R] column order
    must match the snapshot's."""
    if meta is None:
        raise TypeError(
            "resume_state requires the meta dict load_simulation returned "
            "(it carries the legacy-used conversion marker)")
    alloc = _host_array(arrs.alloc)
    if tuple(state.headroom.shape) != alloc.shape:
        raise ValueError(
            f"checkpoint carry shape {tuple(state.headroom.shape)} does "
            f"not match the snapshot's [N, R] {alloc.shape} "
            "— was the cluster re-encoded with different nodes or resources?")
    saved_res = meta.get("_resources")
    if saved_res is not None and resources is not None and list(saved_res) != list(resources):
        raise ValueError(
            f"checkpoint resource columns {list(saved_res)} do not match the "
            f"snapshot's {list(resources)} — the [N, R] carry would silently "
            "mix columns; re-encode with the original pod set or discard the "
            "checkpoint")
    if meta.pop("_headroom_is_legacy_used", False):
        state = dataclasses.replace(state, headroom=torch.from_numpy(
            alloc.astype(np.float32) - _host_array(state.headroom).astype(np.float32)))
    topo = _host_array(arrs.topo_onehot)
    k1, _, d = topo.shape
    s = state.group_count.shape[1]
    state = _widen_vol_cnt(state, arrs)
    if tuple(state.dom_count.shape) == (k1, d, s):
        return state
    gc = _host_array(state.group_count.to(torch.float32))
    rebuilt = np.einsum("knd,ns->kds", topo, gc).astype(np.float32)
    return dataclasses.replace(state, dom_count=torch.from_numpy(rebuilt))


def _widen_vol_cnt(state: SimState, arrs) -> SimState:
    n = _host_array(arrs.alloc).shape[0]
    want = (n, _host_array(arrs.vol_limit_cap).shape[1])
    if tuple(state.vol_cnt.shape) != want:
        state = dataclasses.replace(state, vol_cnt=torch.zeros(want, dtype=torch.float32))
    want_sv = (n, _host_array(arrs.svol_key).shape[0])
    if tuple(state.svol_on_node.shape) != want_sv:
        state = dataclasses.replace(state, svol_on_node=torch.zeros(want_sv, dtype=torch.bool))
    return state
