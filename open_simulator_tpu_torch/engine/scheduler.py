"""The scheduler engine in torch: config, carry, prefix fold, the plain
step and ``schedule_pods``.

One step is one kube-scheduler scheduleOne over all N nodes (the
reference's ``engine/scheduler.py:_step``): filter masks, first-fail reason
counts, raw scores, the normalizer reductions, selectHost and the bind into
the carry. ``_step`` below is the plain torch twin of the reference's step
for the ops this package runs — the plain-fit ops (unschedulable, class
node affinity, class taints, host ports, fit per resource), required pod
affinity and anti-affinity (both directions, the ``slot_paint`` and the
dense form), hard and soft PodTopologySpread on both of its carries (the
per-domain ``dom_count`` and the per-node ``group_count``), the
interpod preference score with its ``pref_paint`` carry, and the
device-resource ops: GPU share (filter, score, device pick), open-local
storage (LVM packing, exclusive devices), the static volume class masks,
WaitForFirstConsumer PV matching, attach limits and shared-volume dedup.
Under ``traced_weights`` each lane's step multiplies by its own [K] row
of score weights (``schedule_lanes(weights=)``, ``WEIGHT_FIELDS`` order),
every weight-gated row kept live. Out-of-tree extension ops
(``engine/extensions.ExtensionOp``, ``cfg.extensions``) add their filter
masks after the built-in ones, each in its own reason row, and their
scores after the built-in rows; their callables read the carry, so the
engine evaluates them on the host before each pod and runs the step one
pod at a time (``_extension_scan``).

``schedule_lanes`` runs S lanes (active masks) in one launch and
``schedule_pods`` is its one-lane case. On a CUDA device the pod loop is
the hand-written kernel ``csrc/plain_step.cu`` (``kernels/step.py``); the
plain step runs only for CPU tensors, and as the yardstick the kernel is
held equal to. Given a wave plan (``engine/waves.py``), both run it
(``_run_wave_plan``): the scan segments through the step, each batched
wave through the step's frozen form and one ``kernels/wave.wave_merge``.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Mapping
from dataclasses import dataclass
from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from open_simulator_tpu_torch.encode.snapshot import (
    OP_FIT_BASE,
    SLOT_CAP,
    ClusterSnapshot,
    SnapshotArrays,
)
from open_simulator_tpu_torch.ops import filters, gpu_share, scores, storage, threefry, volumes
from open_simulator_tpu_torch.ops.domains import ActiveHoist, hoist_active_stats

# fp32 everywhere, and no TF32 in the plain merge's matmuls: encoded counts
# and requests go up to 2^24, and TF32 keeps integers exact only to 2^11.
torch.backends.cuda.matmul.allow_tf32 = False
torch.set_float32_matmul_precision("highest")

# The K score-plugin weights, in the order the traced-weights mode
# (EngineConfig.traced_weights) takes them: the reference's WEIGHT_FIELDS,
# the v1beta2 plugin weight table as one [K] axis, which lets tuning run
# W policy variants as the lanes of one launch (tune/search.py).
WEIGHT_FIELDS: Tuple[str, ...] = (
    "w_balanced", "w_least", "w_most", "w_node_aff", "w_taint",
    "w_interpod", "w_spread", "w_simon", "w_gpu")


def weight_vector(cfg: "EngineConfig") -> np.ndarray:
    """The config's own weights as the [K] f32 vector the traced-weights
    mode takes (WEIGHT_FIELDS order). A traced run at this vector gives
    the constant run's placements, counts, carry and digest."""
    return np.asarray([getattr(cfg, f) for f in WEIGHT_FIELDS], dtype=np.float32)


class EngineConfig(NamedTuple):
    """Static engine configuration — a copy of the reference's
    ``EngineConfig`` (field for field, so a config means the same thing
    in both packages)."""

    n_resources: int
    cpu_mem_idx: Tuple[int, ...] = (0, 1)
    enable_gpu: bool = False
    enable_storage: bool = False
    w_balanced: float = 1.0
    w_least: float = 1.0
    w_most: float = 0.0
    w_node_aff: float = 1.0
    w_taint: float = 1.0
    w_interpod: float = 1.0
    w_spread: float = 2.0
    w_simon: float = 1.0
    w_gpu: float = 1.0
    tie_break_seed: int = 0
    scan_unroll: int = 6
    # group_count/term_block stored bfloat16 (integer-exact below 256);
    # make_config turns it off when a node could hold >= 255 pods
    compact_carry: bool = True
    fail_reasons: bool = True
    enable_ports: bool = True
    enable_pod_affinity: bool = True
    enable_anti_affinity: bool = True
    enable_spread_hard: bool = True
    enable_spread_soft: bool = True
    enable_pref: bool = True
    enable_node_aff_score: bool = True
    enable_taint_score: bool = True
    spread_hostname: bool = True
    enable_unsched: bool = True
    enable_class_aff: bool = True
    enable_class_taint: bool = True
    enable_vol_static: bool = False
    enable_pv_match: bool = False
    enable_vol_limits: bool = False
    enable_vol_dedup: bool = False
    slot_paint: bool = False
    extensions: Tuple = ()
    explain_topk: int = 0
    forced_prefix: int = 0
    compile_cache_dir: str = ""
    wave_scheduling: bool = True
    traced_weights: bool = False

    @property
    def enable_spread(self) -> bool:
        return self.enable_spread_hard or self.enable_spread_soft

    @property
    def maintain_dom_count(self) -> bool:
        return self.enable_spread and (
            not self.needs_group_count or bool(self.extensions))

    @property
    def needs_group_count(self) -> bool:
        return (self.enable_pod_affinity or self.enable_anti_affinity
                or self.enable_pref
                or (self.enable_spread and self.spread_hostname))

    @property
    def n_ops(self) -> int:
        return (OP_FIT_BASE + self.n_resources + 10
                + sum(1 for e in self.extensions if e.filter_fn is not None))

    @property
    def extension_op_names(self) -> Tuple[str, ...]:
        return tuple(e.name for e in self.extensions if e.filter_fn is not None)


@dataclass
class SimState:
    """The carry — the reference's twelve ``SimState`` arrays as tensors.
    A lane-batched carry has a leading [S] axis on every field."""

    headroom: torch.Tensor      # [N, R] f32 = alloc - used
    group_count: torch.Tensor   # [N, S] bf16 | f32
    term_block: torch.Tensor    # [N, T] bf16 | f32
    pref_paint: torch.Tensor    # [N, T2] f32
    ports_used: torch.Tensor    # [N, Pt] bool
    gpu_used: torch.Tensor      # [N, G] f32
    vg_used: torch.Tensor       # [N, V] f32
    sdev_taken: torch.Tensor    # [N, E] bool
    dom_count: torch.Tensor     # [K1, D, S] f32
    pv_taken: torch.Tensor      # [Npv] bool
    vol_cnt: torch.Tensor       # [N, Lk] f32
    svol_on_node: torch.Tensor  # [N, Nsv] bool


STATE_FIELDS = tuple(f.name for f in dataclasses.fields(SimState))


class ScheduleOutput(NamedTuple):
    node: torch.Tensor         # [P] i32, -1 = unscheduled
    fail_counts: torch.Tensor  # [P, OPS] i32
    feasible: torch.Tensor     # [P] i32 feasible-node count
    gpu_pick: torch.Tensor     # [P, G] i32 per-device GPU multiplicities (G = 0 when gated off)
    vol_pick: torch.Tensor     # [P, Lw] i32 PV id bound per WFC claim slot, -1 none (Lw = 0 off)
    # explain_topk (K = min(explain_topk, N), C = len(score_part_names);
    # both 0 when off): the candidates by final score, -3.4e38 past the
    # feasible nodes, and each score row's weighted value at them
    topk_node: torch.Tensor    # [P, K] i32
    topk_score: torch.Tensor   # [P, K] f32
    topk_parts: torch.Tensor   # [P, C, K] f32
    state: SimState


def resolve_device(device=None) -> torch.device:
    """None means the card. A CUDA device without CUDA raises: the entry
    points never fall back to the CPU on their own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain torch "
            "step on the CPU")
    return dev


def device_arrays(arrs: SnapshotArrays, device) -> SnapshotArrays:
    """Host numpy (or tensors) -> tensors on `device` (one transfer per
    field; a tensor already there is kept as it is)."""
    def put(x):
        if isinstance(x, torch.Tensor):
            return x.to(device)
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)

    return SnapshotArrays(**{f.name: put(getattr(arrs, f.name)) for f in dataclasses.fields(arrs)})


def init_state(arrs: SnapshotArrays, cfg: Optional[EngineConfig] = None) -> SimState:
    """Fresh carry for tensor-valued `arrs` (on their device)."""
    dev = arrs.alloc.device
    n, _ = arrs.alloc.shape
    s = arrs.match_groups.shape[1]
    f32 = torch.float32
    cdt = torch.bfloat16 if (cfg is not None and cfg.compact_carry) else f32
    k1, _, d = arrs.topo_onehot.shape

    def z(shape, dt):
        return torch.zeros(shape, dtype=dt, device=dev)

    return SimState(
        headroom=arrs.alloc.to(f32).clone(),
        group_count=z((n, s), cdt),
        term_block=z((n, arrs.own_terms.shape[1]), cdt),
        pref_paint=z((n, arrs.hit_pref.shape[1]), f32),
        ports_used=z((n, arrs.ports.shape[1]), torch.bool),
        gpu_used=z((n, arrs.gpu_slot.shape[1]), f32),
        vg_used=z((n, arrs.vg_cap.shape[1]), f32),
        sdev_taken=z((n, arrs.sdev_cap.shape[1]), torch.bool),
        dom_count=z((k1, d, s), f32),
        pv_taken=z((arrs.pv_node_ok.shape[0],), torch.bool),
        vol_cnt=z((n, arrs.vol_limit_cap.shape[1]), f32),
        svol_on_node=z((n, arrs.svol_key.shape[0]), torch.bool),
    )


# the reference's prefix-fold chunk: a bf16 carry adds each chunk's sum
# rounded once
_PREFIX_CHUNK = 4096


def apply_forced_prefix(arrs: SnapshotArrays, cfg: EngineConfig,
                        state: SimState, k: int) -> SimState:
    """Fold the first k pods (all forced binds) into a copy of the carry at
    once — what k steps of the forced fast path would do: the reference's
    ``apply_forced_prefix``, ``apply_forced_mask`` with the first k pods
    set. The GPU, storage and WFC carries depend on the order of the
    binds, so ``make_config`` cuts the prefix where a pod uses them."""
    return _fold_forced(arrs, cfg, state, arrs.forced_node[:k].to(torch.int32))


def apply_forced_mask(arrs: SnapshotArrays, cfg: EngineConfig,
                      state: SimState, mask: torch.Tensor) -> SimState:
    """Fold every pod with `mask` set into a copy of the carry at its
    forced node, wherever it sits in pod order — the reference's
    ``apply_forced_mask`` (its one-hot fold at Precision.HIGHEST):
    ``kernels/wave.forced_fold`` (the kernel on the card, its plain
    version on the CPU) in ``_PREFIX_CHUNK`` chunks as the reference folds
    (a bf16 carry adds each chunk's sum rounded once). The 0/1 weights and
    integer-valued requests keep every sum exact below 2^24. Callers gate
    it as the reference does: no order-dependent GPU, storage, WFC or
    shared-volume carry among the masked pods. A masked pod with no
    forced node folds at node 0, as the reference's clamped one-hot does
    (its callers mask only forced pods)."""
    return _fold_forced(arrs, cfg, state, arrs.forced_node.to(torch.int32),
                        mask.to(torch.bool))


def _fold_forced(arrs: SnapshotArrays, cfg: EngineConfig, state: SimState,
                 nodes: torch.Tensor, mask: Optional[torch.Tensor] = None) -> SimState:
    """Fold pods [0, len(nodes)) into a new carry, pod p at ``nodes[p]``
    (negative: not folded; with `mask`, at ``max(nodes[p], 0)`` where
    ``mask[p]``): one ``forced_fold`` call, a launch pair a
    ``_PREFIX_CHUNK``-pod chunk, which writes every field of the new
    carry from `state` and the folds."""
    from open_simulator_tpu_torch.kernels import wave as wave_kernels

    state = SimState(**{f: getattr(state, f).contiguous() for f in STATE_FIELDS})
    out = SimState(**{f: torch.empty_like(getattr(state, f)) for f in STATE_FIELDS})
    wave_kernels.forced_fold(arrs, cfg, state, 0, nodes.shape[0], nodes.contiguous(), out=out,
                             mask=None if mask is None else mask.contiguous())
    return out


def score_part_names(cfg: EngineConfig) -> Tuple[str, ...]:
    """The names of the weighted score rows the step records under
    ``explain_topk``, in the topk_parts row order (the reference's
    ``score_part_names``: the score extensions last, in registration
    order)."""
    names = ["NodeResources"]
    for on, name in zip(score_rows(cfg), ("NodeAffinity", "TaintToleration",
                                          "InterPodAffinity", "PodTopologySpread", "Simon")):
        if on:
            names.append(name)
    if cfg.enable_gpu:
        names.append("Open-Gpu-Share")
    names += [e.name for e in cfg.extensions if e.score_fn is not None]
    return tuple(names)


def topk_widths(arrs, cfg: EngineConfig) -> Tuple[int, int]:
    """(K, C) of the top-k outputs: 0, 0 with explain_topk off."""
    if not cfg.explain_topk:
        return 0, 0
    return min(cfg.explain_topk, arrs.alloc.shape[0]), len(score_part_names(cfg))


def score_rows(cfg: EngineConfig) -> Tuple[bool, bool, bool, bool, bool]:
    """Which normalized score rows the step adds: node affinity, taint
    toleration, interpod preference, soft spread, Simon. A zero weight or
    a gated-off op drops its row entirely (the reference's ``use_*``
    gates); under the traced weights every enabled row stays live, and a
    zero weight adds its ``0 x value`` in its place in the sum."""
    tw = cfg.traced_weights
    return (bool(tw or cfg.w_node_aff) and cfg.enable_node_aff_score,
            bool(tw or cfg.w_taint) and cfg.enable_taint_score,
            bool(tw or cfg.w_interpod) and cfg.enable_pref,
            bool(tw or cfg.w_spread) and cfg.enable_spread_soft,
            bool(tw or cfg.w_simon))


def resource_terms(cfg: EngineConfig) -> Tuple[bool, bool, bool]:
    """Which NodeResources terms the step adds: balanced, least, most
    (every one under the traced weights)."""
    tw = cfg.traced_weights
    return (bool(tw or cfg.w_balanced), bool(tw or cfg.w_least), bool(tw or cfg.w_most))


def step_weights(cfg: EngineConfig, weights: Optional[torch.Tensor]):
    """The nine weights one lane's step multiplies by, in WEIGHT_FIELDS
    order: the config's floats, or under the traced weights the lane's
    [K] f32 row as 0-dim f32 tensors (never a Python double)."""
    if not cfg.traced_weights:
        return tuple(getattr(cfg, f) for f in WEIGHT_FIELDS)
    if weights is None:
        raise ValueError("cfg.traced_weights is on but no weight row reached the step")
    return tuple(weights[i] for i in range(len(WEIGHT_FIELDS)))


def _column_reads(arrs: SnapshotArrays, host: Dict[str, np.ndarray],
                  gc: torch.Tensor, p: int):
    """The batched carry-column read: the pod's [aff | anti | spread]
    selector-group columns of group_count as f32 [N, Q], each column's
    domain sums per non-hostname key [K1, D, Q], the per-node domain count
    [N, Q] (hostname-keyed columns read themselves) and the key presence
    [Q, N]. Integer counts: every sum is exact."""
    f32 = torch.float32
    dev = gc.device
    gid = np.concatenate([host["aff_group"][p], host["anti_group"][p],
                          host["spread_group"][p]]).astype(np.int64)
    gkey = np.concatenate([host["aff_key"][p], host["anti_key"][p],
                           host["spread_key"][p]]).astype(np.int64)
    colsf = gc[:, torch.from_numpy(np.maximum(gid, 0)).to(dev)].to(f32)  # [N, Q]
    k1s = arrs.topo_onehot.shape[0]
    pd_list = []
    back = None
    for kk in range(k1s):
        ohk = arrs.topo_onehot[kk]                                      # [N, D]
        pdk = ohk.T @ colsf                                             # [D, Q]
        pd_list.append(pdk)
        bk = ohk @ pdk                                                  # [N, Q]
        if k1s == 1:
            back = bk
        else:
            sel = torch.from_numpy((np.maximum(gkey - 1, 0) == kk).astype(np.float32)).to(dev)
            back = bk * sel[None, :] if back is None else back + bk * sel[None, :]
    is_host = torch.from_numpy(gkey == 0).to(dev)
    dc_all = colsf if back is None else torch.where(is_host[None, :], colsf, back)
    nh_all = arrs.has_key[torch.from_numpy(np.maximum(gkey, 0)).to(dev)] > 0   # [Q, N]
    pd_stack = torch.stack(pd_list) if pd_list else None                # [K1, D, Q]
    return colsf, dc_all, nh_all, pd_stack


def _step(arrs: SnapshotArrays, host: Dict[str, np.ndarray], active: torch.Tensor,
          cfg: EngineConfig, hoist: ActiveHoist, inv_alloc: torch.Tensor,
          state: SimState, p: int, disabled: bool = False,
          nominated: Optional[int] = None, weights: Optional[torch.Tensor] = None,
          ext_ok: Optional[torch.Tensor] = None, ext_raw: Optional[torch.Tensor] = None):
    """One pod's scheduleOne: the plain torch twin of the reference's
    ``_step`` for this package's ops. `arrs` holds tensors on the step's
    device; `host` holds the per-pod slot arrays as numpy (forced node,
    class, selector groups, keys, term ids), so static per-pod choices
    branch on the host the way the reference's gates select code. `hoist`
    is one lane's ActiveHoist. `disabled` and `nominated` are the pod's
    preemption columns (the reference's ``_disabled`` and ``_nominated``):
    a victim, and the preemption retry's node (None: no column). Returns
    (state, (node, fail_counts, feasible, gpu_pick, vol_pick, topk_node,
    topk_score, topk_parts)) with the outputs as device tensors; the
    top-k rows have width 0 unless ``cfg.explain_topk``. `weights` is the
    lane's [K] f32 row under ``cfg.traced_weights`` (WEIGHT_FIELDS order;
    every enabled score row stays live), None otherwise. With
    ``cfg.tie_break_seed`` the jitter is keyed on `p`, the pod's place in
    the whole sequence (the reference's ``_pod_index``). `ext_ok` [Ef, N]
    and `ext_raw` [Es, N] are the pod's extension rows under
    ``cfg.extensions``: what each filter and score callable returned for
    this lane's carry, in registration order."""
    n_nodes = arrs.alloc.shape[0]
    dev = active.device
    f32 = torch.float32
    big = 3.4e38
    true_v = torch.ones((n_nodes,), dtype=torch.bool, device=dev)
    cid = int(host["class_id"][p])
    req = arrs.req[p]

    def t(a):  # a host per-pod row -> a tensor on the step's device
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def fill(v):
        return torch.full((n_nodes,), v, dtype=f32, device=dev)

    gc = state.group_count if cfg.needs_group_count else None
    gcr = gc is not None and (cfg.enable_pod_affinity or cfg.enable_anti_affinity
                              or cfg.enable_spread)
    a_w = host["aff_group"].shape[1]
    b_w = host["anti_group"].shape[1]
    cs_n = host["spread_group"].shape[1]
    if gcr:
        colsf, dc_all, nh_all, pd_stack = _column_reads(arrs, host, gc, p)

    ok_unsched = ~arrs.unschedulable if cfg.enable_unsched else true_v
    ok_aff = arrs.class_affinity[cid] if cfg.enable_class_aff else true_v
    ok_taint = arrs.class_taint[cid] if cfg.enable_class_taint else true_v
    ok_ports = (filters.ports_free(state.ports_used, arrs.ports[p])
                if cfg.enable_ports else true_v)
    fit = filters.fit_per_resource(state.headroom, req)            # [N, R]

    # InterPodAffinity required terms off the batched domain sums
    # (semantics: filters.pod_affinity_ok, with the first-pod bootstrap)
    ok_pod_aff = true_v
    if cfg.enable_pod_affinity and a_w:
        dc_a = dc_all[:, :a_w]
        totals = torch.sum(colsf[:, :a_w], dim=0)
        term_ok = nh_all[:a_w].T & ((dc_a > 0) | ((totals == 0) & t(host["aff_self"][p]))[None, :])
        ok_pod_aff = torch.all(torch.where(t(host["aff_valid"][p])[None, :], term_ok, True), dim=1)
    ok_pod_anti = true_v
    if cfg.enable_anti_affinity:
        if cfg.slot_paint:
            hit = host["hit_tid"][p]
            if hit.shape[0]:
                tc = state.term_block[:, t(np.maximum(hit, 0).astype(np.int64))]
                blocked = torch.any(t(hit >= 0)[None, :] & (tc > 0), dim=1)
            else:
                blocked = torch.zeros((n_nodes,), dtype=torch.bool, device=dev)
        else:
            blocked = filters.anti_blocked_dense(state.term_block, arrs.hit_terms[p])
        if b_w:
            dc_b = dc_all[:, a_w:a_w + b_w]
            fwd_ok = torch.all(torch.where(t(host["anti_valid"][p])[None, :], dc_b == 0, True),
                               dim=1)
        else:
            fwd_ok = true_v
        ok_pod_anti = fwd_ok & ~blocked

    # PodTopologySpread: the domain counts are shared between the
    # DoNotSchedule filter (skew against the eligible-domain minimum) and
    # the ScheduleAnyway score pass 1. Soft slots that do not apply add
    # where(False, .., 0.0) = +0.0 in the reference and are skipped here
    # (spread_raw only ever holds sums of nonnegative terms).
    spread_raw = fill(0.0)
    spread_node_ok = true_v
    ok_spread = true_v
    any_soft = False
    valid_s = host["spread_valid"][p]
    hard_s = valid_s & host["spread_hard"][p]
    soft_s = valid_s & ~host["spread_hard"][p]
    skey = host["spread_key"][p]
    if cfg.enable_spread and gc is not None:
        s0 = a_w + b_w
        if cs_n and cfg.enable_spread_hard:
            dc_s = dc_all[:, s0:s0 + cs_n]
            k1sel = np.maximum(skey - 1, 0).astype(np.int64)
            if pd_stack is not None:
                pd_sel = pd_stack[t(k1sel), :, t(np.arange(s0, s0 + cs_n))]     # [Cs, D]
                dhas_sel = hoist.domain_has[cid, t(k1sel)]                       # [Cs, D]
                min_other = torch.min(torch.where(dhas_sel, pd_sel, big), dim=1).values
            else:
                min_other = torch.zeros((cs_n,), dtype=f32, device=dev)
            min_host = torch.min(torch.where(hoist.elig_host[cid][:, None],
                                             colsf[:, s0:s0 + cs_n], big), dim=0).values
            min_val = torch.where(t(skey == 0), min_host, min_other)
            min_val = torch.where(hoist.any_elig[cid, t(skey.astype(np.int64))], min_val, 0.0)
            if cfg.slot_paint:
                m_gid = host["match_gid"][p]
                self_raw = np.any((m_gid[:, None] >= 0)
                                  & (m_gid[:, None] == host["spread_group"][p][None, :]), axis=0)
            else:
                self_raw = host["match_groups"][p][host["spread_group"][p]]
            self_m = t((self_raw & valid_s).astype(np.float32))
            skew = dc_s + self_m[None, :] - min_val[None, :]
            term_ok = nh_all[s0:s0 + cs_n].T & (skew <= t(host["spread_skew"][p])[None, :])
            ok_spread = torch.all(torch.where(t(hard_s)[None, :], term_ok, True), dim=1)
        if cfg.enable_spread_soft:
            for c in range(cs_n):
                if not soft_s[c]:
                    continue
                w = hoist.log_dom[int(skey[c])]
                spread_raw = spread_raw + (dc_all[:, s0 + c] * w
                                           + (float(host["spread_skew"][p, c]) - 1.0))
                spread_node_ok = spread_node_ok & nh_all[s0 + c]
                any_soft = True
    elif cfg.enable_spread:
        # dom_count path (no [N, S] carry): non-hostname spread reads the
        # tiny [K1, D, S] per-domain table
        k1_static = arrs.topo_onehot.shape[0]
        for c in range(cs_n):
            if not (hard_s[c] and cfg.enable_spread_hard) and not (
                    soft_s[c] and cfg.enable_spread_soft):
                continue
            kid = int(skey[c])
            g = int(host["spread_group"][p, c])
            kk = 0 if k1_static == 1 else max(kid - 1, 0)
            dcol = state.dom_count[kk, :, g]                       # [D]
            dc = arrs.topo_onehot[kk] @ dcol
            node_has = arrs.has_key[kid] > 0
            if hard_s[c] and cfg.enable_spread_hard:
                dhas = hoist.domain_has[cid, kk]
                min_val = torch.min(torch.where(dhas, dcol, big))
                min_val = torch.where(hoist.any_elig[cid, kid], min_val, 0.0)
                if cfg.slot_paint:
                    self_m = bool(np.any(host["match_gid"][p] == g))
                else:
                    self_m = bool(host["match_groups"][p, g])
                skew = dc + float(self_m) - min_val
                ok_spread = ok_spread & node_has & (skew <= float(host["spread_skew"][p, c]))
            if soft_s[c] and cfg.enable_spread_soft:
                w = hoist.log_dom[kid]
                spread_raw = spread_raw + (dc * w + (float(host["spread_skew"][p, c]) - 1.0))
                spread_node_ok = spread_node_ok & node_has
                any_soft = True

    # GPU share and open-local storage (the storage plan's bound-node row
    # is committed at the bind)
    gpu_mem, gpu_cnt = arrs.gpu_mem[p], arrs.gpu_cnt[p]
    ok_gpu = (gpu_share.gpu_fit(state.gpu_used, arrs.gpu_cap_mem, arrs.gpu_slot, gpu_mem,
                                gpu_cnt, arrs.gpu_has_forced[p])
              if cfg.enable_gpu else true_v)
    if cfg.enable_storage:
        ok_storage, vg_add, sdev_take = storage.storage_fit_and_plan(
            state.vg_used, arrs.vg_cap, state.sdev_taken, arrs.sdev_cap, arrs.sdev_ssd,
            arrs.lvm_req[p], arrs.sdev_req[p], arrs.sdev_req_ssd[p])
    else:
        ok_storage = true_v

    # VolumeBinding / VolumeZone: the static class masks, then the dynamic
    # WaitForFirstConsumer PV matching over pv_taken
    ok_vol_node = ok_vol_zone = ok_vol_bind = ok_pv_exist = true_v
    if cfg.enable_vol_static:
        vcid = int(host["vol_cid"][p])
        ok_vol_node = arrs.class_vol_node[vcid]
        ok_vol_zone = arrs.class_vol_zone[vcid]
        ok_vol_bind = arrs.class_vol_bind[vcid]
        ok_pv_exist = true_v & ~arrs.vol_pv_missing[p]
    wfc_ccid, wfc_valid = host["wfc_ccid"][p], host["wfc_valid"][p]
    if cfg.enable_pv_match:
        wfc_ok = volumes.wfc_claims_ok(state.pv_taken, arrs.pv_cand, arrs.pv_node_ok,
                                       wfc_ccid, wfc_valid)
        ok_vol_bind = ok_vol_bind & wfc_ok if ok_vol_bind is not true_v else wfc_ok
    # NodeVolumeLimits: attachments + demand within every limit key; the
    # shared-claim slots add their demand too, deduped against the
    # per-node presence carry (dedup-blind when the dedup gate is off)
    svol = host["svol_id"][p]
    if cfg.enable_vol_limits:
        vol_demand = arrs.vol_limit_req[p][None, :]
        lk_n = arrs.vol_limit_cap.shape[1]
        if svol.shape[0]:
            sv_extra = torch.zeros((n_nodes, lk_n), dtype=f32, device=dev)
            for vid in svol:
                vid = int(vid)
                if cfg.enable_vol_dedup:
                    add = (vid >= 0) & ~state.svol_on_node[:, max(vid, 0)]
                else:
                    add = torch.full((n_nodes,), vid >= 0, dtype=torch.bool, device=dev)
                key_oh = torch.arange(lk_n, device=dev) == arrs.svol_key[max(vid, 0)]
                sv_extra = sv_extra + add.to(f32)[:, None] * key_oh.to(f32)[None, :]
            vol_demand = vol_demand + sv_extra
        ok_vol_limits = torch.all(state.vol_cnt + vol_demand <= arrs.vol_limit_cap, dim=1)
    else:
        ok_vol_limits = true_v

    op_masks = [ok_unsched, ok_aff, ok_taint, ok_ports]
    op_masks += [fit[:, r] for r in range(cfg.n_resources)]
    op_masks += [ok_pod_aff, ok_pod_anti, ok_spread, ok_gpu, ok_storage,
                 ok_vol_node, ok_vol_zone, ok_vol_bind, ok_pv_exist, ok_vol_limits]
    # out-of-tree filter extensions: after the built-in pipeline, each with
    # its own reason row
    ext_filters = [e for e in cfg.extensions if e.filter_fn is not None]
    ext_scores = [e for e in cfg.extensions if e.score_fn is not None]
    op_masks += [ext_ok[i].to(torch.bool) for i in range(len(ext_filters))]
    if cfg.fail_reasons:
        ops_ok = torch.stack(op_masks)                             # [OPS, N]
        mask = active & torch.all(ops_ok, dim=0)
        fails = ~ops_ok
        first_fail = torch.argmax(fails.to(torch.uint8), dim=0)    # first max
        charged = active & torch.any(fails, dim=0)
        onehot_ops = first_fail[None, :] == torch.arange(cfg.n_ops, device=dev)[:, None]
        fail_counts = torch.sum(onehot_ops & charged[None, :], dim=1).to(torch.int32)
    else:
        mask = active
        for m in op_masks:
            if m is not true_v:
                mask = mask & m
        fail_counts = torch.zeros((0,), dtype=torch.int32, device=dev)

    use_na, use_tt, use_ip, use_sp, use_si = score_rows(cfg)
    w_bal, w_lst, w_mst, w_na, w_tt, w_ip, w_sp, w_si, w_gp = step_weights(cfg, weights)

    score = scores.resource_scores_fused(
        state.headroom, inv_alloc, req, cfg.cpu_mem_idx, w_bal, w_lst, w_mst,
        always_on=cfg.traced_weights)

    # the reference's one variadic min-reduce, row by row (min is exact in
    # any order; maxima ride as minima of the negation)
    if use_na:
        raw_na = arrs.class_node_aff_score[cid]
        hi_na = -torch.min(torch.where(mask, -raw_na, fill(0.0)))
    if use_tt:
        raw_tt = arrs.class_taint_prefer[cid]
        hi_tt = -torch.min(torch.where(mask, -raw_tt, fill(0.0)))
    if use_ip:
        # existing pods' preferred terms toward this pod (the weighted
        # domain paint), then this pod's own preferred terms
        existing = state.pref_paint @ arrs.hit_pref[p].to(f32)
        raw_ip = scores.interpod_preference_raw(
            gc, arrs.topo_onehot, arrs.has_key, host["pref_group"][p], host["pref_key"][p],
            host["pref_weight"][p], host["pref_valid"][p], extra_raw=existing)
        ip_lo = torch.min(torch.where(mask, raw_ip, fill(big)))
        ip_hi = -torch.min(torch.where(mask, -raw_ip, fill(big)))
    if use_sp:
        sp_scored = mask & spread_node_ok
        sp_lo = torch.min(torch.where(sp_scored, spread_raw, fill(big)))
        sp_hi = -torch.min(torch.where(sp_scored, -spread_raw, fill(big)))
    if use_si:
        raw_si = scores.simon_max_share_raw(arrs.spec_alloc, req)[arrs.spec_id.long()]
        si_lo = torch.min(torch.where(mask, raw_si, fill(big)))
        si_hi = -torch.min(torch.where(mask, -raw_si, fill(big)))
    if cfg.enable_gpu:
        raw_gp = gpu_share.gpu_share_raw(state.gpu_used, arrs.gpu_cap_mem, arrs.gpu_slot,
                                         gpu_mem, gpu_cnt)
        gp_lo = torch.min(torch.where(mask, raw_gp, fill(big)))
        gp_hi = -torch.min(torch.where(mask, -raw_gp, fill(big)))
    # the score extensions' rows of the reduction: minmax two, max one
    # (its zero fill reaches the minimum wherever a node is infeasible)
    ext_red = []
    for i, e in enumerate(ext_scores):
        raw_e = ext_raw[i]
        if e.normalize == "minmax":
            ext_red.append((torch.min(torch.where(mask, raw_e, fill(big))),
                            -torch.min(torch.where(mask, -raw_e, fill(big)))))
        elif e.normalize == "max":
            ext_red.append((None, -torch.min(torch.where(mask, -raw_e, fill(0.0)))))
        else:
            ext_red.append((None, None))

    # each weighted row, kept under explain_topk for the candidates'
    # breakdown, in the score_part_names order (the reference's _part)
    part_rows = [score]
    if use_na:
        part_rows.append(w_na * scores.max_apply(raw_na, hi_na))
    if use_tt:
        part_rows.append(w_tt * scores.max_apply(raw_tt, hi_tt, reverse=True))
    if use_ip:
        part_rows.append(w_ip * scores.minmax_apply(raw_ip, ip_lo, ip_hi))
    if use_sp:
        part_rows.append(w_sp * scores.spread_apply(
            spread_raw, sp_lo, sp_hi, spread_node_ok, any_soft))
    if use_si:
        part_rows.append(w_si * scores.minmax_apply(raw_si, si_lo, si_hi))
    if cfg.enable_gpu:
        # a pod without a GPU request scores 0 on the GPU dimension
        gp_w = torch.as_tensor(w_gp, dtype=f32, device=dev) * (gpu_cnt > 0).to(f32)
        part_rows.append(gp_w * scores.minmax_apply(raw_gp, gp_lo, gp_hi))
    for i, (e, (lo_e, hi_e)) in enumerate(zip(ext_scores, ext_red)):
        if lo_e is not None:
            part_rows.append(e.weight * scores.minmax_apply(ext_raw[i], lo_e, hi_e))
        elif hi_e is not None:
            part_rows.append(e.weight * scores.max_apply(ext_raw[i], hi_e))
        else:
            part_rows.append(e.weight * ext_raw[i])
    for row in part_rows[1:]:
        score = score + row

    # the preemption retry: a nominated node still feasible is the only
    # candidate (the normalizers and fail counts above saw the full mask);
    # a nomination out of range falls back to the full feasible set
    iota = torch.arange(n_nodes, dtype=torch.int32, device=dev)
    if nominated is not None and 0 <= nominated < n_nodes:
        mask = torch.where(mask[nominated], mask & (iota == nominated), mask)

    if cfg.tie_break_seed:
        # the framework's integer score scale first, so the jitter only
        # reorders exact ties; torch.round rounds half to even, as jnp.round
        score = torch.round(score) + threefry.tie_break_jitter(cfg.tie_break_seed, p, n_nodes,
                                                               dev)
    # selectHost: max, then the lowest index among exact maxima
    neg_inf = -3.4e38
    masked_score = torch.where(mask, score, fill(neg_inf))
    if cfg.explain_topk:
        # the candidates by final score (jitter included), ranked as
        # lax.top_k ranks: descending, the lower index first among ties;
        # filler slots past the feasible nodes get zeroed parts
        topk_node = rank_desc(masked_score)[:min(cfg.explain_topk, n_nodes)]
        topk_score = masked_score[topk_node]
        topk_parts = torch.where((topk_score > neg_inf)[None, :],
                                 torch.stack(part_rows)[:, topk_node], 0.0)
        topk_node = topk_node.to(torch.int32)
    else:
        topk_node = torch.zeros((0,), dtype=torch.int32, device=dev)
        topk_score = torch.zeros((0,), dtype=f32, device=dev)
        topk_parts = torch.zeros((0, 0), dtype=f32, device=dev)
    top = torch.max(masked_score)
    any_feasible = top > neg_inf
    sel_node = torch.min(torch.where(masked_score == top, iota,
                                     torch.full_like(iota, n_nodes)))
    if cfg.fail_reasons:
        feasible_n = torch.sum(mask.to(torch.int32)).to(torch.int32)
    else:
        feasible_n = torch.zeros((), dtype=torch.int32, device=dev)

    forced = int(host["forced_node"][p])
    unbound = torch.full((), -1, dtype=torch.int32, device=dev)
    if forced >= 0:
        final_node = arrs.forced_node[p].to(torch.int32)
    elif forced == -1:
        final_node = torch.where(any_feasible, sel_node, unbound)
    else:
        final_node = unbound
    if disabled:
        # a preemption victim is a deleted pod: no bind, no reasons
        final_node = torch.full((), -3, dtype=torch.int32, device=dev)
        fail_counts = torch.zeros_like(fail_counts)
        feasible_n = torch.zeros_like(feasible_n)

    # bind: dense one-hot updates, or in-place column updates under
    # slot_paint, as the reference (-1 -> an all-zero row; each column is
    # touched at most once per pod, so both forms add the same values)
    bound_f = (final_node >= 0).to(f32)
    safe_node = torch.clamp_min(final_node, 0).long()
    onehot_n = (iota == final_node).to(f32)
    headroom = state.headroom - onehot_n[:, None] * req[None, :]
    group_count = state.group_count
    dom_count = state.dom_count
    m_gid = host["match_gid"][p]
    if cfg.needs_group_count:
        if cfg.slot_paint:
            group_count = group_count.clone()
            for g_raw in m_gid:
                gid = max(int(g_raw), 0)
                group_count[:, gid] = group_count[:, gid] + (
                    onehot_n * float(g_raw >= 0)).to(group_count.dtype)
        else:
            group_count = group_count + (
                onehot_n[:, None] * arrs.match_groups[p].to(f32)[None, :]
            ).to(group_count.dtype)
    if cfg.maintain_dom_count:
        dom_row = arrs.topo_onehot[:, safe_node, :] * bound_f              # [K1, D]
        if cfg.slot_paint:
            dom_count = dom_count.clone()
            for g_raw in m_gid:
                gid = max(int(g_raw), 0)
                dom_count[:, :, gid] = dom_count[:, :, gid] + dom_row * float(g_raw >= 0)
        else:
            dom_count = dom_count + (
                dom_row[:, :, None] * arrs.match_groups[p].to(f32)[None, None, :])
    ports_used = state.ports_used
    if cfg.enable_ports:
        ports_used = ports_used | ((onehot_n[:, None] > 0) & arrs.ports[p][None, :])

    # sd_all [K, N]: the nodes sharing the bound node's domain under every
    # key (hostname: the node itself; a node without the key: none)
    if cfg.enable_anti_affinity or cfg.enable_pref:
        sd_list = [onehot_n]
        for kk in range(arrs.topo_onehot.shape[0]):
            oh = arrs.topo_onehot[kk]
            sd_list.append(oh @ oh[safe_node] * bound_f)
        sd_all = torch.stack(sd_list)
    term_block = state.term_block
    if cfg.enable_anti_affinity:
        cdt = term_block.dtype
        if cfg.slot_paint:
            term_block = term_block.clone()
            for t_raw in host["own_tid"][p]:
                tid = max(int(t_raw), 0)
                col = sd_all[int(host["term_key"][tid])] * float(t_raw >= 0)
                term_block[:, tid] = term_block[:, tid] + col.to(cdt)
        else:
            paint = sd_all[arrs.term_key.long()].T * arrs.own_terms[p].to(f32)[None, :]
            term_block = term_block + paint.to(cdt)
    pref_paint = state.pref_paint
    if cfg.enable_pref:
        pref_paint = pref_paint.clone()
        for a in range(host["pref_tid"].shape[1]):
            tcol = int(host["pref_tid"][p, a])
            w = arrs.pref_weight[p, a] * arrs.pref_valid[p, a].to(f32)
            pref_paint[:, tcol] = pref_paint[:, tcol] + sd_all[int(host["pref_key"][p, a])] * w

    # the device-resource binds, on the bound node's row
    gpu_used = state.gpu_used
    if cfg.enable_gpu:
        pick = gpu_share.gpu_pick_devices(
            state.gpu_used[safe_node], arrs.gpu_cap_mem[safe_node], arrs.gpu_slot[safe_node],
            gpu_mem, gpu_cnt, arrs.gpu_forced[p], arrs.gpu_has_forced[p])
        pick = pick * (final_node >= 0).to(torch.int32)
        gpu_used = gpu_used + onehot_n[:, None] * pick.to(f32)[None, :] * gpu_mem
    else:
        pick = torch.zeros((0,), dtype=torch.int32, device=dev)
    vg_used, sdev_taken = state.vg_used, state.sdev_taken
    if cfg.enable_storage:
        vg_used = vg_used + onehot_n[:, None] * vg_add[safe_node][None, :]
        sdev_taken = sdev_taken | ((onehot_n[:, None] > 0) & sdev_take[safe_node][None, :])
    pv_taken = state.pv_taken
    if cfg.enable_pv_match:
        pv_taken, vol_pick = volumes.wfc_pick_for_node(
            state.pv_taken, arrs.pv_cand, arrs.pv_node_ok[:, safe_node], wfc_ccid, wfc_valid,
            bool(final_node >= 0))
    else:
        vol_pick = torch.zeros((0,), dtype=torch.int32, device=dev)
    vol_cnt = state.vol_cnt
    if cfg.enable_vol_limits:
        # the filter's per-node demand: the bound row's increment is
        # exactly the new attachments
        vol_cnt = vol_cnt + onehot_n[:, None] * vol_demand
    svol_on = state.svol_on_node
    if cfg.enable_vol_limits and cfg.enable_vol_dedup:
        nsv = svol_on.shape[1]
        for vid in svol:
            sv_oh = torch.arange(nsv, device=dev) == int(vid)
            svol_on = svol_on | ((onehot_n[:, None] > 0) & sv_oh[None, :])
    new_state = SimState(headroom=headroom, group_count=group_count, term_block=term_block,
                         pref_paint=pref_paint, ports_used=ports_used, gpu_used=gpu_used,
                         vg_used=vg_used, sdev_taken=sdev_taken, dom_count=dom_count,
                         pv_taken=pv_taken, vol_cnt=vol_cnt, svol_on_node=svol_on)
    return new_state, (final_node, fail_counts, feasible_n, pick, vol_pick, topk_node,
                       topk_score, topk_parts)


def rank_desc(v: torch.Tensor) -> torch.Tensor:
    """[N] f32 -> the indices in ``lax.top_k``'s order: descending by the
    float's total order (+0.0 above -0.0), the lower index first among
    equal values (a stable sort of the order-preserving integer key)."""
    bits = v.contiguous().view(torch.int32).to(torch.int64)
    key = torch.where(bits >= 0, bits, bits ^ 0x7FFFFFFF)
    return torch.sort(key, descending=True, stable=True).indices


# what the plain step reads on the host: the per-pod scalars and slot rows
# (and term_key, the [T] topology key of each anti-affinity term)
STEP_HOST_FIELDS = ("class_id", "forced_node", "spread_group", "spread_key",
                    "spread_skew", "spread_hard", "spread_valid", "match_groups",
                    "match_gid", "aff_group", "aff_key", "aff_valid", "aff_self",
                    "anti_group", "anti_key", "anti_valid", "own_tid", "hit_tid",
                    "term_key", "pref_group", "pref_key", "pref_weight", "pref_valid",
                    "pref_tid", "vol_cid", "wfc_ccid", "wfc_valid", "svol_id")


def inv_alloc_of(alloc: torch.Tensor) -> torch.Tensor:
    """Loop-invariant reciprocal (0 where alloc <= 0), as a true divide."""
    pos = alloc > 0
    return torch.where(pos, torch.ones_like(alloc) / torch.where(pos, alloc, torch.ones_like(alloc)),
                       torch.zeros_like(alloc))


def hoist_of(arrs: SnapshotArrays, active: torch.Tensor) -> ActiveHoist:
    """The ActiveHoist of an [S, N] active mask over tensor-valued `arrs`."""
    return hoist_active_stats(arrs.topo_onehot, arrs.has_key, arrs.class_affinity, active)


def lane_carry(template: SimState, n_lanes: int,
               carry: Optional[SimState] = None) -> SimState:
    """The [S, ...] output carry of an S-lane launch: `carry` (an earlier
    round's, reused as the buffer, as the reference donates its carry) if
    it has the lanes' shapes and dtypes, else a new one. Its contents do
    not matter: the lane prologue overwrites every lane."""
    want = {f: ((n_lanes,) + tuple(getattr(template, f).shape), getattr(template, f).dtype)
            for f in STATE_FIELDS}
    if carry is None:
        dev = template.headroom.device
        return SimState(**{f: torch.empty(shape, dtype=dt, device=dev)
                           for f, (shape, dt) in want.items()})
    for f, (shape, dt) in want.items():
        got = getattr(carry, f)
        if tuple(got.shape) != shape or got.dtype != dt or got.device != template.headroom.device:
            raise ValueError(f"carry.{f} is {got.dtype}{tuple(got.shape)} on {got.device}, "
                             f"expected {dt}{shape} on {template.headroom.device}")
    return carry


# ---- wave execution ------------------------------------------------------
# engine/waves.py proves which contiguous pod runs are carry-independent;
# _run_wave_plan executes its plan (the reference's, scheduler.py:593): scan
# segments through the step, each batched wave through the step's frozen
# form against the wave-start carry and one merge of its binds. The merge's
# sums equal the sequential adds (0/1 counts, integer-valued requests), so
# the result is bit-identical to the scan.

_WAVE_CHUNK = 512  # pods of a BATCH segment evaluated against one carry


def _const_outputs(arrs: SnapshotArrays, cfg: EngineConfig, lo: int, hi: int):
    """The step's outputs for a forced-bind prefix or a FORCED or SENTINEL
    run [lo, hi) — what the reference's ``_const_outputs`` and prefix fold
    emit: the forced node or -1, zero reason and feasible counts and GPU
    picks, PV picks -1, top-k nodes -1 with zero scores and parts."""
    from open_simulator_tpu_torch.kernels.step import pick_widths

    dev = arrs.alloc.device
    c = hi - lo
    forced = arrs.forced_node[lo:hi].to(torch.int32)
    g_w, lw = pick_widths(arrs, cfg)
    k_top, c_parts = topk_widths(arrs, cfg)
    i32 = torch.int32
    return (torch.where(forced >= 0, forced, torch.full_like(forced, -1)),
            torch.zeros((c, cfg.n_ops if cfg.fail_reasons else 0), dtype=i32, device=dev),
            torch.zeros((c,), dtype=i32, device=dev),
            torch.zeros((c, g_w), dtype=i32, device=dev),
            torch.full((c, lw), -1, dtype=i32, device=dev),
            torch.full((c, k_top), -1, dtype=i32, device=dev),
            torch.zeros((c, k_top), dtype=torch.float32, device=dev),
            torch.zeros((c, c_parts, k_top), dtype=torch.float32, device=dev))


def _run_wave_plan(arrs: SnapshotArrays, active: torch.Tensor, hoist: ActiveHoist,
                   inv_alloc: torch.Tensor, carry: SimState, template: SimState,
                   cfg: EngineConfig, waves, k: int, n_pods: int,
                   weights: Optional[torch.Tensor] = None):
    """Run the plan's segments over pods [k, n_pods) on every lane of
    `carry` (written from `template` first, by the first scan launch's
    lane prologue or, where a wave comes first, by a copy), every launch
    with the lanes' [S, K] `weights` under the traced weights. Returns the
    step's (node, fail_counts, feasible, gpu_pick, vol_pick) for those
    pods. A segment past the real pods (the reference's padded tail) is
    skipped: it binds nothing. No launch falls back to another path."""
    from open_simulator_tpu_torch.engine import waves as wave_mod
    from open_simulator_tpu_torch.kernels import step as step_kernels
    from open_simulator_tpu_torch.kernels import wave as wave_kernels

    dev = active.device
    n_lanes, n_out = active.shape[0], n_pods - k
    g_w, lw = step_kernels.pick_widths(arrs, cfg)
    k_top, c_parts = topk_widths(arrs, cfg)
    i32 = torch.int32
    fail = (torch.empty((n_lanes, n_out, cfg.n_ops), dtype=i32, device=dev)
            if cfg.fail_reasons else step_kernels.no_fail_counts(n_lanes, n_out, cfg.n_ops, dev))
    outs = [torch.empty((n_lanes, n_out), dtype=i32, device=dev), fail,
            torch.empty((n_lanes, n_out), dtype=i32, device=dev),
            torch.empty((n_lanes, n_out, g_w), dtype=i32, device=dev),
            torch.empty((n_lanes, n_out, lw), dtype=i32, device=dev),
            torch.empty((n_lanes, n_out, k_top), dtype=i32, device=dev),
            torch.empty((n_lanes, n_out, k_top), dtype=torch.float32, device=dev),
            torch.empty((n_lanes, n_out, c_parts, k_top), dtype=torch.float32, device=dev)]
    step_inputs: Dict[str, Any] = {}
    merge_inputs: Dict[str, Any] = {}
    pending = template

    def put(lo: int, hi: int, out) -> None:
        a, b = lo - k, hi - k
        for i, (dst, src) in enumerate(zip(outs, out)):
            if i != 1 or cfg.fail_reasons:
                dst[:, a:b] = src

    def wave(lo: int, hi: int) -> None:
        out = step_kernels.plain_step(arrs, active, hoist, inv_alloc, carry, cfg, lo, hi,
                                      frozen=True, inputs=step_inputs, weights=weights)
        wave_kernels.wave_merge(arrs, cfg, carry, lo, hi, out[0],
                                out[3] if cfg.enable_gpu else None, inputs=merge_inputs)
        put(lo, hi, out)

    for lo, hi, kind, w in waves.segments:
        hi = min(hi, n_pods)
        if lo >= hi:
            continue
        if kind == wave_mod.SCAN:
            put(lo, hi, step_kernels.plain_step(arrs, active, hoist, inv_alloc, carry, cfg, lo,
                                                hi, template=pending, inputs=step_inputs,
                                                weights=weights))
            pending = None
            continue
        if pending is not None:
            step_kernels.copy_template(carry, pending)
            pending = None
        if kind in (wave_mod.SENTINEL, wave_mod.FORCED):
            put(lo, hi, tuple(x[None].expand((n_lanes,) + x.shape)
                              for x in _const_outputs(arrs, cfg, lo, hi)))
            if kind == wave_mod.FORCED:
                for s0 in range(lo, hi, _PREFIX_CHUNK):
                    s1 = min(s0 + _PREFIX_CHUNK, hi)
                    wave_kernels.wave_merge(arrs, cfg, carry, s0, s1,
                                            arrs.forced_node[s0:s1].to(i32).contiguous(),
                                            None, inputs=merge_inputs)
        elif kind == wave_mod.GRID:
            for w0 in range(lo, hi, w):
                wave(w0, w0 + w)
        else:  # BATCH: one wave, in chunks of _WAVE_CHUNK pods
            for s0 in range(lo, hi, _WAVE_CHUNK):
                wave(s0, min(s0 + _WAVE_CHUNK, hi))
    if pending is not None:
        step_kernels.copy_template(carry, pending)
    return tuple(outs)


def schedule_lanes(arrs: SnapshotArrays, masks: np.ndarray, cfg: EngineConfig,
                   device=None, carry: Optional[SimState] = None,
                   state: Optional[SimState] = None, waves=None,
                   weights=None) -> ScheduleOutput:
    """Schedule the pod sequence once per lane of the [S, N] bool `masks`
    (each lane's active nodes) in one launch; return [S]-batched
    assignments, reason counts, feasible counts, GPU and PV picks and
    carries. `arrs` is
    host numpy (the encoder's output); the work runs on `device` (None =
    the card).

    The port of the reference's lane launch (``engine/exec_cache.py:
    run_batched_cached`` over ``batched_lane_fn`` with ``_fresh_lane_state``)
    without its compile cache. Every lane starts from one template: the
    fresh carry with the leading run of forced binds (``cfg.forced_prefix``)
    folded in once — the fold reads no active mask, so it is the same for
    every lane — or, given, the resumed carry `state` (no fold). The
    prefix pods get their forced node and zero reason and feasible counts;
    every later pod runs the step. `carry`, an earlier launch's [S, ...]
    output state, is reused as this launch's output buffer. With
    ``cfg.fail_reasons`` off the fail counts are a zero-stride view (no
    [S, P, OPS] buffer). On CUDA the step loop is one ``plain_step`` kernel
    launch for all lanes; on the CPU it is the plain torch step.

    `waves`, a WavePlan of ``engine.waves.waves_for`` over these arrays
    and `cfg`, holds for every lane: its scan segments run the step, its
    batched waves the frozen step and one merge each, bit-identical to
    the scan. The plan is dropped (a full scan) under the reference's
    rules: with a resumed `state`, under extensions, or when it was made
    for another pod count; with a plan the prefix fold is its ``start``,
    not ``cfg.forced_prefix``.

    `weights` is the [S, K] per-lane score-weight matrix (WEIGHT_FIELDS
    order) under ``cfg.traced_weights``, the reference's lane weights
    (``exec_cache._check_lane_weights``): a traced cfg without weights
    runs every lane at ``weight_vector(cfg)``; weights without the traced
    mode are a ValueError."""
    return _launch(arrs, masks, cfg, device, carry, state, None, None, waves,
                   weights=weights)


def lane_weights(cfg: EngineConfig, weights, n_lanes: int, dev) -> Optional[torch.Tensor]:
    """The [S, K] f32 weight matrix a launch of `n_lanes` lanes takes on
    `dev`, checked as the reference's ``_check_lane_weights`` checks it."""
    if cfg.traced_weights and weights is None:
        weights = np.tile(weight_vector(cfg), (n_lanes, 1))
    if weights is None:
        return None
    if not cfg.traced_weights:
        raise ValueError(
            "per-lane weights need cfg.traced_weights (the constant "
            "engine bakes its weights into the executable)")
    w = torch.as_tensor(weights).to(device=dev, dtype=torch.float32)
    if tuple(w.shape) != (n_lanes, len(WEIGHT_FIELDS)):
        raise ValueError(
            f"weights must be [{n_lanes}, {len(WEIGHT_FIELDS)}] "
            f"(lanes x WEIGHT_FIELDS), got {tuple(w.shape)}")
    return w.contiguous()


def _column(name: str, col, n_pods: int, dtype, dev) -> Optional[torch.Tensor]:
    """A [P] preemption column as a tensor on `dev` (None stays None)."""
    if col is None:
        return None
    col = np.asarray(col)
    if col.shape != (n_pods,):
        raise ValueError(f"{name} must be [{n_pods}], got {col.shape}")
    return torch.from_numpy(np.ascontiguousarray(col.astype(dtype))).to(dev)


def usable_plan(waves, n_pods: int, cfg: EngineConfig, resumed: bool, columns: bool):
    """`waves` if its exactness preconditions hold, else None (the
    reference's ``schedule_pods`` rules): no preemption column, no
    extension op, a fresh carry, and a plan made for this pod count (the
    port does not pad, so the reference's bucketed count is accepted too;
    the segments past the real pods are skipped)."""
    from open_simulator_tpu_torch.engine.buckets import bucket_pods

    if waves is None or columns or resumed or cfg.extensions or not waves.segments:
        return None
    if waves.n_pods not in (n_pods, bucket_pods(n_pods)):
        return None
    return waves


def _launch(arrs: SnapshotArrays, masks: np.ndarray, cfg: EngineConfig, device,
            carry: Optional[SimState], state: Optional[SimState],
            disabled: Optional[np.ndarray], nominated: Optional[np.ndarray],
            waves=None, hoist_forced: bool = False,
            state_is_fresh: bool = False, weights=None) -> ScheduleOutput:
    """``schedule_lanes`` with the [P] preemption columns, which every lane
    reads (None: no column), and the reference's ``hoist_forced`` and
    ``state_is_fresh``. With either column the forced prefix is not
    folded: its pods run the step, as in the reference, whose victim and
    nomination indices cover the full sequence; and a wave plan is
    dropped. A given `state` is never written: the launch works on its
    own copy."""
    from open_simulator_tpu_torch.kernels import step as step_kernels

    dev = resolve_device(device)
    masks = np.asarray(masks, dtype=bool)
    if masks.ndim != 2 or masks.shape[1] != arrs.alloc.shape[0]:
        raise ValueError(f"masks must be [S, {arrs.alloc.shape[0]}], got {masks.shape}")
    n_lanes, n_pods = masks.shape[0], arrs.req.shape[0]
    dis_t = _column("disabled", disabled, n_pods, bool, dev)
    nom_t = _column("nominated", nominated, n_pods, np.int32, dev)
    w_t = lane_weights(cfg, weights, n_lanes, dev)
    columns = dis_t is not None or nom_t is not None
    resumed = state is not None and not state_is_fresh
    arrs_t = device_arrays(arrs, dev)
    masks_t = torch.from_numpy(masks).to(dev)
    waves = usable_plan(waves, n_pods, cfg, resumed, columns)
    # hoist_forced: every forced bind folded into the start carry and
    # scanned as a -4 sentinel (the replay pinning semantics); a fresh
    # state hoists like None, a resumed one already holds its pins
    hoist = (hoist_forced and waves is None and not columns and not cfg.extensions
             and not resumed)
    if waves is not None:
        k = min(waves.start, n_pods)
    else:
        k = 0 if (columns or resumed or hoist) else min(cfg.forced_prefix, n_pods)
    template = init_state(arrs_t, cfg) if state is None else state
    template = SimState(**{f: getattr(template, f).to(dev).contiguous() for f in STATE_FIELDS})
    pin_mask = None
    if hoist:
        orig_forced = arrs_t.forced_node.to(torch.int32)
        pin_mask = orig_forced >= 0
        template = apply_forced_mask(arrs_t, cfg, template, pin_mask)
        arrs_t = dataclasses.replace(arrs_t, forced_node=torch.where(
            pin_mask, torch.full_like(orig_forced, -4), orig_forced))
    if k:
        template = apply_forced_prefix(arrs_t, cfg, template, k)
    carry = lane_carry(template, n_lanes, carry)
    hoist_t, inv = hoist_of(arrs_t, masks_t), inv_alloc_of(arrs_t.alloc)
    if cfg.extensions:
        outs = _extension_scan(arrs_t, masks_t, hoist_t, inv, carry, template, cfg, k, n_pods,
                               dis_t, nom_t, w_t)
    elif waves is None:
        outs = step_kernels.plain_step(arrs_t, masks_t, hoist_t, inv, carry, cfg, k, n_pods,
                                       template=template, disabled=dis_t, nominated=nom_t,
                                       weights=w_t)
    else:
        outs = _run_wave_plan(arrs_t, masks_t, hoist_t, inv, carry, template, cfg, waves, k,
                              n_pods, weights=w_t)
    if k:
        # the prefix pods' outputs are the forced-bind constants (the
        # prefix holds no GPU or WFC pod: make_config cuts it there)
        # (without reason accounting the fail counts are replaced below)
        outs = [o if i == 1 and not cfg.fail_reasons
                else torch.cat([c[None].expand((n_lanes,) + c.shape), o], 1)
                for i, (c, o) in enumerate(zip(_const_outputs(arrs_t, cfg, 0, k), outs))]
    node, fail_counts, feasible, gpu_pick, vol_pick, t_node, t_score, t_parts = outs
    if pin_mask is not None:
        # the hoisted pins ran as sentinels: their node is the forced one
        node = torch.where(pin_mask[None], orig_forced[None], node)
    if not cfg.fail_reasons:
        fail_counts = step_kernels.no_fail_counts(n_lanes, n_pods, cfg.n_ops, dev)
    return ScheduleOutput(node=node, fail_counts=fail_counts, feasible=feasible,
                          gpu_pick=gpu_pick, vol_pick=vol_pick, topk_node=t_node,
                          topk_score=t_score, topk_parts=t_parts, state=carry)


class PodSlice(Mapping):
    """Pod p's slice of the step's per-pod inputs, the `x` an extension
    callable reads: every key of the reference's ``_pod_xs``
    (``POD_FIELDS``), ``_pod_index``, ``_disabled``, ``_nominated`` and,
    where the step reads group_count columns, ``gcr_gid`` / ``gcr_key``.
    A read-only mapping: a key's row is cut when it is read."""

    def __init__(self, cols: Dict[str, torch.Tensor], p: int):
        self._cols, self._p = cols, p

    def __getitem__(self, key: str) -> torch.Tensor:
        return self._cols[key][self._p]

    def __iter__(self):
        return iter(self._cols)

    def __len__(self) -> int:
        return len(self._cols)


def pod_columns(arrs: SnapshotArrays, cfg: EngineConfig, disabled: Optional[torch.Tensor],
                nominated: Optional[torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The [P, ...] columns ``PodSlice`` cuts, on the arrays' device: the
    reference's ``_pod_xs`` under extensions (whose live set is every key),
    the preemption columns as False / -1 where there is none, and the
    batched column read's slot ids and keys where its ``_gcr_segments`` is
    not None."""
    dev = arrs.req.device
    n_pods = arrs.req.shape[0]
    cols = {f: getattr(arrs, f) for f in sorted(POD_FIELDS)}
    cols["_pod_index"] = torch.arange(n_pods, dtype=torch.int32, device=dev)
    cols["_disabled"] = (disabled.to(torch.bool) if disabled is not None
                         else torch.zeros((n_pods,), dtype=torch.bool, device=dev))
    cols["_nominated"] = (nominated.to(torch.int32) if nominated is not None
                          else torch.full((n_pods,), -1, dtype=torch.int32, device=dev))
    if cfg.needs_group_count and (cfg.enable_pod_affinity or cfg.enable_anti_affinity
                                  or cfg.enable_spread):
        cols["gcr_gid"] = torch.cat([arrs.aff_group, arrs.anti_group, arrs.spread_group],
                                    1).to(torch.int32)
        cols["gcr_key"] = torch.cat([arrs.aff_key, arrs.anti_key, arrs.spread_key],
                                    1).to(torch.int32)
    return cols


def extension_rows_fn(cfg: EngineConfig):
    """One function of (carry fields, arrs, x) that evaluates every
    extension callable of `cfg` against one lane's carry and returns its
    (filter masks [Ef, N] bool, raw scores [Es, N] f32), either None where
    no extension of the kind is registered; vmapped over the lanes of a
    lane-batched carry (``torch.func.vmap``, arrs and x shared)."""
    filters = [e.filter_fn for e in cfg.extensions if e.filter_fn is not None]
    scorers = [e.score_fn for e in cfg.extensions if e.score_fn is not None]

    def rows(fields, arrs, x):
        st = SimState(*fields)
        out = []
        if filters:
            out.append(torch.stack([f(st, arrs, x).to(torch.bool) for f in filters]))
        if scorers:
            out.append(torch.stack([f(st, arrs, x).to(torch.float32) for f in scorers]))
        return tuple(out)

    lanes = torch.func.vmap(rows, in_dims=(0, None, None))

    def call(fields, arrs, x):
        got = list(lanes(fields, arrs, x))
        return (got.pop(0) if filters else None), (got.pop(0) if scorers else None)

    return call


def _extension_scan(arrs: SnapshotArrays, active: torch.Tensor, hoist: ActiveHoist,
                    inv_alloc: torch.Tensor, carry: SimState, template: SimState,
                    cfg: EngineConfig, k: int, n_pods: int,
                    disabled: Optional[torch.Tensor], nominated: Optional[torch.Tensor],
                    weights: Optional[torch.Tensor], plain: bool = False):
    """The scan over pods [k, n_pods) under extension ops, one launch a
    pod: before pod p every callable is evaluated against each lane's
    carry as it stands (after pod p - 1's bind, in stream order), the
    device arrays and pod p's ``PodSlice``, vmapped over the lanes; their
    rows go to the step of pod p (``kernels/step.pod_launcher``: the kernel
    on the card, the plain step on the CPU or with ``plain=True``), which
    writes its outputs into row p - k of buffers allocated once. `carry`
    is written from `template` first. Returns the step's outputs for
    those pods."""
    from open_simulator_tpu_torch.kernels import step as step_kernels

    dev = active.device
    n_lanes, n_out = active.shape[0], n_pods - k
    g_w, lw = step_kernels.pick_widths(arrs, cfg)
    k_top, c_parts = topk_widths(arrs, cfg)
    i32 = torch.int32
    fail = (torch.zeros((n_lanes, n_out, cfg.n_ops), dtype=i32, device=dev)
            if cfg.fail_reasons else step_kernels.no_fail_counts(n_lanes, n_out, cfg.n_ops, dev))
    outs = step_kernels.StepOutputs(
        torch.empty((n_lanes, n_out), dtype=i32, device=dev), fail,
        torch.empty((n_lanes, n_out), dtype=i32, device=dev),
        torch.empty((n_lanes, n_out, g_w), dtype=i32, device=dev),
        torch.empty((n_lanes, n_out, lw), dtype=i32, device=dev),
        torch.empty((n_lanes, n_out, k_top), dtype=i32, device=dev),
        torch.empty((n_lanes, n_out, k_top), dtype=torch.float32, device=dev),
        torch.empty((n_lanes, n_out, c_parts, k_top), dtype=torch.float32, device=dev))
    step_kernels.copy_template(carry, template)
    launch = step_kernels.pod_launcher(arrs, active, hoist, inv_alloc, carry, cfg, outs, k,
                                       disabled=disabled, nominated=nominated, weights=weights,
                                       plain=plain)
    rows_of = extension_rows_fn(cfg)
    cols = pod_columns(arrs, cfg, disabled, nominated)
    fields = tuple(getattr(carry, f) for f in STATE_FIELDS)
    for p in range(k, n_pods):
        ok, raw = rows_of(fields, arrs, PodSlice(cols, p))
        launch(p, None if ok is None else ok[:, None], None if raw is None else raw[:, None])
    return tuple(outs)


def schedule_pods(arrs: SnapshotArrays, active: np.ndarray, cfg: EngineConfig,
                  state: Optional[SimState] = None, device=None,
                  disabled: Optional[np.ndarray] = None,
                  nominated: Optional[np.ndarray] = None, waves=None,
                  state_is_fresh: bool = False, hoist_forced: bool = False,
                  weights=None) -> ScheduleOutput:
    """Schedule the pod sequence on one [N] active mask; return
    assignments, reason counts and the final carry: ``schedule_lanes`` at
    one lane. Equals the reference's ``schedule_pods(..., waves=waves,
    state_is_fresh=..., hoist_forced=...)``. `arrs` is host numpy or
    tensors (moved to `device`).

    A passed-in `state` is a resumed carry: no prefix fold, no hoist, no
    wave plan (``state_is_fresh=True`` declares it a fresh start carry,
    which folds and plans like None). The state itself is left as it was.
    ``hoist_forced`` folds every forced-bind pod into the start carry
    (``apply_forced_mask``) and scans it as a -4 sentinel, restoring its
    node on the output — only with no wave plan, no preemption column, no
    extension and a fresh or absent state, as in the reference; the
    prefix fold is off under it.

    `disabled` [P] bool marks preemption victims (deleted: node -3, no
    bind, zero reason and feasible counts); `nominated` [P] i32 is the
    preemption retry's node (-1 none; a node no longer feasible, or out of
    range, falls back to the full feasible set). Either column turns the
    prefix fold off.

    `weights` is the [K] score-weight vector (WEIGHT_FIELDS order),
    required and valid only under ``cfg.traced_weights``; omitted under a
    traced config, the config's own ``weight_vector(cfg)`` runs."""
    if cfg.traced_weights:
        if weights is not None:
            weights = torch.as_tensor(weights).to(dtype=torch.float32)
            if tuple(weights.shape) != (len(WEIGHT_FIELDS),):
                raise ValueError(
                    f"weights must be a [{len(WEIGHT_FIELDS)}] vector in "
                    f"WEIGHT_FIELDS order, got shape {tuple(weights.shape)}")
            weights = weights[None]
    elif weights is not None:
        raise ValueError(
            "weights passed but cfg.traced_weights is off — enable the "
            "traced mode (make_config(..., traced_weights=True)) or drop "
            "the vector")
    out = _launch(arrs, np.asarray(active, dtype=bool)[None], cfg, device, None, state,
                  disabled, nominated, waves, hoist_forced=hoist_forced,
                  state_is_fresh=state_is_fresh, weights=weights)
    return out._replace(state=SimState(**{f: getattr(out.state, f)[0] for f in STATE_FIELDS}),
                        **{f: getattr(out, f)[0] for f in out._fields if f != "state"})


# the pod-axis fields (the reference's ``_pod_xs``): what slice_pods cuts
POD_FIELDS = frozenset((
    "req", "class_id", "forced_node", "ports", "match_groups",
    "aff_group", "aff_key", "aff_valid", "aff_self",
    "anti_group", "anti_key", "anti_valid", "own_terms", "hit_terms",
    "spread_group", "spread_key", "spread_skew", "spread_hard", "spread_valid",
    "pref_group", "pref_key", "pref_weight", "pref_valid", "pref_tid", "hit_pref",
    "gpu_mem", "gpu_cnt", "gpu_forced", "gpu_has_forced",
    "lvm_req", "sdev_req", "sdev_req_ssd",
    "vol_cid", "vol_pv_missing", "wfc_ccid", "wfc_valid", "vol_limit_req",
    "svol_id", "match_gid", "own_tid", "hit_tid"))


def slice_pods(arrs: SnapshotArrays, start: int, stop: int) -> SnapshotArrays:
    """A view of the snapshot covering pods [start:stop) — the reference's
    ``slice_pods``, the unit of checkpoint and resume: scan(pods[:k]) then
    scan(pods[k:], state=carry) is exactly scan(pods). The pod axis of
    the slice starts at 0, as the reference's ``_pod_index`` does (only
    the seeded jitter reads it, and replay's fast path runs without a
    seed)."""
    out = {}
    for f in dataclasses.fields(arrs):
        x = getattr(arrs, f.name)
        out[f.name] = x[start:stop] if f.name in POD_FIELDS else x
    return SnapshotArrays(**out)


def make_config(snapshot: ClusterSnapshot, **overrides) -> EngineConfig:
    """EngineConfig from a snapshot — the reference's autodetection
    (``wave_scheduling`` follows ``SIMON_WAVES``, as there)."""
    from open_simulator_tpu_torch.engine.waves import waves_enabled

    res = snapshot.resources
    cpu_mem = (res.index("cpu"), res.index("memory"))
    enable_gpu = bool(np.any(snapshot.arrays.gpu_count > 0))
    if "pods" in res:
        max_per_node = float(np.min([np.max(snapshot.arrays.alloc[:, res.index("pods")]),
                                     snapshot.n_pods]))
    else:
        max_per_node = float(snapshot.n_pods)
    enable_storage = bool(
        np.any(snapshot.arrays.vg_cap > 0) or np.any(snapshot.arrays.sdev_cap > 0)
    )
    a = snapshot.arrays
    kw: Dict[str, Any] = dict(
        n_resources=len(res), cpu_mem_idx=cpu_mem, enable_gpu=enable_gpu,
        enable_storage=enable_storage,
        wave_scheduling=waves_enabled(),
        compact_carry=max_per_node < 255,
        enable_ports=bool(np.any(a.ports)),
        enable_pod_affinity=bool(np.any(a.aff_valid)),
        enable_anti_affinity=bool(np.any(a.anti_valid) or np.any(a.own_terms)),
        enable_spread_hard=bool(np.any(a.spread_valid & a.spread_hard)),
        enable_spread_soft=bool(np.any(a.spread_valid & ~a.spread_hard)),
        spread_hostname=bool(np.any(a.spread_valid & (a.spread_key == 0))),
        enable_pref=bool(np.any(a.pref_valid) or np.any(a.hit_pref)),
        enable_node_aff_score=bool(np.any(a.class_node_aff_score != 0)),
        enable_taint_score=bool(np.any(a.class_taint_prefer != 0)),
        enable_unsched=bool(np.any(a.unschedulable)),
        enable_class_aff=bool(not np.all(a.class_affinity)),
        enable_class_taint=bool(not np.all(a.class_taint)),
        enable_vol_static=bool(
            not np.all(a.class_vol_node) or not np.all(a.class_vol_zone)
            or not np.all(a.class_vol_bind) or np.any(a.vol_pv_missing)
        ),
        enable_pv_match=bool(np.any(a.wfc_valid)),
        enable_vol_limits=bool(
            (np.any(a.vol_limit_req > 0) or np.any(a.svol_id >= 0))
            and np.any(a.vol_limit_cap < 1e9)
        ),
        enable_vol_dedup=bool(
            np.any(a.svol_id >= 0) and np.any(a.vol_limit_cap < 1e9)
        ),
        slot_paint=bool(
            a.match_gid.shape[1] <= SLOT_CAP
            and a.own_tid.shape[1] <= SLOT_CAP
            and a.hit_tid.shape[1] <= SLOT_CAP
        ),
    )
    # forced-bind prefix: leading run of spec.nodeName pods whose carry
    # updates are order-free (no gpu/storage/WFC picks within the prefix)
    fn_arr = np.asarray(a.forced_node)
    nonneg = fn_arr >= 0
    fp = int(np.argmin(nonneg)) if not bool(np.all(nonneg)) else len(fn_arr)
    if fp:
        if enable_gpu and bool(np.any(np.asarray(a.gpu_cnt)[:fp] > 0)):
            fp = 0
        elif enable_storage and bool(
            np.any(np.asarray(a.lvm_req)[:fp] > 0)
            or np.any(np.asarray(a.sdev_req)[:fp] > 0)
        ):
            fp = 0
        elif bool(np.any(np.asarray(a.wfc_valid)[:fp])):
            fp = 0
        elif bool(np.any(np.asarray(a.svol_id)[:fp] >= 0)
                  and np.any(np.asarray(a.vol_limit_cap) < 1e9)):
            fp = 0
    kw["forced_prefix"] = fp
    kw.update(overrides)
    if kw.get("extensions"):
        kw["extensions"] = tuple(e.validate() for e in kw["extensions"])
        # extension ops may read the carry per pod; keep prefix pods in
        # the scan unless the caller explicitly overrode forced_prefix
        if "forced_prefix" not in overrides:
            kw["forced_prefix"] = 0
    return EngineConfig(**kw)
