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
per-domain ``dom_count`` and the per-node ``group_count``) and the
interpod preference score with its ``pref_paint`` carry. Every other gate
raises NotImplementedError naming the ROADMAP item that ports it.

On a CUDA device ``schedule_pods`` runs the pod loop in the hand-written
kernel ``csrc/plain_step.cu`` (``kernels/step.py``); the plain step runs
only for CPU tensors, and as the yardstick the kernel is held equal to.
"""

from __future__ import annotations

import dataclasses
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
from open_simulator_tpu_torch.ops import filters, scores
from open_simulator_tpu_torch.ops.domains import ActiveHoist, hoist_active_stats

# fp32 everywhere, and no TF32 in the prefix fold's matmuls: encoded counts
# and requests go up to 2^24, and TF32 keeps integers exact only to 2^11.
torch.backends.cuda.matmul.allow_tf32 = False
torch.set_float32_matmul_precision("highest")


class EngineConfig(NamedTuple):
    """Static engine configuration — a copy of the reference's
    ``EngineConfig`` (field for field, so a config means the same thing
    in both packages). Gates outside this package's step raise in
    ``check_supported``."""

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
    wave_scheduling: bool = False
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


# gate -> the ROADMAP item that ports it (queue 1 unless noted)
_UNSUPPORTED = (
    ("enable_gpu", "queue 1, item 3 (device-resource slice)"),
    ("enable_storage", "queue 1, item 3 (device-resource slice)"),
    ("enable_vol_static", "queue 1, item 3 (device-resource slice)"),
    ("enable_pv_match", "queue 1, item 3 (device-resource slice)"),
    ("enable_vol_limits", "queue 1, item 3 (device-resource slice)"),
    ("enable_vol_dedup", "queue 1, item 3 (device-resource slice)"),
    ("extensions", "queue 1, item 7 (remaining engine modes)"),
    ("explain_topk", "queue 1, item 7 (remaining engine modes)"),
    ("tie_break_seed", "queue 1, item 7 (remaining engine modes)"),
    ("traced_weights", "queue 1, item 10 (lane consumers)"),
)


def check_supported(cfg: EngineConfig) -> None:
    """Raise NotImplementedError for any gate outside the ported step."""
    for gate, item in _UNSUPPORTED:
        if getattr(cfg, gate):
            raise NotImplementedError(
                f"EngineConfig.{gate} is not ported yet (ROADMAP {item})")


@dataclass
class SimState:
    """The carry — the reference's twelve ``SimState`` arrays as tensors.
    A lane-batched carry has a leading [S] axis on every field. This
    package's step reads and writes headroom, ports_used, group_count /
    dom_count, term_block and pref_paint; the rest stay zero until their
    ops are ported."""

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
    """Host numpy -> tensors on `device` (one transfer per field)."""
    return SnapshotArrays(**{
        f.name: torch.from_numpy(np.ascontiguousarray(getattr(arrs, f.name))).to(device)
        for f in dataclasses.fields(arrs)})


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


_PREFIX_CHUNK = 4096  # bounds the [chunk, N] one-hot of the prefix fold


def apply_forced_prefix(arrs: SnapshotArrays, cfg: EngineConfig,
                        state: SimState, k: int) -> SimState:
    """Fold the first k pods (all forced binds) into the carry at once —
    what k steps of the forced fast path would do. fp32 one-hot matmuls
    with TF32 off: the 0/1 weights and integer-valued requests keep every
    sum exact below 2^24, so the fold equals the sequential binds. The
    anti-affinity term paint and the preferred-term paint go through the
    same-domain rows ``sd_all`` of the reference's ``_apply_prefix_chunk``."""
    f32 = torch.float32
    n = arrs.alloc.shape[0]
    k1 = arrs.topo_onehot.shape[0]
    for lo in range(0, k, _PREFIX_CHUNK):
        hi = min(lo + _PREFIX_CHUNK, k)
        idx = arrs.forced_node[lo:hi].long()
        oh = torch.nn.functional.one_hot(idx, n).to(f32)          # [c, N]
        match = arrs.match_groups[lo:hi].to(f32)
        headroom = state.headroom - oh.T @ arrs.req[lo:hi]
        gc = state.group_count
        if cfg.needs_group_count:
            gc = gc + (oh.T @ match).to(gc.dtype)
        dom = state.dom_count
        if cfg.maintain_dom_count:
            topo_sel = arrs.topo_onehot[:, idx, :]                # [K1, c, D]
            dom = dom + torch.einsum("akd,ks->ads", topo_sel, match)
        ports = state.ports_used
        if cfg.enable_ports:
            ports = ports | ((oh.T @ arrs.ports[lo:hi].to(f32)) > 0)
        term, pref = state.term_block, state.pref_paint
        if cfg.enable_anti_affinity or cfg.enable_pref:
            # sd_all[key][pod, node]: nodes sharing pod i's node's domain
            sd_all = [oh] + [arrs.topo_onehot[kk][idx] @ arrs.topo_onehot[kk].T
                             for kk in range(k1)]
        if cfg.enable_anti_affinity:
            own = arrs.own_terms[lo:hi].to(f32)                   # [c, T]
            paint = torch.zeros((n, own.shape[1]), dtype=f32, device=oh.device)
            for kk in range(len(sd_all)):
                mask_t = (arrs.term_key == kk).to(f32)
                paint = paint + sd_all[kk].T @ (own * mask_t[None, :])
            term = term + paint.to(term.dtype)
        if cfg.enable_pref:
            t2_n = state.pref_paint.shape[1]
            for a in range(arrs.pref_group.shape[1]):
                w = arrs.pref_weight[lo:hi, a] * arrs.pref_valid[lo:hi, a].to(f32)
                key_a = arrs.pref_key[lo:hi, a]
                sd_a = torch.zeros_like(sd_all[0])
                for kk in range(len(sd_all)):
                    sd_a = sd_a + sd_all[kk] * (key_a == kk).to(f32)[:, None]
                col = torch.nn.functional.one_hot(arrs.pref_tid[lo:hi, a].long(), t2_n).to(f32)
                pref = pref + sd_a.T @ (col * w[:, None])
        state = dataclasses.replace(state, headroom=headroom, group_count=gc,
                                    term_block=term, pref_paint=pref,
                                    dom_count=dom, ports_used=ports)
    return state


def score_rows(cfg: EngineConfig) -> Tuple[bool, bool, bool, bool, bool]:
    """Which normalized score rows the step adds: node affinity, taint
    toleration, interpod preference, soft spread, Simon. A zero weight or
    a gated-off op drops its row entirely (the reference's ``use_*``
    gates)."""
    return (bool(cfg.w_node_aff) and cfg.enable_node_aff_score,
            bool(cfg.w_taint) and cfg.enable_taint_score,
            bool(cfg.w_interpod) and cfg.enable_pref,
            bool(cfg.w_spread) and cfg.enable_spread_soft,
            bool(cfg.w_simon))


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
          state: SimState, p: int):
    """One pod's scheduleOne: the plain torch twin of the reference's
    ``_step`` for this package's ops. `arrs` holds tensors on the step's
    device; `host` holds the per-pod slot arrays as numpy (forced node,
    class, selector groups, keys, term ids), so static per-pod choices
    branch on the host the way the reference's gates select code. `hoist`
    is one lane's ActiveHoist. Returns (state, (node, fail_counts,
    feasible)) with the outputs as device tensors."""
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

    op_masks = [ok_unsched, ok_aff, ok_taint, ok_ports]
    op_masks += [fit[:, r] for r in range(cfg.n_resources)]
    op_masks += [ok_pod_aff, ok_pod_anti, ok_spread]
    # gpu, storage and the five volume rows are gated off in this
    # package's step: constant-true rows
    op_masks += [true_v] * 7
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

    score = scores.resource_scores_fused(
        state.headroom, inv_alloc, req, cfg.cpu_mem_idx,
        cfg.w_balanced, cfg.w_least, cfg.w_most)

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

    if use_na:
        score = score + cfg.w_node_aff * scores.max_apply(raw_na, hi_na)
    if use_tt:
        score = score + cfg.w_taint * scores.max_apply(raw_tt, hi_tt, reverse=True)
    if use_ip:
        score = score + cfg.w_interpod * scores.minmax_apply(raw_ip, ip_lo, ip_hi)
    if use_sp:
        score = score + cfg.w_spread * scores.spread_apply(
            spread_raw, sp_lo, sp_hi, spread_node_ok, any_soft)
    if use_si:
        score = score + cfg.w_simon * scores.minmax_apply(raw_si, si_lo, si_hi)

    # selectHost: max, then the lowest index among exact maxima
    neg_inf = -3.4e38
    masked_score = torch.where(mask, score, fill(neg_inf))
    top = torch.max(masked_score)
    any_feasible = top > neg_inf
    iota = torch.arange(n_nodes, dtype=torch.int32, device=dev)
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
    new_state = dataclasses.replace(state, headroom=headroom, group_count=group_count,
                                    term_block=term_block, pref_paint=pref_paint,
                                    dom_count=dom_count, ports_used=ports_used)
    return new_state, (final_node, fail_counts, feasible_n)


# what the plain step reads on the host: the per-pod scalars and slot rows
# (and term_key, the [T] topology key of each anti-affinity term)
STEP_HOST_FIELDS = ("class_id", "forced_node", "spread_group", "spread_key",
                    "spread_skew", "spread_hard", "spread_valid", "match_groups",
                    "match_gid", "aff_group", "aff_key", "aff_valid", "aff_self",
                    "anti_group", "anti_key", "anti_valid", "own_tid", "hit_tid",
                    "term_key", "pref_group", "pref_key", "pref_weight", "pref_valid",
                    "pref_tid")


def inv_alloc_of(alloc: torch.Tensor) -> torch.Tensor:
    """Loop-invariant reciprocal (0 where alloc <= 0), as a true divide."""
    pos = alloc > 0
    return torch.where(pos, torch.ones_like(alloc) / torch.where(pos, alloc, torch.ones_like(alloc)),
                       torch.zeros_like(alloc))


def hoist_of(arrs: SnapshotArrays, active: torch.Tensor) -> ActiveHoist:
    """The ActiveHoist of an [S, N] active mask over tensor-valued `arrs`."""
    return hoist_active_stats(arrs.topo_onehot, arrs.has_key, arrs.class_affinity, active)


def schedule_pods(arrs: SnapshotArrays, active: np.ndarray, cfg: EngineConfig,
                  state: Optional[SimState] = None, device=None) -> ScheduleOutput:
    """Schedule the pod sequence; return assignments, reason counts and
    the final carry. `arrs` and `active` are host numpy (the encoder's
    output); the work runs on `device` (None = the card).

    Equals the reference's ``schedule_pods(..., waves=None)``: the leading
    run of forced binds (``cfg.forced_prefix``) folds into the carry first
    and gets zero reason and feasible counts, then every later pod runs
    the step. A passed-in `state` is a resumed carry and skips the fold.
    On CUDA the step loop is the ``plain_step`` kernel; on the CPU it is
    the plain torch step."""
    from open_simulator_tpu_torch.kernels import step as step_kernels

    check_supported(cfg)
    dev = resolve_device(device)
    n_pods = arrs.req.shape[0]
    arrs_t = device_arrays(arrs, dev)
    active_t = torch.from_numpy(np.asarray(active, dtype=bool)).to(dev)
    k = min(cfg.forced_prefix, n_pods) if state is None else 0
    if state is None:
        state = init_state(arrs_t, cfg)
    if k:
        state = apply_forced_prefix(arrs_t, cfg, state, k)
    hoist = hoist_of(arrs_t, active_t[None, :])
    lanes = SimState(**{f: getattr(state, f)[None] for f in STATE_FIELDS})
    node, fail_counts, feasible = step_kernels.plain_step(
        arrs_t, active_t[None, :], hoist, inv_alloc_of(arrs_t.alloc), lanes,
        cfg, k, n_pods)
    state = SimState(**{f: getattr(lanes, f)[0] for f in STATE_FIELDS})
    node, fail_counts, feasible = node[0], fail_counts[0], feasible[0]
    if k:
        node = torch.cat([arrs_t.forced_node[:k].to(torch.int32), node])
        feasible = torch.cat([torch.zeros(k, dtype=torch.int32, device=dev), feasible])
        fail_counts = torch.cat([torch.zeros((k, cfg.n_ops), dtype=torch.int32, device=dev),
                                 fail_counts])
    return ScheduleOutput(node=node, fail_counts=fail_counts, feasible=feasible,
                          state=state)


def make_config(snapshot: ClusterSnapshot, **overrides) -> EngineConfig:
    """EngineConfig from a snapshot — the reference's autodetection, with
    ``wave_scheduling=False``: this package has no wave scheduler, and the
    reference's waves are bit-identical to its scan."""
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
        wave_scheduling=False,
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
    if kw.get("extensions") and "forced_prefix" not in overrides:
        kw["forced_prefix"] = 0
    return EngineConfig(**kw)
