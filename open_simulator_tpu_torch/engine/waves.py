"""Wave scheduling: the host planner (the reference's
``engine/waves.py``, names and plans unchanged; the per-pod greedy runs
only between pods that surely open a wave, found in one numpy pass).

The scan runs one step per pod, each waiting on the previous pod's bind.
This module cuts the pod sequence into **carry-independent waves**:
contiguous runs of pods where no earlier pod of the run can change a later
pod's feasible set, score ranking or diagnostics. A wave then runs as one
batched evaluation of its pods against the wave-start carry (the frozen
form of the step, ``kernels/step.plain_step(..., frozen=True)``) and one
merge of their binds into the carry (``kernels/wave.wave_merge``), which
is bit-identical to scan order: a pod joins a wave only when the analysis
proves it independent of every earlier pod of the wave, over every carry
channel the step touches (per-node channels through the pods' class
footprints, the selector-group, anti-affinity term and preferred-term
channels, and the PV channel). Pods the analysis cannot prove independent
stay on the scan (SCAN segments).

Float exactness of the merge rests on the same invariant as the forced
prefix fold: counts add 0/1 increments and requests are integer-valued in
their encoded units, so the order of the adds does not change a bit.

Everything here is host numpy over the snapshot's arrays, and the plan
holds for every lane (``active`` is ignored), so one plan serves a sweep's
lanes.
"""

from __future__ import annotations

import logging
import os
import threading
import weakref
from collections import OrderedDict
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np

_log = logging.getLogger(__name__)

WAVES_ENV = "SIMON_WAVES"

# segment kinds (WavePlan.segments[i][2])
SCAN = 0      # the sequential step over the slice (the fallback path)
BATCH = 1     # one wave: batched filter+score + one carry merge
FORCED = 2    # forced/sentinel run: constant outputs + one carry merge
GRID = 3      # uniform-width wave run: one batched step + merge per wave
SENTINEL = 4  # pure bind-nothing run: constant outputs, no merge at all

KIND_NAMES = {SCAN: "scan", BATCH: "batch", FORCED: "forced",
              GRID: "grid", SENTINEL: "sentinel"}

# planner thresholds: a batched segment must amortize its merge (~1-2
# scan steps of work) and the per-segment trace/compile cost
MIN_FORCED = 4      # min width for a FORCED merge segment
MIN_SENTINEL = 2    # min width for a SENTINEL constant segment
MIN_BATCH = 8       # min width for a standalone BATCH segment
GRID_MIN_RUN = 4    # min consecutive equal-width waves to fuse into a GRID
GRID_MIN_WIDTH = 2
MAX_SEGMENTS = 24   # the reference's compile-time guard (each segment traced its own body)
# Analysis-cost guard: footprint overlaps are precomputed as a dense
# [C, C] product over the node axis. C (distinct compat classes) is
# small on real clusters, but a pathological dump with per-pod distinct
# affinity/tolerations makes C ~ P and the product O(C^2 * N) — past
# this cap the planner returns all-SCAN instead of stalling the host.
MAX_CLASSES = 512


class WavePlan(NamedTuple):
    """Static, hashable execution plan for one encoded pod sequence.

    ``segments`` are ``(lo, hi, kind, width)`` covering ``[start,
    n_pods)`` in order (``width`` is the wave width for GRID segments, 0
    otherwise). ``start`` is the forced-bind prefix the engine hoists
    before the plan applies (nonzero only under failure accounting /
    explain, where the hoist's zero-diagnostics convention must be
    preserved)."""

    segments: Tuple[Tuple[int, int, int, int], ...]
    start: int
    n_pods: int

    @property
    def n_waves(self) -> int:
        """Batched placement units (GRID segments count their waves)."""
        n = 0
        for lo, hi, kind, w in self.segments:
            if kind == GRID:
                n += (hi - lo) // w
            elif kind != SCAN:
                n += 1
        return n

    @property
    def max_wave_width(self) -> int:
        out = 0
        for lo, hi, kind, w in self.segments:
            if kind == GRID:
                out = max(out, w)
            elif kind != SCAN:
                out = max(out, hi - lo)
        return out

    @property
    def batched_pods(self) -> int:
        return sum(hi - lo for lo, hi, kind, _ in self.segments
                   if kind != SCAN)

    @property
    def wave_fraction(self) -> float:
        """Fraction of the pod axis placed through batched waves (the
        rest rides the fallback scan; the hoisted prefix counts as
        batched — it is one merged wave by construction)."""
        if not self.n_pods:
            return 0.0
        return (self.batched_pods + self.start) / float(self.n_pods)

    def stats(self) -> Dict[str, float]:
        return {"n_waves": self.n_waves,
                "max_wave_width": self.max_wave_width,
                "wave_fraction": round(self.wave_fraction, 4),
                "n_segments": len(self.segments)}

    def pod_waves(self) -> "tuple[np.ndarray, np.ndarray]":
        """(wave_id [n_pods] i32, batched [n_pods] bool) — the explain
        surface's per-pod decode. Wave ids number every placement unit
        in sequence order (scan segments: one id per pod — each pod is
        its own degenerate wave); ``batched`` marks pods placed through
        a batched wave rather than the fallback scan."""
        wave_id = np.zeros(self.n_pods, dtype=np.int32)
        batched = np.zeros(self.n_pods, dtype=bool)
        wid = 0
        if self.start:
            wave_id[: self.start] = wid
            batched[: self.start] = True
            wid += 1
        for lo, hi, kind, w in self.segments:
            if kind == SCAN:
                for i in range(lo, hi):
                    wave_id[i] = wid
                    wid += 1
            elif kind == GRID:
                for j, i in enumerate(range(lo, hi)):
                    wave_id[i] = wid + (j // w)
                batched[lo:hi] = True
                wid += (hi - lo) // w
            else:
                wave_id[lo:hi] = wid
                batched[lo:hi] = True
                wid += 1
        return wave_id, batched


def waves_enabled() -> bool:
    """The process-wide escape hatch: SIMON_WAVES=0 disables wave
    scheduling everywhere regardless of EngineConfig."""
    return os.environ.get(WAVES_ENV, "1") != "0"


def _slot_union(out: np.ndarray, idx: np.ndarray, valid: np.ndarray) -> None:
    """OR one-hot columns of ``idx`` (masked by ``valid``) into the
    [P, W] bool matrix ``out`` — slot arrays to dense read/write sets."""
    if idx.size == 0 or out.shape[1] == 0:
        return
    p_idx = np.arange(out.shape[0])
    for k in range(idx.shape[1]):
        m = valid[:, k] & (idx[:, k] >= 0) & (idx[:, k] < out.shape[1])
        out[p_idx[m], idx[m, k]] = True


class _PodModel(NamedTuple):
    """Per-pod read/write sets, host numpy."""

    forced: np.ndarray        # [P] i32
    cid: np.ndarray           # [P] i32
    fp: np.ndarray            # [C, N] class feasible-superset footprints
    ov: np.ndarray            # [C, C] footprint-overlap
    read_groups: np.ndarray   # [P, S]
    write_groups: np.ndarray  # [P, S]
    read_terms: np.ndarray    # [P, T]
    write_terms: np.ndarray   # [P, T]
    read_prefs: np.ndarray    # [P, T2]
    write_prefs: np.ndarray   # [P, T2]
    gpu: np.ndarray           # [P] wants GPU share
    heavy: np.ndarray         # [P] storage / WFC / shared-volume pods
    wfc: np.ndarray           # [P] reads+writes the global pv channel
    reads_all: bool           # failure accounting / explain: every pod
    #                           observes its class footprint


def _pod_model(arrs, cfg) -> _PodModel:
    a = lambda name: np.asarray(getattr(arrs, name))  # noqa: E731
    forced = a("forced_node").astype(np.int64)
    cid = a("class_id").astype(np.int64)
    fp = a("class_affinity") & a("class_taint") & ~a("unschedulable")[None, :]
    ovf = fp.astype(np.float32)
    ov = (ovf @ ovf.T) > 0

    p_n = forced.shape[0]
    match = a("match_groups")
    own = a("own_terms")
    hitp = a("hit_pref")
    read_groups = np.zeros_like(match)
    if cfg.enable_pod_affinity:
        _slot_union(read_groups, a("aff_group"), a("aff_valid"))
    if cfg.enable_anti_affinity:
        _slot_union(read_groups, a("anti_group"), a("anti_valid"))
    if cfg.enable_spread:
        _slot_union(read_groups, a("spread_group"), a("spread_valid"))
    # traced weights keep every enabled score row live (a lane's variant
    # may weight preferences even when the config's constant is 0), so
    # the plan must treat the preference channel as read/written
    pref_live = bool(cfg.enable_pref
                     and (cfg.w_interpod or cfg.traced_weights))
    pv = a("pref_valid") & (a("pref_weight") != 0)
    if pref_live:
        _slot_union(read_groups, a("pref_group"), pv)
    write_prefs = np.zeros_like(hitp)
    if pref_live:
        _slot_union(write_prefs, a("pref_tid"), pv)

    gpu = (a("gpu_cnt") > 0) if cfg.enable_gpu else np.zeros(p_n, bool)
    storage = np.zeros(p_n, bool)
    if cfg.enable_storage:
        storage = (np.any(a("lvm_req") > 0, axis=1)
                   | np.any(a("sdev_req") > 0, axis=1))
    wfc = (np.any(a("wfc_valid"), axis=1) if cfg.enable_pv_match
           else np.zeros(p_n, bool))
    svol = np.zeros(p_n, bool)
    if cfg.enable_vol_limits:
        svol = np.any(a("svol_id") >= 0, axis=1)

    return _PodModel(
        forced=forced.astype(np.int32), cid=cid.astype(np.int32),
        fp=fp, ov=ov,
        read_groups=read_groups,
        write_groups=(match if cfg.needs_group_count or cfg.enable_spread
                      else np.zeros_like(match)),
        read_terms=(a("hit_terms") if cfg.enable_anti_affinity
                    else np.zeros_like(own)),
        write_terms=own if cfg.enable_anti_affinity else np.zeros_like(own),
        read_prefs=hitp if pref_live else np.zeros_like(hitp),
        write_prefs=write_prefs,
        gpu=gpu, heavy=storage | wfc | svol, wfc=wfc,
        reads_all=bool(cfg.fail_reasons or cfg.explain_topk),
    )


# the info of a run of width-1 waves (always SCAN, never part of a GRID)
_SCAN_RUN = {"scan_run": True}


def _opens_wave(m: _PodModel, lo: int, hi: int) -> np.ndarray:
    """[hi - lo - 1] bool over pods lo + 1 .. hi - 1: pod i conflicts with
    the writes of pod i - 1 alone. The greedy's open wave always holds pod
    i - 1 when it reaches pod i, and a conflict only grows with the wave's
    writes, so each such pod closes the wave before it."""
    i = np.arange(lo + 1, hi)
    j = i - 1
    f_i, f_j, c_i, c_j = m.forced[i], m.forced[j], m.cid[i], m.cid[j]
    sched_j = f_j == -1
    reads_fp = (f_i == -1) | m.reads_all
    node_i = np.where((f_i >= 0) & (m.gpu[i] | m.heavy[i]) & ~reads_fp, f_i, -1)
    at_j, at_i = np.maximum(f_j, 0), np.maximum(node_i, 0)
    hit = np.where(reads_fp,
                   (sched_j & m.ov[c_i, c_j]) | ((f_j >= 0) & m.fp[c_i, at_j]),
                   (node_i >= 0) & (((f_j >= 0) & (node_i == f_j))
                                    | (sched_j & m.fp[c_j, at_i])))

    def meets(reads, writes):
        return np.any(reads[i] & writes[j], axis=1)

    # a sentinel writes nothing
    return hit | ((f_j > -2) & (meets(m.read_groups, m.write_groups)
                                | meets(m.read_terms, m.write_terms)
                                | meets(m.read_prefs, m.write_prefs)
                                | (m.wfc[i] & m.wfc[j])))


def _greedy(m: _PodModel, lo: int, hi: int, waves: list, info: list) -> None:
    """The per-pod greedy over pods [lo, hi), a wave opening at lo:
    appends its waves (lo, hi) and their info."""
    w_lo = lo
    w_classes: set = set()
    w_nodes: set = set()
    w_groups = np.zeros(m.write_groups.shape[1], bool)
    w_terms = np.zeros(m.write_terms.shape[1], bool)
    w_prefs = np.zeros(m.write_prefs.shape[1], bool)
    w_pv = False
    w_info = {"forced_only": True, "sentinel_only": True,
              "heavy": False, "gpu": False}

    def close(i: int) -> None:
        nonlocal w_lo, w_pv, w_info
        if i > w_lo:
            waves.append((w_lo, i))
            info.append(w_info)
        w_lo = i
        w_classes.clear()
        w_nodes.clear()
        w_groups[:] = False
        w_terms[:] = False
        w_prefs[:] = False
        w_pv = False
        w_info = {"forced_only": True, "sentinel_only": True,
                  "heavy": False, "gpu": False}

    for i in range(lo, hi):
        f = int(m.forced[i])
        sched = f == -1
        sentinel = f <= -2
        ci = int(m.cid[i])
        # ---- reads of pod i vs. the wave's accumulated writes ----------
        conflict = False
        reads_fp = sched or m.reads_all
        reads_node = f if (f >= 0 and (m.gpu[i] or m.heavy[i])
                           and not reads_fp) else -1
        if reads_fp:
            if any(m.ov[ci, c] for c in w_classes):
                conflict = True
            elif w_nodes and m.fp[ci, list(w_nodes)].any():
                conflict = True
        elif reads_node >= 0:
            if reads_node in w_nodes or any(
                    m.fp[c, reads_node] for c in w_classes):
                conflict = True
        if not conflict:
            conflict = (
                bool(np.any(m.read_groups[i] & w_groups))
                or bool(np.any(m.read_terms[i] & w_terms))
                or bool(np.any(m.read_prefs[i] & w_prefs))
                or (bool(m.wfc[i]) and w_pv))
        if conflict:
            close(i)
        # ---- writes of pod i -------------------------------------------
        if sched:
            w_classes.add(ci)
        elif f >= 0:
            w_nodes.add(f)
        if not sentinel:
            w_groups |= m.write_groups[i]
            w_terms |= m.write_terms[i]
            w_prefs |= m.write_prefs[i]
            w_pv = w_pv or bool(m.wfc[i])
            w_info["sentinel_only"] = False
            if sched:
                w_info["forced_only"] = False
            w_info["heavy"] = w_info["heavy"] or bool(m.heavy[i])
            w_info["gpu"] = w_info["gpu"] or bool(m.gpu[i])
    close(hi)


def compute_wave_plan(arrs, cfg, n_pods_total: Optional[int] = None,
                      max_segments: int = MAX_SEGMENTS) -> WavePlan:
    """Partition the pod sequence into carry-independent waves.

    ``arrs`` is the (unpadded) host SnapshotArrays; ``n_pods_total`` is
    the bucketed pod-axis length — the pad tail [P, total) is a known
    sentinel run (bind-nothing pods whose outputs are sliced off) and
    becomes one constant SENTINEL segment. Pure host analysis; returns a
    plan even when degenerate (all SCAN) — `waves_for` maps those to
    None so the engine keeps its exact pre-wave executable."""
    p_real = int(np.asarray(arrs.forced_node).shape[0])
    total = int(n_pods_total) if n_pods_total else p_real
    if np.asarray(arrs.class_affinity).shape[0] > MAX_CLASSES:
        _log.info("wave planning skipped: %d compat classes exceeds the "
                  "analysis cap (%d)",
                  np.asarray(arrs.class_affinity).shape[0], MAX_CLASSES)
        return WavePlan(segments=((0, total, SCAN, 0),) if total else (),
                        start=0, n_pods=total)
    m = _pod_model(arrs, cfg)
    merge_ok = not (cfg.fail_reasons or cfg.explain_topk)
    # under failure accounting / explain the leading forced prefix must
    # keep the hoist's zero-diagnostics convention — hoist it and plan
    # the suffix; without accounting the greedy below subsumes the hoist
    start = 0 if merge_ok else min(int(cfg.forced_prefix), p_real)

    # A pod that conflicts with its predecessor's writes alone surely opens
    # a wave (below), so only the runs between such pods need the per-pod
    # greedy. A run of one pod is a wave of width 1, which _classify always
    # makes SCAN: consecutive ones become one scan run without a Python
    # step per pod.
    opens = np.flatnonzero(_opens_wave(m, start, p_real)) + start + 1
    cuts = np.concatenate(([start], opens, [p_real])) if p_real > start else np.zeros(0, int)
    waves = []  # (lo, hi)
    info = []   # per wave: dict(forced_only, sentinel_only, heavy, gpu), or _SCAN_RUN
    pos = start
    for k in np.flatnonzero(np.diff(cuts) > 1):
        lo, hi = int(cuts[k]), int(cuts[k + 1])
        if lo > pos:
            waves.append((pos, lo))
            info.append(_SCAN_RUN)
        _greedy(m, lo, hi, waves, info)
        pos = hi
    if p_real > pos:
        waves.append((pos, p_real))
        info.append(_SCAN_RUN)

    segments = _classify(waves, info, merge_ok)
    if total > p_real:
        # bucketing pad tail: bind-nothing sentinels whose outputs are
        # sliced off by unpad_output — constants regardless of accounting
        segments.append((p_real, total, SENTINEL, 0))
    segments = _coalesce(segments, max_segments)
    return WavePlan(segments=tuple(segments), start=start, n_pods=total)


def _classify(waves, info, merge_ok):
    """Wave list -> segment list: fuse uniform-width runs into GRIDs,
    classify the rest, demote narrow waves to SCAN."""
    segments = []
    n = len(waves)
    i = 0
    while i < n:
        lo, hi = waves[i]
        w = hi - lo
        if info[i].get("scan_run"):
            segments.append((lo, hi, SCAN, 0))
            i += 1
            continue
        # GRID: >= GRID_MIN_RUN consecutive waves of identical width,
        # none carrying storage/WFC/shared-volume pods (their bind picks
        # are not merge-representable). Only widths that could grid are
        # run-scanned — width-1 degenerate sequences must stay O(n).
        j = i
        if w >= GRID_MIN_WIDTH:
            while (j < n and waves[j][1] - waves[j][0] == w
                   and not info[j].get("scan_run") and not info[j]["heavy"]
                   and waves[j][0] == (waves[i][0] + (j - i) * w)):
                j += 1
        if w >= GRID_MIN_WIDTH and (j - i) >= GRID_MIN_RUN:
            segments.append((lo, waves[j - 1][1], GRID, w))
            i = j
            continue
        if (info[i]["sentinel_only"] and merge_ok and w >= MIN_SENTINEL):
            segments.append((lo, hi, SENTINEL, 0))
        elif (info[i]["forced_only"] and merge_ok and w >= MIN_FORCED
              and not info[i]["heavy"] and not info[i]["gpu"]):
            segments.append((lo, hi, FORCED, 0))
        elif w >= MIN_BATCH and not info[i]["heavy"]:
            segments.append((lo, hi, BATCH, 0))
        else:
            segments.append((lo, hi, SCAN, 0))
        i += 1
    return segments


def _coalesce(segments, max_segments):
    """Merge adjacent SCANs; past the segment budget, demote the
    narrowest batched segments back to SCAN (compile-time guard)."""

    def merge_scans(segs):
        out = []
        for s in segs:
            if out and out[-1][2] == SCAN and s[2] == SCAN \
                    and out[-1][1] == s[0]:
                out[-1] = (out[-1][0], s[1], SCAN, 0)
            else:
                out.append(list(s) if isinstance(s, tuple) else s)
                out[-1] = tuple(out[-1])
        return [tuple(s) for s in out]

    segs = merge_scans(segments)
    while sum(1 for s in segs if s[2] != SCAN) and len(segs) > max_segments:
        batched = [s for s in segs if s[2] != SCAN]
        victim = min(batched, key=lambda s: s[1] - s[0])
        segs = [((s[0], s[1], SCAN, 0) if s == victim else s) for s in segs]
        segs = merge_scans(segs)
        if all(s[2] == SCAN for s in segs):
            break
    return segs


# ---- plan cache ----------------------------------------------------------
# Keyed on (a digest of every array the analysis reads, the EngineConfig,
# the padded pod count). A stale plan is a correctness bug (it would batch
# pods the new workload couples), so the digest hashes the content and
# shape of each array _pod_model and compute_wave_plan consume. The
# reference keys on its ledger's workload digest plus the same plan-input
# digest and on a hash of the config; the plans are the same either way.

_PLAN_INPUT_FIELDS = (
    "alloc", "req", "forced_node", "active", "class_id", "gpu_cnt", "spread_valid",
    "unschedulable", "class_affinity", "class_taint",
    "match_groups", "own_terms", "hit_terms", "hit_pref",
    "aff_group", "aff_valid", "anti_group", "anti_valid",
    "spread_group", "pref_group", "pref_valid", "pref_weight", "pref_tid",
    "lvm_req", "sdev_req", "wfc_valid", "svol_id",
)


def _plan_inputs_digest(arrs) -> str:
    import hashlib

    h = hashlib.sha256()
    for name in _PLAN_INPUT_FIELDS:
        x = np.ascontiguousarray(np.asarray(getattr(arrs, name)))
        h.update(f"{name}{x.dtype}{x.shape}".encode())
        h.update(x.tobytes())
    return h.hexdigest()[:16]


# Per-object digest memo: entry points pass the same SnapshotArrays object
# repeatedly (every bisection round), and hashing tens of MB per call would
# make cache hits as expensive as misses. Keyed by id() with a weakref
# finalizer, so a recycled id never serves a dead object's digest.
_digest_memo: Dict[int, str] = {}


def _arrs_digest(arrs) -> str:
    key = id(arrs)
    hit = _digest_memo.get(key)
    if hit is not None:
        return hit
    val = _plan_inputs_digest(arrs)
    try:
        weakref.finalize(arrs, _digest_memo.pop, key, None)
        _digest_memo[key] = val
    except TypeError:  # not weakref-able: recompute next time
        pass
    return val


_PLAN_CACHE: "OrderedDict[Tuple, Optional[WavePlan]]" = OrderedDict()
_PLAN_CACHE_SIZE = 32
_plan_lock = threading.Lock()


def waves_for(arrs, cfg, n_pods_total: Optional[int] = None
              ) -> Optional[WavePlan]:
    """The entry points' plan for (host snapshot arrays, config), or None
    when wave scheduling is off or the analysis found nothing to batch
    (the engine then scans every pod). Plans are cached by content."""
    if not cfg.wave_scheduling or not waves_enabled():
        return None
    if cfg.extensions:
        return None  # extension ops may read/write any carry channel
    key = (_arrs_digest(arrs), cfg, int(n_pods_total or 0))
    with _plan_lock:
        if key in _PLAN_CACHE:
            _PLAN_CACHE.move_to_end(key)
            return _PLAN_CACHE[key]
    plan = compute_wave_plan(arrs, cfg, n_pods_total=n_pods_total)
    # degenerate plans (nothing batched but the padded tail, or only the
    # prefix the fold already covers) map to None: only plans batching
    # real pods survive
    p_real = int(np.asarray(arrs.req).shape[0])
    if not any(s[2] != SCAN and s[0] < p_real for s in plan.segments):
        plan = None
    with _plan_lock:
        _PLAN_CACHE[key] = plan
        _PLAN_CACHE.move_to_end(key)
        while len(_PLAN_CACHE) > _PLAN_CACHE_SIZE:
            _PLAN_CACHE.popitem(last=False)
    if plan is not None:
        _log.debug("wave plan: %s", plan.stats())
    return plan
