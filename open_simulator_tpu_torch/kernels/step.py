"""The scheduling step over a pod range, for S lanes: the ``plain_step``
CUDA kernel (``csrc/plain_step.cu``), its plain torch twin, and the
dispatch between them.

All three take the same arguments::

    (arrs, active [S, N] bool, hoist (a lane-batched ActiveHoist),
     inv_alloc [N, R] f32, state (a lane-batched SimState, updated in
     place), cfg, p0, p1, template=None, disabled=None, nominated=None,
     frozen=False)

and return ``StepOutputs(node [S, P'] i32, fail_counts [S, P', OPS] i32,
feasible [S, P'] i32, gpu_pick [S, P', G] i32, vol_pick [S, P', Lw] i32,
topk_node [S, P', K] i32, topk_score [S, P', K] f32, topk_parts [S, P',
C, K] f32)`` for the pods ``p0 <= p < p1`` (P' = p1 - p0); the picks have
width 0 when their gate (``enable_gpu``, ``enable_pv_match``) is off, and
the top-k outputs (K = min(explain_topk, N), C score rows) when
``explain_topk`` is 0.
``arrs`` is the snapshot as tensors on the step's device
(``engine.scheduler.device_arrays``); ``hoist`` is
``engine.scheduler.hoist_of(arrs, active)``.

With a ``template`` (one [N, ...] SimState), every lane of ``state`` is
first overwritten with it — the lane prologue, the port of the
reference's fresh lane state: ``state`` is then only the output buffer,
and a caller can hand in the previous round's carry. The plain version
of the prologue is ``template[None].expand(S, ...)`` copied into it.

With ``cfg.fail_reasons`` off no [S, P', OPS] buffer exists: the
returned fail counts are a zero-stride view of one zero.

``disabled`` ([P] bool) and ``nominated`` ([P] i32), on the step's
device and indexed by the pod's place in the whole sequence, are the
preemption columns every lane reads (``engine.scheduler._step``): a
victim is deleted (node -3, no bind, zero reason and feasible counts); a
nominated node still feasible is the pod's only candidate. None: no
column (the kernel gets a null pointer; with both None it runs the
instantiation built without the column code).

With ``frozen=True`` (the wave form, the port of the reference's
``_grid_step`` and BATCH ``vmap(step(frozen, .))``) every pod of [p0, p1)
is evaluated against each lane's carry as it stands, and nothing is bound:
``state`` is only read, and ``kernels/wave.wave_merge`` folds the wave's
binds in afterwards. It takes no template and no preemption column (the
wave planner's plan is dropped under them). The PV picks are -1: the
planner keeps WaitForFirstConsumer pods out of waves.

``cfg.explain_topk`` and ``cfg.tie_break_seed`` run the kernel's explain
builds (the fifth template flag, in the library ``plain_step_explain``,
built from the same source): the top-k candidates and the seeded jitter
inside the pod loop. A launch with neither runs the twelve builds of the
library ``plain_step``.

Under ``cfg.traced_weights`` every launch takes ``weights``, an [S, K]
f32 tensor of per-lane score weights (``scheduler.WEIGHT_FIELDS`` order),
and keeps every enabled score row live; the kernel gets it as the
pointer ``w_lane``, which each block reads once, in the lane prologue
(null: the nine scalars in ``StepArgs``). It is a runtime pointer, not a
template flag: the 24 builds serve both modes.

``plain_step_fleet`` runs the scan over a fleet of clusters, one lane
each (``FleetLane``: each lane's own arrays, active mask, hoist, inverse
allocatable, carry and template), in one launch of the kernel's fleet
form (``plain_step_fleet_kernel``, eight more builds: kInterpod x kDevRes
x kExplain), which hands each lane the StepArgs a one-lane launch over its
cluster would take; its plain version, ``plain_step_fleet_torch``, is the
one-lane plain step over each lane in turn. Its launches count under
``plain_step_fleet`` (``plain_step_fleet_explain``).

Under ``cfg.extensions`` a launch takes the extension rows the engine
evaluated against the carry (``engine.scheduler._extension_scan``):
``ext_ok`` [S, P', Ef, N] bool, each filter extension's mask, and
``ext_raw`` [S, P', Es, N] f32, each score extension's raw score, in
registration order; the kernel gets them as runtime pointers (null
without extensions), with each score row's f32 weight and normalize kind,
so the 24 builds serve both. ``pod_launcher`` is the engine's per-pod
form: it builds the ``StepArgs`` once and patches each pod's into them,
writing the outputs into rows of full-length buffers
(``LAUNCHES["plain_step_ext"]`` counts its launches).

``plain_step`` launches the kernel for CUDA tensors and runs the plain
torch step only for CPU tensors; it never falls back from one to the
other. ``LAUNCHES["plain_step"]`` counts the kernel's scan launches and
``LAUNCHES["plain_step_frozen"]`` its frozen ones; the explain builds'
launches count under ``plain_step_explain`` and
``plain_step_frozen_explain``. ``LAUNCHES["plain_step_weights"]``
counts, besides, the launches of any build that carry the weight row, and
``LAUNCHES["plain_step_wide"]`` those of the wide library: the same
source built with ``PLAIN_STEP_WIDE`` (``plain_step_wide`` and
``plain_step_wide_explain``), which walks a device-resource width past
its per-thread arrays (``MAX_VG``, ``MAX_DEVICES``, ``MAX_WFC_CLAIMS``) in
a window of global memory and keeps the regions its plan puts there in
global memory; ``needs_wide`` picks it, so the launches within the
widths and the shared memory run the builds they ran before.

The kernel runs each lane on a thread-block cluster: ``plan_launch``
picks the cluster size, the block size and each block's node slice from
the lane count, the node count and the card's occupancy answer, and
``smem_bytes`` is the per-block shared-memory accounting it checks; where a
block's shared memory cannot hold the dom_count replica or the
column-read partials, the plan puts them in global memory, one region
per block (``scratch_bytes``), as it does the headroom rows. Where a
block's shared memory holds them, the plan also stages the slice's
node-static rows once a launch and each pod's class rows one pod ahead
(``PLACEMENTS``: those are the first regions it drops; ``class_packs``);
every pod's scalars reach the kernel by bulk copy from ``pod_pack``.
``LAST_PLAN`` holds the geometry of the latest launch. The frozen form
runs one cluster per (lane, pod) under the same plan.
"""

from __future__ import annotations

import ctypes
import math
import weakref
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import torch

from open_simulator_tpu_torch.engine import scheduler
from open_simulator_tpu_torch.engine.scheduler import (
    STATE_FIELDS,
    STEP_HOST_FIELDS,
    EngineConfig,
    SimState,
)
from open_simulator_tpu_torch.kernels import build
from open_simulator_tpu_torch.ops import threefry
from open_simulator_tpu_torch.ops.domains import ActiveHoist

LAUNCHES: Dict[str, int] = {"plain_step": 0, "plain_step_frozen": 0, "plain_step_explain": 0,
                            "plain_step_frozen_explain": 0, "plain_step_weights": 0,
                            "plain_step_fleet": 0, "plain_step_fleet_explain": 0,
                            "plain_step_wide": 0, "plain_step_ext": 0}
# the kernel's per-phase cycle counts (kPhases in the .cu), in order
PHASES = ("prologue", "phase 0/0b/0c", "phase 1 filters and raw scores",
          "min/count reduction", "phase 2 score and argmax", "argmax reduction",
          "phase 3 bind")

# StepArgs.flags bits (csrc/plain_step.cu)
F_UNSCHED, F_CLASS_AFF, F_CLASS_TAINT, F_PORTS, F_FAIL = 1, 2, 4, 8, 16
F_NA, F_TT, F_SP, F_SI = 32, 64, 128, 256
F_BAL, F_LEAST, F_MOST = 512, 1024, 2048
F_GC, F_DOM, F_GC_BF16 = 4096, 8192, 16384
F_AFF, F_ANTI, F_SPH, F_IP, F_PREF, F_TB_BF16 = 1 << 15, 1 << 16, 1 << 17, 1 << 18, 1 << 19, 1 << 20
F_TEMPLATE = 1 << 21
F_GPU, F_STORAGE, F_VOL_STATIC = 1 << 22, 1 << 23, 1 << 24
F_PV_MATCH, F_VOL_LIMITS, F_VOL_DEDUP = 1 << 25, 1 << 26, 1 << 27
INTERPOD_FLAGS = F_AFF | F_ANTI | F_SPH | F_IP | F_PREF
DEVRES_FLAGS = F_GPU | F_STORAGE | F_VOL_STATIC | F_PV_MATCH | F_VOL_LIMITS | F_VOL_DEDUP
# StepArgs.res bits (csrc/plain_step.cu)
RES_HEADROOM, RES_DOM_GLOBAL, RES_COLS_GLOBAL = 1, 2, 4
RES_STAGE_NODE, RES_STAGE_CLASS = 8, 16
STAGE_ALL = RES_STAGE_NODE | RES_STAGE_CLASS
# the staged regions a plan can take (its LaunchPlan.stage), by name
PLACEMENT_NAMES = {"none": 0, "node": RES_STAGE_NODE, "class": RES_STAGE_CLASS, "all": STAGE_ALL}
UNSTAGED = 0
# a pod's hit terms are staged in its pod region up to this many terms
# (the width of hit_terms: 97 in the rich north-star cluster at any
# size); past it the region holds no list and the kernel reads the
# host's lists (hit_ptr / hit_idx), chosen from the widths before a launch
MAX_HITS_STAGED = 128

_PTRS = ("inv_alloc", "unschedulable", "class_affinity", "class_taint",
         "class_node_aff_score", "class_taint_prefer", "spec_id", "spec_alloc",
         "node_dom", "has_key", "term_key", "req", "class_id", "forced_node", "ports",
         "match_groups", "spread_group", "spread_key", "spread_skew",
         "spread_soft", "spread_hard", "aff_group", "aff_key", "aff_valid", "aff_self",
         "anti_group", "anti_key", "anti_valid", "hit_ptr", "hit_idx", "own_ptr",
         "own_idx", "pref_group", "pref_key", "pref_weight", "pref_valid", "pref_tid",
         "hit_pref", "disabled", "nominated", "active", "log_dom", "elig_host",
         "domain_has", "any_elig", "headroom", "ports_used", "dom_count", "group_count",
         "term_block",
         "pref_paint", "tmpl_headroom", "tmpl_ports_used", "tmpl_dom_count",
         "tmpl_group_count", "tmpl_term_block", "tmpl_pref_paint", "out_node",
         "out_fail", "out_feasible",
         # the device-resource ops
         "gpu_cap_mem", "gpu_slot", "vg_cap", "sdev_cap", "sdev_ssd", "pv_ptr", "pv_idx",
         "pv_cand", "class_vol_node", "class_vol_zone", "class_vol_bind", "vol_limit_cap",
         "svol_key", "gpu_mem", "gpu_cnt", "gpu_forced", "gpu_has_forced", "lvm_req",
         "sdev_req", "sdev_req_ssd", "vol_cid", "vol_pv_missing", "wfc_ccid", "wfc_valid",
         "vol_limit_req", "svol_id", "gpu_used", "vg_used", "sdev_taken", "pv_taken",
         "vol_cnt", "svol_on_node", "tmpl_gpu_used", "tmpl_vg_used", "tmpl_sdev_taken",
         "tmpl_pv_taken", "tmpl_vol_cnt", "tmpl_svol_on_node", "out_gpu_pick",
         "out_vol_pick")
_N_BASE_PTRS = _PTRS.index("gpu_cap_mem")
# the carry fields the kernel's lane prologue copies from the template, in
# the struct's order; the device-resource ones only in a launch that runs
# their ops (otherwise the launcher copies them)
DEVRES_CARRY = ("gpu_used", "vg_used", "sdev_taken", "pv_taken", "vol_cnt", "svol_on_node")
KERNEL_CARRY = ("headroom", "ports_used", "dom_count", "group_count", "term_block",
                "pref_paint") + DEVRES_CARRY
_INTS = ("n", "r", "c", "u", "k", "k1", "d", "sg", "pt", "cs", "a", "b", "ap", "t",
         "t2", "ops", "s", "p0", "p1", "ci", "mi", "flags", "g", "v", "e", "lv", "ev", "npv",
         "lw", "lk", "lsv", "nsv")
_N_BASE_INTS = _INTS.index("g")
_FLOATS = ("w_bal", "w_least", "w_most", "w_na", "w_tt", "w_ip", "w_sp", "w_si", "w_gpu")
# per-thread widths of the device-resource walks (kMaxV, kMaxE, kMaxLw in
# the .cu): a launch past any of them walks a window of global memory
# (StepArgs.walk) instead
MAX_VG, MAX_DEVICES, MAX_WFC_CLAIMS = 8, 32, 8

# a block's dynamic shared memory budget (227 KB per block on Hopper, less
# the static reduction buffers; what is left over serves as L1)
_SMEM_LIMIT = 200 * 1024
# the launch geometry's bounds (kMaxThreads, kMaxThreadsDevRes,
# kMaxThreadsWide, kMaxThreadsWideDevRes, kMaxCluster in the .cu): block
# sizes under which each instantiation stays in registers (the fleet builds
# and the wide library's take the smaller caps), and cluster sizes (over 8
# blocks is non-portable, and the card may refuse it)
MAX_THREADS, MAX_THREADS_DEVRES = 512, 384
MAX_THREADS_WIDE, MAX_THREADS_WIDE_DEVRES = 384, 256
MAX_THREADS_EXPLAIN, MAX_THREADS_EXPLAIN_DEVRES = 384, 256
CLUSTER_SIZES = (16, 8, 4, 2, 1)
# the explain top-k (kTopkPass, kTopkLists in the .cu): a pass ranks up to
# TOPK_PASS candidates a pod in one cluster round; its lists take
# TOPK_LISTS + 5 rows of TOPK_PASS 8-byte keys of a block's shared memory
TOPK_PASS, TOPK_LISTS = 8, 16
TOPK_WORDS = 2 * (TOPK_LISTS + 5) * TOPK_PASS


class SmemWidths(NamedTuple):
    """The widths a block's shared memory grows with (kernel: layout_of)."""
    ops: int    # first-fail histogram rows
    q: int      # the pod's carry columns (A + B + Cs + Ap)
    d: int      # domains per key
    cs: int     # spread constraints
    dom: int    # K1 * D * Sg, the dom_count replica (0 off the dom_count path)
    rows: int   # raw-score rows: 3, + interpod, + GPU (+ the top-k's masked scores)
                # (+ the raw extension scores, + the nodes' first failing
                # filter extensions)
    r: int      # resources (the headroom row)
    npv: int    # the pv_taken replica (0 without PV matching)
    ext: int = 0  # the extension minima and normalizers (3 * ered + 3 * Es)
    keys: int = 0  # the top-k's key rows, in words (TOPK_WORDS under explain_topk)
    pod: int = 0   # the pod region, in words (pod_words)
    node_w: int = 0  # the staged node rows' words a node: inv_alloc's two columns,
                     # spec_id and K1 node_dom rows (RES_STAGE_NODE)
    node_b: int = 0  # and their bytes a node: active, unschedulable, K has_key rows
    cls: int = 0   # a pod's class rows, bytes a node of the padded slice (RES_STAGE_CLASS)


def smem_bytes(w: SmemWidths, slice_len: int, headroom: bool, dom_global: bool = False,
               cols_global: bool = False, stage: int = 0) -> int:
    """A block's dynamic shared memory for these widths and a slice of
    `slice_len` nodes, its headroom rows in shared memory or not, its
    dom_count replica and its column-read partials in global memory or not,
    and the `stage` regions (RES_STAGE_* bits) staged (mirrors layout_of in
    the .cu): the top-k's key rows, the class rows twice (by pod parity,
    each slice padded to 16 nodes), the pod region, the histogram and the
    column-read partials twice, the merged column read, the column needs,
    the hard-spread minima, the dom_count replica, the slice's raw scores
    (and headroom, and the staged node rows) as 4-byte words, then its
    flags, the pv_taken replica and the staged node rows' bytes."""
    qd = w.q * w.d + 2 * w.q
    slp = _cdiv(slice_len, 16) * 16
    node = slice_len if stage & RES_STAGE_NODE else 0
    words = (w.keys + (2 * w.cls * slp // 4 if stage & RES_STAGE_CLASS else 0) + 2 * w.pod
             + 2 * w.ops + (0 if cols_global else 2 * qd) + qd + w.q + w.cs
             + (0 if dom_global else w.dom)
             + w.rows * slice_len + w.ext + (slice_len * w.r if headroom else 0)
             + w.node_w * node)
    return 4 * words + slice_len + w.npv + w.node_b * node


class LaunchPlan(NamedTuple):
    """One launch's geometry: S clusters of `cluster` blocks of `threads`
    threads; block `rank` of a lane owns nodes [rank * slice_len,
    (rank + 1) * slice_len) (cut at N; trailing slices may be empty)."""
    cluster: int
    threads: int
    slice_len: int
    headroom: bool   # the block's headroom rows live in shared memory
    smem: int        # dynamic shared memory per block (bytes)
    resident: int    # clusters of this geometry the card holds at once
    dom_global: bool = False   # each block's dom_count replica lives in global memory
    cols_global: bool = False  # its column-read partials live in global memory
    wide: bool = False         # the wide library's builds (global regions, walk window)
    stage: int = 0             # the staged regions (RES_STAGE_* bits)


# where plan_launch puts a block's regions, in the order it tries them:
# (headroom rows in shared memory, dom_count replica in global memory,
# column-read partials in global memory, the staged regions); the first
# that fits wins. The staged regions are the first thing dropped: the class
# rows' copies, then the node rows; then the headroom rows leave shared
# memory, then (the wide library only) the replica and the partials.
PLACEMENTS = ((True, False, False, STAGE_ALL), (True, False, False, RES_STAGE_NODE),
              (True, False, False, UNSTAGED), (False, False, False, UNSTAGED),
              (False, True, False, UNSTAGED), (False, False, True, UNSTAGED),
              (False, True, True, UNSTAGED))


def placement_name(plan: "LaunchPlan") -> str:
    """The PLACEMENT_NAMES name of a plan's staged regions."""
    return next(k for k, v in PLACEMENT_NAMES.items() if v == plan.stage)


def placements_held_to(stage: int) -> tuple:
    """PLACEMENTS with every staged placement held to `stage` (the other
    placements as they are): what a measurement or a test sets to run a
    launch under one staging."""
    return tuple(dict.fromkeys(pl[:3] + (stage if pl[3] else 0,) for pl in PLACEMENTS))


def max_threads(flags: int, fleet: bool = False, wide: bool = False, explain: bool = False,
                frozen: bool = False) -> int:
    """The block size cap of the instantiation these flags launch (a fleet
    build, or a build of the wide library, takes the smaller cap; so do
    the explain builds of the scan, and every explain build with the
    device-resource ops)."""
    devres = bool(flags & DEVRES_FLAGS)
    if fleet or wide:
        return MAX_THREADS_WIDE_DEVRES if devres else MAX_THREADS_WIDE
    if explain and (devres or not frozen):
        return MAX_THREADS_EXPLAIN_DEVRES if devres else MAX_THREADS_EXPLAIN
    return MAX_THREADS_DEVRES if devres else MAX_THREADS


def block_geometry(n_nodes: int, cluster: int, cap: int = MAX_THREADS) -> Tuple[int, int]:
    """(slice length, threads per block) of a lane of `n_nodes` nodes over
    `cluster` blocks: ceil(N / C) nodes a block, and the fewest warps that
    give each thread the same number of them (at most `cap`)."""
    sl = max(1, _cdiv(n_nodes, cluster))
    per = _cdiv(sl, cap)
    return sl, max(32, 32 * _cdiv(_cdiv(sl, per), 32))


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def node_slices(plan: LaunchPlan, n_nodes: int) -> List[Tuple[int, int]]:
    """Each block rank's [lo, hi) node slice, in rank order."""
    los = [min(r * plan.slice_len, n_nodes) for r in range(plan.cluster)]
    return [(lo, min(lo + plan.slice_len, n_nodes)) for lo in los]


def plan_launch(n_lanes: int, n_nodes: int, w: SmemWidths,
                occupancy: Callable[..., int],
                cap: int = MAX_THREADS, placements=PLACEMENTS) -> LaunchPlan:
    """The launch geometry: the largest cluster size C in CLUSTER_SIZES
    whose block fits its shared memory and whose `n_lanes` clusters the card
    holds at once (`occupancy(C, threads, slice_len, headroom, dom_global,
    cols_global, stage)`, the card's cudaOccupancyMaxActiveClusters, 0 where
    it cannot place one); where no size holds every lane at once, the
    smallest size that fits (its lanes run in waves). Blocks have at most
    `cap` threads (``max_threads``). Each size takes the first of
    `placements` that fits (PLACEMENTS: every region staged where they fit,
    then without the class rows' copies, then without the node rows, then
    the headroom rows in global memory, then the dom_count replica, then
    the column-read partials, then both, in global memory per block).
    Raises ValueError when no cluster size fits even so."""
    fits = []
    for c in CLUSTER_SIZES:
        sl, threads = block_geometry(n_nodes, c, cap)
        for hr, dg, cg, stage in placements:
            smem = smem_bytes(w, sl, hr, dg, cg, stage)
            if smem <= _SMEM_LIMIT:
                break
        else:
            continue  # this size's slices do not fit
        plan = LaunchPlan(c, threads, sl, hr, smem,
                          occupancy(c, threads, sl, hr, dg, cg, stage), dg, cg, stage=stage)
        if plan.resident >= n_lanes:
            return plan
        fits.append(plan)
    if not fits:
        sl = block_geometry(n_nodes, CLUSTER_SIZES[0])[0]
        need = smem_bytes(w, sl, False, True, True)
        raise ValueError(
            f"plain_step: {w.ops} ops, {w.q} carry columns x {w.d} domains and "
            f"{sl}-node slices need {need} bytes of shared memory, over the block's "
            f"{_SMEM_LIMIT}")
    return fits[-1]


LAST_PLAN: Optional[LaunchPlan] = None


class StepArgs(ctypes.Structure):
    # the C struct's order: the fields of the instantiations without the
    # device-resource ops first (their layout unchanged), then the
    # device-resource ones
    _fields_ = ([(f, ctypes.c_void_p) for f in _PTRS[:_N_BASE_PTRS]]
                + [(f, ctypes.c_int) for f in _INTS[:_N_BASE_INTS]]
                + [(f, ctypes.c_float) for f in _FLOATS[:-1]]
                + [(f, ctypes.c_void_p) for f in _PTRS[_N_BASE_PTRS:]]
                + [(f, ctypes.c_int) for f in _INTS[_N_BASE_INTS:]]
                + [(f, ctypes.c_float) for f in _FLOATS[-1:]]
                + [("cycles", ctypes.c_void_p)]
                + [(f, ctypes.c_int) for f in ("cl", "bt", "sl", "res", "frozen", "topk",
                                                 "n_parts", "jitter")]
                + [(f, ctypes.c_uint) for f in ("key0", "key1")]
                + [(f, ctypes.c_void_p) for f in ("out_topk_node", "out_topk_score",
                                                  "out_topk_parts", "w_lane")]
                + [("lanes", ctypes.c_void_p), ("fleet", ctypes.c_int), ("walk", ctypes.c_void_p),
                   ("walk_w", ctypes.c_int), ("dom_spill", ctypes.c_void_p),
                   ("col_spill", ctypes.c_void_p)]
                + [(f, ctypes.c_void_p) for f in ("ext_ok", "ext_raw", "ext_w", "ext_norm")]
                + [(f, ctypes.c_int) for f in ("ef", "es", "ered", "ls")]
                + [(f, ctypes.c_void_p) for f in ("pod_pack", "cls_pack")]
                + [("hit_w", ctypes.c_int)])


# ExtensionOp.normalize -> StepArgs.ext_norm
EXT_NORMALIZE = {"none": 0, "minmax": 1, "max": 2}


class ExtensionRows(NamedTuple):
    """The extension rows a config's step takes: the filter and the score
    extensions in registration order, and the normalizer rows the scores
    add to the step's reduction (2 per "minmax", 1 per "max")."""
    filters: tuple
    scores: tuple
    ered: int


def extension_rows(cfg: EngineConfig) -> ExtensionRows:
    filters = tuple(e for e in cfg.extensions if e.filter_fn is not None)
    scores = tuple(e for e in cfg.extensions if e.score_fn is not None)
    ered = sum(2 if e.normalize == "minmax" else (1 if e.normalize == "max" else 0)
               for e in scores)
    return ExtensionRows(filters, scores, ered)


def check_extension_rows(cfg: EngineConfig, ext_ok, ext_raw, n_lanes: int, n_out: int,
                         n_nodes: int) -> None:
    """The rows are given exactly where the config registers extensions of
    their kind, as [S, P', Ef, N] bool or uint8 and [S, P', Es, N] f32
    tensors on the step's device."""
    rows = extension_rows(cfg)
    for name, got, want, dtypes in (("ext_ok", ext_ok, len(rows.filters),
                                     (torch.bool, torch.uint8)),
                                    ("ext_raw", ext_raw, len(rows.scores), (torch.float32,))):
        if not want:
            if got is not None:
                raise ValueError(f"plain_step: {name} given but the config registers no "
                                 "such extension")
            continue
        if got is None:
            raise ValueError(f"plain_step: cfg.extensions needs {name} [S, P', {want}, N]")
        shape = (n_lanes, n_out, want, n_nodes)
        if got.dtype not in dtypes or tuple(got.shape) != shape:
            raise ValueError(f"plain_step: {name} is {got.dtype}{tuple(got.shape)}, expected "
                             f"{dtypes[0]}{shape}")


class StepOutputs(NamedTuple):
    node: torch.Tensor          # [S, P'] i32
    fail_counts: torch.Tensor   # [S, P', OPS] i32 (a zero-stride view without reasons)
    feasible: torch.Tensor      # [S, P'] i32
    gpu_pick: torch.Tensor      # [S, P', G] i32
    vol_pick: torch.Tensor      # [S, P', Lw] i32
    topk_node: torch.Tensor     # [S, P', K] i32
    topk_score: torch.Tensor    # [S, P', K] f32
    topk_parts: torch.Tensor    # [S, P', C, K] f32



def explain_on(cfg: EngineConfig) -> bool:
    """Does the launch run the explain builds (top-k or the jitter)?"""
    return bool(cfg.explain_topk or cfg.tie_break_seed)


def pick_widths(arrs, cfg: EngineConfig) -> Tuple[int, int]:
    """(G, Lw) of the gpu_pick / vol_pick outputs: 0 for a gated-off op,
    so a launch carries no dead buffer."""
    return (arrs.gpu_slot.shape[1] if cfg.enable_gpu else 0,
            arrs.wfc_ccid.shape[1] if cfg.enable_pv_match else 0)


def plain_step(arrs, active: torch.Tensor, hoist: ActiveHoist,
               inv_alloc: torch.Tensor, state: SimState, cfg: EngineConfig,
               p0: int, p1: int, template: Optional[SimState] = None,
               disabled: Optional[torch.Tensor] = None,
               nominated: Optional[torch.Tensor] = None, frozen: bool = False,
               inputs: Optional[dict] = None,
               weights: Optional[torch.Tensor] = None,
               ext_ok: Optional[torch.Tensor] = None,
               ext_raw: Optional[torch.Tensor] = None) -> StepOutputs:
    """The step over pods [p0, p1): the CUDA kernel for CUDA tensors, the
    plain torch step for CPU tensors. `inputs` (CUDA only) is a dict the
    caller keeps across launches over the same arrays, lanes and config."""
    if active.device.type == "cuda":
        return plain_step_cuda(arrs, active, hoist, inv_alloc, state, cfg, p0, p1, template,
                               disabled=disabled, nominated=nominated, frozen=frozen,
                               inputs=inputs, weights=weights, ext_ok=ext_ok, ext_raw=ext_raw)
    if active.device.type == "cpu":
        return plain_step_torch(arrs, active, hoist, inv_alloc, state, cfg, p0, p1, template,
                                disabled=disabled, nominated=nominated, frozen=frozen,
                                weights=weights, ext_ok=ext_ok, ext_raw=ext_raw)
    raise ValueError(f"no plain_step for device {active.device}")


def _check_frozen(template, disabled, nominated, phase_cycles=None,
                  cfg: Optional[EngineConfig] = None) -> None:
    if template is not None or disabled is not None or nominated is not None:
        raise ValueError("plain_step: the frozen wave form takes no template and no "
                         "preemption column")
    if cfg is not None and cfg.extensions:
        raise ValueError("plain_step: the frozen wave form takes no extension rows (a wave "
                         "plan is dropped under extensions)")
    if phase_cycles is not None:
        raise ValueError("plain_step: the frozen wave form has no cycle counts")


def check_weights(cfg: EngineConfig, weights: Optional[torch.Tensor],
                  n_lanes: int) -> None:
    """The weight row is given exactly under the traced weights, as an
    [S, K] f32 tensor on the step's device."""
    if not cfg.traced_weights:
        if weights is not None:
            raise ValueError("plain_step: weights given without cfg.traced_weights")
        return
    k = len(scheduler.WEIGHT_FIELDS)
    if weights is None:
        raise ValueError("plain_step: cfg.traced_weights is on but no weights were given")
    if weights.dtype != torch.float32 or tuple(weights.shape) != (n_lanes, k):
        raise ValueError(f"plain_step: weights are {weights.dtype}{tuple(weights.shape)}, "
                         f"expected torch.float32({n_lanes}, {k})")


def copy_template(state: SimState, template: SimState, fields=STATE_FIELDS) -> None:
    """The plain version of the lane prologue: `fields` of every lane of
    `state` become the template's."""
    for f in fields:
        lanes = getattr(state, f)
        lanes.copy_(getattr(template, f)[None].expand_as(lanes))


def no_fail_counts(n_lanes: int, n_pods: int, n_ops: int, device) -> torch.Tensor:
    """The [S, P, OPS] fail counts of a run without reason accounting: a
    zero-stride view of one int32 zero, so nothing of that size exists."""
    return torch.zeros((), dtype=torch.int32, device=device).expand(n_lanes, n_pods, n_ops)


def plain_step_torch(arrs, active: torch.Tensor, hoist: ActiveHoist,
                     inv_alloc: torch.Tensor, state: SimState, cfg: EngineConfig,
                     p0: int, p1: int, template: Optional[SimState] = None,
                     disabled: Optional[torch.Tensor] = None,
                     nominated: Optional[torch.Tensor] = None,
                     frozen: bool = False,
                     weights: Optional[torch.Tensor] = None,
                     ext_ok: Optional[torch.Tensor] = None,
                     ext_raw: Optional[torch.Tensor] = None) -> StepOutputs:
    """The plain version: lane by lane, pod by pod through the torch twin
    of the reference step (``engine.scheduler._step``), on any device.
    Frozen: every pod against a clone of the lane's carry, which is left
    as it is. Lane s takes ``weights[s]`` under the traced weights, and
    pod p of lane s the extension rows ``ext_ok[s, p - p0]`` and
    ``ext_raw[s, p - p0]``."""
    if frozen:
        _check_frozen(template, disabled, nominated, cfg=cfg)
    dev = active.device
    n_lanes, n_out = active.shape[0], p1 - p0
    check_weights(cfg, weights, n_lanes)
    check_extension_rows(cfg, ext_ok, ext_raw, n_lanes, max(n_out, 0), arrs.alloc.shape[0])
    if template is not None:
        copy_template(state, template)
    host = {f: getattr(arrs, f).cpu().numpy() for f in STEP_HOST_FIELDS}
    dis = disabled.cpu().numpy() if disabled is not None else None
    nom = nominated.cpu().numpy() if nominated is not None else None
    node = torch.empty((n_lanes, n_out), dtype=torch.int32, device=dev)
    fail = (torch.zeros((n_lanes, n_out, cfg.n_ops), dtype=torch.int32, device=dev)
            if cfg.fail_reasons else no_fail_counts(n_lanes, n_out, cfg.n_ops, dev))
    feas = torch.empty((n_lanes, n_out), dtype=torch.int32, device=dev)
    g_w, lw = pick_widths(arrs, cfg)
    k_top, c_parts = scheduler.topk_widths(arrs, cfg)
    gpick = torch.empty((n_lanes, n_out, g_w), dtype=torch.int32, device=dev)
    vpick = torch.empty((n_lanes, n_out, lw), dtype=torch.int32, device=dev)
    tnode = torch.empty((n_lanes, n_out, k_top), dtype=torch.int32, device=dev)
    tscore = torch.empty((n_lanes, n_out, k_top), dtype=torch.float32, device=dev)
    tparts = torch.empty((n_lanes, n_out, c_parts, k_top), dtype=torch.float32, device=dev)
    for s in range(n_lanes):
        st = SimState(**{f: getattr(state, f)[s] for f in STATE_FIELDS})
        lane_hoist = ActiveHoist(*(x[s] for x in hoist))
        rows = []
        for p in range(p0, p1):
            src = SimState(**{f: getattr(st, f).clone() for f in STATE_FIELDS}) if frozen else st
            new, out = scheduler._step(arrs, host, active[s], cfg, lane_hoist, inv_alloc, src, p,
                                       disabled=dis is not None and bool(dis[p]),
                                       nominated=None if nom is None else int(nom[p]),
                                       weights=None if weights is None else weights[s],
                                       ext_ok=None if ext_ok is None else ext_ok[s, p - p0],
                                       ext_raw=None if ext_raw is None else ext_raw[s, p - p0])
            if not frozen:
                st = new
            rows.append(out)
        if n_out:
            nodes, fails, feasible, gpus, vols, t_nodes, t_scores, t_parts = zip(*rows)
            node[s] = torch.stack(nodes)
            feas[s] = torch.stack(feasible)
            gpick[s] = torch.stack(gpus)
            vpick[s] = torch.stack(vols)
            tnode[s] = torch.stack(t_nodes)
            tscore[s] = torch.stack(t_scores)
            tparts[s] = torch.stack(t_parts)
            if cfg.fail_reasons:
                fail[s] = torch.stack(fails)
        if not frozen:
            for f in STATE_FIELDS:
                getattr(state, f)[s].copy_(getattr(st, f))
    return StepOutputs(node, fail, feas, gpick, vpick, tnode, tscore, tparts)


def node_domains(topo_onehot: torch.Tensor) -> torch.Tensor:
    """[K1, N, D] one-hot -> [K1, N] i32 domain index, -1 where the node
    lacks the key."""
    has = topo_onehot.sum(dim=2) > 0
    return torch.where(has, topo_onehot.argmax(dim=2),
                       torch.full_like(has, -1, dtype=torch.long)).to(torch.int32)


def _flags(cfg: EngineConfig, state: SimState, template: bool) -> int:
    fl = F_TEMPLATE if template else 0
    fl |= F_UNSCHED if cfg.enable_unsched else 0
    fl |= F_CLASS_AFF if cfg.enable_class_aff else 0
    fl |= F_CLASS_TAINT if cfg.enable_class_taint else 0
    fl |= F_PORTS if cfg.enable_ports else 0
    fl |= F_FAIL if cfg.fail_reasons else 0
    use_na, use_tt, use_ip, use_sp, use_si = scheduler.score_rows(cfg)
    fl |= F_NA if use_na else 0
    fl |= F_TT if use_tt else 0
    fl |= F_IP if use_ip else 0
    fl |= F_SP if use_sp else 0
    fl |= F_SI if use_si else 0
    use_bal, use_least, use_most = scheduler.resource_terms(cfg)
    fl |= F_BAL if use_bal else 0
    fl |= F_LEAST if use_least else 0
    fl |= F_MOST if use_most else 0
    fl |= F_GC if cfg.needs_group_count else 0
    fl |= F_DOM if cfg.maintain_dom_count else 0
    fl |= F_GC_BF16 if state.group_count.dtype == torch.bfloat16 else 0
    fl |= F_AFF if cfg.enable_pod_affinity else 0
    fl |= F_ANTI if cfg.enable_anti_affinity else 0
    fl |= F_SPH if cfg.enable_spread_hard else 0
    fl |= F_PREF if cfg.enable_pref else 0
    fl |= F_TB_BF16 if state.term_block.dtype == torch.bfloat16 else 0
    fl |= F_GPU if cfg.enable_gpu else 0
    fl |= F_STORAGE if cfg.enable_storage else 0
    fl |= F_VOL_STATIC if cfg.enable_vol_static else 0
    fl |= F_PV_MATCH if cfg.enable_pv_match else 0
    fl |= F_VOL_LIMITS if cfg.enable_vol_limits else 0
    fl |= F_VOL_DEDUP if cfg.enable_vol_dedup else 0
    return fl


def instantiation(cfg: EngineConfig, state: SimState, columns: bool = False,
                  frozen: bool = False, fleet: bool = False) -> str:
    """The ``plain_step<kInterpod, kDevRes, kCols, kFrozen, kExplain>`` a
    launch under `cfg` on this carry runs, as "<I,D>", with "+columns"
    where the launch passes the preemption columns, "+frozen" for the wave
    form, "+fleet" for ``plain_step_fleet_kernel<kInterpod, kDevRes,
    kExplain>`` and "+explain" under explain_topk or tie_break_seed (the
    kernel's ``kernel_of`` picks it from the same flags and pointers)."""
    fl = _flags(cfg, state, False)
    return (f"<{int(bool(fl & INTERPOD_FLAGS))},{int(bool(fl & DEVRES_FLAGS))}>"
            + ("+columns" if columns else "") + ("+frozen" if frozen else "")
            + ("+fleet" if fleet else "") + ("+explain" if explain_on(cfg) else ""))


def devres_on(cfg: EngineConfig) -> bool:
    """Does the launch run the device-resource instantiation?"""
    return bool(cfg.enable_gpu or cfg.enable_storage or cfg.enable_vol_static
                or cfg.enable_pv_match or cfg.enable_vol_limits or cfg.enable_vol_dedup)


def admitted_pv_lists(pv_node_ok: torch.Tensor,
                      pv_cand: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """([Npv, N] bool, [Cc, Npv] bool) -> (ptr [N+1] i32, idx [nnz] i32):
    each node's admitted PVs in ascending PV id (the capacity-ascending
    axis, so the first free candidate in a list is the smallest that
    fits), leaving out the PVs no claim class can take (bound volumes,
    other classes): no claim ever finds those."""
    wanted = pv_cand.any(dim=0) if pv_cand.shape[0] else torch.zeros_like(pv_node_ok[:, 0])
    return term_lists((pv_node_ok & wanted[:, None]).T.contiguous())


def term_lists(dense: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """[P, T] bool -> (ptr [P+1] i32, idx [nnz] i32): each pod's set
    columns, ascending (the nonzeros of hit_terms / own_terms). The same
    columns as the slot form's hit_tid / own_tid, for either form."""
    n_pods = dense.shape[0]
    rows, cols = torch.nonzero(dense, as_tuple=True)
    ptr = torch.zeros((n_pods + 1,), dtype=torch.int32, device=dense.device)
    ptr[1:] = torch.cumsum(torch.bincount(rows, minlength=n_pods), 0).to(torch.int32)
    return ptr, cols.to(torch.int32).contiguous()


def _check(name: str, t: torch.Tensor, dtype, shape, kernel: str = "plain_step") -> torch.Tensor:
    """`t` as a kernel takes it (on the card, of this dtype and shape,
    contiguous), or a ValueError naming `kernel` and the input."""
    if t.device.type != "cuda":
        raise ValueError(f"{kernel}: {name} is on {t.device}, not on the card")
    if t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise ValueError(f"{kernel}: {name} is {t.dtype}{tuple(t.shape)}, "
                         f"expected {dtype}{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{kernel}: {name} is not contiguous")
    return t


def _check_index(name: str, t: torch.Tensor, bound: int) -> None:
    """The kernel indexes with these without bounds checks."""
    if t.numel() and int(t.max()) >= bound:
        raise ValueError(f"plain_step: {name} holds {int(t.max())}, past its bound {bound}")


def hit_width(arrs, cfg: EngineConfig) -> int:
    """The width of each pod's staged hit-term list (StepArgs.hit_w): the
    terms' count, where the anti-affinity row is live and it is at most
    MAX_HITS_STAGED; else 0, and the kernel reads the host's lists."""
    t = arrs.hit_terms.shape[1]
    return t if cfg.enable_anti_affinity and t <= MAX_HITS_STAGED else 0


def pod_words(arrs, cfg: EngineConfig) -> int:
    """The pod region's 4-byte words (kernel: pod_lay): a 4-word record a
    carry column (affinity, anti-affinity, spread and preferred terms),
    the resources and the hit list; then its byte rows (ports, match
    groups, preferred hits) rounded up to words, the whole to 4 words."""
    q = sum(getattr(arrs, f).shape[1] for f in ("aff_group", "anti_group", "spread_group",
                                               "pref_group"))
    words = 4 * q + arrs.alloc.shape[1] + hit_width(arrs, cfg)
    bytes_ = arrs.ports.shape[1] + arrs.match_groups.shape[1] + arrs.hit_pref.shape[1]
    return _cdiv(words + _cdiv(bytes_, 4), 4) * 4


def smem_widths(arrs, cfg: EngineConfig, flags: int) -> SmemWidths:
    """The widths of a launch's shared memory under its StepArgs flags."""
    k1, _, d = arrs.topo_onehot.shape
    rows = extension_rows(cfg)
    return SmemWidths(
        ops=cfg.n_ops,
        q=sum(getattr(arrs, f).shape[1] for f in ("aff_group", "anti_group", "spread_group",
                                                  "pref_group")),
        d=d, cs=arrs.spread_group.shape[1],
        dom=k1 * d * arrs.match_groups.shape[1] if flags & F_DOM else 0,
        # the raw-score rows, and the masked final scores of the top-k
        rows=3 + bool(flags & INTERPOD_FLAGS) + bool(flags & DEVRES_FLAGS)
        + bool(cfg.explain_topk) + len(rows.scores) + bool(rows.filters),
        r=arrs.alloc.shape[1],
        npv=arrs.pv_node_ok.shape[0] if flags & DEVRES_FLAGS and flags & F_PV_MATCH else 0,
        ext=3 * rows.ered + 3 * len(rows.scores),
        keys=TOPK_WORDS if cfg.explain_topk else 0,
        pod=pod_words(arrs, cfg),
        node_w=3 + k1, node_b=2 + arrs.has_key.shape[0],
        cls=10)


def needs_wide(arrs, cfg: EngineConfig, flags: int) -> bool:
    """Does a launch of these arrays need the wide library: a walk past its
    per-thread widths, or a block whose shared memory cannot hold its
    regions even at the largest cluster with the headroom rows out?"""
    sl = block_geometry(arrs.alloc.shape[0], CLUSTER_SIZES[0])[0]
    return bool(walk_width(arrs, cfg)) or smem_bytes(smem_widths(arrs, cfg, flags), sl,
                                                      False) > _SMEM_LIMIT


def placements_for(wide: bool, one_pod: bool = False, flags: int = 0) -> tuple:
    """The PLACEMENTS a launch may take: the replica and the partials stay
    in shared memory outside the wide library; a launch of one pod a
    cluster (the frozen form, the extension loop's) stages no node or
    class rows, whose copies would cost it more than its one pod reads;
    the device-resource builds stage no class rows, and the build with
    both slices' gates (`<1,1>`) no node rows either (the kernel compiles
    those stagings out of them: registers)."""
    devres, both = bool(flags & DEVRES_FLAGS), bool(flags & DEVRES_FLAGS and flags & INTERPOD_FLAGS)
    allowed = 0 if one_pod or both else (RES_STAGE_NODE if devres else STAGE_ALL)
    return tuple(dict.fromkeys(pl[:3] + (pl[3] & allowed,) for pl in PLACEMENTS
                               if wide or not (pl[1] or pl[2])))


def plan_for(arrs, cfg: EngineConfig, flags: int, n_lanes: int,
             occupancy: Callable[..., int], fleet: bool = False,
             one_pod: bool = False, frozen: bool = False) -> LaunchPlan:
    """``plan_launch`` for a launch of these arrays under these flags: the
    wide library's builds and placements where ``needs_wide``; `one_pod`
    for launches of one pod a cluster (``placements_for``), `frozen` for
    the frozen form's builds (``max_threads``)."""
    wide = needs_wide(arrs, cfg, flags)
    plan = plan_launch(n_lanes, arrs.alloc.shape[0], smem_widths(arrs, cfg, flags), occupancy,
                       max_threads(flags, fleet, wide, explain_on(cfg), frozen),
                       placements_for(wide, one_pod, flags))
    return plan._replace(wide=wide)


def _library(explain: bool = False, wide: bool = False) -> ctypes.CDLL:
    """The kernel's library: the twelve builds and the four fleet builds,
    or their explain twins; the wide library's builds past the walk widths
    or the shared memory."""
    lib = build.load("plain_step" + ("_wide" if wide else "") + ("_explain" if explain else ""))
    args_p = ctypes.POINTER(StepArgs)
    lib.plain_step_launch.argtypes = [args_p, ctypes.c_void_p]
    lib.plain_step_launch.restype = ctypes.c_int
    lib.plain_step_clusters.argtypes = [args_p, ctypes.POINTER(ctypes.c_int)]
    lib.plain_step_clusters.restype = ctypes.c_int
    lib.plain_step_smem.argtypes = [args_p]
    lib.plain_step_smem.restype = ctypes.c_int
    return lib


def _set_geometry(args: StepArgs, plan) -> None:
    args.cl, args.bt, args.sl = plan.cluster, plan.threads, plan.slice_len
    args.res = ((RES_HEADROOM if plan.headroom else 0)
                | (RES_DOM_GLOBAL if plan.dom_global else 0)
                | (RES_COLS_GLOBAL if plan.cols_global else 0) | plan.stage)


def _card_occupancy(lib: ctypes.CDLL, args: StepArgs):
    """plan_launch's occupancy answer on the current card."""
    def occupancy(cluster: int, threads: int, slice_len: int, headroom: bool,
                  dom_global: bool = False, cols_global: bool = False, stage: int = 0) -> int:
        _set_geometry(args, LaunchPlan(cluster, threads, slice_len, headroom, 0, 0,
                                       dom_global, cols_global, stage=stage))
        n = ctypes.c_int(0)
        err = lib.plain_step_clusters(ctypes.byref(args), ctypes.byref(n))
        if err:
            raise RuntimeError(f"plain_step occupancy query failed: CUDA error {err}")
        return n.value
    return occupancy


def _static_inputs(arrs, active: torch.Tensor, hoist: ActiveHoist, inv_alloc: torch.Tensor,
                   cfg: EngineConfig) -> Dict[str, torch.Tensor]:
    """The launch's node, pod and lane arrays in the kernel's types, after
    the index checks: what every launch over the same arrays, lanes and
    config shares."""
    n, r = arrs.alloc.shape
    n_lanes = active.shape[0]
    k1, _, d = arrs.topo_onehot.shape
    n_cls = arrs.class_affinity.shape[0]
    sg = arrs.match_groups.shape[1]
    t2 = arrs.hit_pref.shape[1]
    k = arrs.has_key.shape[0]
    lk, nsv, lw = arrs.vol_limit_cap.shape[1], arrs.svol_key.shape[0], arrs.wfc_ccid.shape[1]
    devres = devres_on(cfg)
    soft = arrs.spread_valid & ~arrs.spread_hard
    hard = arrs.spread_valid & arrs.spread_hard
    _check_index("class_id", arrs.class_id, n_cls)
    _check_index("spec_id", arrs.spec_id, arrs.spec_alloc.shape[0])
    _check_index("forced_node", arrs.forced_node, n)
    _check_index("spread_group", arrs.spread_group[arrs.spread_valid], sg)
    _check_index("spread_key", arrs.spread_key[arrs.spread_valid], k)
    _check_index("aff_group", arrs.aff_group[arrs.aff_valid], sg)
    _check_index("aff_key", arrs.aff_key[arrs.aff_valid], k)
    _check_index("anti_group", arrs.anti_group[arrs.anti_valid], sg)
    _check_index("anti_key", arrs.anti_key[arrs.anti_valid], k)
    _check_index("pref_group", arrs.pref_group[arrs.pref_valid], sg)
    _check_index("pref_key", arrs.pref_key[arrs.pref_valid], k)
    _check_index("pref_tid", arrs.pref_tid[arrs.pref_valid], t2)
    _check_index("term_key", arrs.term_key, k)
    if devres:
        _check_index("vol_cid", arrs.vol_cid, arrs.class_vol_node.shape[0])
        _check_index("wfc_ccid", arrs.wfc_ccid, arrs.pv_cand.shape[0])
        _check_index("svol_id", arrs.svol_id, nsv)
        _check_index("svol_key", arrs.svol_key, lk)
        if lw > 1 and bool((arrs.wfc_valid[:, 1:] & ~arrs.wfc_valid[:, :-1]).any()):
            raise ValueError("plain_step: a pod's valid WaitForFirstConsumer slots must "
                             "come before its padded ones")

    def u8(t):
        return t.to(torch.uint8).contiguous()

    def i32(t):
        return t.to(torch.int32).contiguous()

    def f32(t):
        return t.to(torch.float32).contiguous()

    hit_ptr, hit_idx = term_lists(arrs.hit_terms)
    own_ptr, own_idx = term_lists(arrs.own_terms)
    pv_ptr, pv_idx = admitted_pv_lists(arrs.pv_node_ok, arrs.pv_cand)
    return dict(
        inv_alloc=_check("inv_alloc", inv_alloc, torch.float32, (n, r)),
        unschedulable=u8(arrs.unschedulable),
        class_affinity=u8(arrs.class_affinity),
        class_taint=u8(arrs.class_taint),
        class_node_aff_score=f32(arrs.class_node_aff_score),
        class_taint_prefer=f32(arrs.class_taint_prefer),
        spec_id=i32(arrs.spec_id),
        spec_alloc=f32(arrs.spec_alloc),
        node_dom=node_domains(arrs.topo_onehot).contiguous(),
        has_key=u8(arrs.has_key > 0),
        term_key=i32(arrs.term_key),
        req=f32(arrs.req),
        class_id=i32(arrs.class_id),
        forced_node=i32(arrs.forced_node),
        ports=u8(arrs.ports),
        match_groups=u8(arrs.match_groups),
        spread_group=i32(arrs.spread_group),
        spread_key=i32(arrs.spread_key),
        spread_skew=f32(arrs.spread_skew),
        spread_soft=u8(soft),
        spread_hard=u8(hard),
        aff_group=i32(arrs.aff_group),
        aff_key=i32(arrs.aff_key),
        aff_valid=u8(arrs.aff_valid),
        aff_self=u8(arrs.aff_self),
        anti_group=i32(arrs.anti_group),
        anti_key=i32(arrs.anti_key),
        anti_valid=u8(arrs.anti_valid),
        hit_ptr=hit_ptr, hit_idx=hit_idx, own_ptr=own_ptr, own_idx=own_idx,
        pod_pack=pod_pack(arrs, cfg, hit_ptr, hit_idx),
        pref_group=i32(arrs.pref_group),
        pref_key=i32(arrs.pref_key),
        pref_weight=f32(arrs.pref_weight),
        pref_valid=u8(arrs.pref_valid),
        pref_tid=i32(arrs.pref_tid),
        hit_pref=u8(arrs.hit_pref),
        gpu_cap_mem=f32(arrs.gpu_cap_mem), gpu_slot=f32(arrs.gpu_slot),
        vg_cap=f32(arrs.vg_cap), sdev_cap=f32(arrs.sdev_cap), sdev_ssd=u8(arrs.sdev_ssd),
        pv_ptr=pv_ptr, pv_idx=pv_idx, pv_cand=u8(arrs.pv_cand),
        class_vol_node=u8(arrs.class_vol_node), class_vol_zone=u8(arrs.class_vol_zone),
        class_vol_bind=u8(arrs.class_vol_bind), vol_limit_cap=f32(arrs.vol_limit_cap),
        svol_key=i32(arrs.svol_key),
        gpu_mem=f32(arrs.gpu_mem), gpu_cnt=f32(arrs.gpu_cnt), gpu_forced=i32(arrs.gpu_forced),
        gpu_has_forced=u8(arrs.gpu_has_forced), lvm_req=f32(arrs.lvm_req),
        sdev_req=f32(arrs.sdev_req), sdev_req_ssd=u8(arrs.sdev_req_ssd),
        vol_cid=i32(arrs.vol_cid), vol_pv_missing=u8(arrs.vol_pv_missing),
        wfc_ccid=i32(arrs.wfc_ccid), wfc_valid=u8(arrs.wfc_valid),
        vol_limit_req=f32(arrs.vol_limit_req), svol_id=i32(arrs.svol_id),
        active=u8(_check("active", active, torch.bool, (n_lanes, n))),
        # the hoist has one log per one-hot row plus the hostname's (K1 + 1,
        # which is 2 where the hostname is the only key); keys run below K
        log_dom=_check("log_dom", hoist.log_dom[:, :k].contiguous(), torch.float32,
                       (n_lanes, k)),
        elig_host=u8(_check("elig_host", hoist.elig_host, torch.bool, (n_lanes, n_cls, n))),
        domain_has=u8(_check("domain_has", hoist.domain_has, torch.bool,
                             (n_lanes, n_cls, k1, d))),
        any_elig=u8(_check("any_elig", hoist.any_elig, torch.bool, (n_lanes, n_cls, k))),
    )


def padded_lists(ptr: torch.Tensor, idx: torch.Tensor, width: int) -> torch.Tensor:
    """(ptr [P+1], idx) lists -> [P, width] i32 rows, each list's entries
    then -1 (every list at most `width` long)."""
    n_rows = ptr.shape[0] - 1
    out = torch.full((n_rows, width), -1, dtype=torch.int32, device=ptr.device)
    if idx.numel():
        counts = (ptr[1:] - ptr[:-1]).long()
        rows = torch.repeat_interleave(torch.arange(n_rows, device=ptr.device), counts)
        out[rows, torch.arange(idx.numel(), device=ptr.device) - ptr[:-1].long()[rows]] = idx
    return out


def pod_pack(arrs, cfg: EngineConfig, hit_ptr: torch.Tensor,
             hit_idx: torch.Tensor) -> torch.Tensor:
    """[P, pod_words] i32: each pod's region as the kernel stages it (its
    pod_lay), the source of the bulk copy that brings it in, one pod
    ahead: a 4-word record a carry column over the [aff | anti | spread |
    pref] slot axis ({group, key, valid | self << 1, 0}, {group, key,
    valid, 0}, {group, key, soft | hard << 1, maxSkew's f32 bits},
    {group, key, valid ? pref_tid : -1, weight's f32 bits}), the request's
    f32 bits, the hit list (``hit_width`` wide, -1 past its last), then the
    ports, match groups and preferred hits as bytes, zeros to the end."""
    n_pods = arrs.req.shape[0]
    dev = arrs.req.device

    def i32(t):
        return t.to(torch.int32)

    def bits(t):
        return t.to(torch.float32).contiguous().view(torch.int32)

    soft, hard = arrs.spread_valid & ~arrs.spread_hard, arrs.spread_valid & arrs.spread_hard
    records = [
        torch.stack([i32(arrs.aff_group), i32(arrs.aff_key),
                     i32(arrs.aff_valid) | (i32(arrs.aff_self) << 1),
                     torch.zeros_like(i32(arrs.aff_group))], -1),
        torch.stack([i32(arrs.anti_group), i32(arrs.anti_key), i32(arrs.anti_valid),
                     torch.zeros_like(i32(arrs.anti_group))], -1),
        torch.stack([i32(arrs.spread_group), i32(arrs.spread_key), i32(soft) | (i32(hard) << 1),
                     bits(arrs.spread_skew)], -1),
        torch.stack([i32(arrs.pref_group), i32(arrs.pref_key),
                     torch.where(arrs.pref_valid, i32(arrs.pref_tid), -1),
                     bits(arrs.pref_weight)], -1)]
    hit_w = hit_width(arrs, cfg)
    q = sum(r.shape[1] for r in records)
    words = [torch.cat(records, 1).reshape(n_pods, 4 * q), bits(arrs.req)]
    if hit_w:
        words.append(padded_lists(hit_ptr, hit_idx, hit_w))
    bytes_ = torch.cat([arrs.ports.to(torch.uint8), arrs.match_groups.to(torch.uint8),
                        arrs.hit_pref.to(torch.uint8)], 1)
    bytes_ = torch.cat([bytes_, torch.zeros((n_pods, -bytes_.shape[1] % 4), dtype=torch.uint8,
                                            device=dev)], 1).contiguous()
    words.append(bytes_.view(torch.int32))
    out = torch.zeros((n_pods, pod_words(arrs, cfg)), dtype=torch.int32, device=dev)
    body = torch.cat(words, 1)
    out[:, :body.shape[1]] = body
    return out


def class_packs(arrs, plan: LaunchPlan) -> torch.Tensor:
    """The bulk copies' source of a plan that stages the class rows
    (RES_STAGE_CLASS): each class's rows cut into the plan's block slices,
    each slice padded to slp = slice_len rounded up to 16 nodes (so every
    copy starts and ends 16-byte aligned), [C, cl, 10 * slp] bytes: the
    node-affinity score and the taint prefer as f32, the class affinity
    and taint as u8."""
    n, sl, cl = arrs.alloc.shape[0], plan.slice_len, plan.cluster
    slp = _cdiv(sl, 16) * 16

    def sliced(t, dtype):
        full = torch.zeros((t.shape[0], cl * sl), dtype=dtype, device=t.device)
        full[:, :n] = t
        out = torch.zeros((t.shape[0], cl, slp), dtype=dtype, device=t.device)
        out[:, :, :sl] = full.view(-1, cl, sl)
        return out.view(torch.uint8)

    return torch.cat([sliced(arrs.class_node_aff_score, torch.float32),
                      sliced(arrs.class_taint_prefer, torch.float32),
                      sliced(arrs.class_affinity, torch.uint8),
                      sliced(arrs.class_taint, torch.uint8)], dim=2).contiguous()


def _stage_sources(args: StepArgs, arrs, plan: LaunchPlan, static: dict) -> Optional[torch.Tensor]:
    """Point `args` at the class pack a plan's staged class rows copy from
    (kept in `static` per geometry); returns it (to outlive the launch)."""
    if not plan.stage & RES_STAGE_CLASS:
        args.cls_pack = None
        return None
    key = ("cls_pack", plan.slice_len, plan.cluster)
    if key not in static:
        static[key] = class_packs(arrs, plan)
    args.cls_pack = static[key].data_ptr()
    return static[key]


# the class packs of each fleet lane's arrays, kept while the arrays live:
# a campaign's launches over the same lanes build them once
_LANE_PACKS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def lane_packs(arrs) -> dict:
    """The dict ``_stage_sources`` keeps a fleet lane's class packs in:
    one per arrays object, as a one-lane launch keeps them in `inputs`."""
    packs = _LANE_PACKS.get(arrs)
    if packs is None:
        packs = _LANE_PACKS[arrs] = {}
    return packs


def walk_width(arrs, cfg: EngineConfig) -> int:
    """Words of a thread's window for the device-resource walks (the free
    space and debit of V volume groups, the free and taken flags of E
    devices, the PV of Lw claims), or 0 when every width fits the walks'
    per-thread arrays (MAX_VG, MAX_DEVICES, MAX_WFC_CLAIMS)."""
    v, e, lw = arrs.vg_cap.shape[1], arrs.sdev_cap.shape[1], arrs.wfc_ccid.shape[1]
    if not devres_on(cfg) or (v <= MAX_VG and e <= MAX_DEVICES and lw <= MAX_WFC_CLAIMS):
        return 0
    return 2 * (v + e) + lw


def scratch_bytes(arrs, cfg: EngineConfig, flags: int, plan: LaunchPlan, n_clusters: int,
                  frozen: bool = False) -> int:
    """The global memory a launch of `n_clusters` clusters under `plan`
    takes besides its inputs and outputs: each block's dom_count replica
    and column-read partials where the plan put them there (the frozen
    form reads the lane's dom_count itself), and the walks' windows."""
    k1, _, d = arrs.topo_onehot.shape
    w = smem_widths(arrs, cfg, flags)
    blocks = n_clusters * plan.cluster
    words = ((k1 * d * arrs.match_groups.shape[1] if plan.dom_global and flags & F_DOM
              and not frozen else 0)
             + (2 * (w.q * w.d + 2 * w.q) if plan.cols_global else 0)
             + walk_width(arrs, cfg) * plan.threads)
    return 4 * blocks * words


# a frozen launch whose scratch would pass this runs as launches over
# fewer pods each (its clusters are one per lane and pod)
_SCRATCH_LIMIT = 1 << 30


def _scratch(args: StepArgs, arrs, cfg: EngineConfig, flags: int, plan: LaunchPlan,
             n_clusters: int, dev, frozen: bool = False) -> List[torch.Tensor]:
    """Allocate a launch's scratch (``scratch_bytes``) and point `args` at
    it; returns the tensors, which must outlive the launch."""
    k1, _, d = arrs.topo_onehot.shape
    w = smem_widths(arrs, cfg, flags)
    blocks = n_clusters * plan.cluster
    keep: List[torch.Tensor] = []
    if not plan.wide:
        return keep

    def alloc(words, dtype):
        t = torch.empty((blocks * words,), dtype=dtype, device=dev)
        keep.append(t)
        return t.data_ptr()

    args.dom_spill = (alloc(k1 * d * arrs.match_groups.shape[1], torch.float32)
                      if plan.dom_global and flags & F_DOM and not frozen else None)
    args.col_spill = (alloc(2 * (w.q * w.d + 2 * w.q), torch.int32)
                      if plan.cols_global else None)
    args.walk_w = walk_width(arrs, cfg)
    args.walk = alloc(args.walk_w * plan.threads, torch.int32) if args.walk_w else None
    return keep


def _empty_outputs(arrs, cfg: EngineConfig, n_lanes: int, dev) -> StepOutputs:
    gp_w, vp_w = pick_widths(arrs, cfg)
    k_top, c_parts = scheduler.topk_widths(arrs, cfg)
    empty = torch.empty((n_lanes, 0), dtype=torch.int32, device=dev)
    return StepOutputs(
        empty, no_fail_counts(n_lanes, 0, cfg.n_ops, dev), empty,
        torch.empty((n_lanes, 0, gp_w), dtype=torch.int32, device=dev),
        torch.empty((n_lanes, 0, vp_w), dtype=torch.int32, device=dev),
        torch.empty((n_lanes, 0, k_top), dtype=torch.int32, device=dev),
        torch.empty((n_lanes, 0, k_top), dtype=torch.float32, device=dev),
        torch.empty((n_lanes, 0, c_parts, k_top), dtype=torch.float32, device=dev))


def _launch_args(arrs, active: torch.Tensor, hoist: ActiveHoist, inv_alloc: torch.Tensor,
                 state: SimState, cfg: EngineConfig, p0: int, p1: int,
                 template: Optional[SimState], phase_cycles: Optional[torch.Tensor],
                 disabled: Optional[torch.Tensor], nominated: Optional[torch.Tensor],
                 frozen: bool, static: dict, weights: Optional[torch.Tensor],
                 ext_ok: Optional[torch.Tensor] = None, ext_raw: Optional[torch.Tensor] = None,
                 out: Optional[StepOutputs] = None):
    """A launch's StepArgs without its geometry, and the tensors it points
    at (converted inputs, carry, outputs), which must outlive the launch.
    `static` keeps the converted inputs across launches (``plain_step_cuda``'s
    `inputs`). Given `out` (StepOutputs of [S, P'', ...] buffers whose first
    rows are this launch's pods), the kernel writes there, P'' apart per
    lane (``StepArgs.ls``), instead of into new outputs."""
    dev = active.device
    n, r = arrs.alloc.shape
    n_lanes, n_out = active.shape[0], p1 - p0
    k1, _, d = arrs.topo_onehot.shape
    sg = arrs.match_groups.shape[1]
    pt = arrs.ports.shape[1]
    t_w, t2 = arrs.own_terms.shape[1], arrs.hit_pref.shape[1]
    ops = cfg.n_ops
    g_w, v_w, e_w = arrs.gpu_slot.shape[1], arrs.vg_cap.shape[1], arrs.sdev_cap.shape[1]
    n_pv, lw, lk = arrs.pv_node_ok.shape[0], arrs.wfc_ccid.shape[1], arrs.vol_limit_cap.shape[1]
    nsv = arrs.svol_key.shape[0]
    gp_w, vp_w = pick_widths(arrs, cfg)
    k_top, c_parts = scheduler.topk_widths(arrs, cfg)
    if "tensors" not in static:
        static["tensors"] = _static_inputs(arrs, active, hoist, inv_alloc, cfg)
        static["plans"] = {}
    gc_dt, tb_dt = state.group_count.dtype, state.term_block.dtype
    for name, dt in (("group_count", gc_dt), ("term_block", tb_dt)):
        if dt not in (torch.bfloat16, torch.float32):
            raise ValueError(f"plain_step: {name} dtype {dt}")
    if "ext" not in static:
        rows = extension_rows(cfg)
        static["ext"] = (rows, dict(
            ext_w=torch.tensor([float(e.weight) for e in rows.scores], dtype=torch.float32,
                               device=dev),
            ext_norm=torch.tensor([EXT_NORMALIZE[e.normalize] for e in rows.scores],
                                  dtype=torch.int32, device=dev)) if rows.scores else {})
    rows, ext_meta = static["ext"]
    tensors = dict(
        static["tensors"], **ext_meta,
        headroom=_check("headroom", state.headroom, torch.float32, (n_lanes, n, r)),
        ports_used=_check("ports_used", state.ports_used, torch.bool, (n_lanes, n, pt)),
        dom_count=_check("dom_count", state.dom_count, torch.float32, (n_lanes, k1, d, sg)),
        group_count=_check("group_count", state.group_count, gc_dt, (n_lanes, n, sg)),
        term_block=_check("term_block", state.term_block, tb_dt, (n_lanes, n, t_w)),
        pref_paint=_check("pref_paint", state.pref_paint, torch.float32, (n_lanes, n, t2)),
        gpu_used=_check("gpu_used", state.gpu_used, torch.float32, (n_lanes, n, g_w)),
        vg_used=_check("vg_used", state.vg_used, torch.float32, (n_lanes, n, v_w)),
        sdev_taken=_check("sdev_taken", state.sdev_taken, torch.bool, (n_lanes, n, e_w)),
        pv_taken=_check("pv_taken", state.pv_taken, torch.bool, (n_lanes, n_pv)),
        vol_cnt=_check("vol_cnt", state.vol_cnt, torch.float32, (n_lanes, n, lk)),
        svol_on_node=_check("svol_on_node", state.svol_on_node, torch.bool,
                            (n_lanes, n, nsv)),
        out_node=torch.empty((n_lanes, n_out), dtype=torch.int32, device=dev),
        out_feasible=torch.empty((n_lanes, n_out), dtype=torch.int32, device=dev),
        out_gpu_pick=torch.empty((n_lanes, n_out, gp_w), dtype=torch.int32, device=dev),
        out_vol_pick=torch.empty((n_lanes, n_out, vp_w), dtype=torch.int32, device=dev),
        out_topk_node=torch.empty((n_lanes, n_out, k_top), dtype=torch.int32, device=dev),
        out_topk_score=torch.empty((n_lanes, n_out, k_top), dtype=torch.float32, device=dev),
        out_topk_parts=torch.empty((n_lanes, n_out, c_parts, k_top), dtype=torch.float32,
                                   device=dev),
    )
    if cfg.fail_reasons:
        tensors["out_fail"] = torch.zeros((n_lanes, n_out, ops), dtype=torch.int32, device=dev)
    ls = n_out
    if out is not None:
        ls = out.node.shape[1]
        for name, buf in zip(_OUT_PTRS, out):
            if name == "out_fail" and not cfg.fail_reasons:
                continue
            want = tensors[name]
            if (buf.dtype != want.dtype or buf.device != dev or not buf.is_contiguous()
                    or tuple(buf.shape[2:]) != tuple(want.shape[2:])
                    or buf.shape[:2] != (n_lanes, ls) or ls < n_out):
                raise ValueError(f"plain_step: out {name} is {buf.dtype}{tuple(buf.shape)}, "
                                 f"expected {want.dtype}({n_lanes}, >={n_out}, "
                                 f"{', '.join(map(str, want.shape[2:]))}) contiguous on {dev}")
            tensors[name] = buf
    if ext_ok is not None:
        # (a torch.bool tensor's bytes are the 0/1 the kernel reads as u8)
        tensors["ext_ok"] = ext_ok.contiguous()
    if ext_raw is not None:
        tensors["ext_raw"] = ext_raw.contiguous()
    n_pods = arrs.req.shape[0]
    if disabled is not None:
        tensors["disabled"] = _check("disabled", disabled, torch.bool, (n_pods,))
    if nominated is not None:
        tensors["nominated"] = _check("nominated", nominated, torch.int32, (n_pods,))
    if phase_cycles is not None:
        tensors["cycles"] = _check("phase_cycles", phase_cycles, torch.int64,
                                   (n_lanes, len(PHASES)))
    if weights is not None:
        tensors["w_lane"] = _check("weights", weights, torch.float32,
                                   (n_lanes, len(scheduler.WEIGHT_FIELDS)))
    if template is not None:
        for f in STATE_FIELDS:
            _check(f"template {f}", getattr(template, f), getattr(state, f).dtype,
                   getattr(state, f).shape[1:])
        in_kernel = KERNEL_CARRY if devres_on(cfg) else [f for f in KERNEL_CARRY
                                                         if f not in DEVRES_CARRY]
        copy_template(state, template, [f for f in STATE_FIELDS if f not in in_kernel])
        tensors.update({f"tmpl_{f}": getattr(template, f) for f in in_kernel})
    for name, t in tensors.items():
        if t.device != dev:
            raise ValueError(f"plain_step: {name} is on {t.device}, not {dev}")
    prng = threefry.prng_key(cfg.tie_break_seed)
    args = StepArgs(
        **{f: (tensors[f].data_ptr() if f in tensors else None) for f in _PTRS},
        topk=k_top, n_parts=c_parts, jitter=int(bool(cfg.tie_break_seed)), key0=prng[0],
        key1=prng[1],
        **{f: (tensors[f].data_ptr() if k_top else None)
           for f in ("out_topk_node", "out_topk_score", "out_topk_parts")},
        w_lane=tensors["w_lane"].data_ptr() if "w_lane" in tensors else None,
        n=n, r=r, c=arrs.class_affinity.shape[0], u=arrs.spec_alloc.shape[0],
        k=arrs.has_key.shape[0], k1=k1, d=d, sg=sg, pt=pt, cs=arrs.spread_group.shape[1],
        a=arrs.aff_group.shape[1], b=arrs.anti_group.shape[1], ap=arrs.pref_group.shape[1],
        t=t_w, t2=t2, ops=ops, s=n_lanes, p0=p0, p1=p1,
        ci=cfg.cpu_mem_idx[0], mi=cfg.cpu_mem_idx[1],
        flags=_flags(cfg, state, template is not None),
        g=g_w, v=v_w, e=e_w, lv=arrs.lvm_req.shape[1], ev=arrs.sdev_req.shape[1], npv=n_pv,
        lw=lw, lk=lk, lsv=arrs.svol_id.shape[1], nsv=nsv,
        w_bal=cfg.w_balanced, w_least=cfg.w_least, w_most=cfg.w_most,
        w_na=cfg.w_node_aff, w_tt=cfg.w_taint, w_ip=cfg.w_interpod, w_sp=cfg.w_spread,
        w_si=cfg.w_simon, w_gpu=cfg.w_gpu,
        cycles=tensors["cycles"].data_ptr() if "cycles" in tensors else None,
        frozen=int(frozen),
        **{f: (tensors[f].data_ptr() if f in tensors else None)
           for f in ("ext_ok", "ext_raw", "ext_w", "ext_norm")},
        ef=len(rows.filters), es=len(rows.scores), ered=rows.ered, ls=ls,
        pod_pack=tensors["pod_pack"].data_ptr(), hit_w=hit_width(arrs, cfg))
    return args, tensors


def _outputs(tensors: dict, cfg: EngineConfig, n_lanes: int, n_out: int, dev) -> StepOutputs:
    fail = (tensors["out_fail"] if cfg.fail_reasons
            else no_fail_counts(n_lanes, n_out, cfg.n_ops, dev))
    return StepOutputs(tensors["out_node"], fail, tensors["out_feasible"],
                       tensors["out_gpu_pick"], tensors["out_vol_pick"],
                       tensors["out_topk_node"], tensors["out_topk_score"],
                       tensors["out_topk_parts"])


def _fire(lib: ctypes.CDLL, args: StepArgs, plan: LaunchPlan, dev, what: str) -> None:
    """Launch `args` (geometry set) on the current stream; raises on a
    refused launch."""
    if lib.plain_step_smem(ctypes.byref(args)) != plan.smem:
        raise RuntimeError(f"{what}: smem_bytes and the kernel's layout_of disagree")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.plain_step_launch(ctypes.byref(args), ctypes.c_void_p(stream))
    if err:
        raise RuntimeError(f"{what} launch failed: CUDA error {err} ({plan})")


def plain_step_cuda(arrs, active: torch.Tensor, hoist: ActiveHoist,
                    inv_alloc: torch.Tensor, state: SimState, cfg: EngineConfig,
                    p0: int, p1: int, template: Optional[SimState] = None,
                    phase_cycles: Optional[torch.Tensor] = None,
                    disabled: Optional[torch.Tensor] = None,
                    nominated: Optional[torch.Tensor] = None, frozen: bool = False,
                    inputs: Optional[dict] = None,
                    weights: Optional[torch.Tensor] = None,
                    ext_ok: Optional[torch.Tensor] = None,
                    ext_raw: Optional[torch.Tensor] = None) -> StepOutputs:
    """Launch the ``plain_step`` kernel: one thread-block cluster per lane
    (``plan_launch``), the pod loop inside the kernel, the carry updated in
    place on the current stream (with a `template`, first written from it
    by the lane prologue); frozen, one cluster per (lane, pod) and the
    carry only read. Given `phase_cycles`, an [S, len(PHASES)] int64
    tensor on the card, the kernel writes each lane's cycles per phase
    into it. `disabled` and `nominated` go to the kernel as pointers (null
    when None). `inputs`, a dict the caller keeps across launches over the
    same arrays, lanes and config, holds the converted inputs and the
    launch plans after the first call. `weights` ([S, K] f32, under the
    traced weights only) goes to the kernel as ``w_lane``, and the
    extension rows `ext_ok` / `ext_raw` (under ``cfg.extensions`` only) as
    theirs. Regions the
    plan puts in global memory, and the device-resource walks past their
    per-thread widths, get scratch of their own (``scratch_bytes``)."""
    global LAST_PLAN
    if frozen:
        _check_frozen(template, disabled, nominated, phase_cycles, cfg)
    dev = active.device
    n_lanes, n_out = active.shape[0], p1 - p0
    check_weights(cfg, weights, n_lanes)
    check_extension_rows(cfg, ext_ok, ext_raw, n_lanes, max(n_out, 0), arrs.alloc.shape[0])
    flags = _flags(cfg, state, template is not None)
    plan_for(arrs, cfg, flags, n_lanes, lambda *_: n_lanes)  # raises where nothing fits
    if n_out <= 0:
        if template is not None:
            copy_template(state, template)
        return _empty_outputs(arrs, cfg, n_lanes, dev)
    static = inputs if inputs is not None else {}
    args, tensors = _launch_args(arrs, active, hoist, inv_alloc, state, cfg, p0, p1, template,
                                 phase_cycles, disabled, nominated, frozen, static, weights,
                                 ext_ok, ext_raw)
    explain = explain_on(cfg)
    lib = _library(explain, needs_wide(arrs, cfg, flags))
    n_clusters = n_lanes * n_out if frozen else n_lanes
    with torch.cuda.device(dev):
        key = (flags, n_clusters, frozen)
        plan = static["plans"].get(key)
        if plan is None:
            plan = plan_for(arrs, cfg, flags, n_clusters, _card_occupancy(lib, args),
                            one_pod=frozen, frozen=frozen)
            static["plans"][key] = plan
    if (frozen and n_out > 1
            and scratch_bytes(arrs, cfg, flags, plan, n_clusters, True) > _SCRATCH_LIMIT):
        # one cluster per (lane, pod): half the pods, half the scratch
        mid = p0 + n_out // 2
        halves = [plain_step_cuda(arrs, active, hoist, inv_alloc, state, cfg, lo, hi,
                                  frozen=True, inputs=static, weights=weights)
                  for lo, hi in ((p0, mid), (mid, p1))]
        return StepOutputs(*(torch.cat(pair, 1) for pair in zip(*halves)))
    _set_geometry(args, plan)
    keep = _scratch(args, arrs, cfg, flags, plan, n_clusters, dev, frozen)
    _stage_sources(args, arrs, plan, static)
    _fire(lib, args, plan, dev, "plain_step")
    del keep  # freed in stream order: the next use of the memory follows the launch
    _count(plan, explain, frozen, weights is not None, bool(cfg.extensions))
    LAST_PLAN = plan
    return _outputs(tensors, cfg, n_lanes, n_out, dev)


def _count(plan: LaunchPlan, explain: bool, frozen: bool, weights: bool, ext: bool) -> None:
    """Count one launch of the scan or frozen builds in LAUNCHES."""
    LAUNCHES[("plain_step_frozen" if frozen else "plain_step")
             + ("_explain" if explain else "")] += 1
    if weights:
        LAUNCHES["plain_step_weights"] += 1
    if plan.wide:
        LAUNCHES["plain_step_wide"] += 1
    if ext:
        LAUNCHES["plain_step_ext"] += 1


# the StepArgs output pointers, in StepOutputs order
_OUT_PTRS = ("out_node", "out_fail", "out_feasible", "out_gpu_pick", "out_vol_pick",
             "out_topk_node", "out_topk_score", "out_topk_parts")


def pod_launcher(arrs, active: torch.Tensor, hoist: ActiveHoist, inv_alloc: torch.Tensor,
                 state: SimState, cfg: EngineConfig, out: StepOutputs, p_base: int,
                 disabled: Optional[torch.Tensor] = None,
                 nominated: Optional[torch.Tensor] = None,
                 weights: Optional[torch.Tensor] = None, inputs: Optional[dict] = None,
                 plain: bool = False) -> Callable[..., None]:
    """The step one pod at a time over the lanes of `state` (the carry,
    updated in place, read by the extension callables between launches):
    returns ``launch(p, ext_ok, ext_raw)``, which runs pod p with its
    [S, 1, Ef, N] / [S, 1, Es, N] extension rows (None where the config
    registers no extension of the kind) and writes its outputs into row
    ``p - p_base`` of `out`, StepOutputs of [S, P'', ...] buffers. On the
    card the StepArgs are built at the first pod and patched for each
    later one (the pod, the rows, the output offsets), one kernel launch a
    pod on the current stream; on the CPU, or with ``plain=True`` (the
    yardstick on the card), the plain step."""
    dev = active.device
    n_lanes = active.shape[0]
    if plain or dev.type == "cpu":
        def launch_plain(p: int, ext_ok=None, ext_raw=None) -> None:
            got = plain_step_torch(arrs, active, hoist, inv_alloc, state, cfg, p, p + 1,
                                   disabled=disabled, nominated=nominated, weights=weights,
                                   ext_ok=ext_ok, ext_raw=ext_raw)
            row = p - p_base
            for i, (dst, src) in enumerate(zip(out, got)):
                if i != 1 or cfg.fail_reasons:
                    dst[:, row:row + 1] = src
        return launch_plain
    if dev.type != "cuda":
        raise ValueError(f"no plain_step for device {dev}")
    check_weights(cfg, weights, n_lanes)
    flags = _flags(cfg, state, False)
    plan_for(arrs, cfg, flags, n_lanes, lambda *_: n_lanes)  # raises where nothing fits
    static = inputs if inputs is not None else {}
    explain = explain_on(cfg)
    lib = _library(explain, needs_wide(arrs, cfg, flags))
    words = [math.prod(t.shape[2:]) for t in out]  # 4-byte words of a pod's row
    built: Dict[str, object] = {}

    def launch(p: int, ext_ok=None, ext_raw=None) -> None:
        global LAST_PLAN
        check_extension_rows(cfg, ext_ok, ext_raw, n_lanes, 1, arrs.alloc.shape[0])
        ok = None if ext_ok is None else ext_ok.contiguous()
        raw = None if ext_raw is None else ext_raw.contiguous()
        if not built:
            args, tensors = _launch_args(arrs, active, hoist, inv_alloc, state, cfg, p, p + 1,
                                         None, None, disabled, nominated, False, static,
                                         weights, ok, raw, out=out)
            with torch.cuda.device(dev):
                key = (flags, n_lanes, "one pod")
                plan = static["plans"].get(key)
                if plan is None:
                    plan = plan_for(arrs, cfg, flags, n_lanes, _card_occupancy(lib, args),
                                    one_pod=True)
                    static["plans"][key] = plan
                stream = torch.cuda.current_stream(dev).cuda_stream
            _set_geometry(args, plan)
            built.update(args=args, tensors=tensors, plan=plan, stream=stream,
                         keep=_scratch(args, arrs, cfg, flags, plan, n_lanes, dev),
                         base={f: getattr(args, f) for f in _OUT_PTRS})
            if lib.plain_step_smem(ctypes.byref(args)) != plan.smem:
                raise RuntimeError("plain_step: smem_bytes and the kernel's layout_of disagree")
        args, plan = built["args"], built["plan"]
        row = p - p_base
        args.p0, args.p1 = p, p + 1
        for f, w in zip(_OUT_PTRS, words):
            b = built["base"][f]
            setattr(args, f, None if b is None else b + 4 * w * row)
        args.ext_ok = None if ok is None else ok.data_ptr()
        args.ext_raw = None if raw is None else raw.data_ptr()
        err = lib.plain_step_launch(ctypes.byref(args), ctypes.c_void_p(built["stream"]))
        if err:
            raise RuntimeError(f"plain_step launch failed: CUDA error {err} ({plan})")
        # (ok and raw are freed in stream order: their memory's next use
        # follows this launch)
        _count(plan, explain, False, weights is not None, bool(cfg.extensions))
        LAST_PLAN = plan
    return launch


# ---- the fleet form: one cluster per lane, each lane its own cluster ------


class FleetLane(NamedTuple):
    """One lane of a fleet launch: its own cluster's arrays (tensors on the
    step's device), its [1, N] active mask, its ActiveHoist and inverse
    allocatable, its [1, ...] carry (written from `template` by the lane
    prologue) and its template carry."""
    arrs: object
    active: torch.Tensor
    hoist: ActiveHoist
    inv_alloc: torch.Tensor
    state: SimState
    template: SimState


def _check_fleet(lanes: List[FleetLane]) -> None:
    from open_simulator_tpu_torch.engine.exec_cache import _shape_sig

    if not lanes:
        raise ValueError("plain_step_fleet: no lanes")
    sig = _shape_sig(lanes[0].arrs)
    for ln in lanes:
        if _shape_sig(ln.arrs) != sig:
            raise ValueError("plain_step_fleet: lanes need shape-identical snapshots; group "
                             "by the full shape signature first")
        if ln.active.shape[0] != 1:
            raise ValueError("plain_step_fleet: each lane takes one [1, N] active mask")


def plain_step_fleet(lanes: List[FleetLane], cfg: EngineConfig, p0: int,
                     p1: int) -> List[StepOutputs]:
    """The scan over pods [p0, p1) of every lane of a fleet, each lane its
    own cluster from its own template: the fleet kernel for CUDA tensors,
    the plain torch step lane by lane for CPU tensors. One StepOutputs per
    lane ([1, P', ...])."""
    _check_fleet(lanes)
    dev = lanes[0].active.device
    if dev.type == "cuda":
        return plain_step_fleet_cuda(lanes, cfg, p0, p1)
    if dev.type == "cpu":
        return plain_step_fleet_torch(lanes, cfg, p0, p1)
    raise ValueError(f"no plain_step_fleet for device {dev}")


def plain_step_fleet_torch(lanes: List[FleetLane], cfg: EngineConfig, p0: int,
                           p1: int) -> List[StepOutputs]:
    """The plain version: the one-lane plain step over each lane's own
    arrays, in turn."""
    _check_fleet(lanes)
    return [plain_step_torch(ln.arrs, ln.active, ln.hoist, ln.inv_alloc, ln.state, cfg, p0, p1,
                             template=ln.template) for ln in lanes]


def plain_step_fleet_cuda(lanes: List[FleetLane], cfg: EngineConfig, p0: int,
                          p1: int) -> List[StepOutputs]:
    """Launch the fleet form of ``plain_step``: one thread-block cluster
    per lane, each lane's StepArgs the one a one-lane ``plain_step_cuda``
    of that cluster alone would build, copied to the card as one array
    the kernel indexes by lane. The lanes share the launch geometry
    (``plan_launch`` over S lanes), the flags and the shape signature;
    the scan only (no columns, not frozen, no weight row)."""
    global LAST_PLAN
    _check_fleet(lanes)
    if cfg.traced_weights:
        raise ValueError("plain_step_fleet: the fleet runs the config's own weights")
    if cfg.extensions:
        raise ValueError("plain_step_fleet: extension rows run one pod at a time "
                         "(engine.exec_cache.run_fleet_batched runs each lane alone)")
    dev = lanes[0].active.device
    n_lanes, n_out = len(lanes), p1 - p0
    arrs0 = lanes[0].arrs
    flags = _flags(cfg, lanes[0].state, True)
    plan_for(arrs0, cfg, flags, n_lanes, lambda *_: n_lanes, True)  # raises where nothing fits
    if n_out <= 0:
        out = []
        for ln in lanes:
            copy_template(ln.state, ln.template)
            out.append(_empty_outputs(ln.arrs, cfg, 1, dev))
        return out
    built = [_launch_args(ln.arrs, ln.active, ln.hoist, ln.inv_alloc, ln.state, cfg, p0, p1,
                          ln.template, None, None, None, False, {}, None) for ln in lanes]
    if any(args.flags != flags for args, _ in built):
        raise ValueError("plain_step_fleet: the lanes' carries differ in their flags")
    explain = explain_on(cfg)
    lib = _library(explain, needs_wide(arrs0, cfg, flags))
    head = StepArgs.from_buffer_copy(built[0][0])
    head.s, head.fleet = n_lanes, 1
    with torch.cuda.device(dev):
        plan = plan_for(arrs0, cfg, flags, n_lanes, _card_occupancy(lib, head), True)
    _set_geometry(head, plan)
    keep = _scratch(head, arrs0, cfg, flags, plan, n_lanes, dev)
    blob = bytearray()
    for (args, _), ln in zip(built, lanes):
        args.fleet = 1
        _set_geometry(args, plan)
        keep.append(_stage_sources(args, ln.arrs, plan, lane_packs(ln.arrs)))
        args.walk, args.walk_w = head.walk, head.walk_w
        args.dom_spill, args.col_spill = head.dom_spill, head.col_spill
        blob += bytes(args)
    lanes_dev = torch.frombuffer(blob, dtype=torch.uint8).to(dev)
    head.lanes = lanes_dev.data_ptr()
    head.cls_pack = built[0][0].cls_pack
    _fire(lib, head, plan, dev, "plain_step_fleet")
    del keep, lanes_dev  # freed in stream order, after the launch
    LAUNCHES["plain_step_fleet" + ("_explain" if explain else "")] += 1
    if plan.wide:
        LAUNCHES["plain_step_wide"] += 1
    LAST_PLAN = plan
    return [_outputs(tensors, cfg, 1, n_out, dev) for _, tensors in built]
