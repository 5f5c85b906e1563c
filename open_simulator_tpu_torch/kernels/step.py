"""The scheduling step over a pod range, for S lanes: the ``plain_step``
CUDA kernel (``csrc/plain_step.cu``), its plain torch twin, and the
dispatch between them.

All three take the same arguments::

    (arrs, active [S, N] bool, hoist (a lane-batched ActiveHoist),
     inv_alloc [N, R] f32, state (a lane-batched SimState, updated in
     place), cfg, p0, p1, template=None)

and return ``(node [S, P'] i32, fail_counts [S, P', OPS] i32,
feasible [S, P'] i32, gpu_pick [S, P', G] i32, vol_pick [S, P', Lw] i32)``
for the pods ``p0 <= p < p1`` (P' = p1 - p0); the picks have width 0
when their gate (``enable_gpu``, ``enable_pv_match``) is off.
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

``plain_step`` launches the kernel for CUDA tensors and runs the plain
torch step only for CPU tensors; it never falls back from one to the
other. ``LAUNCHES["plain_step"]`` counts the kernel's launches.

The kernel runs each lane on a thread-block cluster: ``plan_launch``
picks the cluster size, the block size and each block's node slice from
the lane count, the node count and the card's occupancy answer, and
``smem_bytes`` is the per-block shared-memory accounting it checks.
``LAST_PLAN`` holds the geometry of the latest launch.
"""

from __future__ import annotations

import ctypes
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
from open_simulator_tpu_torch.ops.domains import ActiveHoist

LAUNCHES: Dict[str, int] = {"plain_step": 0}
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
RES_HEADROOM = 1

_PTRS = ("inv_alloc", "unschedulable", "class_affinity", "class_taint",
         "class_node_aff_score", "class_taint_prefer", "spec_id", "spec_alloc",
         "node_dom", "has_key", "term_key", "req", "class_id", "forced_node", "ports",
         "match_groups", "spread_group", "spread_key", "spread_skew",
         "spread_soft", "spread_hard", "aff_group", "aff_key", "aff_valid", "aff_self",
         "anti_group", "anti_key", "anti_valid", "hit_ptr", "hit_idx", "own_ptr",
         "own_idx", "pref_group", "pref_key", "pref_weight", "pref_valid", "pref_tid",
         "hit_pref", "active", "log_dom", "elig_host", "domain_has", "any_elig",
         "headroom", "ports_used", "dom_count", "group_count", "term_block",
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
# the .cu)
MAX_VG, MAX_DEVICES, MAX_WFC_CLAIMS = 8, 32, 8

# a block's dynamic shared memory budget (227 KB per block on Hopper, less
# the static reduction buffers; what is left over serves as L1)
_SMEM_LIMIT = 200 * 1024
# the launch geometry's bounds (kMaxThreads, kMaxThreadsDevRes, kMaxCluster
# in the .cu): block sizes under which each instantiation stays in
# registers, and cluster sizes (over 8 blocks is non-portable, and the card
# may refuse it)
MAX_THREADS, MAX_THREADS_DEVRES = 512, 384
CLUSTER_SIZES = (16, 8, 4, 2, 1)


class SmemWidths(NamedTuple):
    """The widths a block's shared memory grows with (kernel: layout_of)."""
    ops: int    # first-fail histogram rows
    q: int      # the pod's carry columns (A + B + Cs + Ap)
    d: int      # domains per key
    cs: int     # spread constraints
    dom: int    # K1 * D * Sg, the dom_count replica (0 off the dom_count path)
    rows: int   # raw-score rows: 3, + interpod, + GPU
    r: int      # resources (the headroom row)
    npv: int    # the pv_taken replica (0 without PV matching)


def smem_bytes(w: SmemWidths, slice_len: int, headroom: bool) -> int:
    """A block's dynamic shared memory for these widths and a slice of
    `slice_len` nodes, its headroom rows in shared memory or not (mirrors
    layout_of in the .cu): the histogram and column-read partials twice
    (by pod parity), the merged column read, the column needs, the
    hard-spread minima, the dom_count replica, the slice's raw scores (and
    headroom) as 4-byte words, then its flags and the pv_taken replica as
    bytes."""
    qd = w.q * w.d + 2 * w.q
    words = (2 * w.ops + 3 * qd + w.q + w.cs + w.dom + w.rows * slice_len
             + (slice_len * w.r if headroom else 0))
    return 4 * words + slice_len + w.npv


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


def max_threads(flags: int) -> int:
    """The block size cap of the instantiation these flags launch."""
    return MAX_THREADS_DEVRES if flags & DEVRES_FLAGS else MAX_THREADS


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
                occupancy: Callable[[int, int, int, bool], int],
                cap: int = MAX_THREADS) -> LaunchPlan:
    """The launch geometry: the largest cluster size C in CLUSTER_SIZES
    whose block fits its shared memory and whose `n_lanes` clusters the card
    holds at once (`occupancy(C, threads, slice_len, headroom)`, the card's
    cudaOccupancyMaxActiveClusters, 0 where it cannot place one); where no
    size holds every lane at once, the smallest size that fits (its lanes
    run in waves). Blocks have at most `cap` threads (``max_threads``).
    The headroom rows go to shared memory where they fit. Raises
    ValueError when no cluster size fits."""
    fits = []
    for c in CLUSTER_SIZES:
        sl, threads = block_geometry(n_nodes, c, cap)
        for hr in (True, False):
            smem = smem_bytes(w, sl, hr)
            if smem <= _SMEM_LIMIT:
                break
        else:
            continue  # this size's slices do not fit
        plan = LaunchPlan(c, threads, sl, hr, smem, occupancy(c, threads, sl, hr))
        if plan.resident >= n_lanes:
            return plan
        fits.append(plan)
    if not fits:
        sl = block_geometry(n_nodes, CLUSTER_SIZES[0])[0]
        need = smem_bytes(w, sl, False)
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
                + [(f, ctypes.c_int) for f in ("cl", "bt", "sl", "res")])


Outputs = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def pick_widths(arrs, cfg: EngineConfig) -> Tuple[int, int]:
    """(G, Lw) of the gpu_pick / vol_pick outputs: 0 for a gated-off op,
    so a launch carries no dead buffer."""
    return (arrs.gpu_slot.shape[1] if cfg.enable_gpu else 0,
            arrs.wfc_ccid.shape[1] if cfg.enable_pv_match else 0)


def plain_step(arrs, active: torch.Tensor, hoist: ActiveHoist,
               inv_alloc: torch.Tensor, state: SimState, cfg: EngineConfig,
               p0: int, p1: int, template: Optional[SimState] = None) -> Outputs:
    """The step over pods [p0, p1): the CUDA kernel for CUDA tensors, the
    plain torch step for CPU tensors."""
    if active.device.type == "cuda":
        return plain_step_cuda(arrs, active, hoist, inv_alloc, state, cfg, p0, p1, template)
    if active.device.type == "cpu":
        return plain_step_torch(arrs, active, hoist, inv_alloc, state, cfg, p0, p1, template)
    raise ValueError(f"no plain_step for device {active.device}")


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
                     p0: int, p1: int, template: Optional[SimState] = None) -> Outputs:
    """The plain version: lane by lane, pod by pod through the torch twin
    of the reference step (``engine.scheduler._step``), on any device."""
    scheduler.check_supported(cfg)
    dev = active.device
    n_lanes, n_out = active.shape[0], p1 - p0
    if template is not None:
        copy_template(state, template)
    host = {f: getattr(arrs, f).cpu().numpy() for f in STEP_HOST_FIELDS}
    node = torch.empty((n_lanes, n_out), dtype=torch.int32, device=dev)
    fail = (torch.zeros((n_lanes, n_out, cfg.n_ops), dtype=torch.int32, device=dev)
            if cfg.fail_reasons else no_fail_counts(n_lanes, n_out, cfg.n_ops, dev))
    feas = torch.empty((n_lanes, n_out), dtype=torch.int32, device=dev)
    g_w, lw = pick_widths(arrs, cfg)
    gpick = torch.empty((n_lanes, n_out, g_w), dtype=torch.int32, device=dev)
    vpick = torch.empty((n_lanes, n_out, lw), dtype=torch.int32, device=dev)
    for s in range(n_lanes):
        st = SimState(**{f: getattr(state, f)[s] for f in STATE_FIELDS})
        lane_hoist = ActiveHoist(*(x[s] for x in hoist))
        rows = []
        for p in range(p0, p1):
            st, out = scheduler._step(arrs, host, active[s], cfg, lane_hoist, inv_alloc, st, p)
            rows.append(out)
        if n_out:
            nodes, fails, feasible, gpus, vols = zip(*rows)
            node[s] = torch.stack(nodes)
            feas[s] = torch.stack(feasible)
            gpick[s] = torch.stack(gpus)
            vpick[s] = torch.stack(vols)
            if cfg.fail_reasons:
                fail[s] = torch.stack(fails)
        for f in STATE_FIELDS:
            getattr(state, f)[s].copy_(getattr(st, f))
    return node, fail, feas, gpick, vpick


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
    fl |= F_BAL if cfg.w_balanced else 0
    fl |= F_LEAST if cfg.w_least else 0
    fl |= F_MOST if cfg.w_most else 0
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


def _check(name: str, t: torch.Tensor, dtype, shape) -> torch.Tensor:
    if t.device.type != "cuda":
        raise ValueError(f"plain_step: {name} is on {t.device}, not on the card")
    if t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise ValueError(f"plain_step: {name} is {t.dtype}{tuple(t.shape)}, "
                         f"expected {dtype}{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"plain_step: {name} is not contiguous")
    return t


def _check_index(name: str, t: torch.Tensor, bound: int) -> None:
    """The kernel indexes with these without bounds checks."""
    if t.numel() and int(t.max()) >= bound:
        raise ValueError(f"plain_step: {name} holds {int(t.max())}, past its bound {bound}")


def smem_widths(arrs, cfg: EngineConfig, flags: int) -> SmemWidths:
    """The widths of a launch's shared memory under its StepArgs flags."""
    k1, _, d = arrs.topo_onehot.shape
    return SmemWidths(
        ops=cfg.n_ops,
        q=sum(getattr(arrs, f).shape[1] for f in ("aff_group", "anti_group", "spread_group",
                                                  "pref_group")),
        d=d, cs=arrs.spread_group.shape[1],
        dom=k1 * d * arrs.match_groups.shape[1] if flags & F_DOM else 0,
        rows=3 + bool(flags & INTERPOD_FLAGS) + bool(flags & DEVRES_FLAGS),
        r=arrs.alloc.shape[1],
        npv=arrs.pv_node_ok.shape[0] if flags & DEVRES_FLAGS and flags & F_PV_MATCH else 0)


def plan_for(arrs, cfg: EngineConfig, flags: int, n_lanes: int,
             occupancy: Callable[[int, int, int, bool], int]) -> LaunchPlan:
    """``plan_launch`` for a launch of these arrays under these flags."""
    return plan_launch(n_lanes, arrs.alloc.shape[0], smem_widths(arrs, cfg, flags), occupancy,
                       max_threads(flags))


def _library() -> ctypes.CDLL:
    lib = build.load("plain_step")
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
    args.res = RES_HEADROOM if plan.headroom else 0


def _card_occupancy(lib: ctypes.CDLL, args: StepArgs):
    """plan_launch's occupancy answer on the current card."""
    def occupancy(cluster: int, threads: int, slice_len: int, headroom: bool) -> int:
        _set_geometry(args, LaunchPlan(cluster, threads, slice_len, headroom, 0, 0))
        n = ctypes.c_int(0)
        err = lib.plain_step_clusters(ctypes.byref(args), ctypes.byref(n))
        if err:
            raise RuntimeError(f"plain_step occupancy query failed: CUDA error {err}")
        return n.value
    return occupancy


def plain_step_cuda(arrs, active: torch.Tensor, hoist: ActiveHoist,
                    inv_alloc: torch.Tensor, state: SimState, cfg: EngineConfig,
                    p0: int, p1: int, template: Optional[SimState] = None,
                    phase_cycles: Optional[torch.Tensor] = None) -> Outputs:
    """Launch the ``plain_step`` kernel: one thread-block cluster per lane
    (``plan_launch``), the pod loop inside the kernel, the carry updated in
    place on the current stream (with a `template`, first written from it
    by the lane prologue). Given `phase_cycles`, an [S, len(PHASES)] int64
    tensor on the card, the kernel writes each lane's cycles per phase
    into it."""
    global LAST_PLAN
    scheduler.check_supported(cfg)
    dev = active.device
    n, r = arrs.alloc.shape
    n_lanes, n_out = active.shape[0], p1 - p0
    k1, _, d = arrs.topo_onehot.shape
    n_cls = arrs.class_affinity.shape[0]
    sg = arrs.match_groups.shape[1]
    pt = arrs.ports.shape[1]
    cs = arrs.spread_group.shape[1]
    a_w, b_w, ap = arrs.aff_group.shape[1], arrs.anti_group.shape[1], arrs.pref_group.shape[1]
    t_w, t2 = arrs.own_terms.shape[1], arrs.hit_pref.shape[1]
    k = arrs.has_key.shape[0]
    ops = cfg.n_ops
    q = a_w + b_w + cs + ap
    g_w, v_w, e_w = arrs.gpu_slot.shape[1], arrs.vg_cap.shape[1], arrs.sdev_cap.shape[1]
    n_pv, lw, lk = arrs.pv_node_ok.shape[0], arrs.wfc_ccid.shape[1], arrs.vol_limit_cap.shape[1]
    lsv, nsv = arrs.svol_id.shape[1], arrs.svol_key.shape[0]
    gp_w, vp_w = pick_widths(arrs, cfg)
    devres = devres_on(cfg)
    flags = _flags(cfg, state, template is not None)
    plan_for(arrs, cfg, flags, n_lanes, lambda *_: n_lanes)  # raises where nothing fits
    for what, width, cap in (("volume groups per node", v_w, MAX_VG),
                             ("exclusive devices per node", e_w, MAX_DEVICES),
                             ("WaitForFirstConsumer claims per pod", lw, MAX_WFC_CLAIMS)):
        if devres and width > cap:
            raise ValueError(f"plain_step: {width} {what}, over the kernel's {cap}")
    if n_out <= 0:
        if template is not None:
            copy_template(state, template)
        empty = torch.empty((n_lanes, 0), dtype=torch.int32, device=dev)
        return (empty, no_fail_counts(n_lanes, 0, ops, dev), empty,
                torch.empty((n_lanes, 0, gp_w), dtype=torch.int32, device=dev),
                torch.empty((n_lanes, 0, vp_w), dtype=torch.int32, device=dev))
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

    gc_dt, tb_dt = state.group_count.dtype, state.term_block.dtype
    for name, dt in (("group_count", gc_dt), ("term_block", tb_dt)):
        if dt not in (torch.bfloat16, torch.float32):
            raise ValueError(f"plain_step: {name} dtype {dt}")
    hit_ptr, hit_idx = term_lists(arrs.hit_terms)
    own_ptr, own_idx = term_lists(arrs.own_terms)
    pv_ptr, pv_idx = admitted_pv_lists(arrs.pv_node_ok, arrs.pv_cand)
    tensors = dict(
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
    )
    if cfg.fail_reasons:
        tensors["out_fail"] = torch.zeros((n_lanes, n_out, ops), dtype=torch.int32, device=dev)
    if phase_cycles is not None:
        tensors["cycles"] = _check("phase_cycles", phase_cycles, torch.int64,
                                   (n_lanes, len(PHASES)))
    if template is not None:
        for f in STATE_FIELDS:
            _check(f"template {f}", getattr(template, f), getattr(state, f).dtype,
                   getattr(state, f).shape[1:])
        in_kernel = KERNEL_CARRY if devres else [f for f in KERNEL_CARRY
                                                 if f not in DEVRES_CARRY]
        copy_template(state, template, [f for f in STATE_FIELDS if f not in in_kernel])
        tensors.update({f"tmpl_{f}": getattr(template, f) for f in in_kernel})
    for name, t in tensors.items():
        if t.device != dev:
            raise ValueError(f"plain_step: {name} is on {t.device}, not {dev}")
    args = StepArgs(
        **{f: (tensors[f].data_ptr() if f in tensors else None) for f in _PTRS},
        n=n, r=r, c=n_cls, u=arrs.spec_alloc.shape[0], k=k, k1=k1, d=d, sg=sg, pt=pt,
        cs=cs, a=a_w, b=b_w, ap=ap, t=t_w, t2=t2, ops=ops, s=n_lanes, p0=p0, p1=p1,
        ci=cfg.cpu_mem_idx[0], mi=cfg.cpu_mem_idx[1],
        flags=flags,
        g=g_w, v=v_w, e=e_w, lv=arrs.lvm_req.shape[1], ev=arrs.sdev_req.shape[1], npv=n_pv,
        lw=lw, lk=lk, lsv=lsv, nsv=nsv,
        w_bal=cfg.w_balanced, w_least=cfg.w_least, w_most=cfg.w_most,
        w_na=cfg.w_node_aff, w_tt=cfg.w_taint, w_ip=cfg.w_interpod, w_sp=cfg.w_spread,
        w_si=cfg.w_simon, w_gpu=cfg.w_gpu,
        cycles=tensors["cycles"].data_ptr() if "cycles" in tensors else None)
    lib = _library()
    with torch.cuda.device(dev):
        plan = plan_for(arrs, cfg, flags, n_lanes, _card_occupancy(lib, args))
        _set_geometry(args, plan)
        if lib.plain_step_smem(ctypes.byref(args)) != plan.smem:
            raise RuntimeError("plain_step: smem_bytes and the kernel's layout_of disagree")
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.plain_step_launch(ctypes.byref(args), ctypes.c_void_p(stream))
    if err:
        raise RuntimeError(f"plain_step launch failed: CUDA error {err} ({plan})")
    LAUNCHES["plain_step"] += 1
    LAST_PLAN = plan
    fail = tensors["out_fail"] if cfg.fail_reasons else no_fail_counts(n_lanes, n_out, ops, dev)
    return (tensors["out_node"], fail, tensors["out_feasible"], tensors["out_gpu_pick"],
            tensors["out_vol_pick"])
