"""The scheduling step over a pod range, for S lanes: the ``plain_step``
CUDA kernel (``csrc/plain_step.cu``), its plain torch twin, and the
dispatch between them.

All three take the same arguments::

    (arrs, active [S, N] bool, hoist (a lane-batched ActiveHoist),
     inv_alloc [N, R] f32, state (a lane-batched SimState, updated in
     place), cfg, p0, p1)

and return ``(node [S, P'] i32, fail_counts [S, P', OPS] i32,
feasible [S, P'] i32)`` for the pods ``p0 <= p < p1`` (P' = p1 - p0).
``arrs`` is the snapshot as tensors on the step's device
(``engine.scheduler.device_arrays``); ``hoist`` is
``engine.scheduler.hoist_of(arrs, active)``.

``plain_step`` launches the kernel for CUDA tensors and runs the plain
torch step only for CPU tensors; it never falls back from one to the
other. ``LAUNCHES["plain_step"]`` counts the kernel's launches.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

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

# StepArgs.flags bits (csrc/plain_step.cu)
F_UNSCHED, F_CLASS_AFF, F_CLASS_TAINT, F_PORTS, F_FAIL = 1, 2, 4, 8, 16
F_NA, F_TT, F_SP, F_SI = 32, 64, 128, 256
F_BAL, F_LEAST, F_MOST = 512, 1024, 2048
F_GC, F_DOM, F_GC_BF16 = 4096, 8192, 16384
F_AFF, F_ANTI, F_SPH, F_IP, F_PREF, F_TB_BF16 = 1 << 15, 1 << 16, 1 << 17, 1 << 18, 1 << 19, 1 << 20

_PTRS = ("inv_alloc", "unschedulable", "class_affinity", "class_taint",
         "class_node_aff_score", "class_taint_prefer", "spec_id", "spec_alloc",
         "node_dom", "has_key", "term_key", "req", "class_id", "forced_node", "ports",
         "match_groups", "spread_group", "spread_key", "spread_skew",
         "spread_soft", "spread_hard", "aff_group", "aff_key", "aff_valid", "aff_self",
         "anti_group", "anti_key", "anti_valid", "hit_ptr", "hit_idx", "own_ptr",
         "own_idx", "pref_group", "pref_key", "pref_weight", "pref_valid", "pref_tid",
         "hit_pref", "active", "log_dom", "elig_host", "domain_has", "any_elig",
         "headroom", "ports_used", "dom_count", "group_count", "term_block",
         "pref_paint", "out_node", "out_fail", "out_feasible", "scratch", "scratch_flags")
_INTS = ("n", "r", "c", "u", "k", "k1", "d", "sg", "pt", "cs", "a", "b", "ap", "t",
         "t2", "ops", "s", "p0", "p1", "ci", "mi", "flags")
_FLOATS = ("w_bal", "w_least", "w_most", "w_na", "w_tt", "w_ip", "w_sp", "w_si")

# the block's dynamic shared memory (227 KB per block on Hopper, less the
# static reduction buffers): OPS + Q*D + 3*Q ints + Cs floats, where
# Q = A + B + Cs + Ap is the pod's batched carry-column read
_SMEM_LIMIT = 200 * 1024


def smem_bytes(ops: int, q: int, d: int, cs: int) -> int:
    """The kernel's dynamic shared memory for these widths (mirrors
    plain_step_launch in the .cu)."""
    return (ops + q * d + 3 * q + cs) * 4


class StepArgs(ctypes.Structure):
    _fields_ = ([(f, ctypes.c_void_p) for f in _PTRS]
                + [(f, ctypes.c_int) for f in _INTS]
                + [(f, ctypes.c_float) for f in _FLOATS])


Outputs = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def plain_step(arrs, active: torch.Tensor, hoist: ActiveHoist,
               inv_alloc: torch.Tensor, state: SimState, cfg: EngineConfig,
               p0: int, p1: int) -> Outputs:
    """The step over pods [p0, p1): the CUDA kernel for CUDA tensors, the
    plain torch step for CPU tensors."""
    if active.device.type == "cuda":
        return plain_step_cuda(arrs, active, hoist, inv_alloc, state, cfg, p0, p1)
    if active.device.type == "cpu":
        return plain_step_torch(arrs, active, hoist, inv_alloc, state, cfg, p0, p1)
    raise ValueError(f"no plain_step for device {active.device}")


def plain_step_torch(arrs, active: torch.Tensor, hoist: ActiveHoist,
                     inv_alloc: torch.Tensor, state: SimState, cfg: EngineConfig,
                     p0: int, p1: int) -> Outputs:
    """The plain version: lane by lane, pod by pod through the torch twin
    of the reference step (``engine.scheduler._step``), on any device."""
    scheduler.check_supported(cfg)
    dev = active.device
    host = {f: getattr(arrs, f).cpu().numpy() for f in STEP_HOST_FIELDS}
    n_lanes, n_out = active.shape[0], p1 - p0
    node = torch.empty((n_lanes, n_out), dtype=torch.int32, device=dev)
    fail = torch.zeros((n_lanes, n_out, cfg.n_ops), dtype=torch.int32, device=dev)
    feas = torch.empty((n_lanes, n_out), dtype=torch.int32, device=dev)
    for s in range(n_lanes):
        st = SimState(**{f: getattr(state, f)[s] for f in STATE_FIELDS})
        lane_hoist = ActiveHoist(*(x[s] for x in hoist))
        nodes, fails, feasible = [], [], []
        for p in range(p0, p1):
            st, (nd, fc, fe) = scheduler._step(
                arrs, host, active[s], cfg, lane_hoist, inv_alloc, st, p)
            nodes.append(nd)
            fails.append(fc)
            feasible.append(fe)
        if n_out:
            node[s] = torch.stack(nodes)
            feas[s] = torch.stack(feasible)
            if cfg.fail_reasons:
                fail[s] = torch.stack(fails)
        for f in STATE_FIELDS:
            getattr(state, f)[s].copy_(getattr(st, f))
    return node, fail, feas


def node_domains(topo_onehot: torch.Tensor) -> torch.Tensor:
    """[K1, N, D] one-hot -> [K1, N] i32 domain index, -1 where the node
    lacks the key."""
    has = topo_onehot.sum(dim=2) > 0
    return torch.where(has, topo_onehot.argmax(dim=2),
                       torch.full_like(has, -1, dtype=torch.long)).to(torch.int32)


def _flags(cfg: EngineConfig, state: SimState) -> int:
    fl = 0
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
    return fl


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


def plain_step_cuda(arrs, active: torch.Tensor, hoist: ActiveHoist,
                    inv_alloc: torch.Tensor, state: SimState, cfg: EngineConfig,
                    p0: int, p1: int) -> Outputs:
    """Launch the ``plain_step`` kernel: one block per lane, the pod loop
    inside the kernel, the carry updated in place on the current stream."""
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
    if smem_bytes(ops, q, d, cs) > _SMEM_LIMIT:
        raise ValueError(
            f"plain_step: {ops} ops + {q} carry columns x {d} domains need "
            f"{smem_bytes(ops, q, d, cs)} bytes of shared memory, over the "
            f"block's {_SMEM_LIMIT}")
    if n_out <= 0:
        empty = torch.empty((n_lanes, 0), dtype=torch.int32, device=dev)
        return empty, torch.zeros((n_lanes, 0, ops), dtype=torch.int32, device=dev), empty
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
        active=u8(_check("active", active, torch.bool, (n_lanes, n))),
        log_dom=_check("log_dom", hoist.log_dom, torch.float32, (n_lanes, k)),
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
        out_node=torch.empty((n_lanes, n_out), dtype=torch.int32, device=dev),
        out_fail=torch.zeros((n_lanes, n_out, ops), dtype=torch.int32, device=dev),
        out_feasible=torch.empty((n_lanes, n_out), dtype=torch.int32, device=dev),
        scratch=torch.empty((n_lanes, 4, n), dtype=torch.float32, device=dev),
        scratch_flags=torch.empty((n_lanes, n), dtype=torch.uint8, device=dev),
    )
    for name, t in tensors.items():
        if t.device != dev:
            raise ValueError(f"plain_step: {name} is on {t.device}, not {dev}")
    args = StepArgs(
        **{f: tensors[f].data_ptr() for f in _PTRS},
        n=n, r=r, c=n_cls, u=arrs.spec_alloc.shape[0], k=k, k1=k1, d=d, sg=sg, pt=pt,
        cs=cs, a=a_w, b=b_w, ap=ap, t=t_w, t2=t2, ops=ops, s=n_lanes, p0=p0, p1=p1,
        ci=cfg.cpu_mem_idx[0], mi=cfg.cpu_mem_idx[1], flags=_flags(cfg, state),
        w_bal=cfg.w_balanced, w_least=cfg.w_least, w_most=cfg.w_most,
        w_na=cfg.w_node_aff, w_tt=cfg.w_taint, w_ip=cfg.w_interpod, w_sp=cfg.w_spread,
        w_si=cfg.w_simon)
    lib = build.load("plain_step")
    lib.plain_step_launch.argtypes = [ctypes.POINTER(StepArgs), ctypes.c_void_p]
    lib.plain_step_launch.restype = ctypes.c_int
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.plain_step_launch(ctypes.byref(args), ctypes.c_void_p(stream))
    if err:
        raise RuntimeError(f"plain_step launch failed: CUDA error {err}")
    LAUNCHES["plain_step"] += 1
    return tensors["out_node"], tensors["out_fail"], tensors["out_feasible"]
