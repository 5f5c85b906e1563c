"""The wave merge: one wave's binds folded into the lanes' carry at once —
the ``wave_merge`` CUDA kernel (``csrc/wave_merge.cu``), its plain torch
twin, and the dispatch between them.

All three take::

    (arrs, cfg, state (a lane-batched SimState, updated in place),
     p0, p1, nodes, gpu_pick=None)

for the wave's pods ``p0 <= p < p1`` (c = p1 - p0). ``nodes`` is [S, c]
i32, each lane's node per pod (negative: the pod binds nothing), or [c]
for binds every lane shares (a FORCED segment's ``forced_node``).
``gpu_pick`` is [S, c, G] i32, each pod's GPU multiplicities, or None
(no GPU debit). ``arrs`` is the snapshot as tensors on the merge's device.

The merge is the port of the reference's ``_wave_merge``
(``engine/scheduler.py:473``, with ``_dense_slot_rows`` ``:460``): the
wave's request sums leave ``headroom``; its matched groups join
``group_count`` (the slot rows under ``slot_paint``) and, per topology
key, ``dom_count``; its ports join ``ports_used``; its attachments join
``vol_cnt``; its anti-affinity terms paint ``term_block`` over each
term key's domain of the bound node, and its preferred terms paint
``pref_paint`` (weighted, slot by slot); the GPU picks times the pods'
per-device memory join ``gpu_used``. Each channel behind the reference's
gate. The sums are f32; a bf16 carry adds the sum rounded to bf16 once,
as the reference's ``astype`` does.

``wave_merge`` launches the kernel for CUDA tensors and runs the plain
version only for CPU tensors; it never falls back from one to the other.
``LAUNCHES["wave_merge"]`` counts the kernel's launches.

``forced_fold`` is the same fold for one carry and many pods, few a
node: the forced binds of ``engine.scheduler.apply_forced_mask`` (the
replay pins) and ``apply_forced_prefix``, in 4,096-pod chunks, on the
``forced_fold`` kernel (``csrc/forced_fold.cu``: two launches a chunk),
which buckets the chunk's pods by node and by domain and walks only each
cell's pods, and writes a new carry (or folds one in place). Its plain
version is ``wave_merge_torch`` on a one-lane view of the carry, chunk
by chunk; ``LAUNCHES["forced_fold"]`` counts its launch pairs (one a
chunk).
"""

from __future__ import annotations

import ctypes
import weakref
from typing import Dict, Optional

import torch

from open_simulator_tpu_torch.engine.scheduler import (
    _PREFIX_CHUNK,
    STATE_FIELDS,
    EngineConfig,
    SimState,
)
from open_simulator_tpu_torch.kernels import build
from open_simulator_tpu_torch.kernels.step import _check as step_check
from open_simulator_tpu_torch.kernels.step import node_domains

LAUNCHES: Dict[str, int] = {"wave_merge": 0, "forced_fold": 0}

# MergeArgs.flags bits (csrc/wave_merge.cu)
M_GC, M_DOM, M_SLOT, M_PORTS, M_VOL = 1, 2, 4, 8, 16
M_ANTI, M_PREF, M_GPU, M_GC_BF16, M_TB_BF16 = 32, 64, 128, 256, 512

_PTRS = ("node_dom", "term_key", "req", "match_groups", "match_gid", "ports", "vol_limit_req",
         "own_terms", "own_tid", "pref_key", "pref_tid", "pref_weight", "pref_valid",
         "gpu_mem", "nodes", "gpu_pick", "headroom", "group_count", "dom_count", "ports_used",
         "vol_cnt", "term_block", "pref_paint", "gpu_used")
_INTS = ("n", "r", "sg", "mg", "pt", "lk", "t", "ot", "ap", "t2", "g", "k1", "d", "s", "p0",
         "c", "node_stride", "flags")


class MergeArgs(ctypes.Structure):
    _fields_ = ([(f, ctypes.c_void_p) for f in _PTRS]
                + [(f, ctypes.c_int) for f in _INTS])


def wave_merge(arrs, cfg: EngineConfig, state: SimState, p0: int, p1: int,
               nodes: torch.Tensor, gpu_pick: Optional[torch.Tensor] = None,
               inputs: Optional[dict] = None) -> None:
    """Merge pods [p0, p1)'s binds into every lane of `state`: the CUDA
    kernel for CUDA tensors, the plain torch version for CPU tensors."""
    if nodes.device.type == "cuda":
        return wave_merge_cuda(arrs, cfg, state, p0, p1, nodes, gpu_pick, inputs)
    if nodes.device.type == "cpu":
        return wave_merge_torch(arrs, cfg, state, p0, p1, nodes, gpu_pick)
    raise ValueError(f"no wave_merge for device {nodes.device}")


def dense_slot_rows(idx: torch.Tensor, width: int) -> torch.Tensor:
    """[c, K] slot indices (-1 padded) -> [c, width] f32 rows counting
    each index (the reference's ``_dense_slot_rows``)."""
    cols = torch.arange(width, device=idx.device)
    return (idx[:, :, None] == cols).to(torch.float32).sum(1)


def wave_merge_torch(arrs, cfg: EngineConfig, state: SimState, p0: int, p1: int,
                     nodes: torch.Tensor, gpu_pick: Optional[torch.Tensor] = None) -> None:
    """The plain version, lane by lane: the reference's ``_wave_merge`` in
    fp32 ``torch.matmul`` (TF32 is off: ``engine.scheduler`` sets it), on
    any device."""
    n_lanes = state.headroom.shape[0]
    lane_nodes = nodes.expand(n_lanes, nodes.shape[-1])   # a [c] row: every lane's
    for s in range(n_lanes):
        lane = SimState(**{f: getattr(state, f)[s] for f in STATE_FIELDS})
        new = _merge_lane(arrs, cfg, lane, p0, p1, lane_nodes[s],
                          None if gpu_pick is None else gpu_pick[s])
        for f, v in new.items():
            getattr(state, f)[s].copy_(v)


def _merge_lane(arrs, cfg: EngineConfig, st: SimState, lo: int, hi: int,
                nodes: torch.Tensor, gpu_pick: Optional[torch.Tensor]) -> Dict[str, torch.Tensor]:
    f32 = torch.float32
    dev = st.headroom.device
    n = arrs.alloc.shape[0]
    idx = nodes.long()
    safe = idx.clamp_min(0)
    boundf = (idx >= 0).to(f32)
    oh = (idx[:, None] == torch.arange(n, device=dev)).to(f32)           # [c, N]
    out = {"headroom": st.headroom - oh.T @ arrs.req[lo:hi]}
    if cfg.needs_group_count or cfg.maintain_dom_count:
        s_n = st.group_count.shape[1]
        match = (dense_slot_rows(arrs.match_gid[lo:hi], s_n) if cfg.slot_paint
                 else arrs.match_groups[lo:hi].to(f32))                  # [c, S]
    if cfg.needs_group_count:
        gc = st.group_count
        out["group_count"] = gc + (oh.T @ match).to(gc.dtype)
    if cfg.maintain_dom_count:
        topo_sel = arrs.topo_onehot[:, safe, :] * boundf[None, :, None]  # [K1, c, D]
        out["dom_count"] = st.dom_count + torch.einsum("akd,ks->ads", topo_sel, match)
    if cfg.enable_ports:
        out["ports_used"] = st.ports_used | ((oh.T @ arrs.ports[lo:hi].to(f32)) > 0)
    if cfg.enable_vol_limits:
        # static demand only: the planner keeps shared-volume pods out of
        # merged waves
        out["vol_cnt"] = st.vol_cnt + oh.T @ arrs.vol_limit_req[lo:hi]
    if cfg.enable_anti_affinity or cfg.enable_pref:
        # sd_all[key][pod, node]: the nodes sharing the pod's bound node's
        # domain (zero rows for unbound pods)
        sd_all = [oh] + [(arrs.topo_onehot[kk][safe] * boundf[:, None]) @ arrs.topo_onehot[kk].T
                         for kk in range(arrs.topo_onehot.shape[0])]
    if cfg.enable_anti_affinity:
        t_n = st.term_block.shape[1]
        own = (dense_slot_rows(arrs.own_tid[lo:hi], t_n) if cfg.slot_paint
               else arrs.own_terms[lo:hi].to(f32))                       # [c, T]
        paint = torch.zeros((n, t_n), dtype=f32, device=dev)
        for kk in range(len(sd_all)):
            mask_t = (arrs.term_key == kk).to(f32)
            paint = paint + sd_all[kk].T @ (own * mask_t[None, :])
        out["term_block"] = st.term_block + paint.to(st.term_block.dtype)
    if cfg.enable_pref:
        t2_n = st.pref_paint.shape[1]
        pref = st.pref_paint
        cols = torch.arange(t2_n, device=dev)
        for a in range(arrs.pref_group.shape[1]):
            w = arrs.pref_weight[lo:hi, a] * arrs.pref_valid[lo:hi, a].to(f32)
            key_a = arrs.pref_key[lo:hi, a]
            sd_a = torch.zeros_like(sd_all[0])
            for kk in range(len(sd_all)):
                sd_a = sd_a + sd_all[kk] * (key_a == kk).to(f32)[:, None]
            col = (arrs.pref_tid[lo:hi, a][:, None] == cols).to(f32)
            pref = pref + sd_a.T @ (col * w[:, None])
        out["pref_paint"] = pref
    if cfg.enable_gpu and gpu_pick is not None:
        out["gpu_used"] = st.gpu_used + oh.T @ (gpu_pick.to(f32) * arrs.gpu_mem[lo:hi, None])
    return out


def merge_flags(cfg: EngineConfig, state: SimState, gpu: bool) -> int:
    fl = M_GC if cfg.needs_group_count else 0
    fl |= M_DOM if cfg.maintain_dom_count else 0
    fl |= M_SLOT if cfg.slot_paint else 0
    fl |= M_PORTS if cfg.enable_ports else 0
    fl |= M_VOL if cfg.enable_vol_limits else 0
    fl |= M_ANTI if cfg.enable_anti_affinity else 0
    fl |= M_PREF if cfg.enable_pref else 0
    fl |= M_GPU if (cfg.enable_gpu and gpu) else 0
    fl |= M_GC_BF16 if state.group_count.dtype == torch.bfloat16 else 0
    fl |= M_TB_BF16 if state.term_block.dtype == torch.bfloat16 else 0
    return fl


def _library() -> ctypes.CDLL:
    lib = build.load("wave_merge")
    lib.wave_merge_launch.argtypes = [ctypes.POINTER(MergeArgs), ctypes.c_void_p]
    lib.wave_merge_launch.restype = ctypes.c_int
    return lib


def _static_inputs(arrs) -> Dict[str, torch.Tensor]:
    """The node and pod arrays in the kernel's types (built once per
    launch context when the caller keeps `inputs`)."""
    def c(t, dt):
        return t.to(dt).contiguous()

    i32, u8, f32 = torch.int32, torch.uint8, torch.float32
    return dict(node_dom=node_domains(arrs.topo_onehot).contiguous(),
                term_key=c(arrs.term_key, i32), req=c(arrs.req, f32),
                match_groups=c(arrs.match_groups, u8), match_gid=c(arrs.match_gid, i32),
                ports=c(arrs.ports, u8), vol_limit_req=c(arrs.vol_limit_req, f32),
                own_terms=c(arrs.own_terms, u8), own_tid=c(arrs.own_tid, i32),
                pref_key=c(arrs.pref_key, i32), pref_tid=c(arrs.pref_tid, i32),
                pref_weight=c(arrs.pref_weight, f32), pref_valid=c(arrs.pref_valid, u8),
                gpu_mem=c(arrs.gpu_mem, f32))


def _check(name: str, t: torch.Tensor, dtype, shape) -> torch.Tensor:
    return step_check(name, t, dtype, shape, "wave_merge")


def wave_merge_cuda(arrs, cfg: EngineConfig, state: SimState, p0: int, p1: int,
                    nodes: torch.Tensor, gpu_pick: Optional[torch.Tensor] = None,
                    inputs: Optional[dict] = None) -> None:
    """Launch the ``wave_merge`` kernel on the current stream: one thread
    per (lane, carry cell) the merge writes, each summing the wave's pods
    in pod order. `inputs`, a dict the caller keeps across launches over
    the same arrays, holds the converted node and pod arrays after the
    first call."""
    n, r = arrs.alloc.shape
    n_lanes, c = state.headroom.shape[0], p1 - p0
    k1, _, d = arrs.topo_onehot.shape
    sg, pt, lk = arrs.match_groups.shape[1], arrs.ports.shape[1], arrs.vol_limit_cap.shape[1]
    t_w, t2, g_w = arrs.own_terms.shape[1], arrs.hit_pref.shape[1], arrs.gpu_slot.shape[1]
    gc_dt, tb_dt = state.group_count.dtype, state.term_block.dtype
    for name, dt in (("group_count", gc_dt), ("term_block", tb_dt)):
        if dt not in (torch.bfloat16, torch.float32):
            raise ValueError(f"wave_merge: {name} dtype {dt}")
    if nodes.dim() == 1:
        _check("nodes", nodes, torch.int32, (c,))
        stride = 0
    else:
        _check("nodes", nodes, torch.int32, (n_lanes, c))
        stride = c
    if gpu_pick is not None:
        _check("gpu_pick", gpu_pick, torch.int32, (n_lanes, c, g_w))
    carry = dict(
        headroom=_check("headroom", state.headroom, torch.float32, (n_lanes, n, r)),
        group_count=_check("group_count", state.group_count, gc_dt, (n_lanes, n, sg)),
        dom_count=_check("dom_count", state.dom_count, torch.float32, (n_lanes, k1, d, sg)),
        ports_used=_check("ports_used", state.ports_used, torch.bool, (n_lanes, n, pt)),
        vol_cnt=_check("vol_cnt", state.vol_cnt, torch.float32, (n_lanes, n, lk)),
        term_block=_check("term_block", state.term_block, tb_dt, (n_lanes, n, t_w)),
        pref_paint=_check("pref_paint", state.pref_paint, torch.float32, (n_lanes, n, t2)),
        gpu_used=_check("gpu_used", state.gpu_used, torch.float32, (n_lanes, n, g_w)))
    if c <= 0:
        return
    static = inputs if inputs is not None else {}
    if not static:
        static.update(_static_inputs(arrs))
    tensors = {**static, **carry, "nodes": nodes}
    if gpu_pick is not None:
        tensors["gpu_pick"] = gpu_pick
    dev = nodes.device
    for name, t in tensors.items():
        if t.device != dev:
            raise ValueError(f"wave_merge: {name} is on {t.device}, not {dev}")
    args = MergeArgs(
        **{f: (tensors[f].data_ptr() if f in tensors else None) for f in _PTRS},
        n=n, r=r, sg=sg, mg=arrs.match_gid.shape[1], pt=pt, lk=lk, t=t_w,
        ot=arrs.own_tid.shape[1], ap=arrs.pref_group.shape[1], t2=t2, g=g_w, k1=k1, d=d,
        s=n_lanes, p0=p0, c=c, node_stride=stride,
        flags=merge_flags(cfg, state, gpu_pick is not None))
    lib = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.wave_merge_launch(ctypes.byref(args), ctypes.c_void_p(stream))
    if err:
        raise RuntimeError(f"wave_merge launch failed: CUDA error {err}")
    LAUNCHES["wave_merge"] += 1


# ---- the forced fold -----------------------------------------------------

# the carry fields the fold folds, and those it only carries over
_FOLD_CARRY = ("headroom", "group_count", "dom_count", "ports_used", "vol_cnt", "term_block",
               "pref_paint")
_FOLD_KEPT = ("gpu_used", "vg_used", "sdev_taken", "pv_taken", "svol_on_node")
_FOLD_PTRS = (("node_dom", "term_key", "req", "match_groups", "ports", "vol_limit_req",
               "own_terms", "pref_key", "pref_tid", "pref_weight", "pref_valid", "nodes", "mask",
               "off", "list", "dom_terms", "dom_pref")
              + tuple("in_" + f for f in _FOLD_CARRY) + _FOLD_CARRY
              + tuple("in_" + f for f in _FOLD_KEPT) + _FOLD_KEPT)
_FOLD_INTS = ("n", "r", "sg", "pt", "lk", "t", "ap", "t2", "k1", "d", "p0", "c", "flags", "g",
              "v", "e", "npv", "nsv")
# the bucket launch's shared memory cap (csrc/forced_fold.cu: kSmemMax)
_FOLD_SMEM_LIMIT = 200 * 1024
# each device arrays object's converted fold inputs and scratch, built on
# its first fold and dropped with it (fold_inputs)
_FOLD_INPUTS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


class FoldArgs(ctypes.Structure):
    _fields_ = ([(f, ctypes.c_void_p) for f in _FOLD_PTRS]
                + [(f, ctypes.c_int) for f in _FOLD_INTS])


def fold_inputs(arrs) -> dict:
    """The dict ``forced_fold_cuda`` keeps its converted inputs and scratch
    in for the device arrays `arrs`: one per arrays object, kept while it
    lives, so the folds over the same arrays (every call of a replay or a
    sweep) convert them once."""
    inputs = _FOLD_INPUTS.get(arrs)
    if inputs is None:
        inputs = _FOLD_INPUTS[arrs] = {}
    return inputs


def forced_fold(arrs, cfg: EngineConfig, state: SimState, p0: int, p1: int,
                nodes: torch.Tensor, out: Optional[SimState] = None,
                mask: Optional[torch.Tensor] = None) -> None:
    """Fold pods [p0, p1) into the one-lane carry `state`, pod ``p0 + i``
    at ``nodes[i]`` (negative: not folded; with `mask` [p1 - p0] bool, at
    ``max(nodes[i], 0)`` where ``mask[i]`` and nowhere else), in chunks of
    ``_PREFIX_CHUNK`` pods from p0, each chunk's sums added once (a bf16
    carry rounds them once a chunk, as the reference folds): in place, or
    given `out` (a one-lane carry of the same shapes) into `out`, every
    field of it written and `state` only read. The ``forced_fold``
    kernel for CUDA tensors, the plain version for CPU tensors."""
    if nodes.device.type == "cuda":
        return forced_fold_cuda(arrs, cfg, state, p0, p1, nodes, out, mask)
    if nodes.device.type == "cpu":
        return forced_fold_torch(arrs, cfg, state, p0, p1, nodes, out, mask)
    raise ValueError(f"no forced_fold for device {nodes.device}")


def forced_fold_torch(arrs, cfg: EngineConfig, state: SimState, p0: int, p1: int,
                      nodes: torch.Tensor, out: Optional[SimState] = None,
                      mask: Optional[torch.Tensor] = None) -> None:
    """The plain version: the plain merge of each chunk's binds on a
    one-lane view of the carry (no GPU debit: the fold's callers hold no
    GPU pod)."""
    if mask is not None:
        nodes = torch.where(mask, nodes.clamp_min(0), torch.full_like(nodes, -1))
    if out is not None:
        for f in STATE_FIELDS:
            getattr(out, f).copy_(getattr(state, f))
        state = out
    lane = SimState(**{f: getattr(state, f)[None] for f in STATE_FIELDS})
    for lo in range(p0, p1, _PREFIX_CHUNK):
        hi = min(lo + _PREFIX_CHUNK, p1)
        wave_merge_torch(arrs, cfg, lane, lo, hi, nodes[lo - p0:hi - p0])


def fold_flags(cfg: EngineConfig, state: SimState) -> int:
    """The fold's channels: the merge's, without the slot rows (the fold
    reads the dense rows, as the reference's) and without the GPU debit."""
    return merge_flags(cfg, SimState(**{f: getattr(state, f)[None] for f in STATE_FIELDS}),
                       False) & ~M_SLOT


def fold_smem(n: int, k1: int, d: int, c: int, domains: bool) -> int:
    """The bucket launch's dynamic shared memory (csrc/forced_fold.cu:
    bucket_smem): the warp totals, then the node counts, or a key's domain
    counts and the chunk's pod list where domain cells fold."""
    return 4 * (32 + max(n + 1, d + 1 + c if domains and k1 > 0 else 0))


def _fold_check(name: str, t: torch.Tensor, dtype, shape) -> torch.Tensor:
    return step_check(name, t, dtype, shape, "forced_fold")


def _fold_library() -> ctypes.CDLL:
    lib = build.load("forced_fold")
    lib.forced_fold_launch.argtypes = [ctypes.POINTER(FoldArgs), ctypes.c_void_p]
    lib.forced_fold_launch.restype = ctypes.c_int
    return lib


def forced_fold_cuda(arrs, cfg: EngineConfig, state: SimState, p0: int, p1: int,
                     nodes: torch.Tensor, out: Optional[SimState] = None,
                     mask: Optional[torch.Tensor] = None) -> None:
    """Launch the ``forced_fold`` pair on the current stream, once a
    chunk: bucket the chunk's pods by node (block 0) and sum each domain
    cell (the other blocks, each bucketing by its key's domain), then one
    thread a node cell walks its node's pods and reads its domains' sums,
    writing `out` (or `state` in place) and carrying over what the chunk
    leaves; the chunks after the first fold `out` in place. The inputs are
    checked once a call; the converted pod and node arrays and the scratch
    are kept per arrays object (``fold_inputs``)."""
    n, r = arrs.alloc.shape
    c = p1 - p0
    k1, _, d = arrs.topo_onehot.shape
    sg, pt, lk = arrs.match_groups.shape[1], arrs.ports.shape[1], arrs.vol_limit_cap.shape[1]
    t_w, t2, ap = arrs.own_terms.shape[1], arrs.hit_pref.shape[1], arrs.pref_group.shape[1]
    gc_dt, tb_dt = state.group_count.dtype, state.term_block.dtype
    for name, dt in (("group_count", gc_dt), ("term_block", tb_dt)):
        if dt not in (torch.bfloat16, torch.float32):
            raise ValueError(f"forced_fold: {name} dtype {dt}")
    flags = fold_flags(cfg, state)
    domains = bool(flags & (M_DOM | M_ANTI | M_PREF))
    chunk = min(max(c, 0), _PREFIX_CHUNK)
    if fold_smem(n, k1, d, chunk, domains) > _FOLD_SMEM_LIMIT:
        raise ValueError(f"forced_fold: {n} nodes, or {d} domains and {chunk} pods, over the "
                         f"bucket kernel's {_FOLD_SMEM_LIMIT} bytes of shared memory")
    _fold_check("nodes", nodes, torch.int32, (c,))
    if mask is not None:
        _fold_check("mask", mask, torch.bool, (c,))
    shapes = dict(headroom=(torch.float32, (n, r)), group_count=(gc_dt, (n, sg)),
                  dom_count=(torch.float32, (k1, d, sg)), ports_used=(torch.bool, (n, pt)),
                  vol_cnt=(torch.float32, (n, lk)), term_block=(tb_dt, (n, t_w)),
                  pref_paint=(torch.float32, (n, t2)))
    shapes.update({f: (getattr(state, f).dtype, tuple(getattr(state, f).shape))
                   for f in _FOLD_KEPT})
    dst = out if out is not None else state
    carry = {}
    for f, (dt, shape) in shapes.items():
        carry["in_" + f] = _fold_check(f, getattr(state, f), dt, shape)
        carry[f] = _fold_check(f, getattr(dst, f), dt, shape)
    if c <= 0:
        if out is not None:
            for f in STATE_FIELDS:
                getattr(out, f).copy_(getattr(state, f))
        return
    static = fold_inputs(arrs)
    if "fold" not in static:
        def u8(x):  # bool rows as the bytes they are stored in
            return x.contiguous().view(torch.uint8) if x.dtype == torch.bool else \
                x.to(torch.uint8).contiguous()

        def cv(x, dt):
            return x.to(dt).contiguous()

        i32, f32 = torch.int32, torch.float32
        static["fold"] = dict(
            node_dom=node_domains(arrs.topo_onehot).contiguous(),
            term_key=cv(arrs.term_key, i32), req=cv(arrs.req, f32),
            match_groups=u8(arrs.match_groups), ports=u8(arrs.ports),
            vol_limit_req=cv(arrs.vol_limit_req, f32), own_terms=u8(arrs.own_terms),
            pref_key=cv(arrs.pref_key, i32), pref_tid=cv(arrs.pref_tid, i32),
            pref_weight=cv(arrs.pref_weight, f32), pref_valid=u8(arrs.pref_valid))
    dev = nodes.device
    # scratch, written before it is read within each launch pair, so the
    # chunks and the calls over the same arrays share it (stream order)
    scratch = static.get("fold_scratch")
    if scratch is None or scratch["list"].numel() < chunk:
        scratch = static["fold_scratch"] = dict(
            off=torch.empty((n + 1,), dtype=torch.int32, device=dev),
            list=torch.empty((chunk,), dtype=torch.int32, device=dev),
            dom_terms=torch.empty((max(1, k1 * d * t_w),), dtype=torch.float32, device=dev),
            dom_pref=torch.empty((max(1, k1 * d * ap * t2),), dtype=torch.float32, device=dev))
    tensors = {**static["fold"], **carry, **scratch, "nodes": nodes}
    if mask is not None:
        tensors["mask"] = mask
    for name, t in tensors.items():
        if t.device != dev:
            raise ValueError(f"forced_fold: {name} is on {t.device}, not {dev}")
    args = FoldArgs(
        **{f: (tensors[f].data_ptr() if f in tensors else None) for f in _FOLD_PTRS},
        n=n, r=r, sg=sg, pt=pt, lk=lk, t=t_w, ap=ap, t2=t2, k1=k1, d=d, p0=p0, c=chunk,
        flags=flags, **{w: (getattr(state, f).shape[-1] if getattr(state, f).dim() > 1 else 0)
                        for w, f in (("g", "gpu_used"), ("v", "vg_used"), ("e", "sdev_taken"),
                                     ("nsv", "svol_on_node"))},
        npv=state.pv_taken.shape[0])
    lib = _fold_library()
    with torch.cuda.device(dev):
        stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
        for lo in range(p0, p1, _PREFIX_CHUNK):
            if lo > p0:  # the chunks after the first: `dst` in place
                args.p0, args.c = lo, min(lo + _PREFIX_CHUNK, p1) - lo
                args.nodes = tensors["nodes"].data_ptr() + 4 * (lo - p0)
                if mask is not None:
                    args.mask = tensors["mask"].data_ptr() + (lo - p0)
                for f in shapes:
                    setattr(args, "in_" + f, getattr(args, f))
            err = lib.forced_fold_launch(ctypes.byref(args), stream)
            if err:
                raise RuntimeError(f"forced_fold launch failed: CUDA error {err}")
            LAUNCHES["forced_fold"] += 1
