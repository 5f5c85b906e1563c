"""Score ops: torch twins of the reference's ``ops/scores.py`` hot-path
forms, written so every float operation is the same IEEE operation in the
same order as the reference's.

Two torch habits would change bits and are avoided here:

* ``scalar / tensor`` is ``tensor.reciprocal() * scalar`` in torch, and on
  CUDA ``tensor / python_scalar`` multiplies by the reciprocal. Every
  divide below is tensor / tensor (``_div``), a round-to-nearest divide.
* Composite ops that may fuse a multiply and an add (``addcmul``,
  ``lerp``) are not used.
"""

from __future__ import annotations

import torch

from open_simulator_tpu_torch.ops.domains import domain_count

MAX_SCORE = 100.0


def _div(num: float, den: torch.Tensor) -> torch.Tensor:
    """num / den as a true elementwise divide (see module docstring)."""
    return torch.full_like(den, num) / den


def resource_scores_fused(headroom: torch.Tensor, inv_alloc: torch.Tensor,
                          req_p: torch.Tensor, cpu_mem_idx, w_balanced, w_least, w_most,
                          always_on: bool = False) -> torch.Tensor:
    """Balanced + Least(+Most)Allocated over the shared free fractions
    h = (headroom - req) * inv_alloc (reference ``resource_scores_fused``).
    Constant weights (Python floats): a zero weight drops its term.
    ``always_on`` is the traced-weights mode: the weights are 0-dim f32
    tensors, never branched on, and every term is added (a zero weight
    adds ``+0.0``: the terms are finite and nonnegative)."""
    ci, mi = cpu_mem_idx
    h_c = (headroom[:, ci] - req_p[ci]) * inv_alloc[:, ci]
    h_m = (headroom[:, mi] - req_p[mi]) * inv_alloc[:, mi]
    out = torch.zeros(headroom.shape[:1], dtype=torch.float32,
                      device=headroom.device)
    if always_on or w_balanced:
        out = out + w_balanced * (
            (1.0 - torch.abs(h_c - h_m) * 0.5) * MAX_SCORE)
    if always_on or w_least:
        out = out + w_least * (
            (torch.clamp_min(h_c, 0.0) + torch.clamp_min(h_m, 0.0))
            * (MAX_SCORE / 2.0))
    if always_on or w_most:
        # mostRequestedScore returns 0 when capacity == 0
        out = out + w_most * (
            (torch.clamp(1.0 - h_c, 0.0, 1.0) * (inv_alloc[:, ci] > 0)
             + torch.clamp(1.0 - h_m, 0.0, 1.0) * (inv_alloc[:, mi] > 0))
            * (MAX_SCORE / 2.0))
    return out


def simon_max_share_raw(alloc: torch.Tensor, req_p: torch.Tensor) -> torch.Tensor:
    """Simon plugin raw score: max over resources of share(req, alloc - req)
    x 100, with 0/0 = 0 and a/0 = 1 (static allocatable, as the reference)."""
    avail = alloc - req_p[None, :]
    requested = req_p[None, :].expand(alloc.shape)
    nz = avail != 0
    share = torch.where(
        nz, requested / torch.where(nz, avail, torch.ones_like(avail)),
        (requested != 0).to(torch.float32))
    share = torch.where(requested > 0, torch.clamp(share, 0.0, 1.0),
                        torch.zeros_like(share))
    return torch.amax(share, dim=1) * MAX_SCORE


def minmax_apply(raw: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """Min-max normalize to 0..100 from already-reduced lo/hi."""
    rng = hi - lo
    pos = rng > 0
    inv = torch.where(pos, _div(MAX_SCORE, torch.where(pos, rng, torch.ones_like(rng))),
                      torch.zeros_like(rng))
    return (raw - lo) * inv


def max_apply(raw: torch.Tensor, hi: torch.Tensor, reverse: bool = False) -> torch.Tensor:
    """DefaultNormalizeScore from an already-reduced max (reverse flips)."""
    pos = hi > 0
    inv = torch.where(pos, _div(MAX_SCORE, torch.where(pos, hi, torch.ones_like(hi))),
                      torch.zeros_like(hi))
    return MAX_SCORE - raw * inv if reverse else raw * inv


def spread_apply(raw: torch.Tensor, s_min: torch.Tensor, s_max: torch.Tensor,
                 node_ok: torch.Tensor, any_soft: bool) -> torch.Tensor:
    """PodTopologySpread score pass 2: 100*(max+min-raw)/max when max > 0
    else 100, as base + (c1 - raw)*inv; nodes missing a constraint key
    score 0. ``any_soft`` (a host bool) folds in as a 0/1 factor."""
    pos = s_max > 0
    soft = float(any_soft)
    inv = torch.where(pos, _div(100.0, torch.clamp_min(s_max, 1e-9)),
                      torch.zeros_like(s_max)) * soft
    base = torch.where(pos, torch.zeros_like(s_max),
                       torch.full_like(s_max, 100.0)) * soft
    c1 = s_max + s_min
    return torch.where(node_ok, base + (c1 - raw) * inv, torch.zeros_like(raw))


def interpod_preference_raw(group_count: torch.Tensor, topo_onehot: torch.Tensor,
                            has_key: torch.Tensor, pref_group, pref_key, pref_weight,
                            pref_valid, extra_raw: torch.Tensor = None) -> torch.Tensor:
    """InterPodAffinity score pass 1: per valid preferred term of the
    incoming pod, weight x (#matching pods in the node's domain), zero on
    nodes without the key, summed onto `extra_raw` (the existing pods'
    direction, ``pref_paint @ hit_pref``) in slot order. Weights and
    counts are integers, so every sum is exact below 2^24."""
    f32 = torch.float32
    n = group_count.shape[0]
    raw = (torch.zeros((n,), dtype=f32, device=group_count.device)
           if extra_raw is None else extra_raw)
    for a in range(len(pref_group)):
        if not bool(pref_valid[a]):
            continue
        vec = group_count[:, int(pref_group[a])].to(f32)
        dc = domain_count(vec, pref_key[a], topo_onehot)
        node_has = (has_key[int(pref_key[a])] > 0).to(f32)
        raw = raw + (float(pref_weight[a]) * dc) * node_has
    return raw
