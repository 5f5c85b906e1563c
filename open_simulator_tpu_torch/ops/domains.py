"""Topology-domain primitives, and the statistics hoisted out of the pod
loop (the torch twins of the reference's ``ops/domains.py``).

A topology key partitions nodes into domains (hostname: every node its
own domain; zone or region: a few). For a non-hostname key the count of
matching pods in each node's domain is a pair of small matmuls against
the one-hot domain matrix ``O [N, D]``: ``O @ (O^T @ v)``. Counts are
integers below 2^24, so every such sum is exact in f32 in any order.

``hoist_active_stats`` computes once per launch what the active mask
fixes: ``log_dom`` (the soft spread's topologyNormalizingWeight) and the
per-class eligibility tables the hard spread's minimum reads.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

_F32 = np.float32
# Cephes single-precision log polynomial (the coefficients XLA's CPU
# backend evaluates for f32 log).
_LOG_P = tuple(_F32(c) for c in (
    7.0376836292E-2, -1.1514610310E-1, 1.1676998740E-1, -1.2420140846E-1,
    1.4249322787E-1, -1.6668057665E-1, 2.0000714765E-1, -2.4999993993E-1,
    3.3333331174E-1))


def _fma(a, b, c) -> np.ndarray:
    # the f32 product is exact in f64; one rounding of the f64 sum to f32
    return (np.float64(a) * np.float64(b) + np.float64(c)).astype(_F32)


def log_f32(x: np.ndarray) -> np.ndarray:
    """float32 natural log, bit-identical to the reference's (XLA CPU's
    Cephes polynomial). It differs from a correctly rounded log by one
    ulp at some inputs (log(7) is one), and a one-ulp change in the spread
    weight can flip an exact tie in selectHost. Valid for finite x >= 1,
    which is all this package passes (domain counts + 2)."""
    v = np.asarray(x, dtype=_F32)
    bits = v.view(np.uint32)
    m = ((bits & np.uint32(0x807FFFFF)) | np.uint32(0x3F000000)).view(_F32)
    e = _F32(1.0) + ((bits >> np.uint32(23)).astype(np.int32) - 0x7F).astype(_F32)
    small = m < _F32(0.707106781186547524)
    tmp = np.where(small, m, _F32(0.0))
    m = m - _F32(1.0)
    e = e - np.where(small, _F32(1.0), _F32(0.0))
    m = m + tmp
    x2 = m * m
    x3 = x2 * m
    p = _LOG_P
    y = _fma(m, p[0], p[1])
    y1 = _fma(m, p[3], p[4])
    y2 = _fma(m, p[6], p[7])
    y = _fma(y, m, p[2])
    y1 = _fma(y1, m, p[5])
    y2 = _fma(y2, m, p[8])
    y = _fma(y, x3, y1)
    y = _fma(y, x3, y2)
    y = _fma(y, x3, _F32(-2.12194440e-4) * e)
    m = m - _F32(0.5) * x2
    m = m + y
    return (m + _F32(0.693359375) * e).astype(_F32)


def domain_count(count_vec: torch.Tensor, key_id: int,
                 topo_onehot: torch.Tensor) -> torch.Tensor:
    """[N] -> [N]: for each node, the sum of count_vec over its domain
    under topology key `key_id` (0 = hostname: the vector itself; a node
    without the key gets 0)."""
    key_id = int(key_id)
    if key_id == 0:
        return count_vec
    oh = topo_onehot[key_id - 1]
    return oh @ (oh.T @ count_vec)


class ActiveHoist(NamedTuple):
    """Launch-invariant statistics of an [N] (or lane-batched [S, N])
    active mask; a leading [S] axis on every field when batched."""

    dom_counts: torch.Tensor  # [..., K] f32: #domains holding an active node
    log_dom: torch.Tensor     # [..., K] f32: log(dom_counts + 2)
    elig_host: torch.Tensor   # [..., C, N] bool: active & class affinity & hostname
    domain_has: torch.Tensor  # [..., C, K1, D] bool: domain holds an eligible node
    any_elig: torch.Tensor    # [..., C, K] bool: an eligible node has the key


def hoist_active_stats(topo_onehot: torch.Tensor, has_key: torch.Tensor,
                       class_affinity: torch.Tensor,
                       active: torch.Tensor) -> ActiveHoist:
    """Domain counts per topology key (key 0 is the hostname: one domain
    per active node) and the per-class spread eligibility — active, in
    the class's node affinity and holding the key — as the reference's
    ``hoist_active_stats``, for an [N] or [S, N] active mask."""
    f32 = torch.float32
    act = active.to(f32)
    dom_counts = [act.sum(dim=-1)]
    for k in range(topo_onehot.shape[0]):
        present = torch.any((topo_onehot[k] * act[..., :, None]) > 0, dim=-2)
        dom_counts.append(present.to(f32).sum(dim=-1))
    stacked = torch.stack(dom_counts, dim=-1)
    host = stacked.cpu().numpy()
    log_dom = torch.from_numpy(log_f32(host + _F32(2.0))).to(stacked.device)
    elig_ck = (class_affinity.bool()[:, None, :] & (has_key > 0)[None, :, :]
               & active.bool()[..., None, None, :])                 # [..., C, K, N]
    k1, n_keys = topo_onehot.shape[0], has_key.shape[0]
    if k1:
        # key k + 1 clamps to the last key, as the reference's index does
        # (a cluster with only the hostname key still has one, empty,
        # one-hot row)
        domain_has = torch.stack([
            (elig_ck[..., :, min(k + 1, n_keys - 1), :].to(f32) @ topo_onehot[k]) > 0
            for k in range(k1)
        ], dim=-2)                                                  # [..., C, K1, D]
    else:
        domain_has = torch.zeros(elig_ck.shape[:-2] + (0, 0), dtype=torch.bool,
                                 device=elig_ck.device)
    return ActiveHoist(dom_counts=stacked, log_dom=log_dom,
                       elig_host=elig_ck[..., :, 0, :].contiguous(), domain_has=domain_has,
                       any_elig=torch.any(elig_ck, dim=-1))
