"""Open-Gpu-Share as torch ops: the twins of the reference's
``ops/gpu_share.py`` (the GPU-share plugin and its cache, AllocateGpuId).

On a dense per-device memory array::

  carry gpu_used [N, G]   memory used per device slot
  node  gpu_cap  [N]      per-device memory capacity (uniform per node)
        gpu_slot [N, G]   1.0 for real device slots

* filter: the node's total GPU memory covers the pod's per-GPU memory,
  the node has a device, and the two-pointer allocation succeeds
  (sum over devices of floor(idle/mem) >= cnt; pinned pods skip it);
* score: want / (free_total - want), clipped to [0, 1], x 100;
* pick on the bound node: the tightest single device (lowest id on ties)
  for cnt == 1, the ascending two-pointer with per-device multiplicity
  for cnt > 1, a pinned ``gpu-index`` verbatim.

Every divide is tensor / tensor (a round-to-nearest divide on both
devices), and the floor is taken of the divided value, as the reference.
"""

from __future__ import annotations

import torch

_BIG = 3.4e38


def slots_per_device(gpu_used: torch.Tensor, gpu_cap: torch.Tensor,
                     gpu_slot: torch.Tensor, mem_p: torch.Tensor) -> torch.Tensor:
    """floor(max(idle, 0) / mem) per device: how many of the pod's
    requested GPUs one device can hold (0 on a missing slot). `gpu_cap`
    broadcasts against `gpu_used`; `mem_p` is a 0-d tensor."""
    free = gpu_cap - gpu_used
    mem_safe = torch.where(mem_p > 0, mem_p, torch.ones_like(mem_p))
    slots = torch.floor(torch.clamp_min(free, 0.0) / mem_safe.expand(free.shape))
    return torch.where(gpu_slot > 0, slots, torch.zeros_like(slots))


def gpu_fit(gpu_used: torch.Tensor, gpu_cap: torch.Tensor, gpu_slot: torch.Tensor,
            mem_p: torch.Tensor, cnt_p: torch.Tensor,
            has_forced_p: torch.Tensor) -> torch.Tensor:
    """[N] bool GPU-share filter (reference ``gpu_fit``): capacity
    precheck against the per-GPU memory, a device present, and the
    two-pointer allocation (skipped for a pinned pod). Pods without a GPU
    request pass everywhere."""
    n_slots = torch.sum(gpu_slot, dim=1)
    has_dev = n_slots > 0
    cap_ok = gpu_cap * n_slots >= mem_p
    slots = slots_per_device(gpu_used, gpu_cap[:, None], gpu_slot, mem_p)
    alloc_ok = torch.sum(slots, dim=1) >= cnt_p
    ok = cap_ok & has_dev & (alloc_ok | has_forced_p)
    return torch.where(cnt_p > 0, ok, torch.ones_like(ok))


def gpu_share_raw(gpu_used: torch.Tensor, gpu_cap: torch.Tensor, gpu_slot: torch.Tensor,
                  mem_p: torch.Tensor, cnt_p: torch.Tensor) -> torch.Tensor:
    """[N] raw GPU-share score before min-max normalization (reference
    ``gpu_share_raw``)."""
    free = gpu_cap[:, None] - gpu_used
    free_total = torch.sum(torch.where(gpu_slot > 0, free, torch.zeros_like(free)), dim=1)
    want = mem_p * cnt_p
    avail = free_total - want
    pos = avail > 0
    share = torch.where(
        pos, want.expand(avail.shape) / torch.where(pos, avail, torch.ones_like(avail)),
        torch.where(want > 0, 1.0, 0.0).expand(avail.shape))
    return torch.clamp(share, 0.0, 1.0) * 100.0


def gpu_pick_devices(gpu_used_n: torch.Tensor, gpu_cap_n: torch.Tensor,
                     gpu_slot_n: torch.Tensor, mem_p: torch.Tensor, cnt_p: torch.Tensor,
                     forced_counts: torch.Tensor, has_forced: torch.Tensor) -> torch.Tensor:
    """[G] int32 multiplicities on one node (reference
    ``gpu_pick_devices``): device d's memory debit is count x mem."""
    g = gpu_used_n.shape[0]
    free = gpu_cap_n - gpu_used_n
    feasible = (gpu_slot_n > 0) & (free >= mem_p)
    slots = slots_per_device(gpu_used_n, gpu_cap_n, gpu_slot_n, mem_p)
    before = torch.cumsum(slots, 0) - slots
    take = torch.minimum(torch.clamp_min(cnt_p - before, 0.0), slots)
    complete = torch.sum(slots) >= cnt_p
    multi = torch.where(complete, take, torch.zeros_like(take))
    key = torch.where(feasible, free, torch.full_like(free, _BIG))
    sel = torch.argmin(key)  # the first minimum: lowest id on ties
    single = ((torch.arange(g, device=free.device) == sel).to(torch.float32)
              * torch.any(feasible).to(torch.float32))
    pick = torch.where(cnt_p == 1, single, multi)
    pick = torch.where(has_forced, forced_counts.to(torch.float32), pick)
    return (pick * (cnt_p > 0).to(torch.float32)).to(torch.int32)
