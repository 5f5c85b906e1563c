"""open-local storage as torch ops: the twins of the reference's
``ops/storage.py``.

* ``lvm_pack``: each LVM volume (sizes arrive largest first) goes to the
  volume group with the most free space, the first such VG on ties;
* ``device_match``: an exclusive HDD/SSD claim takes the tightest free
  device of its media type that holds it, the lowest index on ties, and
  the device is then gone.

Both broadcast over a leading node axis: the filter runs them at [N, V]
and [N, E], the bind takes the bound node's row of the plan.
"""

from __future__ import annotations

import torch

_BIG = 3.4e38


def lvm_pack(vg_used: torch.Tensor, vg_cap: torch.Tensor, lvm_p: torch.Tensor):
    """(ok [...], add [..., V]): whether every volume found a VG, and the
    per-VG debit the bind applies (meaningful only where ok)."""
    free = vg_cap - vg_used
    v = free.shape[-1]
    ok = torch.ones(free.shape[:-1], dtype=torch.bool, device=free.device)
    add = torch.zeros_like(free)
    cols = torch.arange(v, device=free.device)
    for i in range(lvm_p.shape[0]):
        size = lvm_p[i]
        active = size > 0
        slot = torch.argmax(free, dim=-1)  # the first maximum
        slot_free = torch.amax(free, dim=-1)
        ok = ok & ((slot_free >= size) | ~active)
        delta = (slot[..., None] == cols).to(free.dtype) * size * active.to(free.dtype)
        free = free - delta
        add = add + delta
    return ok, add


def device_match(dev_taken: torch.Tensor, dev_cap: torch.Tensor, dev_ssd: torch.Tensor,
                 dreq_p: torch.Tensor, dssd_p: torch.Tensor):
    """(ok [...], take [..., E] bool): exclusive-device claims onto whole
    free devices, size and media matched."""
    e = dev_cap.shape[-1]
    cols = torch.arange(e, device=dev_cap.device)
    ok = torch.ones(dev_cap.shape[:-1], dtype=torch.bool, device=dev_cap.device)
    take = torch.zeros(dev_cap.shape, dtype=torch.bool, device=dev_cap.device)
    avail = ~dev_taken & (dev_cap > 0)
    for j in range(dreq_p.shape[0]):
        size = dreq_p[j]
        active = size > 0
        elig = avail & (dev_cap >= size) & (dev_ssd == dssd_p[j])
        key = torch.where(elig, dev_cap, torch.full_like(dev_cap, _BIG))
        pick = torch.argmin(key, dim=-1)  # tightest; the first on ties
        any_e = torch.any(elig, dim=-1)
        ok = ok & (any_e | ~active)
        grab = (pick[..., None] == cols) & any_e[..., None] & active
        take = take | grab
        avail = avail & ~grab
    return ok, take


def storage_fit_and_plan(vg_used, vg_cap, dev_taken, dev_cap, dev_ssd, lvm_p, dreq_p,
                         dssd_p):
    """(ok [N], vg_add [N, V], dev_take [N, E]): the filter mask and the
    bind plan in one pass."""
    ok_vg, vg_add = lvm_pack(vg_used, vg_cap, lvm_p)
    ok_dev, dev_take = device_match(dev_taken, dev_cap, dev_ssd, dreq_p, dssd_p)
    return ok_vg & ok_dev, vg_add, dev_take
