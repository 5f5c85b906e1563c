"""VolumeBinding as torch ops: WaitForFirstConsumer claim -> PV matching,
the twins of the reference's ``ops/volumes.py``.

The PV axis is capacity-ascending (the encoder's order), so "the first
available candidate" is the smallest PV that satisfies the claim. A pod's
claims are walked in order and must land on distinct PVs; ``pv_taken``
carries the PVs earlier pods were given.
"""

from __future__ import annotations

import torch


def wfc_claims_ok(pv_taken: torch.Tensor, pv_cand: torch.Tensor, pv_node_ok: torch.Tensor,
                  wfc_ccid, wfc_valid) -> torch.Tensor:
    """[N] bool: every valid claim of the pod finds its own PV on the node
    (per node, the greedy smallest-first match with the claims' PVs
    disjoint). `wfc_ccid` / `wfc_valid` are the pod's [Lw] host rows."""
    n_pv, n_nodes = pv_node_ok.shape
    dev = pv_node_ok.device
    if n_pv == 0:
        # no PVs at all: every valid claim is unmatchable on every node
        return torch.full((n_nodes,), not bool(wfc_valid.any()), dtype=torch.bool, device=dev)
    rows = torch.arange(n_pv, device=dev)[:, None]
    ok = torch.ones((n_nodes,), dtype=torch.bool, device=dev)
    chosen = torch.zeros((n_pv, n_nodes), dtype=torch.bool, device=dev)
    for j in range(len(wfc_ccid)):
        cand = pv_cand[int(wfc_ccid[j])] & ~pv_taken                   # [Npv]
        avail = cand[:, None] & pv_node_ok & ~chosen                   # [Npv, N]
        found = torch.any(avail, dim=0)                                # [N]
        # the first True along the capacity-ascending PV axis
        pick = torch.argmax(avail.to(torch.uint8), dim=0)              # [N]
        chosen = chosen | ((rows == pick[None, :]) & found[None, :])
        ok = ok & (found | (not bool(wfc_valid[j])))
    return ok


def wfc_pick_for_node(pv_taken: torch.Tensor, pv_cand: torch.Tensor,
                      pv_node_col: torch.Tensor, wfc_ccid, wfc_valid, bound: bool):
    """(new pv_taken [Npv], picks [Lw] int32): commit the bound node's
    greedy match; picks are PV ids, -1 for none or an invalid slot."""
    n_pv = pv_taken.shape[0]
    lw = len(wfc_ccid)
    dev = pv_taken.device
    picks = torch.full((lw,), -1, dtype=torch.int32, device=dev)
    if n_pv == 0:
        return pv_taken, picks
    taken = pv_taken.clone()
    for j in range(lw):
        avail = pv_cand[int(wfc_ccid[j])] & ~taken & pv_node_col
        if not (bool(wfc_valid[j]) and bound and bool(avail.any())):
            continue
        idx = int(torch.argmax(avail.to(torch.uint8)))
        taken[idx] = True
        picks[j] = idx
    return taken, picks
