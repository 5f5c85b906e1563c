"""Filter ops: each returns an [N] (or [N, R]) boolean feasibility mask
for one pod — the torch twins of the reference's ``ops/filters.py`` for
the ops this package's step runs."""

from __future__ import annotations

import torch

from open_simulator_tpu_torch.ops.domains import domain_count


def fit_per_resource(headroom: torch.Tensor, req_p: torch.Tensor) -> torch.Tensor:
    """NodeResourcesFit per resource: [N, R] bool, req <= headroom (the
    engine carries headroom = alloc - used)."""
    return req_p[None, :] <= headroom


def ports_free(ports_used: torch.Tensor, pod_ports: torch.Tensor) -> torch.Tensor:
    """NodePorts: no requested (hostPort, protocol) already taken on the node."""
    return ~torch.any(ports_used & pod_ports[None, :], dim=1)


def pod_affinity_ok(group_count: torch.Tensor, topo_onehot: torch.Tensor,
                    has_key: torch.Tensor, aff_group, aff_key, aff_valid,
                    aff_self) -> torch.Tensor:
    """InterPodAffinity required terms: every valid term needs a matching
    pod in the node's domain; if no pod matches anywhere and the incoming
    pod matches its own selector, the term passes on nodes that have the
    topology key (the first-pod bootstrap). The semantic oracle the
    step's inline form follows; the per-term arrays are [A] sequences."""
    ok = torch.ones((group_count.shape[0],), dtype=torch.bool, device=group_count.device)
    for a in range(len(aff_group)):
        if not bool(aff_valid[a]):
            continue
        vec = group_count[:, int(aff_group[a])].to(torch.float32)
        dc = domain_count(vec, aff_key[a], topo_onehot)
        node_has = has_key[int(aff_key[a])] > 0
        total = torch.sum(vec)
        ok = ok & node_has & ((dc > 0) | ((total == 0) & bool(aff_self[a])))
    return ok


def pod_anti_affinity_ok(group_count: torch.Tensor, topo_onehot: torch.Tensor,
                         anti_group, anti_key, anti_valid,
                         blocked: torch.Tensor) -> torch.Tensor:
    """InterPodAffinity required anti-affinity, both directions: forward,
    no existing pod matching a valid term of the incoming pod in the
    node's domain; reverse, ``blocked`` (nodes where an existing pod's own
    term covers this pod, read off the term paint)."""
    ok = ~blocked
    for b in range(len(anti_group)):
        if not bool(anti_valid[b]):
            continue
        vec = group_count[:, int(anti_group[b])].to(torch.float32)
        ok = ok & (domain_count(vec, anti_key[b], topo_onehot) == 0)
    return ok


def anti_blocked_dense(term_block: torch.Tensor, hit_terms_p: torch.Tensor) -> torch.Tensor:
    """Reverse anti-affinity verdict, dense form: the paint summed over
    every term whose selector matches this pod, > 0 (a sum of nonnegative
    counts cannot false-positive in bf16)."""
    return (term_block @ hit_terms_p.to(term_block.dtype)) > 0
