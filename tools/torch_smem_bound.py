#!/usr/bin/env python3
"""Where a step launch's shared memory runs out, from the kernel's own
accounting (``open_simulator_tpu_torch/kernels/step.smem_bytes``).

    python3 tools/torch_smem_bound.py [--nodes 5120]

For a lane of `--nodes` nodes on the largest cluster (16 blocks, the
headroom rows in global memory), prints the largest domain count D whose
block still fits the 200 KB budget (``_SMEM_LIMIT``) at Q = 1, 2, 4 and 8
carry columns: with the regions in shared memory (the placement every
launch had before the wide library), without and with the dom_count
replica (K1 = 1 key, Sg = 8 selector groups); then the largest D once the
plan puts the replica or the column-read partials in global memory. The
other widths: 17 filter ops (3 resources), one spread constraint, four
raw-score rows, no PV replica. Host arithmetic only; needs no card.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--nodes", type=int, default=5120)
    ap.add_argument("--groups", type=int, default=8, help="selector groups (Sg)")
    args = ap.parse_args()
    from open_simulator_tpu_torch.kernels import step

    sl = step.block_geometry(args.nodes, step.CLUSTER_SIZES[0])[0]

    def d_max(q: int, dom: bool, dom_global: bool = False, cols_global: bool = False) -> int:
        def fits(d: int) -> bool:
            w = step.SmemWidths(ops=17, q=q, d=d, cs=1, dom=d * args.groups if dom else 0,
                                rows=4, r=3, npv=0)
            return step.smem_bytes(w, sl, False, dom_global, cols_global) <= step._SMEM_LIMIT

        lo, hi = 0, 1
        while fits(hi):
            lo, hi = hi, hi * 2
        while hi - lo > 1:
            mid = (lo + hi) // 2
            lo, hi = (mid, hi) if fits(mid) else (lo, mid)
        return lo

    print(f"{args.nodes} nodes, 16 blocks of {sl} nodes, budget {step._SMEM_LIMIT} bytes")
    print("Q  D_max(no replica)  D_max(replica)  replica global  partials global  both global")
    for q in (1, 2, 4, 8):
        print(f"{q}  {d_max(q, False):17d}  {d_max(q, True):14d}  "
              f"{d_max(q, True, dom_global=True):14d}  {d_max(q, False, cols_global=True):15d}  "
              f"{d_max(q, True, True, True):11d}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
