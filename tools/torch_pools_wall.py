#!/usr/bin/env python3
"""Time the pools preset's ``simulate()`` (the reference bench's wave
showcase, ``bench.py:351``: 1,024 nodes x 10,240 pods in 32 pools, one
GRID of 320 waves) of this tree and of another checkout on one card, each
side in a process of its own, in the order other, this, this, other:

    python3 tools/torch_pools_wall.py --other <dir> [--runs N]

`<dir>` is a checkout of another commit (``git archive <rev> | tar -x -C
<dir>``). Each process builds the pools cluster objects, then calls
``simulate()`` N + 1 times without explain and N + 1 times with
``explain_topk = 3`` (the first call of each kind is cold: it loads the
kernel libraries and fills the port's caches). For the objects' build and
for each call it prints the wall (host clock, the card synchronised), the
cyclic garbage collector's pauses inside it (``gc.callbacks``: seconds,
and full generation-2 passes) and the heap's tracked objects before it;
for the last call of each kind a host profile (``cProfile``: the 14
functions with the most cumulative time). Each checkout's kernels are
built in its own ``build/torch_kernels`` before its first process runs
(``kernels/build.build_all``), so no timed call compiles. The card's name
and power limit come first.
"""
from __future__ import annotations

import argparse
import cProfile
import gc
import io
import json
import pstats
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
POOLS = {"nodes": 1024, "pods": 10240, "pools": 32}
EXPLAIN_K = 3


class GcClock:
    """The collector's pauses (host clock) since ``mark()``."""

    def __init__(self) -> None:
        self.s, self.full, self._t0 = 0.0, 0, 0.0
        gc.callbacks.append(self)

    def __call__(self, phase: str, info: dict) -> None:
        if phase == "start":
            self._t0 = time.perf_counter()
        else:
            self.s += time.perf_counter() - self._t0
            self.full += info["generation"] == 2

    def mark(self):
        return self.s, self.full

    def since(self, mark) -> dict:
        return {"gc_s": self.s - mark[0], "gc_full": self.full - mark[1]}


def child(tree: str, runs: int, side: str) -> None:
    """One side's process: `tree`'s package, the pools objects and calls."""
    sys.path.insert(0, tree)
    import torch

    from open_simulator_tpu_torch.core import simulate
    from open_simulator_tpu_torch.k8s.loader import ClusterResources
    from open_simulator_tpu_torch.kernels import build
    from open_simulator_tpu_torch.testing.synthetic import synthetic_objects

    build.build_all()
    clock = GcClock()

    def emit(what: str, wall: float, mark, objs: int, **extra) -> None:
        print(json.dumps({"side": side, "what": what, "wall_s": wall, "objects": objs,
                          **clock.since(mark), **extra}), flush=True)

    objs, mark, t0 = len(gc.get_objects()), clock.mark(), time.perf_counter()
    nodes, pods, _ = synthetic_objects(POOLS["nodes"], POOLS["pods"], pools=POOLS["pools"])
    cluster = ClusterResources(nodes=nodes, pods=pods)
    emit("objects", time.perf_counter() - t0, mark, objs)
    for label, overrides in (("pools", None), ("pools-explain", {"explain_topk": EXPLAIN_K})):
        for i in range(runs + 1):
            profile = cProfile.Profile() if i == runs else None
            objs, mark = len(gc.get_objects()), clock.mark()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if profile:
                profile.enable()
            result = simulate(cluster, [], device="cuda", config_overrides=overrides)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            if profile:
                profile.disable()
            emit(label, wall, mark, objs, call=i, cold=i == 0,
                 scheduled=len(result.scheduled_pods))
            if profile:
                buf = io.StringIO()
                pstats.Stats(profile, stream=buf).sort_stats("cumulative").print_stats(14)
                print(f"# {side} {label} call {i}: host profile\n{buf.getvalue()}", flush=True)
            del result


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", help="a checkout of another commit")
    ap.add_argument("--runs", type=int, default=2, help="warm calls of each kind")
    ap.add_argument("--child", help=argparse.SUPPRESS)
    ap.add_argument("--side", help=argparse.SUPPRESS)
    opts = ap.parse_args()
    if opts.child:
        child(opts.child, opts.runs, opts.side)
        return 0
    if not opts.other:
        ap.error("--other is required")
    import torch

    if not torch.cuda.is_available():
        print("torch_pools_wall: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip()
    print(f"card: {card}", flush=True)
    other = str(Path(opts.other).resolve())
    rows = []
    for side, tree in (("other", other), ("this", str(ROOT)), ("this", str(ROOT)),
                       ("other", other)):
        out = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--child", tree,
                              "--runs", str(opts.runs), "--side", side],
                             capture_output=True, text=True, timeout=1800)
        if out.returncode:
            print(out.stdout[-4000:], out.stderr[-4000:], file=sys.stderr)
            return 1
        for line in out.stdout.splitlines():
            print(line, flush=True)
            if line.startswith("{"):
                rows.append(json.loads(line))
    for what in ("objects", "pools", "pools-explain"):
        for cold in (True, False):
            for side in ("other", "this"):
                got = [r for r in rows if r["what"] == what and r["side"] == side
                       and r.get("cold", True) == cold]
                if got:
                    print(f"{what}{'' if what == 'objects' else (' cold' if cold else ' warm')}, "
                          f"{side}: wall_s {[round(r['wall_s'], 3) for r in got]} gc_s "
                          f"{[round(r['gc_s'], 3) for r in got]} full gc "
                          f"{[r['gc_full'] for r in got]}", flush=True)
            if what == "objects":
                break
    return 0


if __name__ == "__main__":
    sys.exit(main())
