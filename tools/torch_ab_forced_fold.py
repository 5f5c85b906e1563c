#!/usr/bin/env python3
"""Time the port's forced fold against another commit's, in one process,
on one card, launch by launch.

    python3 tools/torch_ab_forced_fold.py --other <checkout> [--rounds 3] [--no-replay]

`<checkout>` is another commit's tree (``git archive <rev> | tar -x -C
<dir>``): its ``csrc/forced_fold.cu`` and ``kernels/wave.py`` are the other
side, folded the way that commit's engine folds (the carry cloned, then
each 4,096-pod chunk folded in place, the inputs converted once a call);
this side is this tree's ``apply_forced_prefix`` / ``apply_forced_mask``.
Both sources are compiled with the package's nvcc flags into
``build/torch_ab/``, each inside a probe that records a CUDA event when a
launch sequence starts and after each launch (the source's
``cudaGetLastError`` after every launch), so each launch is timed alone.

The inputs: the capacity prefixes at full width (5,120 nodes + 64 slots x
51,200 pods: north-star and rich with their first 4,096 pods pinned where
a one-lane launch at 63 new nodes placed them, and the device-resource
cluster's own nodeName prefix), and (unless ``--no-replay``) the last
full scan's whole-mask fold of the replay-day run (5,120 + 1,024 nodes).
Each fold runs in the order other, this, this, other, ``--rounds`` times:
once with the host launching (CUDA events around the call) and once with
the stream primed (``torch.cuda._sleep`` first, so the times are the
device's alone); the primed runs are cut at the probe's marks into the
work before the first launch (the wrapper's own kernels: the clone, the
input conversions), each launch of a sequence (summed over the chunks)
and the rest. The minima are printed with the card's name and power
limit, and the two sides' folded carries must be equal. Needs the card.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import importlib.util
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

# the probe: the source included whole, its forced_fold_launch wrapped so
# that each sequence records a start mark, and each cudaGetLastError after
# a launch an end mark, on the launch's stream
PROBE = r"""
#include <cuda_runtime.h>
static cudaStream_t g_stream;
static cudaEvent_t g_ev[512];
static int g_kind[512];
static int g_n, g_on;
static void probe_mark(int kind) {
  if (!g_on || g_n >= 512) return;
  if (!g_ev[g_n]) cudaEventCreate(&g_ev[g_n]);
  g_kind[g_n] = kind;
  cudaEventRecord(g_ev[g_n++], g_stream);
}
static cudaError_t probe_after_launch() {
  const cudaError_t e = cudaGetLastError();
  probe_mark(1);
  return e;
}
#define cudaGetLastError probe_after_launch
#define forced_fold_launch probe_inner_launch
#include "SOURCE"
#undef forced_fold_launch
#undef cudaGetLastError
extern "C" int forced_fold_launch(const FoldArgs* a, void* stream) {
  g_stream = static_cast<cudaStream_t>(stream);
  probe_mark(0);
  return probe_inner_launch(a, stream);
}
// kind 2: the call starts, 3: it ends (recorded from the caller)
extern "C" void probe_begin(void* stream, int on) {
  g_n = 0;
  g_on = on;
  g_stream = static_cast<cudaStream_t>(stream);
  probe_mark(2);
}
extern "C" int probe_end(void* stream) {
  g_stream = static_cast<cudaStream_t>(stream);
  probe_mark(3);
  g_on = 0;
  return g_n;
}
extern "C" int probe_kind(int i) { return g_kind[i]; }
extern "C" float probe_ms(int i) {
  float ms = -1.0f;
  cudaEventElapsedTime(&ms, g_ev[i - 1], g_ev[i]);
  return ms;
}
"""


def build_probe(name: str, source: str, out_dir: str, build) -> ctypes.CDLL:
    wrapper = os.path.join(out_dir, f"fold_probe_{name}.cu")
    with open(wrapper, "w", encoding="utf-8") as f:
        f.write(PROBE.replace("SOURCE", os.path.abspath(source)))
    lib_path = os.path.join(out_dir, f"fold_probe_{name}.so")
    proc = subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-o", lib_path, wrapper],
                          capture_output=True, text=True)
    if proc.returncode:
        raise SystemExit(f"nvcc failed for {source}:\n{proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(lib_path)
    lib.probe_begin.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.probe_end.argtypes = [ctypes.c_void_p]
    lib.probe_end.restype = ctypes.c_int
    lib.probe_kind.argtypes = [ctypes.c_int]
    lib.probe_kind.restype = ctypes.c_int
    lib.probe_ms.argtypes = [ctypes.c_int]
    lib.probe_ms.restype = ctypes.c_float
    return lib


def load_module(name: str, path: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def phases(lib, n_marks: int) -> dict:
    """The last call's marks as phases: "before" (the call's start to its
    first launch sequence), "launch j" (the j-th launch of a sequence,
    summed over the sequences), "rest" (everything else)."""
    out = {"before": 0.0, "rest": 0.0}
    j, seen = 0, False
    for i in range(1, n_marks):
        kind, ms = lib.probe_kind(i), lib.probe_ms(i)
        if kind == 0:
            out["before" if not seen else "rest"] += ms
            seen, j = True, 0
        elif kind == 1:
            j += 1
            out[f"launch {j}"] = out.get(f"launch {j}", 0.0) + ms
        else:
            out["rest"] += ms
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", required=True, help="a checkout of the other commit")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--nodes", type=int, default=5120)
    ap.add_argument("--pods", type=int, default=51200)
    ap.add_argument("--no-replay", action="store_true", help="skip the replay-day input")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("torch_ab_forced_fold: needs the card", file=sys.stderr)
        return 1
    import chip_smoke
    from open_simulator_tpu_torch import replay as replay_mod
    from open_simulator_tpu_torch.engine import scheduler as sched
    from open_simulator_tpu_torch.kernels import build, step
    from open_simulator_tpu_torch.kernels import wave
    from open_simulator_tpu_torch.parallel.sweep import active_masks_for_counts
    from open_simulator_tpu_torch.testing.synthetic import (device_resource_snapshot,
                                                            synthetic_snapshot)

    other_pkg = os.path.join(os.path.abspath(args.other), "open_simulator_tpu_torch")
    out_dir = os.path.join(HERE, "build", "torch_ab")
    os.makedirs(out_dir, exist_ok=True)
    libs = {"other": build_probe("other", os.path.join(other_pkg, "csrc", "forced_fold.cu"),
                                 out_dir, build),
            "this": build_probe("this", str(build.CSRC_DIR / "forced_fold.cu"), out_dir, build)}
    for lib in libs.values():
        lib.forced_fold_launch.argtypes = [ctypes.POINTER(wave.FoldArgs), ctypes.c_void_p]
        lib.forced_fold_launch.restype = ctypes.c_int
    other_wave = load_module("other_wave", os.path.join(other_pkg, "kernels", "wave.py"))
    other_wave._fold_library = lambda: libs["other"]
    other_lib = libs["other"]
    other_lib.forced_fold_launch.argtypes = [ctypes.POINTER(other_wave.FoldArgs),
                                             ctypes.c_void_p]
    wave._fold_library = lambda: libs["this"]

    def other_fold(arrs, cfg, state, nodes):
        """The other commit's engine fold (scheduler._fold_forced before
        this design): clone the carry, fold each chunk in place."""
        state = sched.SimState(**{f: getattr(state, f).contiguous().clone()
                                  for f in sched.STATE_FIELDS})
        inputs = {}
        for lo in range(0, nodes.shape[0], sched._PREFIX_CHUNK):
            hi = min(lo + sched._PREFIX_CHUNK, nodes.shape[0])
            other_wave.forced_fold(arrs, cfg, state, lo, hi, nodes[lo:hi].contiguous(),
                                   inputs=inputs)
        return state

    def folds(arrs, cfg, state, k=None, mask=None):
        """{side: fold()} over the prefix of k pods or the pods under mask."""
        if mask is None:
            return {"this": lambda: sched.apply_forced_prefix(arrs, cfg, state, k),
                    "other": lambda: other_fold(arrs, cfg, state,
                                                arrs.forced_node[:k].to(torch.int32))}
        forced = arrs.forced_node.to(torch.int32)
        return {"this": lambda: sched.apply_forced_mask(arrs, cfg, state, mask),
                "other": lambda: other_fold(arrs, cfg, state, torch.where(
                    mask.to(torch.bool), forced.clamp_min(0), torch.full_like(forced, -1)))}

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    dev = torch.device("cuda")
    inputs = {}
    for kind in ("northstar", "rich", "devres"):
        if kind == "devres":
            snap = device_resource_snapshot(args.nodes, args.pods, max_new=64)
            cfg = sched.make_config(snap)._replace(fail_reasons=False)
            k, pinned = cfg.forced_prefix, snap.arrays
        else:
            snap = synthetic_snapshot(args.nodes, args.pods, max_new=64, rich=kind == "rich")
            cfg = sched.make_config(snap)._replace(fail_reasons=False)
            k = chip_smoke.FOLD_PODS
            arrs = sched.device_arrays(snap.arrays, dev)
            masks = torch.from_numpy(active_masks_for_counts(snap, [63])).to(dev)
            tmpl = sched.init_state(arrs, cfg)
            carry = sched.lane_carry(tmpl, 1)
            out = step.plain_step_cuda(arrs, masks, sched.hoist_of(arrs, masks),
                                       sched.inv_alloc_of(arrs.alloc), carry, cfg, 0, k,
                                       template=tmpl)
            forced = snap.arrays.forced_node.copy()
            forced[:k] = out.node[0].cpu().numpy()
            pinned = dataclasses.replace(snap.arrays, forced_node=forced)
            del arrs, carry, out
        fcfg = cfg._replace(forced_prefix=k)
        arrs_f = sched.device_arrays(pinned, dev)
        inputs[f"{kind} prefix ({k} pods)"] = folds(arrs_f, fcfg, sched.init_state(arrs_f, fcfg),
                                                    k=k)
    if not args.no_replay:
        captured = []
        real_mask = sched.apply_forced_mask

        def capture(arrs, cfg, state, mask):
            captured[:] = [(arrs, cfg, sched.SimState(**{
                f: getattr(state, f).clone() for f in sched.STATE_FIELDS}), mask.clone())]
            return real_mask(arrs, cfg, state, mask)

        sched.apply_forced_mask = capture
        try:
            chip_smoke.replay_run(torch, replay_mod, checkpoint=False)
        finally:
            sched.apply_forced_mask = real_mask
        arrs_m, cfg_m, st_m, mask = captured[0]
        inputs[f"replay-day whole mask ({int(mask.sum())} of {mask.shape[0]} pods)"] = folds(
            arrs_m, cfg_m, st_m, mask=mask)

    stream = torch.cuda.current_stream(dev)
    for label, fns in inputs.items():
        host = {"other": [], "this": []}
        primed = {"other": [], "this": []}
        results = {}
        for _ in range(args.rounds):
            for name in ("other", "this", "this", "other"):
                lib = libs[name]
                for prime in (False, True):
                    if prime:
                        torch.cuda._sleep(int(chip_smoke.PRIME_MS * chip_smoke.SPIN_CYCLES_PER_MS))
                    lib.probe_begin(ctypes.c_void_p(stream.cuda_stream), 1)
                    results[name] = fns[name]()
                    n_marks = lib.probe_end(ctypes.c_void_p(stream.cuda_stream))
                    torch.cuda.synchronize()
                    total = sum(lib.probe_ms(i) for i in range(1, n_marks))
                    if prime:
                        primed[name].append((total, phases(lib, n_marks)))
                    else:
                        host[name].append(total)
        same = all(torch.equal(getattr(results["other"], f), getattr(results["this"], f))
                   for f in sched.STATE_FIELDS)
        for name in ("other", "this"):
            best = min(primed[name], key=lambda t: t[0])
            launches = sorted(k for k in best[1] if k.startswith("launch"))
            print(f"{label}, {name}: with the host launching min {min(host[name]):.4f} ms "
                  f"(runs {[round(t, 4) for t in host[name]]}); the device alone (primed) min "
                  f"{best[0]:.4f} ms (runs {[round(t, 4) for t, _ in primed[name]]}): before "
                  f"the first launch {best[1]['before']:.4f} ms, "
                  + ", ".join(f"{k} {best[1][k]:.4f} ms" for k in launches)
                  + f", the rest {best[1]['rest']:.4f} ms", flush=True)
        print(f"{label}: the device alone, this {min(t for t, _ in primed['this']):.4f} ms "
              f"against other {min(t for t, _ in primed['other']):.4f} ms; with the host, this "
              f"{min(host['this']):.4f} against {min(host['other']):.4f} ms; carries equal: "
              f"{same}", flush=True)
        if not same:
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
