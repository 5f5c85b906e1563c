#!/usr/bin/env python3
"""Build the port's CUDA kernels and print ptxas's report of each kernel.

    python3 tools/torch_ptxas_report.py [--json OUT] [--beside PLAIN_STEP_CU ...]

Compiles every library of ``open_simulator_tpu_torch/csrc`` (one nvcc per
library, started together, as ``kernels/build.build_all``) and prints one
line per kernel function: its library, its name (the ``plain_step``
builds as ``<kInterpod,kDevRes>`` with ``+columns``, ``+frozen``,
``+fleet``, ``+explain`` and ``+ext``), registers, stack frame and spill
bytes. ``--beside`` (repeatable) compiles another ``plain_step.cu`` (an
earlier commit's) with the same flags, both libraries, and prints each
build's registers beside the package's, and beside the package's twin
with the extension rows (``plain_step_ext``, ``plain_step_ext_explain``)
where there is one. Exits 1 if any kernel of the package spills.
Needs nvcc (the machine with the card).
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

_STEP = re.compile(r"plain_step_kernelILb([01])ELb([01])ELb([01])ELb([01])ELb([01])E"
                   r"(?:Lb([01])E)?")
_FLEET = re.compile(r"plain_step_fleet_kernelILb([01])ELb([01])ELb([01])E")
_FUNC = re.compile(r"Compiling entry function '(\w+)'|Function properties for (\w+)")


def kernel_name(mangled: str) -> str:
    """A plain_step build's short name, else the mangled name."""
    m = _STEP.search(mangled)
    if m:
        i, d, c, f, x, e = m.groups()
        return (f"<{i},{d}>" + ("+columns" if c == "1" else "") + ("+frozen" if f == "1" else "")
                + ("+explain" if x == "1" else "") + ("+ext" if e == "1" else ""))
    m = _FLEET.search(mangled)
    if m:
        i, d, x = m.groups()
        return f"<{i},{d}>+fleet" + ("+explain" if x == "1" else "")
    return mangled


def parse(log: str) -> dict:
    """{kernel: {registers, stack_bytes, spill_store_bytes, spill_load_bytes}}
    from one library's ptxas -v output."""
    out, name = {}, None
    for line in log.splitlines():
        m = _FUNC.search(line)
        if m:
            name = kernel_name(m.group(1) or m.group(2))
            out.setdefault(name, {})
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and name:
            out[name].update(stack_bytes=int(m.group(1)), spill_store_bytes=int(m.group(2)),
                             spill_load_bytes=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out[name]["registers"] = int(m.group(1))
    return out


def build_beside(src: str) -> dict:
    """{library: parse(log)} of `src` compiled as plain_step and as its
    explain twin, with the package's flags, into a temporary directory."""
    import subprocess
    import tempfile

    from open_simulator_tpu_torch.kernels import build

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        procs = {}
        for lib, extra in (("plain_step", ()), ("plain_step_explain",
                                                build.VARIANTS["plain_step_explain"][1])):
            cmd = [build.nvcc_path(), *build.NVCC_FLAGS, *extra, "-o",
                   os.path.join(tmp, lib + ".so"), src]
            procs[lib] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                          text=True)
        for lib, proc in procs.items():
            log, _ = proc.communicate()
            if proc.returncode:
                raise RuntimeError(f"nvcc failed for {src} ({lib}):\n{log}")
            out[lib] = parse(log)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--json", default="", help="also write the report as JSON here")
    ap.add_argument("--beside", action="append", default=[], metavar="PLAIN_STEP_CU",
                    help="another plain_step.cu to compile and report beside the package's "
                         "(repeatable)")
    args = ap.parse_args()
    from open_simulator_tpu_torch.kernels import build

    t0 = time.perf_counter()
    build.build_all()
    print(f"build: {time.perf_counter() - t0:.1f}s for {build.kernel_names()}")
    report = {lib: parse(log) for lib, log in sorted(build.BUILD_LOG.items())}
    beside = {}
    for src in args.beside:
        beside[src] = build_beside(src)
        for lib, kernels in beside[src].items():
            ext_lib = lib.replace("plain_step", "plain_step_ext", 1)
            for name, r in sorted(kernels.items()):
                for now_lib, now_name in ((lib, name), (ext_lib, name + "+ext")):
                    now = report.get(now_lib, {}).get(now_name)
                    if now is None and now_lib != lib:
                        continue
                    now = now or {}
                    print(f"beside {os.path.basename(src)} {lib:20s} {name:28s} registers "
                          f"{r.get('registers')} -> {now.get('registers')} ({now_lib} "
                          f"{now_name}) spill_stores {r.get('spill_store_bytes')} -> "
                          f"{now.get('spill_store_bytes')}")
    if beside:
        report["beside"] = beside
    spilled = []
    for lib, kernels in report.items():
        if lib == "beside":
            continue
        for name, r in sorted(kernels.items()):
            print(f"{lib:20s} {name:28s} registers={r.get('registers')} "
                  f"stack={r.get('stack_bytes')} spill_stores={r.get('spill_store_bytes')} "
                  f"spill_loads={r.get('spill_load_bytes')}")
            if r.get("spill_store_bytes") or r.get("spill_load_bytes"):
                spilled.append(f"{lib}:{name}")
    if args.json:
        with open(args.json, "w", encoding="utf-8") as f:
            json.dump(report, f, indent=1, sort_keys=True)
    if spilled:
        print(f"spills: {spilled}")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
