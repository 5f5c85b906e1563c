"""Build and load the package's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` into its own shared library
with a plain C interface and loaded with ``ctypes``. Libraries land in
``build/torch_kernels/`` at the repository root (listed in ``.gitignore``),
named by a hash of their source and flags, so an edited source rebuilds
and an unchanged one is reused within and across processes. Nothing is
built when the package is imported: the first call that launches a kernel
builds it. A failed build raises; there is no fallback.

Flags: ``sm_90a`` (Hopper), ``-O3``, and ``--fmad=false`` so that no
multiply and add is contracted into an FMA — the kernels are held bit for
bit against the plain torch step, which rounds every operation. No
``--use_fast_math``: divides stay IEEE round-to-nearest.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Dict, List, Tuple

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_LOCK = threading.Lock()
_LOADED: Dict[str, ctypes.CDLL] = {}
# ptxas report (registers, shared memory, spills) of each build, by kernel;
# kept beside the library, so a reused build reports it too
BUILD_LOG: Dict[str, str] = {}


def nvcc_path() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
                 shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the CUDA kernels are built from source at first use")


def _target(name: str) -> Tuple[Path, Path]:
    src = CSRC_DIR / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return src, BUILD_DIR / f"{name}-{digest}.so"


def _start(name: str):
    src, out = _target(name)
    if out.exists():
        report = out.with_suffix(".ptxas.txt")
        if report.exists():
            BUILD_LOG[name] = report.read_text()
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, str(src)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, started) -> None:
    if started is None:
        return
    proc, tmp, out = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed for {name}.cu (exit {proc.returncode}):\n{log}")
    BUILD_LOG[name] = log
    out.with_suffix(".ptxas.txt").write_text(log)
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing


def kernel_names() -> List[str]:
    return sorted(p.stem for p in CSRC_DIR.glob("*.cu"))


def build_all() -> None:
    """Compile every csrc/*.cu not built yet, one nvcc per source, all
    started together."""
    with _LOCK:
        started = {name: _start(name) for name in kernel_names()}
        for name, st in started.items():
            _finish(name, st)


def load(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, building it if needed."""
    with _LOCK:
        lib = _LOADED.get(name)
        if lib is None:
            _finish(name, _start(name))
            lib = ctypes.CDLL(str(_target(name)[1]))
            _LOADED[name] = lib
        return lib
