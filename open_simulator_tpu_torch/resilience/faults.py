"""The device fault domain around launches: the reference's classifier and
``run_launch`` (``resilience/faults.py``), for the launches replay makes.

The classifier maps a raised exception to a structured code and tags it
*transient* (worth a retry: the moment, not the program) or
*deterministic* (the same launch fails again; the caller's degradation
rung is the answer):

  ==============  ===========  ==========================================
  code            disposition  raised when
  ==============  ===========  ==========================================
  E_DEVICE_OOM    determ.      out of memory (a torch CUDA OOM says "CUDA
                               out of memory"), allocation failure
  E_DEVICE_LOST   determ.      device lost / unavailable
  E_TRANSFER      transient    host<->device transfer trouble, connection
                               resets, and any bare OSError
  E_NUMERIC       determ.      NaN/inf, a FloatingPointError
  E_COMPILE       determ.      compilation or lowering failure
  E_STORAGE_FULL  determ.      ENOSPC / EDQUOT / EROFS on durable writes
  E_STORAGE_IO    transient    EIO on durable writes
  ==============  ===========  ==========================================

Unclassified exceptions (``ValueError`` bugs, structured
``SimulationError`` s, cancellation) pass through untouched.

Not ported yet (ROADMAP queue 1, item 8): the injection plan
(``SIMON_FAULT_PLAN``), the fault metrics and ledger events, and the
wrapping of launches other than replay's (the sweeps, simulate() and the
Simulator still raise a launch's error as it is).
"""

from __future__ import annotations

import collections
import errno as _errno
import logging
import random
import re
import time
from dataclasses import dataclass
from typing import Callable, Optional, Tuple, TypeVar

from open_simulator_tpu_torch.errors import SimulationError

_log = logging.getLogger(__name__)

T = TypeVar("T")

E_DEVICE_OOM = "E_DEVICE_OOM"
E_DEVICE_LOST = "E_DEVICE_LOST"
E_TRANSFER = "E_TRANSFER"
E_NUMERIC = "E_NUMERIC"
E_COMPILE = "E_COMPILE"
E_STORAGE_FULL = "E_STORAGE_FULL"
E_STORAGE_IO = "E_STORAGE_IO"

# degradation rungs taken, by (launch fn, rung): what the replay tests
# and chip_smoke.py read back
RUNGS: "collections.Counter[Tuple[str, str]]" = collections.Counter()


@dataclass(frozen=True)
class FaultClass:
    """One taxonomy verdict: the structured code and its disposition."""

    code: str
    transient: bool


_OOM = FaultClass(E_DEVICE_OOM, transient=False)
_LOST = FaultClass(E_DEVICE_LOST, transient=False)
_XFER = FaultClass(E_TRANSFER, transient=True)
_NUM = FaultClass(E_NUMERIC, transient=False)
_COMP = FaultClass(E_COMPILE, transient=False)
_SFULL = FaultClass(E_STORAGE_FULL, transient=False)
_SIO = FaultClass(E_STORAGE_IO, transient=True)

_STORAGE_FULL_ERRNOS = frozenset({_errno.ENOSPC, _errno.EDQUOT, _errno.EROFS})
_STORAGE_FULL_PAT = re.compile(
    r"no space left|disk quota exceeded|read-?only file ?system", re.I)

# message patterns, checked in order (an OOM while compiling is an OOM)
_PATTERNS: Tuple[Tuple[re.Pattern, FaultClass], ...] = (
    (re.compile(r"resource[_ ]exhausted|out of memory|\boom\b|"
                r"allocation failure|failed to allocate", re.I), _OOM),
    (re.compile(r"device (?:lost|unavailable|not found|halted)|"
                r"slice preempted|\bpreempted\b|device is gone|"
                r"heartbeat.*(?:lost|timeout)", re.I), _LOST),
    (re.compile(r"\bnan\b|\binf\b|non-?finite", re.I), _NUM),
    (re.compile(r"compilation|lowering|\bmlir\b|\bhlo\b|"
                r"compile failed", re.I), _COMP),
    (re.compile(r"data[_ ]loss|transfer|connection reset|broken pipe|"
                r"socket closed|\bunavailable\b", re.I), _XFER),
)


class DeviceFault(SimulationError):
    """A classified device or runtime failure, structured for every
    surface. ``transient`` is the disposition at classification; a
    transient DeviceFault out of ``run_launch`` has spent its retries."""

    code = E_TRANSFER

    def __init__(self, message: str, code: str, transient: bool,
                 fn: str = "", hint: str = ""):
        super().__init__(message, code=code, ref=f"device/{fn}" if fn else "device",
                         hint=hint)
        self.transient = bool(transient)
        self.fn = fn


def classify(exc: BaseException) -> Optional[FaultClass]:
    """An exception's device-fault class, or None when it is not device
    trouble (structured errors, cancellation, program bugs)."""
    if isinstance(exc, DeviceFault):
        return FaultClass(exc.code, exc.transient)
    if isinstance(exc, SimulationError):
        return None
    if isinstance(exc, FloatingPointError):
        return _NUM
    if not isinstance(exc, (RuntimeError, OSError)):
        return None
    msg = str(exc)
    if isinstance(exc, OSError):
        if exc.errno in _STORAGE_FULL_ERRNOS or _STORAGE_FULL_PAT.search(msg):
            return _SFULL
        if exc.errno == _errno.EIO:
            return _SIO
    for pat, fc in _PATTERNS:
        if pat.search(msg):
            return fc
    if isinstance(exc, OSError):
        return _XFER
    return None


def is_transient(exc: BaseException) -> bool:
    """Retry only faults classified transient; an escalated DeviceFault
    has spent its own retries and is never retried again."""
    if isinstance(exc, DeviceFault):
        return False
    fc = classify(exc)
    return fc is not None and fc.transient


def record_rung(fn: str, rung: str, code: str = "") -> None:
    """Count and log one degradation rung (its output equals the healthy
    path's)."""
    RUNGS[(fn, rung)] += 1
    _log.warning("device fault domain: %s degraded via rung %r (%s)",
                 fn, rung, code or "unclassified")


def run_launch(fn: str, launch: Callable[[], T], *, retries: int = 2,
               backoff_s: float = 0.05, max_backoff_s: float = 2.0,
               rng: Optional[random.Random] = None) -> T:
    """Run one device launch inside the fault domain: a transient failure
    retries up to `retries` times with full-jitter backoff, a
    deterministic one raises on the first attempt; whatever the classifier
    recognises escapes as a ``DeviceFault``, anything else unchanged."""
    attempt = 0
    while True:
        try:
            return launch()
        except SimulationError:
            raise
        except Exception as e:  # noqa: BLE001 — classify, retry, wrap or re-raise
            fc = classify(e)
            if fc is None:
                raise
            if fc.transient and attempt < retries:
                capped = min(backoff_s * (2.0 ** attempt), max_backoff_s)
                time.sleep((rng or random).uniform(0.0, capped))
                attempt += 1
                continue
            raise DeviceFault(
                f"{type(e).__name__}: {e}", code=fc.code, transient=fc.transient, fn=fn,
                hint=("transient retries exhausted" if fc.transient else
                      "deterministic device fault: the degradation ladder "
                      "was the recovery path")) from e


def run_io(fn: str, op: Callable[[], T], *, retries: int = 2) -> T:
    """``run_launch`` for durable-state writes, at disk timescales."""
    return run_launch(fn, op, retries=retries, backoff_s=0.02, max_backoff_s=0.5)


def check_finite(fn: str, **arrays) -> None:
    """NaN/inf sentinel scan over decoded (hosted) float outputs: a NaN
    escaping a score would otherwise flow silently into verdicts and
    digests. Raises a deterministic ``E_NUMERIC`` DeviceFault naming the
    first offending array; integer arrays pass through untouched."""
    import numpy as np

    for name, x in arrays.items():
        if x is None:
            continue
        x = np.asarray(x)
        if not np.issubdtype(x.dtype, np.floating):
            continue
        if not bool(np.isfinite(x).all()):
            bad = int(np.size(x) - np.count_nonzero(np.isfinite(x)))
            raise DeviceFault(
                f"non-finite values (NaN/inf) in decoded output "
                f"{name!r}: {bad} element(s)", code=E_NUMERIC,
                transient=False, fn=fn,
                hint="a fused score or carry update produced NaN; the "
                     "degraded re-launch (waves off / split batch) "
                     "isolates the producer")
