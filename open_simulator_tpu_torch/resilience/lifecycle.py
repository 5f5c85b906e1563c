"""What replay needs of the reference's ``resilience/lifecycle.py``: the
checkpoint directory, the bounded journal directory (``prune_journals``)
and cooperative cancellation (``CancelToken``, ``cancel_scope``,
``check_current``). The admission queue, the sweep journal and drain
belong to serving and the sweeps (ROADMAP queue 1, items 11 and 8).
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from typing import Any, Callable, Dict, Optional

from open_simulator_tpu_torch.errors import SimulationError
from open_simulator_tpu_torch.resilience.journal import ResumeError  # noqa: F401

CHECKPOINT_DIR_ENV = "SIMON_CHECKPOINT_DIR"
LEDGER_DIR_ENV = "SIMON_LEDGER_DIR"
# completed journals kept per (checkpoint dir, journal kind); unfinished
# ones are resumable crash evidence and never pruned
SHARED_JOURNAL_KEEP_ENV = "SIMON_JOURNAL_KEEP"
DEFAULT_JOURNAL_KEEP = 32
_DONE_TOKENS = (b'"kind": "done"', b'"kind": "close"')


def journal_keep() -> int:
    """The keep-N-completed bound: SIMON_JOURNAL_KEEP, else the default."""
    raw = os.environ.get(SHARED_JOURNAL_KEEP_ENV)
    try:
        return max(0, int(raw)) if raw is not None else DEFAULT_JOURNAL_KEEP
    except ValueError:
        return DEFAULT_JOURNAL_KEEP


def journal_is_done(path: str) -> bool:
    """Does the journal's tail carry a done or close marker?"""
    try:
        with open(path, "rb") as f:
            f.seek(0, os.SEEK_END)
            f.seek(max(0, f.tell() - 4096))
            tail = f.read()
    except OSError:
        return False
    return any(tok in tail for tok in _DONE_TOKENS)


def prune_journals(root: str, suffix: str) -> int:
    """Delete completed ``*<suffix>`` journals oldest-first past
    ``journal_keep()``; returns the number removed."""
    keep = journal_keep()
    try:
        names = [n for n in os.listdir(root) if n.endswith(suffix)]
    except OSError:
        return 0
    done = [n for n in names if journal_is_done(os.path.join(root, n))]
    done.sort(key=lambda n: os.path.getmtime(os.path.join(root, n)))
    removed = 0
    for n in done[:max(0, len(done) - keep)]:
        try:
            os.remove(os.path.join(root, n))
            removed += 1
        except OSError:
            pass
    return removed


def checkpoint_dir() -> Optional[str]:
    """Where journals live: SIMON_CHECKPOINT_DIR, else ``<ledger
    dir>/checkpoints`` under SIMON_LEDGER_DIR. None: no checkpoints."""
    explicit = os.environ.get(CHECKPOINT_DIR_ENV)
    if explicit:
        return explicit
    d = os.environ.get(LEDGER_DIR_ENV)
    return os.path.join(d, "checkpoints") if d else None


class CancelledError(SimulationError):
    """Cooperative cancellation observed at a phase boundary; ``partial``
    carries what the computation had finished."""

    code = "E_CANCELLED"

    def __init__(self, message: str, code: Optional[str] = None,
                 partial: Optional[Dict[str, Any]] = None, **kw):
        super().__init__(message, code=code, **kw)
        self.partial = partial or {}

    def to_dict(self) -> Dict[str, Any]:
        out = super().to_dict()
        if self.partial:
            out["partial"] = self.partial
        return out


class CancelToken:
    """A deadline plus an explicit cancellation flag, shared between the
    thread that owns a request and the thread doing its work."""

    def __init__(self, deadline_s: Optional[float] = None, reason: str = ""):
        self._event = threading.Event()
        self._reason = reason
        armed = deadline_s is not None and deadline_s > 0
        self.deadline = time.monotonic() + float(deadline_s) if armed else None
        self.deadline_s = float(deadline_s) if armed else None

    def cancel(self, reason: str = "cancelled") -> None:
        self._reason = reason
        self._event.set()

    @property
    def reason(self) -> str:
        if self._reason:
            return self._reason
        if self.deadline is not None and time.monotonic() >= self.deadline:
            return f"deadline of {self.deadline_s:.1f}s exceeded"
        return ""

    @property
    def cancelled(self) -> bool:
        if self._event.is_set():
            return True
        return self.deadline is not None and time.monotonic() >= self.deadline

    def error(self, where: str = "",
              partial: Optional[Dict[str, Any]] = None) -> CancelledError:
        """The structured error: E_DEADLINE once a deadline has passed,
        E_CANCELLED for a cancellation ahead of any deadline."""
        deadline_passed = self.deadline is not None and time.monotonic() >= self.deadline
        code = ("E_DEADLINE" if deadline_passed
                else "E_CANCELLED" if self._event.is_set() else "E_DEADLINE")
        msg = self.reason or "cancelled"
        if where:
            msg = f"{msg} (observed at {where})"
        return CancelledError(
            msg, code=code, partial=partial, ref="request",
            hint="partial results, if any, are in the 'partial' field; "
                 "retry with a larger deadline, or resume a checkpointed run")


_tls = threading.local()


@contextlib.contextmanager
def cancel_scope(token: Optional[CancelToken]):
    """Install `token` as the current thread's cancellation context."""
    prev = getattr(_tls, "token", None)
    _tls.token = token
    try:
        yield token
    finally:
        _tls.token = prev


def current_token() -> Optional[CancelToken]:
    return getattr(_tls, "token", None)


def check_current(where: str = "",
                  partial: Optional[Callable[[], Dict[str, Any]]] = None) -> None:
    """Raise CancelledError if the current scope's token is cancelled
    (`partial` is a thunk, built only when cancellation fires)."""
    tok = current_token()
    if tok is not None and tok.cancelled:
        raise tok.error(where, partial() if partial is not None else None)
