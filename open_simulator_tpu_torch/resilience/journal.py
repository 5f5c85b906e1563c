"""Integrity-framed durable journals: the reference's
``resilience/journal.py`` (the frame format, the strict reader, token
resolution and the ``DurableJournal`` base), for the replay journal.

**Frame format** (one record per line)::

    J1 <crc32:08x> <seq> <canonical-json payload>\\n

``seq`` is the 0-based, strictly monotone record number (the header is
record 0); the CRC32 covers ``"<seq> <payload>"``. Journals of plain
JSON lines (the older format) are still read, flagged ``legacy``.

**Strict torn-tail-only recovery**: the only damage tolerated is an
undecodable (or CRC-failing) final line — the partial write a crash
mid-append leaves; it is dropped and the journal resumes from the
prefix. Anything else (a bad line mid-file, a sequence gap, a duplicated
or reordered record) raises ``JournalCorrupt`` (``E_CORRUPT``).

**Storage faults**: appends run inside ``faults.run_io`` (ENOSPC is
deterministic, EIO transient); a fault that outlives the retries latches
the journal off (``broken``: the ``checkpointing_disabled`` rung) and the
run goes on. The reference's journal metrics and flight-recorder events
are not ported (ROADMAP queue 1, item 11).
"""

from __future__ import annotations

import json
import logging
import os
import zlib
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from open_simulator_tpu_torch.errors import SimulationError

_log = logging.getLogger(__name__)

E_CORRUPT = "E_CORRUPT"

FRAME_PREFIX = b"J1 "
FORMAT_FRAMED = "framed"
FORMAT_LEGACY = "legacy"


class ResumeError(SimulationError):
    """Bad resume request: unknown id, fingerprint mismatch, drift."""

    code = "E_RESUME"


class JournalCorrupt(SimulationError):
    """Durable state failed the integrity scan somewhere other than the
    torn tail; carries the journal ``kind``, the 0-based record ``index``
    and the byte ``offset`` of the first bad record."""

    code = E_CORRUPT

    def __init__(self, message: str, *, kind: str = "", index: int = -1,
                 offset: int = -1, path: str = "", **kw):
        kw.setdefault("ref", f"journal/{kind}" if kind else "journal")
        kw.setdefault(
            "hint",
            "the journal cannot be resumed; quarantine or delete the file "
            "and re-run from scratch (the torn-tail rule only forgives a "
            "partial FINAL line)")
        super().__init__(message, code=E_CORRUPT, **kw)
        self.kind = kind
        self.index = int(index)
        self.offset = int(offset)
        self.path = path

    def to_dict(self) -> Dict[str, Any]:
        out = super().to_dict()
        out["journal"] = {"kind": self.kind, "index": self.index,
                          "offset": self.offset, "file": os.path.basename(self.path)}
        return out


def _json_default(o):
    import numpy as np

    if isinstance(o, (np.integer,)):
        return int(o)
    if isinstance(o, (np.floating,)):
        return float(o)
    if isinstance(o, np.ndarray):
        return o.tolist()
    raise TypeError(f"not JSON serializable: {type(o).__name__}")


def frame_record(seq: int, rec: Dict[str, Any]) -> bytes:
    """One framed journal line."""
    payload = json.dumps(rec, sort_keys=True, default=_json_default)
    body = f"{int(seq)} {payload}".encode("utf-8")
    crc = zlib.crc32(body) & 0xFFFFFFFF
    return FRAME_PREFIX + f"{crc:08x} ".encode() + body + b"\n"


def unframe_line(line) -> str:
    """The JSON payload of one journal line, framed or legacy (for tools
    and tests; reads go through ``read_journal``)."""
    if isinstance(line, bytes):
        line = line.decode("utf-8")
    if line.startswith(FRAME_PREFIX.decode()):
        return line.split(" ", 3)[3]
    return line


class _BadLine(Exception):
    """A line that failed to decode; ``tolerable`` marks damage a torn
    write could produce (forgivable at the tail only)."""

    def __init__(self, reason: str, tolerable: bool = True):
        super().__init__(reason)
        self.reason = reason
        self.tolerable = tolerable


def _decode_frame(raw: bytes, expect_seq: int) -> Dict[str, Any]:
    parts = raw.split(b" ", 3)
    if len(parts) != 4 or parts[0] != b"J1":
        raise _BadLine("not a J1-framed line")
    _, crc_hex, seq_b, payload = parts
    try:
        want_crc = int(crc_hex, 16)
    except ValueError:
        raise _BadLine(f"unparsable crc field {crc_hex[:16]!r}") from None
    have_crc = zlib.crc32(seq_b + b" " + payload) & 0xFFFFFFFF
    if have_crc != want_crc:
        raise _BadLine(
            f"crc mismatch (recorded {want_crc:08x}, computed {have_crc:08x}) — the "
            f"line's bytes changed after it was written")
    # CRC verified: a sequence violation means a lost, duplicated or moved
    # record, never a torn write
    try:
        seq = int(seq_b)
    except ValueError:
        raise _BadLine(f"unparsable seq field {seq_b[:16]!r}", tolerable=False) from None
    if seq != expect_seq:
        raise _BadLine(
            f"sequence break: expected record #{expect_seq}, found #{seq} (gap, "
            f"duplicate, or reordered line)", tolerable=False)
    try:
        rec = json.loads(payload)
    except json.JSONDecodeError as e:
        raise _BadLine(f"framed payload is not JSON: {e}", tolerable=False) from None
    if not isinstance(rec, dict):
        raise _BadLine("framed payload is not a JSON object", tolerable=False)
    return rec


def _decode_legacy(raw: bytes) -> Dict[str, Any]:
    try:
        rec = json.loads(raw)
    except json.JSONDecodeError as e:
        raise _BadLine(f"unparsable JSON line: {e}") from None
    if not isinstance(rec, dict):
        raise _BadLine("record is not a JSON object")
    return rec


@dataclass
class JournalScan:
    """One verified read of a journal file."""

    records: List[Dict[str, Any]] = field(default_factory=list)
    legacy: bool = False
    torn_tail: bool = False
    torn_offset: int = -1        # byte offset of the truncated line
    next_seq: int = 0            # the seq the next append must carry
    path: str = ""


def read_journal(path: str, kind: str) -> JournalScan:
    """Parse and verify a journal under the torn-tail-only rule; raise
    ``JournalCorrupt`` on anything a crash mid-append cannot explain."""
    with open(path, "rb") as f:
        data = f.read()
    lines = data.split(b"\n")
    if lines and lines[-1] == b"":
        lines.pop()
    scan = JournalScan(path=path)
    if lines:
        scan.legacy = not lines[0].startswith(FRAME_PREFIX)
    offset = 0
    for i, raw in enumerate(lines):
        line_off = offset
        offset += len(raw) + 1
        last = i == len(lines) - 1
        try:
            if scan.legacy:
                if not raw.strip():
                    raise _BadLine("blank line inside the journal")
                rec = _decode_legacy(raw)
            else:
                rec = _decode_frame(raw, scan.next_seq)
        except _BadLine as bad:
            if last and bad.tolerable:
                scan.torn_tail = True
                scan.torn_offset = line_off
                _log.warning(
                    "%s journal %s: dropped torn final line at byte offset %d (%s); "
                    "resuming from the %d-record prefix", kind, path, line_off, bad.reason,
                    len(scan.records))
                break
            raise JournalCorrupt(
                f"{kind} journal {os.path.basename(path)} is corrupt at record #{i} "
                f"(byte offset {line_off}): {bad.reason}",
                kind=kind, index=i, offset=line_off, path=path) from None
        scan.records.append(rec)
        scan.next_seq += 1
    return scan


def resolve_journal_path(root: str, token: str, suffix: str, noun: str) -> str:
    """``token`` (a unique id prefix, or ``last``/``latest``) -> a path;
    ``ResumeError`` for a missing directory or an unknown or ambiguous
    token."""
    if not root or not os.path.isdir(root):
        raise ResumeError(
            f"no checkpoint directory at {root!r}", ref="resume",
            hint="set SIMON_CHECKPOINT_DIR (or SIMON_LEDGER_DIR: checkpoints live in "
                 "<ledger>/checkpoints)")
    names = sorted(n for n in os.listdir(root) if n.endswith(suffix))
    if not names:
        raise ResumeError(f"no {noun} checkpoints under {root}", ref="resume")
    if token in ("last", "latest"):
        pick = max(names, key=lambda n: os.path.getmtime(os.path.join(root, n)))
    else:
        hits = [n for n in names if n.startswith(token)]
        if not hits:
            raise ResumeError(
                f"no {noun} checkpoint matches {token!r}", ref="resume",
                hint=f"known: {[n.split('.')[0] for n in names]}")
        if len(hits) > 1:
            raise ResumeError(
                f"{noun} id prefix {token!r} is ambiguous: "
                f"{[n.split('.')[0] for n in hits]}", ref="resume")
        pick = hits[0]
    return os.path.join(root, pick)


class DurableJournal:
    """The framed writer and verified-state holder of a journal kind: an
    fsynced append through the ``journal_append`` storage fault domain,
    with the ``checkpointing_disabled`` latch (``broken``, ``broken_code``),
    and the format bookkeeping a strict load threads in."""

    KIND = "journal"

    def __init__(self, path: str, header: Dict[str, Any]):
        self.path = path
        self.header = header
        self.legacy = False
        self.torn_tail = False
        self._seq = 0
        self.broken = False
        self.broken_code: Optional[str] = None
        # a torn final line to drop before the first resumed append
        self._truncate_at: Optional[int] = None

    def _adopt_scan(self, scan: JournalScan) -> None:
        self.legacy = scan.legacy
        self.torn_tail = scan.torn_tail
        self._seq = scan.next_seq
        if scan.torn_tail and scan.torn_offset >= 0:
            self._truncate_at = scan.torn_offset

    def _append(self, rec: Dict[str, Any]) -> None:
        from open_simulator_tpu_torch.resilience import faults

        if self.broken:
            return
        if self.legacy:
            line = json.dumps(rec, sort_keys=True, default=_json_default).encode() + b"\n"
        else:
            line = frame_record(self._seq, rec)

        def write() -> None:
            if self._truncate_at is not None:
                with open(self.path, "r+b") as tf:
                    tf.truncate(self._truncate_at)
                self._truncate_at = None
            with open(self.path, "ab") as f:
                start = f.tell()
                try:
                    f.write(line)
                    f.flush()
                    os.fsync(f.fileno())
                except OSError:
                    # a retried append must never leave a torn line mid-file
                    try:
                        f.truncate(start)
                    except OSError:
                        pass
                    raise

        try:
            faults.run_io("journal_append", write)
        except faults.DeviceFault as e:
            self._disable(e.code, e)
            return
        except OSError as e:
            self._disable(faults.E_STORAGE_IO, e)
            return
        self._seq += 1

    def _disable(self, code: str, err: Exception) -> None:
        from open_simulator_tpu_torch.resilience import faults

        self.broken = True
        self.broken_code = code
        faults.record_rung("journal_append", "checkpointing_disabled", code)
        _log.warning(
            "%s journal %s is unwritable (%s: %s); checkpointing disabled for the rest "
            "of this run — it cannot be resumed past the last durable record",
            self.KIND, self.path, code, err)
